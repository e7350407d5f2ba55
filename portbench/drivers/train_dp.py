"""Data-parallel training: one process a card over NCCL, each running the
program's train step (``core/train.py::make_train_step``, which averages
the gradients and takes BatchNorm's statistics over all ranks when a
process group is up) on its rows of the global batch; the ranks stop
together through the program's host-group flag (``any_process``), as
``fit`` does.

The harness's process starts ``world`` workers (``python -m
portbench.drivers.train_dp <args>``, torchrun's environment on a free
localhost port), waits for them, and then runs the reference on card 0:
the plain single-process steps at the global batch. Rank r's rows of every
batch are drawn from the seed for (batch, rank), so the reference puts the
global batch together in rank order. Compared: the check steps' losses,
first gradients and changes as the one-card cell compares them, and the
ranks' parameters after the check steps (every rank the same, exactly).

Traffic keys: those of ``train`` with ``batch`` the global batch, and
``world`` (ranks, one a card). End-to-end: ``dp_train_images_per_s``, the
images of all ranks' steps completed in the window over the window.

Dormant: no cell of ``BENCHMARK.json`` plays this driver yet (PERF.md,
open questions); the CPU tests run it on four gloo ranks.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import compare, inputs, program, weights
from portbench.drivers import train as one_card
from portbench.reference import pipeline as ref_pipe


def rank_rows(ctx, world, rank):
    """[(canvases, joints, vis, centers, scales)] of this rank's rows of
    every distinct batch: canvases drawn from (seed, batch, rank), the
    rest cut from the global arrays."""
    tr, seed = ctx.traffic, ctx.seed
    n, s, k = tr["batch"], tr["canvas"], ctx.cfg["model"]["num_joints"]
    per = n // world
    r = inputs.rng(seed, 3)
    out = []
    for i in range(tr["distinct"]):
        j, v = inputs.joints(r, n, k)
        c, sc = inputs.boxes(r, n)
        rows = slice(rank * per, (rank + 1) * per)
        images = inputs.pinned_uint8(seed, 100 + i * world + rank,
                                     (per, s, s, 3), ctx.device)
        out.append((images, j[rows], v[rows], c[rows], sc[rows]))
    return out


def global_rows(ctx, world):
    """The global batches, the ranks' rows in rank order (for the
    reference)."""
    parts = [rank_rows(ctx, world, r) for r in range(world)]
    return [tuple((torch.cat if isinstance(p[0][f], torch.Tensor)
                   else np.concatenate)([q[f] for q in p]) for f in range(5))
            for p in zip(*parts)]


def worker(args):
    """One rank: its train state from the seed's weights, the check steps,
    the window, optionally a traced stretch; rank 0 writes the results."""
    from rsgnet_tpu_torch.core.inference import configure_cudnn
    from rsgnet_tpu_torch.core.train import create_train_state, make_train_step
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.parallel import distributed as pd
    from portbench.run import Context
    ctx = Context(**args["ctx"])
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    pd.initialize_distributed(None, dev, timeout=300)
    if cuda:
        dev = torch.device("cuda", torch.cuda.current_device())
        ctx.device = dev
    if args.get("fault") == "no_exchange":
        import rsgnet_tpu_torch.core.train as core_train
        core_train.average_gradients = lambda params: None
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg = program.config(ctx.cfg)
    configure_cudnn(cfg)
    tr = ctx.traffic
    n, per, ncheck = tr["batch"], tr["batch"] // world, tr["check_steps"]
    raws = rank_rows(ctx, world, rank)
    sd = weights.make_state_dict(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                 ctx.seed, dev)
    with torch.device("meta"):
        shape_ref = one_card.ref_pipe_model(ctx)
    names = one_card.leaf_names(cfg, shape_ref)
    state = create_train_state(cfg, program.model(cfg, sd, dev), device=dev)
    del sd
    params = dict(state.model.named_parameters())
    leaves = [params[p] for _, p in names]
    start = [p.detach().clone() for p in leaves]
    step = make_train_step(cfg, get_spec("coco"))

    def one(i):
        nonlocal state
        d = {k: v[rank * per:(rank + 1) * per]
             for k, v in inputs.draws(ctx.seed, i, n).items()}
        state, metrics = step(state, one_card.batch_of(raws[i % len(raws)],
                                                       dev), d)
        return metrics

    losses = []
    for i in range(ncheck):
        losses.append(one(i)["loss"].detach().float().reshape(()))
        if i == 0:
            b1 = state.optimizer.defaults["betas"][0]
            st = state.optimizer.state
            grad1 = compare.leaf_norms([st[p]["exp_avg"] / (1 - b1)
                                        if p in st else torch.zeros_like(p)
                                        for p in leaves])
    update = compare.leaf_norms([p - q for p, q in zip(leaves, start)])
    norms = compare.leaf_norms(leaves)
    del start
    for i in range(ncheck, ncheck + tr["warm_steps"]):
        one(i)
    sync()
    pd.host_barrier()
    t_start = time.perf_counter()
    i, steps = ncheck + tr["warm_steps"], 0
    while True:
        one(i)
        i += 1
        steps += 1
        if pd.any_process(time.perf_counter() - t_start >= ctx.seconds):
            break
    sync()
    window = time.perf_counter() - t_start
    def stretch():
        for k in range(tr["trace_steps"]):
            one(10 ** 6 + k)
        return tr["trace_steps"]

    trace = None
    if ctx.trace and rank == 0:
        from portbench.trace import Summary, trace_stretch
        t = trace_stretch(torch, stretch)
        trace = None if t is None else Summary.of(t, ("nccl",))
    elif ctx.trace:
        stretch()
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res = {"rank": rank, "t_start": t_start, "window": window,
           "steps": steps, "peak": peak, "norms": norms.tolist(),
           "losses": torch.stack(losses).cpu().tolist(),
           "grad1": grad1.tolist(), "update3": update.tolist(),
           "trace": trace}
    with open(args["out"] % rank, "w") as f:
        json.dump(res, f)
    pd.shutdown_distributed(wait=True)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(ctx, world, workdir, fault=None, timeout=300):
    """Start the ranks, wait for all of them; their results by rank."""
    ctx_args = {k: getattr(ctx, k) for k in ("name", "cell", "cfg",
                                              "traffic", "limits", "seed",
                                              "seconds", "trace", "device")}
    out = os.path.join(workdir, "portbench_rank%d.json")
    args = json.dumps({"ctx": ctx_args, "out": out, "fault": fault})
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.drivers.train_dp", args],
            env=env, stdout=sys.stderr.fileno(), cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"ranks exited {[p.returncode for p in procs]}")
    results = []
    for r in range(world):
        with open(out % r) as f:
            results.append(json.load(f))
        os.remove(out % r)
    return results


def run(ctx):
    import tempfile

    from portbench.trace import Summary
    tr = ctx.traffic
    world = tr["world"]
    if torch.device(ctx.device).type == "cuda" and \
            torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards")
    with tempfile.TemporaryDirectory() as workdir:
        ranks = launch(ctx, world, workdir,
                       fault=ctx.hooks.get("fault"))
    r0 = ranks[0]
    setup_s = r0["t_start"] - ctx.t0
    steps = r0["steps"]
    rate = steps * tr["batch"] / r0["window"]
    prog = {k: np.asarray(r0[k]) for k in ("losses", "grad1", "update3")}
    ref = one_card.reference_train(ctx, global_rows(ctx, world), ctx.device)
    numbers = compare.train_numbers(prog, ref)
    n0 = np.asarray(r0["norms"])
    numbers["rank_gap"] = float(max(np.abs(np.asarray(r["norms"]) - n0).max()
                                    for r in ranks))
    trace = None if r0["trace"] is None else Summary(r0["trace"])
    facts = {"images_per_s": rate, "cfg": ctx.cfg, "batch": tr["batch"],
             "train": True, "world": world}
    return {"setup_s": setup_s, "e2e": {"dp_train_images_per_s": rate},
            "attempted": steps * tr["batch"], "failed": 0,
            "numbers": numbers,
            "memory_peak_bytes": max(r["peak"] for r in ranks),
            "trace": trace, "facts": facts}


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))
