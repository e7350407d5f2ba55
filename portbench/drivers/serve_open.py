"""Open-loop serving: requests of uint8 person crops arrive on a Poisson
schedule at the program's ``DynamicBatcher.submit`` over its
``ServingEngine`` and ``make_inference_fn(normalize_input=True)``, in
process, as ``python -m rsgnet_tpu_torch.serve`` sets them up (every
bucket warmed first).

The schedule holds ``rate`` x the window's seconds requests at uniform
order statistics of the window (a Poisson process given its count), and
their sizes are the quantiles of a geometric distribution of mean
``mean_instances`` truncated at ``max_instances``: every seed sends the same
number of requests of the same sizes, in its own order and at its own
times. Each request's latency runs from when it was due to be sent until
its future resolved; a request that is shed, expires or fails counts in
``failed`` and, in the tail, as the whole wait for it.

Traffic keys: ``rate`` (requests/s), ``mean_instances``,
``max_instances``, ``pool`` (distinct crops), ``buckets``,
``max_wait_ms``, ``in_flight``, ``max_queued``, ``trace_seconds``,
``check_requests``, ``wait_s`` (the wait past the window's close).
End-to-end: ``serve_p95_ms``.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import compare, inputs, program, weights
from portbench.reference import pipeline as ref_pipe
from portbench.trace import trace_stretch


class Schedule:
    """One open-loop stretch: due times (s from its start), sizes and the
    crops, centers and scales of every request."""

    def __init__(self, ctx, stream, seconds, pool):
        tr = ctx.traffic
        r = inputs.rng(ctx.seed, stream)
        count = max(1, int(round(tr["rate"] * seconds)))
        self.due = np.sort(r.uniform(0.0, seconds, count))
        self.sizes = r.permutation(inputs.truncated_geometric_sizes(
            count, tr["mean_instances"], tr["max_instances"]))
        self.rows = [r.integers(0, pool, n) for n in self.sizes]
        self.boxes = [inputs.boxes(r, n) for n in self.sizes]

    def __len__(self):
        return len(self.due)


def play(batcher, sched, crops, start):
    """Submit every request at its due time from this thread; returns
    (futures or exceptions, done times, lateness of each submit)."""
    n = len(sched)
    done = np.full(n, np.nan)
    late = np.zeros(n)
    futs = [None] * n
    for i in range(n):
        due = start + sched.due[i]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - due
        c, s = sched.boxes[i]
        try:
            f = batcher.submit(crops[sched.rows[i]], c, s)
        except Exception as e:                    # shed at admission
            futs[i] = e
            continue

        def mark(_, i=i):
            done[i] = time.perf_counter()
        f.add_done_callback(mark)
        futs[i] = f
    return futs, done, late


def settle(futs, deadline):
    """Wait for every future until ``deadline``; [result or None]."""
    out = []
    for f in futs:
        if isinstance(f, Exception):
            out.append(None)
            continue
        try:
            out.append(f.result(timeout=max(0.0, deadline
                                            - time.perf_counter())))
        except Exception:                         # expired, failed, late
            out.append(None)
    return out


def run(ctx):
    from rsgnet_tpu_torch.core.inference import (configure_cudnn,
                                                 make_inference_fn)
    from rsgnet_tpu_torch.serving.batcher import DynamicBatcher
    from rsgnet_tpu_torch.serving.engine import ServingEngine
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    tr = ctx.traffic
    cfg = program.config(ctx.cfg)
    configure_cudnn(cfg)
    w, h = ctx.cfg["model"]["image_size"]
    crops = inputs.pinned_uint8(ctx.seed, 0, (tr["pool"], h, w, 3),
                                dev).numpy()
    window = Schedule(ctx, 4, ctx.seconds, tr["pool"])
    sd = weights.make_state_dict(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                 ctx.seed, dev)
    fn = make_inference_fn(cfg, program.model(cfg, sd, dev),
                           normalize_input=True, device=dev)
    del sd
    fn = ctx.hooks.get("wrap", lambda f: f)(fn)
    engine = ServingEngine(fn, buckets=tuple(tr["buckets"]),
                           image_shape=(h, w, 3), image_dtype=np.uint8)
    engine.warmup()
    batcher = DynamicBatcher(engine, max_wait_ms=tr["max_wait_ms"],
                             in_flight=tr["in_flight"],
                             max_queued=tr["max_queued"])
    try:
        start = time.perf_counter() + 0.05
        setup_s = start - ctx.t0
        futs, done, late = play(batcher, window, crops, start)
        close = start + ctx.seconds
        results = settle(futs, max(close, time.perf_counter())
                         + tr["wait_s"])
        ended = time.perf_counter()
        stats = batcher.stats()
        trace = None
        if ctx.trace:
            extra = Schedule(ctx, 5, tr["trace_seconds"], tr["pool"])

            def stretch():
                s0 = time.perf_counter() + 0.01
                f, _, _ = play(batcher, extra, crops, s0)
                return sum(r is not None for r in settle(f, s0 + 60))
            trace = trace_stretch(torch, stretch)
    finally:
        batcher.close()
        engine.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del fn, engine, batcher
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ok = np.array([r is not None for r in results])
    lat = np.where(ok, done - (start + window.due), ended - (start + window.due))
    p95 = float(np.percentile(lat, 95) * 1e3)
    p50 = float(np.percentile(lat, 50) * 1e3)
    eng = stats["engine"]["bucket_calls"]
    padded = sum(int(b) * c for b, c in eng.items())
    print(f"diag requests {len(window)} failed {int((~ok).sum())} "
          f"late_ms p50 {np.percentile(late, 50) * 1e3:.3f} p99 "
          f"{np.percentile(late, 99) * 1e3:.3f} max {late.max() * 1e3:.3f} "
          f"p50_ms {p50:.2f} p95_ms {p95:.2f} batches {eng}",
          file=sys.stderr)
    numbers, diag = check(ctx, window, crops, results, ok, dev)
    return {"setup_s": setup_s, "e2e": {"serve_p95_ms": p95},
            "attempted": len(window), "failed": int((~ok).sum()),
            "numbers": numbers, "diag": diag, "memory_peak_bytes": peak,
            "trace": trace,
            "facts": {"serve_p50_ms": p50, "instances": stats["instances"],
                      "padded": padded, "cfg": ctx.cfg,
                      "late_p99_ms": float(np.percentile(late, 99) * 1e3)}}


def pick(ctx, sched, done):
    """``check_requests`` of the requests ``done`` (indices), drawn from
    the seed: the largest quarter first, the rest at random."""
    r = inputs.rng(ctx.seed, 6)
    k = min(ctx.traffic["check_requests"], done.size)
    largest = done[np.argsort(-sched.sizes[done], kind="stable")[:k // 4]]
    rest = np.setdiff1d(done, largest)
    return np.concatenate([largest, r.choice(rest, size=k - largest.size,
                                             replace=False)])


def check(ctx, sched, crops, results, ok, dev):
    """The sampled completed requests against the reference on the same
    crops: (compared numbers, the record's quantiles)."""
    picked = pick(ctx, sched, np.flatnonzero(ok))
    sd = weights.make_state_dict(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                 ctx.seed, dev)
    model = weights.reference_model(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                    sd, dev).eval()
    return compare_requests(ctx, model, sched, crops, results, picked, dev)


def reference_requests(ctx, model, sched, crops, picked, dev):
    """The reference's (preds, maxvals) of the requests ``picked``, in
    one stack."""
    rows = np.concatenate([sched.rows[i] for i in picked])
    c = np.concatenate([sched.boxes[i][0] for i in picked])
    s = np.concatenate([sched.boxes[i][1] for i in picked])
    x = torch.from_numpy(crops[rows]).to(dev).permute(0, 3, 1, 2).float()
    p, m = ref_pipe.predict(
        model, ref_pipe.normalize(x),
        torch.as_tensor(c, dtype=torch.float64, device=dev),
        torch.as_tensor(s, dtype=torch.float64, device=dev),
        ctx.cfg["pipeline"])
    return p.cpu().numpy(), m.cpu().numpy(), s


def compare_requests(ctx, model, sched, crops, results, picked, dev):
    rp, rm, s = reference_requests(ctx, model, sched, crops, picked, dev)
    p = np.concatenate([results[i][0] for i in picked])
    m = np.concatenate([results[i][1] for i in picked])
    hm_w = ctx.cfg["model"]["heatmap_size"][0]
    numbers, diag = compare.pose_check(p, m, rp, rm, s, hm_w)
    print(f"diag {diag}", file=sys.stderr)
    return numbers, diag
