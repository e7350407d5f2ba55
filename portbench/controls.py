"""The controls of ``correct``: the numbers a run compares, read with the
reference put in the program's place, computed in the precision below the
configuration's (float8 for its bfloat16 layers), and with the faults a
cell can have planted in it; and the program's own readings over many
seeds in one process. A limit stands between the program's readings and
these. The benchmark's own runs never run this.

    python -m portbench.controls --workload <name> --seeds 1,2,3 \
        [--arms control,program,half_batch,quarter_batch] [--seconds s]

prints one JSON line a seed and arm, at the cell's own sizes, on the card.
Arms: ``control`` (float8), ``bf16`` (the reference in the configuration's
own precision, a witness), ``program`` (the cell's driver, its window
``--seconds`` long, judged as a run judges it); for inference and serving
the program with a share of each batch's answers left out
(``half_batch``, ``quarter_batch``: the last rows of every batch the
timed path computes carry the first rows' answers); for training the
reference with a fault (``half_batch``: the loss of the first half of the
rows only; ``noop``: parameters never updated).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import compare, inputs, run as harness, weights
from portbench.reference import pipeline as ref_pipe


def infer_control(ctx, quant):
    from portbench.drivers import infer
    batches = infer.make_inputs(ctx, ctx.device)
    which = list(range(len(batches)))
    ref = infer.reference_outputs(ctx, batches, which, ctx.device)
    low = infer.reference_outputs(ctx, batches, which, ctx.device, quant)
    numbers, diag = infer.numbers_of(ctx, batches,
                                     [(b, low[b]) for b in which], ref)
    return _recorded(quant, numbers, diag)


def serve_control(ctx, quant):
    from portbench.drivers import serve_open
    tr = ctx.traffic
    w, h = ctx.cfg["model"]["image_size"]
    crops = inputs.pinned_uint8(ctx.seed, 0, (tr["pool"], h, w, 3),
                                ctx.device).numpy()
    sched = serve_open.Schedule(ctx, 4, ctx.seconds, tr["pool"])
    picked = serve_open.pick(ctx, sched, np.arange(len(sched)))
    sd = weights.make_state_dict(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                 ctx.seed, ctx.device)
    out = {}
    for q in (None, quant):
        model = weights.reference_model(ctx.cfg["model"],
                                        ref_pipe.COCO_SKELETON, sd,
                                        ctx.device, quant=q).eval()
        out[q] = serve_open.reference_requests(ctx, model, sched, crops,
                                               picked, ctx.device)
    (rp, rm, s), (p, m, _) = out[None], out[quant]
    hm_w = ctx.cfg["model"]["heatmap_size"][0]
    return _recorded(quant, *compare.pose_check(p, m, rp, rm, s, hm_w))


def _recorded(arm, numbers, diag):
    """The compared numbers and, beside them, the peak values' median gap
    (not compared: ``compare.pose_numbers``)."""
    print(f"diag {arm} {diag}", file=sys.stderr)
    return dict(numbers, maxval_gap_pct=diag["maxval_gap_pct"])


def train_control(ctx, arm):
    from portbench.drivers import train, train_dp
    raws = (train_dp.global_rows(ctx, ctx.traffic["world"])
            if ctx.traffic["driver"] == "train_dp"
            else train.make_inputs(ctx, ctx.device))
    ref = train.reference_train(ctx, raws, ctx.device)
    if arm in ("control", "bf16"):
        got = train.reference_train(ctx, raws, ctx.device,
                                    quant="fp8" if arm == "control" else arm)
    else:
        got = train.reference_train(ctx, raws, ctx.device, fault=arm)
    return compare.train_numbers(got, ref)


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def real_rows(centers, scales):
    """Rows of a batch before the serving engine's padding, which repeats
    row 0's box at the end."""
    c, s = _host(centers), _host(scales)
    n = len(c)
    while n > 1 and (c[n - 1] == c[0]).all() and (s[n - 1] == s[0]).all():
        n -= 1
    return n


def partial_batch(share):
    """A fault in the program: of the ``n`` real rows of every batch its
    timed path computes, the last ``int(n * share)`` carry the first
    ones' answers (the work of the rest of the batch left out)."""
    def wrap(fn):
        def call(images, centers, scales):
            preds, maxvals = fn(images, centers, scales)
            n = real_rows(centers, scales)
            k = int(n * share)
            if k:
                preds, maxvals = preds.clone(), maxvals.clone()
                preds[n - k:n], maxvals[n - k:n] = preds[:k], maxvals[:k]
            return preds, maxvals
        return call
    return wrap


PROGRAM_FAULTS = {"half_batch": partial_batch(0.5),
                  "quarter_batch": partial_batch(0.25)}


def program_numbers(ctx, arm):
    """The cell's driver run once (with ``arm``'s fault planted in the
    program, for inference and serving) and its compared numbers."""
    import importlib
    driver = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")
    if arm != "program":
        ctx.hooks["wrap"] = PROGRAM_FAULTS[arm]
    res = driver.run(ctx)
    return (_recorded(arm, res["numbers"], res["diag"]) if "diag" in res
            else res["numbers"])


def read(ctx, arm):
    """The compared numbers of ``arm`` (see the module's doc)."""
    kind = ctx.traffic["driver"]
    quant = "fp8" if arm == "control" else arm
    if arm == "program" or (kind in ("infer", "serve_open")
                            and arm in PROGRAM_FAULTS):
        return program_numbers(ctx, arm)
    if kind == "infer":
        return infer_control(ctx, quant)
    if kind == "serve_open":
        return serve_control(ctx, quant)
    return train_control(ctx, arm)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--arms", default="control")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    manifest, cell, cfg, traffic, limits = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for arm in args.arms.split(","):
            ctx = harness.Context(args.workload, cell, cfg, traffic, limits,
                                  seed, args.seconds, False)
            numbers = read(ctx, arm)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "arm": arm, "numbers": numbers}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
