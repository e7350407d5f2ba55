"""Offline pose inference: batches of person boxes on raw canvases through
the program's e2e function (``core/inference.py::make_e2e_fn``: the crop
on the card, the model with flip-test, DARK, keypoints mapped back), with
a fixed number of calls in flight.

Traffic keys: ``batch`` boxes a call, ``canvas`` side of the square uint8
canvases, ``boxes_per_canvas``, ``distinct`` batches held in pinned host
memory and copied per call, ``in_flight`` calls, ``warm_calls``,
``trace_calls`` (the traced stretch), ``check_calls`` (sampled for the
reference). End-to-end: ``infer_images_per_s``, the boxes of every call
completed in the window (outputs on the host) over the window.
"""
from __future__ import annotations

import collections
import gc
import sys
import time

import numpy as np
import torch

from portbench import compare, inputs, program, weights
from portbench.reference import pipeline as ref_pipe
from portbench.trace import trace_stretch


def make_inputs(ctx, device):
    tr, seed = ctx.traffic, ctx.seed
    b, s, d = tr["batch"], tr["canvas"], tr["distinct"]
    per = tr["boxes_per_canvas"]
    r = inputs.rng(seed, 1)
    batches = []
    for i in range(d):
        canv = inputs.pinned_uint8(seed, i, (b // per, s, s, 3), device)
        # boxes_per_canvas boxes share a canvas: rows repeat it
        idx = np.repeat(np.arange(b // per), per)
        images = canv[torch.as_tensor(idx)]
        if torch.device(device).type == "cuda":
            images = images.pin_memory()
        c, sc = inputs.boxes(r, b, lo=s * 0.3125, hi=s * 0.6875)
        batches.append((images, c, sc))
    return batches


def run(ctx):
    from rsgnet_tpu_torch.core.inference import configure_cudnn, make_e2e_fn
    dev = ctx.device
    cfg = program.config(ctx.cfg)
    configure_cudnn(cfg)
    tr = ctx.traffic
    batches = make_inputs(ctx, dev)
    skeleton = ref_pipe.COCO_SKELETON
    sd = weights.make_state_dict(ctx.cfg["model"], skeleton, ctx.seed, dev)
    fn = make_e2e_fn(cfg, program.model(cfg, sd, dev),
                     (tr["canvas"], tr["canvas"]), device=dev)
    del sd
    fn = ctx.hooks.get("wrap", lambda f: f)(fn)
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" \
        else (lambda: None)
    results = {}

    def drive(first, stop):
        """Calls ``first, first + 1, ...`` with ``in_flight`` in flight
        until ``stop(calls made)``; every output back on the host."""
        pending, i = collections.deque(), first
        while not stop(i - first):
            imgs, c, s = batches[i % len(batches)]
            pending.append((i, fn(imgs, c, s)))
            i += 1
            if len(pending) >= tr["in_flight"]:
                j, (p, m) = pending.popleft()
                results[j] = (p.cpu().numpy(), m.cpu().numpy())
        while pending:
            j, (p, m) = pending.popleft()
            results[j] = (p.cpu().numpy(), m.cpu().numpy())
        return i - first

    drive(-tr["warm_calls"], lambda n: n >= tr["warm_calls"])
    sync()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    calls = drive(0, lambda n: time.perf_counter() - t_start >= ctx.seconds)
    window = time.perf_counter() - t_start
    rate = calls * tr["batch"] / window
    trace, launched = None, None
    if ctx.trace:
        from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
        before = dark_decode.launches
        trace = trace_stretch(torch, lambda: drive(
            10 ** 6, lambda n: n >= tr["trace_calls"]))
        launched = dark_decode.launches - before
    peak = (torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else 0)
    del fn
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    numbers, diag = check(ctx, batches, results, calls, dev)
    print(f"diag {diag}", file=sys.stderr)
    return {"setup_s": setup_s, "e2e": {"infer_images_per_s": rate},
            "attempted": calls * tr["batch"], "failed": 0,
            "numbers": numbers, "diag": diag, "memory_peak_bytes": peak,
            "trace": trace,
            "facts": {"images_per_s": rate, "flip_test":
                      ctx.cfg["pipeline"]["flip_test"],
                      "dark_shape": (tr["batch"], ctx.cfg["model"]
                                     ["num_joints"], *ctx.cfg["model"]
                                     ["heatmap_size"][::-1]),
                      "blur_kernel": ctx.cfg["pipeline"]["blur_kernel"],
                      "cfg": ctx.cfg, "batch": tr["batch"],
                      "kernel_launches": launched}}


def reference_predict(ctx, model, images, centers, scales, dev):
    pipe = ctx.cfg["pipeline"]
    w, h = ctx.cfg["model"]["image_size"]
    c = torch.as_tensor(centers, dtype=torch.float64, device=dev)
    s = torch.as_tensor(scales, dtype=torch.float64, device=dev)
    crops = []
    for i in range(0, len(images), 16):
        x = ref_pipe.bilinear_crop(images[i:i + 16].to(dev), c[i:i + 16],
                                   s[i:i + 16], (w, h))
        crops.append(ref_pipe.normalize(x))
    p, m = ref_pipe.predict(model, torch.cat(crops), c, s, pipe)
    return p.cpu().numpy(), m.cpu().numpy()


def reference_outputs(ctx, batches, which, dev, quant=None):
    """{batch index: (preds, maxvals)} of the reference (or, with
    ``quant``, of the control) on the batches ``which``."""
    sd = weights.make_state_dict(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                 ctx.seed, dev)
    model = weights.reference_model(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                    sd, dev, quant=quant).eval()
    return {b: reference_predict(ctx, model, *batches[b], dev)
            for b in sorted(set(which))}


def numbers_of(ctx, batches, got, ref):
    """``compare.pose_check`` over [(batch index, (preds, maxvals))]
    against ``ref``: the compared numbers and the record's quantiles."""
    hm_w = ctx.cfg["model"]["heatmap_size"][0]
    cat = np.concatenate
    p = cat([o[0] for _, o in got])
    m = cat([o[1] for _, o in got])
    rp = cat([ref[b][0] for b, _ in got])
    rm = cat([ref[b][1] for b, _ in got])
    sc = cat([batches[b][2] for b, _ in got])
    return compare.pose_check(p, m, rp, rm, sc, hm_w)


def check(ctx, batches, results, calls, dev):
    """The outputs of ``check_calls`` window calls, drawn from the seed,
    against the reference's on the same canvases and boxes."""
    r = inputs.rng(ctx.seed, 2)
    k = min(ctx.traffic["check_calls"], calls)
    picked = sorted(r.choice(calls, size=k, replace=False).tolist())
    which = [j % len(batches) for j in picked]
    ref = reference_outputs(ctx, batches, which, dev)
    return numbers_of(ctx, batches,
                      [(b, results[j]) for j, b in zip(picked, which)], ref)
