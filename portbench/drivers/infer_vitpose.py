"""Offline pose inference on ViTPose (``MODEL.NAME: pose_vit``): the
traffic and the semantics of ``drivers/infer.py`` (batches of person
boxes on raw canvases through the program's ``make_e2e_fn``, a fixed
number of calls in flight, ``infer_images_per_s`` over the window, 8
sampled calls checked against the plain reference), with this model's
own door into the program and its own reference
(``portbench/reference/vitpose.py``).

The door: ``config`` loads the program's config from the configuration
file's ``program`` and checks it against the file's ``model``; ``model``
builds ``get_pose_net`` and loads the reference-named weights under the
program's names through the program's own map of released ViTPose
checkpoints (``utils/torch_convert.py::convert_state_dict``), strictly.

The compared numbers: ``compare.pose_numbers`` (``kpt_gap_q25_px``,
``boxes_off_pct``) and ``maxval_gap_pct``, the median relative gap of the
heatmap peaks (``compare.pose_diag``). The keypoints alone do not fail a
coarser precision here: on the heatmaps of random-weight ViTPose (a
16x12 grid upsampled by two deconvs) a quarter or more of a call's
keypoints often keep the very coordinates of the reference's (DARK
leaves them on their integer argmax; the map's edge holds only 1.5-10%
of the argmaxes), so the float8 control's ``kpt_gap_q25_px`` reads 0.0
on five seeds of eight and its ``boxes_off_pct`` under 0.2%, while its
peaks move 8-13 times as far as the program's (``PERF.md`` §4).

The readings the limits are set from (as ``portbench/controls.py`` reads
them for the HRNet cells), on the card at the cell's size:

    python -m portbench.drivers.infer_vitpose --workload <cell> \\
        --seeds 1,2,3 [--arms control,bf16,program,half_batch] \\
        [--seconds s]

prints one JSON line a seed and arm: ``control`` (the reference with its
compute-dtype layers in float8), ``bf16`` (in bfloat16, a witness),
``program`` (this driver, judged as a run judges it) and the planted
faults ``half_batch``, ``quarter_batch`` (``controls.PROGRAM_FAULTS``).
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
import time

import torch

from portbench import controls, inputs
from portbench import run as harness
from portbench.drivers import infer
from portbench.reference import vitpose as ref_vit
from portbench.trace import trace_stretch


def topology(cfg):
    """The reference's ``model`` dict that the program's Config states."""
    v, e = cfg.MODEL.VIT, cfg.MODEL.EXTRA
    n = e.NUM_DECONV_LAYERS
    return {"num_joints": cfg.MODEL.NUM_JOINTS,
            "image_size": list(cfg.MODEL.IMAGE_SIZE),
            "heatmap_size": list(cfg.MODEL.HEATMAP_SIZE),
            "embed_dim": v.EMBED_DIM, "depth": v.DEPTH,
            "num_heads": v.NUM_HEADS, "mlp_ratio": v.MLP_RATIO,
            "patch_size": v.PATCH_SIZE, "patch_padding": v.PATCH_PADDING,
            "qkv_bias": v.QKV_BIAS, "ln_eps": v.LN_EPS,
            "deconv_filters": list(e.NUM_DECONV_FILTERS[:n]),
            "deconv_kernels": list(e.NUM_DECONV_KERNELS[:n]),
            "deconv_bias": e.DECONV_WITH_BIAS,
            "final_conv_kernel": e.FINAL_CONV_KERNEL}


def config(cfg_file):
    """The program's Config from the file's ``program`` section, checked
    against the topology the file states for the reference."""
    from rsgnet_tpu_torch.config.defaults import load_config
    cfg = load_config(None, cfg_file["program"])
    got = topology(cfg)
    if (cfg.MODEL.NAME != "pose_vit" or got != cfg_file["model"]
            or cfg.DTYPE != cfg_file["dtype"]):
        raise ValueError(f"the program's configuration differs from the "
                         f"file's: {cfg.MODEL.NAME} {got} dtype {cfg.DTYPE}")
    return cfg


def model(cfg, ref_sd, device):
    """``get_pose_net(cfg)`` on ``device`` holding the benchmark's weights
    (every tensor of its state dict, strictly)."""
    from rsgnet_tpu_torch.models import get_pose_net
    from rsgnet_tpu_torch.utils.torch_convert import convert_state_dict
    with torch.device(device):
        net = get_pose_net(cfg)
    net = net.to(device)
    net.load_state_dict(convert_state_dict(cfg, ref_sd), strict=True)
    return net


def run(ctx):
    from rsgnet_tpu_torch.core.inference import configure_cudnn, make_e2e_fn
    dev = ctx.device
    cfg = config(ctx.cfg)
    configure_cudnn(cfg)
    tr = ctx.traffic
    batches = infer.make_inputs(ctx, dev)
    sd = ref_vit.make_state_dict(ctx.cfg["model"], ctx.seed, dev)
    fn = make_e2e_fn(cfg, model(cfg, sd, dev), (tr["canvas"], tr["canvas"]),
                     device=dev)
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


def reference_outputs(ctx, batches, which, dev, quant=None):
    """{batch index: (preds, maxvals)} of the reference (or, with
    ``quant``, of the control) on the batches ``which``."""
    sd = ref_vit.make_state_dict(ctx.cfg["model"], ctx.seed, dev)
    net = ref_vit.reference_model(ctx.cfg["model"], sd, dev, quant=quant)
    del sd
    with torch.no_grad():
        return {b: infer.reference_predict(ctx, net, *batches[b], dev)
                for b in sorted(set(which))}


def numbers_of(ctx, batches, got, ref):
    """``infer.numbers_of`` with the peaks' median gap compared too (the
    module's doc): (compared numbers, the record's quantiles)."""
    numbers, diag = infer.numbers_of(ctx, batches, got, ref)
    return dict(numbers, maxval_gap_pct=diag["maxval_gap_pct"]), diag


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


def read(ctx, arm):
    """The compared numbers of ``arm`` (the module's doc)."""
    if arm == "program" or arm in controls.PROGRAM_FAULTS:
        return controls.program_numbers(ctx, arm)
    batches = infer.make_inputs(ctx, ctx.device)
    which = list(range(len(batches)))
    ref = reference_outputs(ctx, batches, which, ctx.device)
    low = reference_outputs(ctx, batches, which, ctx.device,
                            "fp8" if arm == "control" else arm)
    return controls._recorded(arm, *numbers_of(
        ctx, batches, [(b, low[b]) for b in which], ref))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--arms", default="control")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    _, cell, cfg, traffic, limits = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("infer_vitpose: no CUDA card", file=sys.stderr)
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
