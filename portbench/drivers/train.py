"""Training: the program's train step (``core/train.py::make_train_step``:
augmentation with the shear warp on the card, forward, loss, backward,
Adam, the accuracy meter) on raw canvases copied from pinned host memory,
with fresh augmentation draws every step.

Set-up builds one train state from the seed's weights and drives it
through the first ``check_steps`` steps, on batches that all differ, with
the window's own call and feed; the losses, the first gradients (from
Adam's first moment after step 1) and the parameters' change over those
steps are kept for the check, and the same state goes on into the window.

Traffic keys: ``batch``, ``canvas``, ``distinct`` batches, ``check_steps``,
``warm_steps``, ``trace_steps``. End-to-end: ``train_images_per_s``, the
images of every step completed in the window over the window.

Dormant: no cell of ``BENCHMARK.json`` plays this driver yet (PERF.md,
open questions, says what the training cell still needs); the CPU tests
run it at a tiny size.
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


def make_inputs(ctx, device):
    """[(pinned canvases, joints, visibility, centers, scales)]."""
    tr, seed = ctx.traffic, ctx.seed
    b, s, k = tr["batch"], tr["canvas"], ctx.cfg["model"]["num_joints"]
    r = inputs.rng(seed, 3)
    out = []
    for i in range(tr["distinct"]):
        images = inputs.pinned_uint8(seed, 100 + i, (b, s, s, 3), device)
        j, v = inputs.joints(r, b, k)
        c, sc = inputs.boxes(r, b)
        out.append((images, j, v, c, sc))
    return out


def batch_of(raw, device):
    images, j, v, c, s = raw
    return {"image": images.to(device, non_blocking=True),
            "joints": torch.from_numpy(j), "joints_vis": torch.from_numpy(v),
            "center": torch.from_numpy(c), "scale": torch.from_numpy(s)}


def leaf_names(cfg, ref_model):
    """[(reference name, program name)] of every parameter, in the
    reference's order."""
    names = [n for n, _ in ref_model.named_parameters()]
    sd = {n: torch.tensor(i) for i, n in enumerate(names)}
    sd.update({n: torch.tensor(-1) for n in ref_model.state_dict()
               if n not in sd})
    mapped = program.state_dict(cfg, sd)
    back = {int(t): p for p, t in mapped.items() if int(t) >= 0}
    return [(n, back[i]) for i, n in enumerate(names)]


def run(ctx):
    from rsgnet_tpu_torch.core.inference import configure_cudnn
    from rsgnet_tpu_torch.core.train import create_train_state, make_train_step
    from rsgnet_tpu_torch.data.skeletons import get_spec
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = program.config(ctx.cfg)
    configure_cudnn(cfg)
    tr = ctx.traffic
    n, ncheck = tr["batch"], tr["check_steps"]
    raws = make_inputs(ctx, dev)
    skeleton = ref_pipe.COCO_SKELETON
    sd = weights.make_state_dict(ctx.cfg["model"], skeleton, ctx.seed, dev)
    with torch.device("meta"):
        shape_ref = ref_pipe_model(ctx)
    names = leaf_names(cfg, shape_ref)
    state = create_train_state(cfg, program.model(cfg, sd, dev), device=dev)
    del sd
    params = dict(state.model.named_parameters())
    leaves = [params[p] for _, p in names]
    start = [p.detach().clone() for p in leaves]
    step = ctx.hooks.get("wrap_step", lambda f: f)(
        make_train_step(cfg, get_spec("coco")))

    def one(i):
        nonlocal state
        state, metrics = step(state, batch_of(raws[i % len(raws)], dev),
                              inputs.draws(ctx.seed, i, n))
        return metrics

    losses = []
    for i in range(ncheck):
        losses.append(one(i)["loss"].detach().float().reshape(()))
        if i == 0:
            b1 = state.optimizer.defaults["betas"][0]
            opt_state = state.optimizer.state
            grad1 = compare.leaf_norms(
                [opt_state[p]["exp_avg"] / (1 - b1) if p in opt_state
                 else torch.zeros_like(p) for p in leaves])
    update = compare.leaf_norms([p - q for p, q in zip(leaves, start)])
    prog = {"losses": torch.stack(losses).cpu().numpy(), "grad1": grad1,
            "update3": update}
    del start
    for i in range(ncheck, ncheck + tr["warm_steps"]):
        one(i)
    sync()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    i = ncheck + tr["warm_steps"]
    steps = 0
    while time.perf_counter() - t_start < ctx.seconds:
        one(i)
        i += 1
        steps += 1
    sync()
    window = time.perf_counter() - t_start
    rate = steps * n / window
    trace, traced = None, list(range(10 ** 6, 10 ** 6 + tr["trace_steps"]))
    launched = None
    if ctx.trace:
        from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp

        def stretch():
            for t in traced:
                one(t)
            return len(traced)
        before = shear_warp.launches
        trace = trace_stretch(torch, stretch)
        launched = shear_warp.launches - before
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state, step, params, leaves
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_train(ctx, raws, dev)
    numbers = compare.train_numbers(prog, ref)
    print(f"diag losses {prog['losses'].tolist()} ref {ref['losses']}",
          file=sys.stderr)
    facts = {"images_per_s": rate, "cfg": ctx.cfg, "batch": n, "train": True,
             "kernel_launches": launched}
    if ctx.trace:
        facts["shear"] = [shear_geometry(ctx, raws[t % len(raws)], t)
                          for t in traced]
    return {"setup_s": setup_s, "e2e": {"train_images_per_s": rate},
            "attempted": steps * n, "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak, "trace": trace, "facts": facts}


def ref_pipe_model(ctx, quant=None, checkpoint=False):
    from portbench.reference.model import PoseRSGNet
    return PoseRSGNet(ctx.cfg["model"], ref_pipe.COCO_SKELETON, quant,
                      checkpoint)


def shear_geometry(ctx, raw, step):
    """(canvas side, matrices (N, 2, 3), out size) of one step, from the
    reference's augmentation geometry: what the shear warp's bytes are
    counted on."""
    images, j, v, c, s = raw
    aug = ctx.cfg["train"]["augment"]
    size = ctx.cfg["model"]["image_size"]
    t, _, _ = ref_pipe.augment_geometry(
        inputs.draws(ctx.seed, step, len(j)), torch.from_numpy(j),
        torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(s),
        float(images.shape[2]), aug, size)
    return images.shape[1], t, tuple(size)


def reference_step_inputs(ctx, raw, step, dev):
    """The reference's augmented inputs, targets and weights of one step."""
    images, j, v, c, s = raw
    tcfg, mcfg = ctx.cfg["train"], ctx.cfg["model"]
    t, warped, vis = ref_pipe.augment_geometry(
        inputs.draws(ctx.seed, step, len(j)), torch.from_numpy(j),
        torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(s),
        float(images.shape[2]), tcfg["augment"], mcfg["image_size"])
    x = ref_pipe.normalize(ref_pipe.shear_warp(images.to(dev), t.to(dev),
                                               mcfg["image_size"]))
    target, weight = ref_pipe.gaussian_targets(
        warped.to(dev), vis.to(dev), mcfg["heatmap_size"],
        mcfg["image_size"], tcfg["sigma"])
    if not tcfg.get("use_target_weight", True):
        weight = torch.ones_like(weight)
    return x, target, weight


def reference_train(ctx, raws, dev, quant=None, fault=None):
    """The reference's first ``check_steps`` steps from the seed's
    weights: losses, first-step gradient norms and the parameters' change,
    one norm a leaf in the reference's parameter order. ``quant`` gives
    the control; ``fault`` plants one of the faults a train step can have
    ("half_batch": the loss of the first half of the rows only;
    "noop": parameters never updated)."""
    sd = weights.make_state_dict(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                 ctx.seed, dev)
    model = weights.reference_model(ctx.cfg["model"], ref_pipe.COCO_SKELETON,
                                    sd, dev, quant=quant,
                                    checkpoint=True).train()
    del sd
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = ref_pipe.Adam(params, lr=ctx.cfg["train"]["lr"])
    losses, grad1 = [], None
    for i in range(ctx.traffic["check_steps"]):
        x, target, weight = reference_step_inputs(ctx, raws[i % len(raws)],
                                                  i, dev)
        if fault == "half_batch":
            h = x.shape[0] // 2
            x, target, weight = x[:h], target[:h], weight[:h]
        final, initial = model(x)
        loss = (ref_pipe.joints_mse(final, target, weight)
                + 0.5 * ref_pipe.joints_mse(initial, target, weight))
        for p in params:
            p.grad = None
        loss.backward()
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = compare.leaf_norms([p.grad for p in params])
        if fault != "noop":
            opt.step()
    update = compare.leaf_norms([p - q for p, q in zip(params, start)])
    return {"losses": np.asarray(losses), "grad1": grad1, "update3": update}
