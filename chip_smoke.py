#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises and the script exits nonzero):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the hand-written CUDA DARK kernel (built from ``rsgnet_tpu_torch/csrc``
   on first use; ptxas registers and spills, shared memory and maps per SM
   of the blur-11 instantiations) against its plain PyTorch version on
   synthetic peaks at the serving shape (64, 17, 96, 72), blur 11 and 3,
   plus edge cases (zero map, border peak, tie, N*K no block multiple) and
   the ten hard cases of ``tests/_torch_port_common.py::HARD_DARK`` (blur
   1/5/31, maps smaller than the blur, a plateau tie over rows, peaks on
   the Newton border, an all-negative map, a blurred max off the raw peak,
   64x64, N*K = 21), a 16-byte-misaligned batch and an odd width (the
   kernel's 4-byte path): peaks identical, maxvals and coords bit-equal;
3. a small-input reference: the tiny float32 RSGNet through the inference
   function on the card and on the CPU, same weights: preds atol 1e-2 px,
   maxvals atol 1e-4;
4. serving, the main path: ``rsgnet_tpu_torch.serve`` builds RSGNet-W48 @
   384x288 with DARK decode from ``experiments/coco/rsgnet/w48_384x288.yaml``
   at full width in bf16 with a seeded init, warms buckets 1/8/32/64 and
   serves HTTP on 127.0.0.1; concurrent /v1/predict and /v1/predict_image
   requests must come back finite and of the right shape, and the kernel's
   launch count must equal the engine's batch count for that window; the
   kernel's peaks and maxvals on one served batch's heatmaps must equal the
   plain version's;
5. timings with CUDA events: the kernel and its plain version at buckets
   1, 8, 32 and 64 (L2 flushed before each launch), each beside its bound,
   the share of the bound it reaches and the time of a plain read of the
   same maps (``amax``), with the timer's floor (an op on one float); one
   inference call at bucket
   32, the request latencies of phase 4, and a torch.profiler breakdown
   (device busy share, device time by kernel class) of one inference call
   at buckets 32 and 1; the bucket-32 call's kernel count must not exceed
   the 5,205 the serving path had before the train slice;
6. the hand-written CUDA shear-warp kernel against its plain PyTorch
   version at the train shape (32, 640, 640, 3) uint8 -> 256x192, on
   matrices from the port's own augmentation draws, plus fixed rotations
   0/+-30/+-90/179, a flip and the transposed frame, a float32 source, an
   odd size, and the five hard matrices of
   ``tests/_torch_port_common.py::HARD_WARPS`` (4x zoom-out at 45 degrees,
   0.05x zoom-in, a crop off a corner, a crop wholly outside the source,
   -135 degrees flipped) on uint8 and float32 sources: every case
   bit-equal, and max |diff| <= 1e-3 on the 0-255 scale;
7. a small-input reference for training: one tiny fp32 train step (SGD)
   on the card and on the CPU, same weights and draws: loss rtol 1e-4,
   each gradient tensor within 5e-2 of its max (3e-3 on average), updated
   params within lr times that;
8. training, the main path of the train slice: RSGNet-W32 @ 256x192 from
   ``experiments/coco/rsgnet/w32_256x192.yaml`` at full width and depth,
   bf16, Adam, seeded init, ``train_one_epoch`` over 8 steps of one
   repeated synthetic raw batch of 32 (640x640 uint8 canvases, boxes, 17
   joints): finite loss at every step, the loss falls, the shear-warp
   kernel ran once per step and the DARK kernel never;
9. timings of the train slice: the shear-warp kernel, its plain version
   and ``F.grid_sample`` (the gather warp, the nearest library call) at
   the train shape, L2 flushed, beside the kernel's bound; the wall time of
   a train step at batch 32; a torch.profiler breakdown of one step;
10. a ``{"kernels": [...]}`` JSON line, the card line, and last the
   ``{"ok": true, "device": {...}}`` line.

Without a CUDA card, or outside a checkout, it exits nonzero and prints no
result.
"""
import copy
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W48_YAML = os.path.join(ROOT, "experiments", "coco", "rsgnet",
                        "w48_384x288.yaml")
W32_YAML = os.path.join(ROOT, "experiments", "coco", "rsgnet",
                        "w32_256x192.yaml")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BUCKETS = "1,8,32,64"
SERVE_KERNELS_BEFORE = 5205      # bucket-32 inference call, before this slice
TRAIN_STEPS = 8
CANVAS = 640                     # square uint8 source canvas of the train set


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def synthetic_heatmaps(n, k, h, w, seed, sigma=3.0):
    """(N, K, H, W) Gaussian peaks at random sub-pixel spots + noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = rng.uniform(2, w - 3, (n, k, 1, 1)).astype(np.float32)
    cy = rng.uniform(2, h - 3, (n, k, 1, 1)).astype(np.float32)
    hm = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
    hm += rng.uniform(0, 0.01, hm.shape)
    return hm.astype(np.float32)


def kernel_vs_plain(torch, dark_decode, reference, hm, blur):
    """Kernel vs plain version on the card: peaks, maxvals and coords
    bit-equal. Returns the max coord diff (0)."""
    c_k, v_k, p_k = dark_decode(hm, blur, return_peaks=True)
    c_p, v_p = reference(hm, blur)
    p_p = torch.argmax(hm.reshape(hm.shape[0], hm.shape[1], -1), dim=2)
    torch.cuda.synchronize()
    if not torch.equal(p_k.long(), p_p):
        raise AssertionError(f"kernel peaks differ from the plain version's "
                             f"in {int((p_k.long() != p_p).sum())} maps")
    if not torch.equal(v_k, v_p):
        raise AssertionError("kernel maxvals are not bit-equal to the plain "
                             "version's")
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"kernel coords are not bit-equal to the plain "
                             f"version's: max |diff| "
                             f"{float((c_k - c_p).abs().max()):.3e}")
    return float((c_k - c_p).abs().max())


def time_cold(torch, fn, reps=20):
    """Mean ms of ``fn()`` over ``reps`` launches, each after the 50 MB L2
    is flushed by writing 256 MB (events bracket ``fn`` alone). A ~1 ms
    spin on the card after the flush keeps the stream busy while the host
    enqueues ``fn``, so the wrapper's host time does not count as device
    time unless ``fn`` itself leaves the card waiting."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.mean(times))


def dark_bound_ms(n, k, h, w, blur):
    """Least time for the DARK decode of (n, k, h, w) maps on an H100: each
    heatmap read once, coords and maxvals written once, against the blur's
    fp32 multiply-adds (2 passes x blur taps x 2 ops per pixel)."""
    nbytes = n * k * h * w * 4 + n * k * 3 * 4
    flops = n * k * h * w * 2 * blur * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def forward_flops(torch, model, x):
    """FLOPs (2 per multiply-add) of the convs and linears in one forward
    of ``x``, counted from their weight and output shapes."""
    total = [0]

    def hook(mod, _, out):
        per_out = mod.weight[0].numel()          # Cin/groups * kh * kw, or in
        total[0] += 2 * out.numel() * per_out

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]


def _kernel_class(name):
    n = name.lower()
    if "dark_decode" in n:
        return "dark_decode"
    if "shear_warp" in n:
        return "shear_warp"
    if "multi_tensor" in n:
        return "optimizer"
    if "reduce" in n:
        return "reduction"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout"
    if any(s in n for s in ("bn_fw", "batch_norm", "batchnorm")):
        return "batch_norm"
    if any(s in n for s in ("copy_kernel", "direct_copy")):
        return "dtype cast/copy"
    if any(s in n for s in ("conv", "xmma", "gemm", "cudnn", "cutlass",
                            "sm90", "implicit")):
        return "conv/gemm"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def profile_device(torch, fn, card, flops, label):
    """Device-time breakdown of one call of ``fn()`` with torch.profiler
    (after one warm call): device busy share of the call's wall time (union
    of kernel intervals), device time by kernel class, the rate the
    conv/gemm kernels reach on ``flops``, and the top kernels by name.
    Returns the number of kernels the call launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"[{card}] profile: no device events (device time not measured)")
        return 0
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_class, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        c = _kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + d
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + d, n + 1)
    total = sum(by_class.values())
    log(f"[{card}] profile of {label}: wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} kernels, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of wall), kernel time "
        f"{total / 1e3:.2f} ms: " + ", ".join(
            f"{c} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)"
            for c, v in sorted(by_class.items(), key=lambda x: -x[1])))
    if by_class.get("conv/gemm"):
        log(f"[{card}]   conv/gemm kernels: {flops / 1e12:.3f} TFLOP in "
            f"{by_class['conv/gemm'] / 1e3:.2f} ms = "
            f"{flops / by_class['conv/gemm'] / 1e6:.1f} TFLOP/s")
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        log(f"[{card}]   {t / 1e3:8.3f} ms  x{n:<4d} {name[:110]}")
    return len(kernels)


def shear_matrices(torch, n, size, cfg, seed):
    """(n + 8, 2, 3) src->dst matrices: the port's augmentation geometry on
    a seeded raw batch of n, then rotations 0/+-30/+-90/179 about the
    canvas center and two flip-composed ones (30 and 90 degrees)."""
    from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
    b = synthetic_train_batch(n, size, seed=seed)
    trans = augment_geometry(
        draw_augment(torch.Generator().manual_seed(seed), n),
        torch.from_numpy(b["joints"]), torch.from_numpy(b["joints_vis"]),
        torch.from_numpy(b["center"]), torch.from_numpy(b["scale"]),
        float(size), cfg, get_spec("coco"))[0]
    rots = torch.tensor([0.0, 30.0, -30.0, 90.0, -90.0, 179.0])
    fixed = get_affine_transform_t(
        torch.full((6, 2), size / 2.0), torch.full((6, 2), size / 300.0),
        rots, tuple(cfg.MODEL.IMAGE_SIZE))
    f = fixed[[1, 3]]
    flipped = torch.stack([-f[:, :, 0], f[:, :, 1],
                           f[:, :, 0] * (size - 1) + f[:, :, 2]], dim=-1)
    return torch.cat([trans, fixed, flipped])


def shear_vs_plain(torch, shear_warp, images, pos):
    """Kernel vs plain shear warp on the card: (max |diff|, bit-equal)."""
    from rsgnet_tpu_torch.ops.shear_warp import shear_warp_reference
    got = shear_warp(images, pos)
    ref = shear_warp_reference(images, pos)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"shear warp output {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite")
    return float((got - ref).abs().max()), bool(torch.equal(got, ref))


def shear_bound_ms(torch, images, pos):
    """Least time for the shear warp of ``images`` at ``pos`` on an H100:
    the fp32 output written once plus the source pixels it depends on read
    once (every pixel a nonzero-weight tap of either pass reaches, counted
    on this run's matrices), against ~15 fp32 operations per element of
    each pass. Returns (ms, "bytes" | "operations", bytes)."""
    n, size, _, ch = images.shape
    out_w, out_h = pos.p_a.shape[1], pos.p_b.shape[1]

    def split(p, s):             # (.., a, b) bases and weights per tap
        pf, sf = torch.floor(p), torch.floor(s)
        phi = (p - pf) + (s - sf)
        w0 = torch.clamp_min(1.0 - phi, 0.0)
        w2 = torch.clamp_min(phi - 1.0, 0.0)
        return (pf + sf).long(), (w0, 1.0 - w0 - w2, w2)

    # pass B: rows r(y, x) = base_b + j with weight wb_j
    base_b, wb = split(pos.p_b[:, :, None], pos.s_b[:, None, :])  # (N,oh,ow)
    seen = torch.zeros(n, size * size, dtype=torch.bool, device=images.device)
    bidx = torch.arange(n, device=images.device)[:, None, None].expand(
        n, out_h, out_w)
    for j in range(3):
        r = base_b + j
        ok_b = (wb[j] > 0) & (r >= 0) & (r < size)
        rc = r.clamp(0, size - 1)
        # pass A at row r, column x: cols base_a + i with weight wa_i
        p_a = pos.p_a[:, None, :].expand(n, out_h, out_w)
        s_a = torch.gather(pos.s_a, 1, rc.reshape(n, -1)).reshape(rc.shape)
        base_a, wa = split(p_a, s_a)
        for i in range(3):
            c = base_a + i
            ok = ok_b & (wa[i] > 0) & (c >= 0) & (c < size)
            flat = rc * size + c.clamp(0, size - 1)
            seen[bidx[ok], flat[ok]] = True
    src_bytes = int(seen.sum()) * ch * images.element_size()
    nbytes = src_bytes + n * ch * out_h * out_w * 4
    ops = 15 * (n * size * out_w * ch + n * ch * out_h * out_w)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, src_bytes)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "rsgnet_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "rsgnet_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from rsgnet_tpu_torch import serve
    from rsgnet_tpu_torch.config.defaults import tiny_rsgnet
    from rsgnet_tpu_torch.core.inference import (heatmaps_with_flip_test,
                                                 make_inference_fn)
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.models import get_pose_net, init_weights
    from rsgnet_tpu_torch.ops.cuda import build
    from rsgnet_tpu_torch.ops.cuda.dark_decode import (BLOCK_THREADS,
                                                       dark_decode,
                                                       shared_bytes)
    from rsgnet_tpu_torch.ops.decode import dark_decode_reference
    from rsgnet_tpu_torch.ops.warp import normalize_image
    from rsgnet_tpu_torch.serving.http_server import (predict_image_remote,
                                                      predict_remote)
    from rsgnet_tpu_torch.config.defaults import load_config
    from rsgnet_tpu_torch.core.function import train_one_epoch
    from rsgnet_tpu_torch.core.train import (create_train_state,
                                             make_train_step)
    from rsgnet_tpu_torch.data.augment import draw_augment
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
    from rsgnet_tpu_torch.ops.shear_warp import (shear_prepare,
                                                 shear_warp_reference)
    from rsgnet_tpu_torch.ops.warp import invert_affine
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_port_common import (HARD_DARK, HARD_WARPS,
                                    hard_dark_heatmaps, hard_warp_matrix,
                                    nchw)

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {kind}; count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # -- 2. kernel vs plain version ----------------------------------------
    t0 = time.perf_counter()
    build.load_library("dark_decode")
    log(f"built dark_decode.cu in {time.perf_counter() - t0:.1f} s: "
        f"{build.library_path('dark_decode').name}")
    ptxas = build.library_path("dark_decode").with_name(
        build.library_path("dark_decode").stem[3:] + ".ptxas.txt")
    entry, regs = None, None
    for line in ptxas.read_text().splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif entry and "ILi11E" in entry and any(
                x in line for x in ("registers", "spill", "smem")):
            cols = 4 if "ILi11ELi4E" in entry else 1
            log(f"ptxas, blur 11, {cols} column(s) per thread: "
                f"{line.strip()}")
            if cols == 4 and "registers" in line:
                regs = int(line.split("Used ")[1].split(" registers")[0])
    # maps per SM on an H100: 64 K registers (256 per warp at a time), 228
    # KB of shared memory (1 KB reserved per block), 2,048 threads
    smem = shared_bytes(96, 72, 11)
    warps = BLOCK_THREADS // 32
    by_regs = 65536 // (-(-regs * 32 // 256) * 256) // warps
    by_smem = 228 * 1024 // (smem + 1024)
    log(f"shared memory per map at 96x72, blur 11: {smem} B; maps per SM "
        f"{min(by_regs, by_smem, 2048 // BLOCK_THREADS)} (by registers "
        f"{by_regs}, by shared memory {by_smem}; blocks of "
        f"{BLOCK_THREADS} threads)")
    hm64 = torch.from_numpy(synthetic_heatmaps(64, 17, 96, 72, 0)).to(dev)
    err64 = {}
    for blur in (11, 3):
        err64[blur] = kernel_vs_plain(torch, dark_decode,
                                      dark_decode_reference, hm64, blur)
        log(f"kernel vs plain (64, 17, 96, 72) blur {blur}: peaks equal, "
            f"maxvals bit-equal, max |coord diff| {err64[blur]:.3e}")
    edge = np.zeros((3, 7, 96, 72), np.float32)     # N*K = 21
    edge[0, 1, 1, 1] = 1.0                           # border peak
    edge[1, 2] = -1.0                                # maxval <= 0
    edge[2, 3, 40, 30] = edge[2, 3, 50, 20] = 2.0    # tie
    edge_t = torch.from_numpy(edge).to(dev)
    c, v = dark_decode(edge_t, 11)
    c, v = c.cpu().numpy(), v.cpu().numpy()
    if not (c[0, 0].tolist() == [0.0, 0.0] and v[0, 0, 0] == 0.0
            and c[0, 1].tolist() == [1.0, 1.0]
            and c[1, 2].tolist() == [0.0, 0.0] and v[1, 2, 0] == -1.0
            and abs(c[2, 3, 0] - 30) < 1 and abs(c[2, 3, 1] - 40) < 1):
        raise AssertionError(f"edge cases decode wrong: {c[:, :4]}")
    kernel_vs_plain(torch, dark_decode, dark_decode_reference, edge_t, 11)
    log("edge cases (zero map, border peak, maxval <= 0, tie, N*K=21): ok")
    for name, blur in sorted(HARD_DARK.items()):
        hard = nchw(hard_dark_heatmaps(name)).to(dev)
        kernel_vs_plain(torch, dark_decode, dark_decode_reference, hard, blur)
        log(f"hard case {name} {tuple(hard.shape)} blur {blur}: peaks, "
            f"maxvals and coords bit-equal")
    shifted = torch.empty(hm64.numel() + 1, device=dev)[1:].view(hm64.shape)
    shifted.copy_(hm64)                  # 4-byte aligned: the scalar path
    odd = torch.from_numpy(synthetic_heatmaps(2, 3, 37, 29, 1)).to(dev)
    for label, x, blur in (("misaligned serving batch", shifted, 11),
                           ("odd width 37x29", odd, 7)):
        kernel_vs_plain(torch, dark_decode, dark_decode_reference, x, blur)
        log(f"{label} {tuple(x.shape)} blur {blur}: bit-equal")

    # -- 3. small-input reference: card vs CPU, fp32 tiny model ------------
    tcfg = tiny_rsgnet()
    tcfg.TEST.DECODE = "dark"
    tcfg.TEST.BLUR_KERNEL = 5
    tiny = init_weights(get_pose_net(tcfg), seed=1)
    tiny_cpu = get_pose_net(tcfg)
    tiny_cpu.load_state_dict(tiny.state_dict())
    rng = np.random.RandomState(2)
    req = (rng.randint(0, 256, (4, 96, 64, 3)).astype(np.uint8),
           rng.uniform(50, 300, (4, 2)).astype(np.float32),
           rng.uniform(0.4, 1.5, (4, 2)).astype(np.float32))
    p_gpu, v_gpu = make_inference_fn(tcfg, tiny, True, device="cuda")(*req)
    p_cpu, v_cpu = make_inference_fn(tcfg, tiny_cpu, True, device="cpu")(*req)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=0, atol=1e-2)
    torch.testing.assert_close(v_gpu.cpu(), v_cpu, rtol=0, atol=1e-4)
    log(f"tiny fp32 RSGNet, card vs CPU: max |pred diff| "
        f"{float((p_gpu.cpu() - p_cpu).abs().max()):.3e} px, max |maxval "
        f"diff| {float((v_gpu.cpu() - v_cpu).abs().max()):.3e}")

    # -- 4. serve RSGNet-W48 @ 384x288, DARK, over HTTP --------------------
    args = serve.parse_args(["--cfg", W48_YAML, "--port", "0", "--buckets",
                             BUCKETS, "--seed", "0", "--max-wait-ms", "5",
                             "--in-flight", "2"])
    t0 = time.perf_counter()
    cfg, model = serve.load_model(args)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.MODEL.NAME} W{cfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0]} "
        f"{cfg.MODEL.IMAGE_SIZE[1]}x{cfg.MODEL.IMAGE_SIZE[0]} DTYPE "
        f"{cfg.DTYPE} DECODE {cfg.TEST.DECODE} blur {cfg.TEST.BLUR_KERNEL}: "
        f"{n_params} params, seeded init in {time.perf_counter() - t0:.1f} s")
    if cfg.TEST.DECODE != "dark" or cfg.MODEL.NAME != "pose_rsgnet":
        raise AssertionError("the W48 YAML no longer selects DARK RSGNet")
    t0 = time.perf_counter()
    engine, batcher, server = serve.build_server(args, cfg, model)
    log(f"warmed buckets {engine.buckets} in {time.perf_counter() - t0:.1f}"
        f" s; min s/dispatch {engine.bucket_cost}")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = "http://%s:%d" % server.server_address
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    k = cfg.MODEL.NUM_JOINTS
    rng = np.random.RandomState(3)
    crop_reqs = [(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
                  rng.uniform(100, 500, (n, 2)).astype(np.float32),
                  rng.uniform(0.8, 2.5, (n, 2)).astype(np.float32))
                 for n in (1, 8, 3, 5, 2, 8, 4, 7)]
    frame = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    frame_boxes = [np.array([[40, 30, 120, 300], [200, 50, 150, 380],
                             [400, 100, 90, 200]], np.float32),
                   np.array([[10, 10, 300, 400], [350, 60, 200, 390],
                             [500, 200, 100, 150], [60, 250, 80, 160],
                             [250, 20, 60, 120], [300, 300, 150, 170]],
                            np.float32)]
    results, latencies, errors = {}, {}, []

    def client(i, kind_, payload):
        t = time.perf_counter()
        try:
            if kind_ == "predict":
                results[i] = predict_remote(url, *payload, timeout=300)
            else:
                results[i] = predict_image_remote(url, image=frame,
                                                  boxes=payload, timeout=300)
        except BaseException as e:          # re-raised below, in main
            errors.append((i, e))
        latencies[i] = time.perf_counter() - t

    jobs = [("predict", r) for r in crop_reqs] + \
           [("predict_image", b) for b in frame_boxes]
    dark_decode.launches = shear_warp.launches = 0   # main path starts here
    batches_before = engine.stats()["batches"]
    try:
        threads = [threading.Thread(target=client, args=(i, kd, pl))
                   for i, (kd, pl) in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        launches = dark_decode.launches          # main path ends here
        warp_on_serve = shear_warp.launches
        batches = engine.stats()["batches"] - batches_before
        stats = batcher.stats()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        th.join(60)
    if errors:
        raise RuntimeError(f"requests failed: {errors}") from errors[0][1]
    if any(t.is_alive() for t in threads) or len(results) != len(jobs):
        raise RuntimeError("not every request came back")
    for i, (kd, pl) in enumerate(jobs):
        n = pl[0].shape[0] if kd == "predict" else pl.shape[0]
        p, v = results[i]
        if p.shape != (n, k, 2) or v.shape != (n, k, 1):
            raise AssertionError(f"request {i}: shapes {p.shape} {v.shape}")
        if not (np.isfinite(p).all() and np.isfinite(v).all()):
            raise AssertionError(f"request {i}: non-finite output")
    lat_ms = sorted(1e3 * x for x in latencies.values())
    log(f"served {len(jobs)} concurrent requests "
        f"({sum(r[0].shape[0] for r in crop_reqs)} crops + "
        f"{sum(len(b) for b in frame_boxes)} boxes) in {batches} engine "
        f"batches {stats['engine']['bucket_calls']}; kernel launches "
        f"{launches}; request latency ms: p50 {np.percentile(lat_ms, 50):.1f}"
        f" max {lat_ms[-1]:.1f}; mean batch fill "
        f"{stats['mean_batch_fill']:.2f}")
    if launches < 1 or launches != batches or warp_on_serve != 0:
        raise AssertionError(f"kernel launches {launches} != engine batches "
                             f"{batches}, or the shear warp ran "
                             f"({warp_on_serve})")

    # kernel vs plain on one served batch's heatmaps (8 crops, bucket 8)
    perm = torch.as_tensor(get_spec(cfg.DATASET.DATASET).flip_perm,
                           device=dev)
    with torch.inference_mode():
        x = torch.from_numpy(crop_reqs[1][0]).to(dev).float()
        x = normalize_image(x).permute(0, 3, 1, 2).contiguous()
        hm = heatmaps_with_flip_test(model, x, cfg, perm).contiguous()
        served_err = kernel_vs_plain(torch, dark_decode,
                                     dark_decode_reference, hm,
                                     cfg.TEST.BLUR_KERNEL)
        per_image = forward_flops(torch, model, x[:1])
    log(f"served batch heatmaps {tuple(hm.shape)}: kernel peaks and maxvals "
        f"equal the plain version's; max |coord diff| {served_err:.3e}")
    passes = 2 if cfg.TEST.FLIP_TEST else 1
    log(f"model forward: {per_image / 1e9:.2f} GFLOP per image (convs and "
        f"linears), {passes} passes per image")

    # -- 5. serving timings -----------------------------------------------
    timing = {}
    blur = cfg.TEST.BLUR_KERNEL
    one = torch.empty(1, device=dev)
    log(f"[{card}] time_cold floor (zero_ of one float): "
        f"{time_cold(torch, one.zero_):.4f} ms")
    for n in (1, 8, 32, 64):
        hm_n = hm64[:n].contiguous()
        ms = time_cold(torch, lambda: dark_decode(hm_n, blur))
        plain_ms = time_cold(torch, lambda: dark_decode_reference(hm_n, blur))
        read_ms = time_cold(torch, hm_n.amax)
        bound, by = dark_bound_ms(n, 17, 96, 72, blur)
        timing[n] = (ms, plain_ms, bound, by)
        log(f"[{card}] dark_decode bucket {n} ({n * 17} maps): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}); {100 * bound / ms:.1f}% of the bound; a plain read "
            f"of the same maps (amax) {read_ms:.4f} ms")
    serve_fn = engine._fn
    req32 = (np.random.RandomState(4).randint(0, 256, (32, h, w, 3))
             .astype(np.uint8), np.full((32, 2), 200.0, np.float32),
             np.full((32, 2), 1.5, np.float32))
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = serve_fn(*req32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    assert out[0].shape == (32, k, 2)
    log(f"[{card}] inference call, bucket 32 (uint8 crops in, flip-test, "
        f"DARK, image coords out): median {1e3 * np.median(walls):.2f} ms, "
        f"min {1e3 * min(walls):.2f} ms = {32 / min(walls):.1f} images/s")
    log(f"[{card}] request latency over HTTP (phase 4): "
        + ", ".join(f"{x:.1f}" for x in lat_ms) + " ms")
    n_kernels = profile_device(torch, lambda: serve_fn(*req32), card,
                               32 * passes * per_image,
                               "one bucket-32 inference call")
    profile_device(torch, lambda: serve_fn(*(a[:1] for a in req32)), card,
                   passes * per_image, "one bucket-1 inference call")
    log(f"serving kernels per bucket-32 inference call: {n_kernels} "
        f"(before the train slice: {SERVE_KERNELS_BEFORE})")
    if n_kernels > SERVE_KERNELS_BEFORE:
        raise AssertionError(f"serving launches {n_kernels} kernels per "
                             f"bucket-32 call, more than "
                             f"{SERVE_KERNELS_BEFORE}")
    serve_launches = launches
    del engine, batcher, server, model, serve_fn
    torch.cuda.empty_cache()

    # -- 6. the shear-warp kernel vs its plain version ---------------------
    t0 = time.perf_counter()
    build.load_library("shear_warp")
    log(f"built shear_warp.cu in {time.perf_counter() - t0:.1f} s: "
        f"{build.library_path('shear_warp').name}")
    ptxas = build.library_path("shear_warp").with_name(
        build.library_path("shear_warp").stem[3:] + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "entry function" in line:        # the kernel named below
                log(f"ptxas: {line.split(chr(39))[1][:40]}...")
            elif any(w in line for w in ("registers", "spill", "smem")):
                log(f"ptxas:   {line.strip()}")
    wcfg = load_config(W32_YAML)
    out_size = tuple(wcfg.MODEL.IMAGE_SIZE)
    rng = np.random.RandomState(5)
    canvases = torch.from_numpy(rng.randint(0, 256, (32, CANVAS, CANVAS, 3))
                                .astype(np.uint8)).to(dev)
    mats = shear_matrices(torch, 32, CANVAS, wcfg, seed=6).to(dev)
    aug_pos = shear_prepare(mats[:32], CANVAS, out_size)
    fixed_pos = shear_prepare(mats[32:], CANVAS, out_size)
    if not (fixed_pos.swap.any() and not fixed_pos.swap.all()):
        raise AssertionError("the fixed matrices miss one of the frames")
    floats = torch.from_numpy(rng.uniform(-1, 2, (8, CANVAS, CANVAS, 3))
                              .astype(np.float32)).to(dev)
    odd = torch.from_numpy(rng.randint(0, 256, (9, 97, 97, 3))
                           .astype(np.uint8)).to(dev)
    ocfg = copy.deepcopy(wcfg)
    ocfg.MODEL.IMAGE_SIZE = (40, 56)
    odd_pos = shear_prepare(shear_matrices(torch, 1, 97, ocfg, 7).to(dev),
                            97, (40, 56))
    cases = [("train shape, augmentation matrices", canvases, aug_pos, 255.0),
             ("fixed rotations, flips, transposed frame", canvases[:8],
              fixed_pos, 255.0),
             ("float32 source of range 3", floats, fixed_pos, 3.0),
             ("odd size 97 -> 40x56", odd, odd_pos, 255.0)]
    for i, name in enumerate(sorted(HARD_WARPS)):
        pos_i = shear_prepare(torch.from_numpy(
            hard_warp_matrix(name, CANVAS, out_size)).to(dev), CANVAS,
            out_size)
        cases += [(f"hard matrix {name}", canvases[i:i + 1], pos_i, 255.0),
                  (f"hard matrix {name}", floats[i:i + 1], pos_i, 3.0)]
    warp_err = 0.0
    for label, images, pos, span in cases:
        err, equal = shear_vs_plain(torch, shear_warp, images, pos)
        err255 = err * 255.0 / span
        log(f"shear_warp kernel vs plain, {label} {tuple(images.shape)} "
            f"{str(images.dtype)[6:]}: max |diff| {err:.3e} ({err255:.3e} "
            f"on 0-255), bit-equal {equal}")
        if err255 > 1e-3 or not equal:
            raise AssertionError(f"shear warp kernel disagrees with its plain "
                                 f"version: {err255} on 0-255, bit-equal "
                                 f"{equal}")
        if label.startswith("train shape"):
            warp_err = err

    # -- 7. small-input reference: a tiny fp32 train step, card vs CPU -----
    tcfg = tiny_rsgnet()
    tcfg.TRAIN.OPTIMIZER = "sgd"
    spec = get_spec("coco")
    tiny = init_weights(get_pose_net(tcfg), seed=1)
    tb = synthetic_train_batch(4, 128, seed=2)
    tdraws = draw_augment(torch.Generator().manual_seed(3), 4)
    res = {}
    for d in (dev, torch.device("cpu")):
        st = create_train_state(tcfg, copy.deepcopy(tiny), device=d)
        batch = {kk: torch.from_numpy(v) for kk, v in tb.items()}
        batch["image"] = batch["image"].to(d)
        st, met = make_train_step(tcfg, spec)(st, batch, tdraws)
        res[d.type] = (float(met["loss"]),
                       {nm: (q.detach().cpu(), q.grad.cpu())
                        for nm, q in st.model.named_parameters()})
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-4,
                               atol=0)
    rels, p_err = [], 0.0
    for nm, (p_cpu, g_cpu) in res["cpu"][1].items():
        p_gpu, g_gpu = res["cuda"][1][nm]
        scale = max(float(g_cpu.abs().max()), 1e-12)
        rels.append(float((g_gpu - g_cpu).abs().max()) / scale)
        if rels[-1] > 5e-2:
            raise AssertionError(f"tiny step grad {nm}: rel {rels[-1]}")
        torch.testing.assert_close(p_gpu, p_cpu, rtol=0,
                                   atol=1e-6 + tcfg.TRAIN.LR * 5e-2 * scale)
        p_err = max(p_err, float((p_gpu - p_cpu).abs().max()))
    if np.mean(rels) > 3e-3:
        raise AssertionError(f"tiny step grads: mean rel {np.mean(rels)}")
    log(f"tiny fp32 train step (SGD), card vs CPU: loss {res['cuda'][0]:.6f}"
        f" vs {res['cpu'][0]:.6f}; grads max rel {max(rels):.3e}, mean "
        f"{np.mean(rels):.3e}; updated params max |diff| {p_err:.3e}")

    # -- 8. train RSGNet-W32 @ 256x192, the train slice's main path --------
    t0 = time.perf_counter()
    wmodel = init_weights(get_pose_net(wcfg), seed=0)
    n_params = sum(q.numel() for q in wmodel.parameters())
    state = create_train_state(wcfg, wmodel, device="cuda")
    step_fn = make_train_step(wcfg, get_spec(wcfg.DATASET.DATASET))
    bs = wcfg.TRAIN.BATCH_SIZE_PER_GPU
    log(f"model {wcfg.MODEL.NAME} W{wcfg.MODEL.EXTRA.STAGE2.NUM_CHANNELS[0]} "
        f"{out_size[1]}x{out_size[0]} DTYPE {wcfg.DTYPE} optimizer "
        f"{wcfg.TRAIN.OPTIMIZER} lr {wcfg.TRAIN.LR} batch {bs} TRAIN.WARP "
        f"{wcfg.TRAIN.WARP}: {n_params} params, seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    if (wcfg.MODEL.NAME != "pose_rsgnet" or wcfg.DTYPE != "bfloat16"
            or wcfg.TRAIN.OPTIMIZER != "adam" or bs != 32):
        raise AssertionError("the W32 YAML no longer selects bf16 Adam "
                             "RSGNet at batch 32")
    raw = synthetic_train_batch(bs, CANVAS, seed=8)
    seen = []
    t0 = time.perf_counter()
    dark_decode.launches = shear_warp.launches = 0   # main path starts here
    state, mean_loss, done = train_one_epoch(
        step_fn, state, [raw] * TRAIN_STEPS, seed=9,
        on_metrics=lambda st_, loss, acc: seen.append((loss, acc)))
    torch.cuda.synchronize()
    warp_launches = shear_warp.launches               # main path ends here
    dark_on_train = dark_decode.launches
    train_s = time.perf_counter() - t0
    losses = [x[0] for x in seen]
    log(f"trained {done} steps in {train_s:.1f} s (first step included): "
        f"loss " + ", ".join(f"{x:.5f}" for x in losses) + "; acc "
        + ", ".join(f"{x[1]:.3f}" for x in seen) + f"; shear_warp launches "
        f"{warp_launches}, dark_decode launches {dark_on_train}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if done != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train steps {done}, losses {losses}")
    if not (losses[-1] < losses[0]
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"the loss on the repeated batch did not fall: "
                             f"{losses}")
    if warp_launches != TRAIN_STEPS or dark_on_train != 0:
        raise AssertionError(f"shear_warp launches {warp_launches} != "
                             f"{TRAIN_STEPS} steps, or dark_decode ran "
                             f"({dark_on_train})")

    # -- 9. timings of the train slice --------------------------------------
    warp_ms = time_cold(torch, lambda: shear_warp(canvases, aug_pos))
    warp_plain_ms = time_cold(torch, lambda: shear_warp_reference(canvases,
                                                                   aug_pos))
    warp_bound, warp_by, warp_bytes, src_bytes = shear_bound_ms(
        torch, canvases, aug_pos)
    # the nearest library call: the gather warp on a float32 NCHW copy of
    # the canvases, grid from the same matrices (both made outside the
    # timed region)
    inv = invert_affine(mats[:32])
    gx = torch.arange(out_size[0], dtype=torch.float32, device=dev)
    gy = torch.arange(out_size[1], dtype=torch.float32, device=dev)[:, None]
    u = inv[:, 0, 0, None, None] * gx + inv[:, 0, 1, None, None] * gy \
        + inv[:, 0, 2, None, None]
    v = inv[:, 1, 0, None, None] * gx + inv[:, 1, 1, None, None] * gy \
        + inv[:, 1, 2, None, None]
    grid = torch.stack([2 * u / (CANVAS - 1) - 1, 2 * v / (CANVAS - 1) - 1],
                       dim=-1)
    src_f = canvases.permute(0, 3, 1, 2).float().contiguous()
    gs_ms = time_cold(torch, lambda: torch.nn.functional.grid_sample(
        src_f, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))
    log(f"[{card}] shear_warp at (32, {CANVAS}, {CANVAS}, 3) uint8 -> (32, "
        f"3, {out_size[1]}, {out_size[0]}) fp32: kernel {warp_ms:.4f} ms, "
        f"plain {warp_plain_ms:.4f} ms, bound {warp_bound:.4f} ms "
        f"({warp_by}: {warp_bytes / 1e6:.1f} MB = output "
        f"{(warp_bytes - src_bytes) / 1e6:.1f} MB + source footprint "
        f"{src_bytes / 1e6:.1f} MB of {canvases.numel() / 1e6:.1f} MB); "
        f"F.grid_sample (the gather warp, fp32 NCHW source; equals the "
        f"shear warp only at rot 0/+-90/flips) {gs_ms:.4f} ms")
    log(f"[{card}] shear_warp kernel: {100 * warp_bound / warp_ms:.1f}% of "
        f"its bound ({warp_ms / warp_bound:.2f}x the bound), "
        f"{warp_ms / gs_ms:.3f}x the time of F.grid_sample "
        f"({'faster' if warp_ms < gs_ms else 'slower'})")
    loader = [raw] * 6
    train_one_epoch(step_fn, state, loader[:2], seed=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(step_fn, state, loader, seed=11)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / len(loader)
    log(f"[{card}] train step, batch {bs} (host batch in, pinned copy, "
        f"augmentation, forward, backward, Adam): {1e3 * step_s:.2f} ms = "
        f"{bs / step_s:.1f} images/s (mean of {len(loader)} steps)")
    draws = draw_augment(torch.Generator().manual_seed(12), bs)
    batch = {kk: torch.from_numpy(v) for kk, v in raw.items()}
    batch["image"] = batch["image"].to(dev)
    with torch.no_grad():
        x = torch.zeros(1, 3, out_size[1], out_size[0], device=dev)
        fwd = forward_flops(torch, state.model.eval(), x)
    profile_device(torch, lambda: step_fn(state, batch, draws), card,
                   3 * bs * fwd, f"one train step at batch {bs} (forward "
                   f"{fwd / 1e9:.2f} GFLOP per image; x3 for fwd+bwd)")

    # -- 10. result lines ----------------------------------------------------
    ms, plain_ms, bound, by = timing[64]
    kernels = [{
        "name": "dark_decode",
        "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/dark_decode.cu",
        "replaces": "rsgnet_tpu/ops/pallas/dark_decode.py:48",
        "launches": serve_launches,
        "max_abs_err": err64[11],
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_share": bound / ms,
        "library_ms": None,
        "shape": [64, 17, 96, 72],
        "blur_kernel": blur,
        "bucket_ms": {str(b): timing[b][0] for b in sorted(timing)},
    }, {
        "name": "shear_warp",
        "route": "cuda",
        "source": "rsgnet_tpu_torch/csrc/shear_warp.cu",
        "replaces": "rsgnet_tpu/ops/pallas/shear_warp.py:88",
        "launches": warp_launches,
        "max_abs_err": warp_err,
        "ms": warp_ms,
        "plain_ms": warp_plain_ms,
        "bound_ms": warp_bound,
        "bound_by": warp_by,
        "library_ms": gs_ms,
        "library_call": "F.grid_sample bilinear zeros (the gather warp)",
        "shape": [32, CANVAS, CANVAS, 3],
        "out_size": list(out_size),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
