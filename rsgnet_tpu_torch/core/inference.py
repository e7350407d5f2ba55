"""Batched inference: crops -> model -> flip-test -> decode -> image coords.

``make_inference_fn(cfg, model, normalize_input, device)`` returns
``fn(images, centers, scales) -> (preds, maxvals)`` with the JAX package's
contract (minus the ``variables`` argument: the module holds its weights):

- images: (N, H, W, 3), raw uint8 crops with ``normalize_input=True``
  (ImageNet normalization runs on the device), else normalized float32;
- centers, scales: (N, 2) float32, the crops' box mapping (pixel_std 200);
- flip-test runs the model on the x-mirrored batch too, un-flips with the
  L/R permutation + SHIFT_HEATMAP and averages (two passes, not one 2N
  batch);
- decode: DARK (the CUDA kernel on the card) or quarter-offset, per
  TEST.DECODE / TEST.POST_PROCESS;
- returns preds (N, K, 2) image-space coordinates and maxvals (N, K, 1),
  as float32 tensors on ``device``. Nothing waits for the device: the
  caller materializes the results when it needs them.

``make_e2e_fn(cfg, model, src_size, device)`` returns ``fn(raw_images,
centers, scales)`` with the same outputs from raw (N, H, W, 3) uint8 source
canvases: the rot-0 crop transforms are solved and the crop
(``ops/warp.py::crop_and_normalize``, per TEST.WARP) runs on the device.

Both run ``DevicePipeline``, the program as one ``nn.Module`` of tensor
ops that ``torch.export`` captures (``utils/export.py``); the two kernels
are reached through their operators. The eager functions give it host
centers and scales, the artifact device ones. The crop transforms are
solved where the canvases lie, and the keypoints are mapped back with the
closed-form rot-0 transform in elementwise fp32 (``ops/affine.py::
rot0_transform_t``) where the boxes lie, which gives the same bits on the
host and on the card: the eager functions and the artifact agree exactly.

Tracing (``utils/profiler.py``): an eager call made under a trace context
(a traced batch's, or on a thread being profiled) records
``pipeline.call`` and, inside ``DevicePipeline``, a span per stage
(``pipeline.crop`` or ``pipeline.normalize``, ``pipeline.forward``, twice
under flip-test, ``pipeline.flip``: the input's flip, then ``flip_back``
and the average, ``pipeline.decode``), each with CUDA events whose device
milliseconds the recorder reads later. The first call of each input shape
records ``pipeline.first_call``, always (cuDNN's autotuning of the shape
happens in it; on a card it waits for the device). The decision is made
in the eager wrapper, outside the module that ``torch.export`` captures,
so the artifact holds none of it.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from rsgnet_tpu_torch.config.defaults import Config
from rsgnet_tpu_torch.data.skeletons import get_spec
from rsgnet_tpu_torch.ops.decode import get_final_preds
from rsgnet_tpu_torch.ops.flip import flip_back
from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
from rsgnet_tpu_torch.ops.warp import (crop_and_normalize, normalize_image,
                                      resolve_eval_warp)
from rsgnet_tpu_torch.utils import profiler


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist. Nothing falls
    back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def configure_precision():
    """Pin the float32 precision of matmuls and cuDNN convs to full fp32.

    cuDNN convs default to TF32 on Hopper (``cudnn.allow_tf32`` is True),
    which would quietly run the fp32 final layer, the fp32 delta conv and the
    head's fp32 einsums at ~3 decimal digits. bf16 compute happens only
    where the model casts explicitly (cfg.DTYPE)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def configure_cudnn(cfg: Config):
    """Set the process's cuDNN switches from the CUDNN keys, as the
    reference's CLIs do: ``cudnn.benchmark`` (pick conv algorithms by
    timing them), ``cudnn.deterministic`` and ``cudnn.enabled``. Under
    DETERMINISTIC also ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless already
    set) and ``torch.use_deterministic_algorithms`` (warning where an op
    has no deterministic version). Bitwise repeatable runs across
    processes need BENCHMARK off as well: timing can pick another
    deterministic algorithm in another process. TF32 stays off whatever
    the keys say (``configure_precision``).

    The CLIs call it once after loading their config; the library
    functions set no global cuDNN state."""
    c = cfg.CUDNN
    det = bool(c.DETERMINISTIC)
    if det:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.benchmark = bool(c.BENCHMARK)
    torch.backends.cudnn.deterministic = det
    torch.backends.cudnn.enabled = bool(c.ENABLED)
    if det or torch.are_deterministic_algorithms_enabled():
        # the switch imports torch's compiler stack (seconds): only when
        # it changes something
        torch.use_deterministic_algorithms(det, warn_only=True)
    configure_precision()


def heatmaps_with_flip_test(model, images, cfg: Config, perm,
                            stage=profiler.no_stage):
    """Model forward (+ flip-test average). images: (N, 3, H, W).
    ``stage(name)`` wraps each step (``profiler.stages``)."""
    with stage("pipeline.forward"):
        output = model(images)
    if not cfg.TEST.FLIP_TEST:
        return output
    with stage("pipeline.flip"):
        images = torch.flip(images, dims=(3,))
    with stage("pipeline.forward"):
        flipped = model(images)
    with stage("pipeline.flip"):
        flipped = flip_back(flipped, perm, shift=cfg.TEST.SHIFT_HEATMAP)
        return (output + flipped) * 0.5


def to_device(x, device):
    """Host array or tensor -> tensor on ``device``; host-to-card copies go
    through pinned memory so they never wait for the work already queued
    on the card."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _make_fn(cfg: Config, model, device, normalize_input=False,
             src_size=None):
    """The shared body of the eager functions: ``DevicePipeline`` on
    ``device`` (``model`` moved there and put in eval mode), fed device
    images and host centers and scales, so the keypoints' mapping back
    stays on the host and never makes the device stream wait."""
    device = resolve_device(device)
    configure_precision()
    pipeline = DevicePipeline(cfg, model.to(device), normalize_input,
                              src_size)
    shapes = set()                    # input shapes called at least once

    def run(images, centers, scales):
        return pipeline(to_device(images, device),
                        torch.as_tensor(np.asarray(centers, np.float32)),
                        torch.as_tensor(np.asarray(scales, np.float32)))

    @torch.inference_mode()
    def fn(images, centers, scales):
        key = (tuple(images.shape), str(images.dtype))
        if key not in shapes:
            shapes.add(key)
            with profiler.span("pipeline.first_call", setup=True,
                               shape=list(key[0])):
                out = run(images, centers, scales)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            return out
        ctx = profiler.current()
        if ctx is None:
            return run(images, centers, scales)
        with profiler.activate(ctx), profiler.span("pipeline.call"):
            return run(images, centers, scales)

    return fn


def make_inference_fn(cfg: Config, model, normalize_input=False,
                      device="cuda"):
    """Crops -> image-space keypoints, honoring TEST.* config. ``model``
    is moved to ``device`` and put in eval mode."""
    return _make_fn(cfg, model, device, normalize_input=normalize_input)


def make_e2e_fn(cfg: Config, model, src_size, device="cuda"):
    """Raw source canvases + center/scale -> image-space keypoints, with
    the crop on the device. ``src_size`` is the canvases' (H, W); ``model``
    is moved to ``device`` and put in eval mode."""
    return _make_fn(cfg, model, device, src_size=src_size)


class DevicePipeline(nn.Module):
    """``forward(images, centers, scales) -> (preds, maxvals)``: the
    inference function's program (``src_size=None``; crops in, raw uint8
    with ``normalize_input``, else normalized float32) or the e2e
    function's (raw (N, H, W, 3) uint8 canvases of ``src_size``; the crop
    per TEST.WARP). images lie on the model's device; centers and scales
    are (N, 2) float32 tensors on the host (the eager functions) or on the
    model's device (the exported artifact). The crop transforms are solved
    on the images' device; the keypoints go back to image space through
    ``ops/affine.py::rot0_transform_t`` where the boxes lie, with the same
    bits on both. Every step is a traceable tensor op or one of the
    kernels' operators, so the module is what ``utils/export.py`` exports.
    """

    def __init__(self, cfg: Config, model, normalize_input=False,
                 src_size=None):
        super().__init__()
        self.cfg = cfg
        self.model = model.eval()
        self.normalize_input = normalize_input
        self.src_size = None if src_size is None else tuple(
            int(v) for v in src_size)
        self.warp = resolve_eval_warp(cfg.TEST.WARP, name="TEST.WARP")
        device = next(model.parameters()).device
        self.register_buffer("perm", torch.as_tensor(
            get_spec(cfg.DATASET.DATASET).flip_perm, dtype=torch.int64,
            device=device), persistent=False)

    def forward(self, images, centers, scales):
        cfg = self.cfg
        stage = profiler.stages(images.device)
        if self.src_size is None:
            with stage("pipeline.normalize"):
                x = images.to(torch.float32)
                if self.normalize_input:
                    x = normalize_image(x)
                x = x.permute(0, 3, 1, 2).contiguous()      # NHWC -> NCHW
        else:
            if tuple(images.shape[1:3]) != self.src_size:
                raise ValueError(f"source canvases are "
                                 f"{tuple(images.shape[1:3])}, the function "
                                 f"was built for {self.src_size}")
            with stage("pipeline.crop"):
                # the crop transforms are solved where the canvases lie
                image_size = tuple(cfg.MODEL.IMAGE_SIZE)        # (w, h)
                c, s = (to_device(t, images.device)
                        for t in (centers, scales))
                trans = get_affine_transform_t(
                    c, s, torch.zeros_like(c[:, 0]), image_size)
                x = crop_and_normalize(images, trans, image_size,
                                       warp=self.warp)
        output = heatmaps_with_flip_test(self.model, x, cfg, self.perm,
                                         stage)
        with stage("pipeline.decode"):
            return get_final_preds(
                output.contiguous(), centers, scales,
                post_process=cfg.TEST.POST_PROCESS,
                use_dark=cfg.TEST.DECODE.lower() == "dark",
                blur_kernel=cfg.TEST.BLUR_KERNEL)
