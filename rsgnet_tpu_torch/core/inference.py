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
are reached through their operators. The eager functions copy centers and
scales to the device as one (2, N, 2) tensor, as the artifact receives
them there. The crop transforms are solved where the canvases lie, and the
keypoints are mapped back with the closed-form rot-0 transform in
elementwise fp32 (``ops/affine.py::transform_preds``), which gives the
same bits on the host and on the card: the eager functions and the
artifact agree exactly.

Tracing (``utils/profiler.py``): an eager call made under a trace context
(a traced batch's, or on a thread being profiled) records
``pipeline.call`` and, inside ``DevicePipeline``, a span per stage
(``pipeline.crop`` or ``pipeline.normalize``, ``pipeline.forward``, twice
under flip-test, ``pipeline.flip``: the input's flip, then ``flip_back``
and the average, ``pipeline.decode``; a model that names its parts runs
a stage a part in place of each ``pipeline.forward``: ``vit.embed``,
``vit.blocks``, ``vit.head`` for ``pose_vit``), each with CUDA events
whose device milliseconds the recorder reads later. The first call of
each input shape records ``pipeline.first_call``, always (cuDNN's
autotuning of the shape happens in it; on a card it waits for the
device). The decision is made
in the eager wrapper, outside the module that ``torch.export`` captures,
so the artifact holds none of it.

CUDA graphs: on a CUDA device the eager functions replay a shape's work.
The first call of an input shape (and dtype) runs eagerly, as above; the
second captures the shape's ``DevicePipeline`` into CUDA graphs, one a
stage, on the calling thread (cuDNN's choices are per thread) into one
memory pool per function, and records the set-up span
``pipeline.capture``; that call and every later one of the shape copy
their inputs into the graphs' static device buffers (images, centers and
scales, non-blocking, on the current stream), replay the stages in order
inside the same stage spans, and return clones of the static outputs, so
a replay never overwrites results a caller has not read. A replay gives
the bits of an eager call. The host issues one graph launch a stage
instead of thousands of kernel launches a call. Calls of one function
share its buffers: make them from one thread at a time, on one stream,
as the serving engine's thread does. A change of any weight's storage or
version (an optimizer step, ``load_state_dict``) drops the function's
graphs: the forward caches casts of the weights, so the call that sees
the change runs eagerly and rebuilds them, and the next call of a shape
captures again. CPU tensors never capture. ``fn.graph_replays`` and
``fn.eager_calls`` count the calls of each kind, and a traced call's
``pipeline.call`` span carries ``graph`` (True or False).
"""
from __future__ import annotations

import contextlib
import functools
import operator
import os

import numpy as np
import torch
from torch import nn

from rsgnet_tpu_torch.config.defaults import Config
from rsgnet_tpu_torch.data.skeletons import get_spec
from rsgnet_tpu_torch.ops.decode import get_final_preds
from rsgnet_tpu_torch.ops.flip import flip_back
from rsgnet_tpu_torch.ops.affine import get_affine_transform_t
from rsgnet_tpu_torch.ops.cuda import launch_tally, replayed
from rsgnet_tpu_torch.ops.warp import (IMAGENET_MEAN, IMAGENET_STD,
                                      crop_and_normalize, normalize_image,
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


def forward_in_stages(model, images, stage=profiler.no_stage):
    """``model(images)``, in one ``pipeline.forward`` stage, or in a stage
    a part where the model names its parts (``model.parts()``: (span
    name, callable) in order, as ``models/pose_vit.py`` does)."""
    parts = getattr(model, "parts", None)
    if parts is None:
        with stage("pipeline.forward"):
            return model(images)
    x = images
    for name, part in parts():
        with stage(name):
            x = part(x)
    return x


def heatmaps_with_flip_test(model, images, cfg: Config, perm,
                            stage=profiler.no_stage):
    """Model forward (+ flip-test average). images: (N, 3, H, W).
    ``stage(name)`` wraps each step (``profiler.stages``); the forwards
    run as ``forward_in_stages``."""
    output = forward_in_stages(model, images, stage)
    if not cfg.TEST.FLIP_TEST:
        return output
    with stage("pipeline.flip"):
        images = torch.flip(images, dims=(3,))
    flipped = forward_in_stages(model, images, stage)
    with stage("pipeline.flip"):
        flipped = flip_back(flipped, perm, shift=cfg.TEST.SHIFT_HEATMAP)
        return (output + flipped) * 0.5


def _pinned(x):
    """A tensor a non-blocking copy to the card reads from: the caller's
    pinned or device tensor as it is, anything else copied into pinned
    memory."""
    t = torch.as_tensor(x)
    return t if t.is_cuda else t.pin_memory()


def to_device(x, device):
    """Host array or tensor -> tensor on ``device``; host-to-card copies go
    through pinned memory so they never wait for the work already queued
    on the card."""
    if device.type == "cuda":
        return _pinned(x).to(device, non_blocking=True)
    return torch.as_tensor(x).to(device)


class _ShapeGraphs:
    """One input shape's ``DevicePipeline`` as CUDA graphs, one a stage,
    captured on the calling thread into ``pool``: the static device
    buffers they read (the images; centers and scales as one (2, N, 2)
    tensor) and write (preds, maxvals), and each stage's name, graph and
    the kernel launches it holds (``ops/cuda``: ``launch_tally``)."""

    def __init__(self, pipeline, images, device, pool):
        images = torch.as_tensor(images)
        self.images = torch.empty(images.shape, dtype=images.dtype,
                                  device=device)
        self.boxes = torch.empty((2, images.shape[0], 2),
                                 dtype=torch.float32, device=device)
        self.stages = []
        self.preds, self.maxvals = pipeline(
            self.images, self.boxes[0], self.boxes[1],
            stage=functools.partial(self._capture, pool))

    @contextlib.contextmanager
    def _capture(self, pool, name):
        graph = torch.cuda.CUDAGraph()
        # thread-local: another thread's synchronizing call (the batcher's
        # completer) cannot break the capture
        with launch_tally() as tally, torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            yield
        self.stages.append((name, graph, tally))

    def __call__(self, images, boxes, stage):
        self.images.copy_(images, non_blocking=True)
        self.boxes.copy_(boxes, non_blocking=True)
        for name, graph, tally in self.stages:
            with stage(name):
                graph.replay()
            replayed(tally)
        return self.preds.clone(), self.maxvals.clone()


_VERSION = operator.attrgetter("_version")


class _Graphs:
    """The CUDA graphs of one eager function: a ``_ShapeGraphs`` per input
    shape and dtype, in one memory pool, dropped when any weight changes
    storage or version."""

    def __init__(self, pipeline, device):
        self.pipeline = pipeline
        self.device = device
        self.tensors = [*pipeline.parameters(), *pipeline.buffers()]
        # inference tensors keep no version: their storage alone is stamped
        self.versioned = [t for t in self.tensors if not t.is_inference()]
        self.weights = self._weights()
        self.by_shape = {}
        self.pool = None

    def _weights(self):
        return (list(map(torch.Tensor.data_ptr, self.tensors)),
                list(map(_VERSION, self.versioned)))

    def weights_changed(self) -> bool:
        """Whether a weight changed since the last look; if one did, every
        graph is dropped (after the card has finished with them)."""
        weights = self._weights()
        if weights == self.weights:
            return False
        self.weights = weights
        if self.by_shape:
            torch.cuda.synchronize(self.device)
            self.by_shape.clear()
            self.pool = None
        return True

    def get(self, key, images) -> _ShapeGraphs:
        """The shape's graphs, captured now on their first use."""
        graphs = self.by_shape.get(key)
        if graphs is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            with profiler.span("pipeline.capture", setup=True,
                               shape=list(key[0])):
                graphs = _ShapeGraphs(self.pipeline, images, self.device,
                                      self.pool)
            self.by_shape[key] = graphs
        return graphs


def _make_fn(cfg: Config, model, device, normalize_input=False,
             src_size=None):
    """The shared body of the eager functions: ``DevicePipeline`` on
    ``device`` (``model`` moved there and put in eval mode), fed the
    images and one (2, N, 2) tensor of centers and scales, both copied
    from pinned memory so the host never waits for the device; on a CUDA
    device a shape's calls after its first replay its CUDA graphs (the
    module docstring)."""
    device = resolve_device(device)
    configure_precision()
    pipeline = DevicePipeline(cfg, model.to(device), normalize_input,
                              src_size)
    graphs = _Graphs(pipeline, device) if device.type == "cuda" else None
    shapes = set()                    # input shapes called at least once

    def run(images, centers, scales, shape_graphs=None):
        boxes = np.stack([np.asarray(centers, np.float32),
                          np.asarray(scales, np.float32)])
        if shape_graphs is not None:
            fn.graph_replays += 1
            return shape_graphs(_pinned(images), _pinned(boxes),
                                profiler.stages(device))
        fn.eager_calls += 1
        boxes = to_device(boxes, device)
        return pipeline(to_device(images, device), boxes[0], boxes[1])

    @torch.inference_mode()
    def fn(images, centers, scales):
        key = (tuple(images.shape), str(images.dtype))
        changed = graphs is not None and graphs.weights_changed()
        if key not in shapes:
            shapes.add(key)
            with profiler.span("pipeline.first_call", setup=True,
                               shape=list(key[0])):
                out = run(images, centers, scales)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            return out
        shape_graphs = (None if graphs is None or changed
                        else graphs.get(key, images))
        ctx = profiler.current()
        if ctx is None:
            return run(images, centers, scales, shape_graphs)
        with profiler.activate(ctx), profiler.span(
                "pipeline.call", graph=shape_graphs is not None):
            return run(images, centers, scales, shape_graphs)

    fn.graph_replays = 0
    fn.eager_calls = 0
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
    per TEST.WARP). images, centers and scales ((N, 2) float32) lie on the
    model's device, as the eager functions and the exported artifact give
    them. The crop transforms are solved on the images' device; the
    keypoints go back to image space through
    ``ops/affine.py::transform_preds`` where the boxes lie (host boxes
    give the same bits). Every step is a traceable tensor op or one of the
    kernels' operators, so the module is what ``utils/export.py`` exports.

    ``stage(name)`` (default ``profiler.stages``) wraps each step, and
    every device op runs inside one: the eager functions capture each
    stage as a CUDA graph of its own (``_ShapeGraphs``).
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
        # the normalization's constants, made once rather than at each call
        for name, values in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)):
            self.register_buffer(name, torch.tensor(
                values, dtype=torch.float32, device=device), persistent=False)

    def forward(self, images, centers, scales, stage=None):
        cfg = self.cfg
        stage = stage or profiler.stages(images.device)
        if self.src_size is None:
            with stage("pipeline.normalize"):
                x = images.to(torch.float32)
                if self.normalize_input:
                    x = normalize_image(x, self.mean, self.std)
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
                                       warp=self.warp, mean=self.mean,
                                       std=self.std)
        output = heatmaps_with_flip_test(self.model, x, cfg, self.perm,
                                         stage)
        with stage("pipeline.decode"):
            return get_final_preds(
                output.contiguous(), centers, scales,
                post_process=cfg.TEST.POST_PROCESS,
                use_dark=cfg.TEST.DECODE.lower() == "dark",
                blur_kernel=cfg.TEST.BLUR_KERNEL)
