"""Shape-bucketed serving executor.

``ServingEngine`` wraps any ``fn(images, centers, scales) -> (preds,
maxvals)`` — the port's inference function (core/inference.py) — pads each
request batch up to the nearest of a small static set of bucket sizes,
dispatches, and slices the results back to the true size. A fixed bucket
set keeps the set of shapes the device sees small: every shape is warmed
(cuDNN algorithm choice, allocator pools, the kernel build) before the
first request, and the batcher's split-vs-pad decisions have measured
costs to work from.

``run`` returns DEVICE tensors (sliced lazily): callers that pipeline
(serving.batcher) materialize them off the dispatch path, so the device
starts the next batch while the previous response is still in flight.

Every call of the function, the warm-up's and the requests', runs on one
thread the engine owns: cuDNN keeps its algorithm choices per thread, and
a thread that has not run a shape pays the choice again (seconds a batch
shape under ``CUDNN.BENCHMARK``), so only a shared thread makes the
warmed shapes warm for the requests. ``close`` stops it.

Tracing (``utils/profiler.py``): a call made under a trace context (a
traced batch's, or a profiled caller's) carries it to the engine's thread
and records ``engine.call`` there, with its bucket. ``warmup`` records one
``serve.warmup`` span per bucket, always, with the warm call
(``serve.warmup.call``) and each timing repeat (``serve.warmup.repeat``)
as its children.

On a card the port's inference function captures a bucket's CUDA graphs
at its second call, the first timing repeat, so ``bucket_cost`` holds
replays and every request's call replays (``stats()``'s
``graph_replays``).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from rsgnet_tpu_torch.utils import profiler


def _wait(out):
    """Block until every CUDA tensor in ``out`` is computed."""
    for t in out:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def to_host(x) -> np.ndarray:
    """A result tensor (any device) or array -> a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class ServingEngine:
    """Pads request batches to static bucket sizes and executes.

    Args:
      serve_fn: ``fn(images, centers, scales) -> (preds, maxvals)``.
        Shapes: images (B, H, W, 3), centers/scales (B, 2).
      buckets: ascending batch sizes requests are padded to. The largest
        bucket is the engine's ``max_batch``.
      image_shape: optional (H, W, 3) to validate requests against at
        submit time.
      image_dtype: optional expected dtype (uint8 for an inference function
        built with ``normalize_input=True``); requests are cast if needed.
    """

    def __init__(self, serve_fn: Callable, buckets: Sequence[int] = (
            1, 2, 4, 8, 16, 32, 64), image_shape=None, image_dtype=None):
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be ascending unique ints, got "
                             f"{buckets!r}")
        self._fn = serve_fn
        self.buckets = tuple(int(b) for b in buckets)
        self.max_batch = self.buckets[-1]
        self.image_shape = tuple(image_shape) if image_shape else None
        self.image_dtype = np.dtype(image_dtype) if image_dtype else None
        self._lock = threading.Lock()
        self._bucket_calls = {b: 0 for b in self.buckets}
        # measured seconds per dispatch, filled by warmup(); the batcher
        # (DynamicBatcher._chunks_for_buckets) uses it to decide whether
        # splitting a group across buckets beats padding to the next one
        self.bucket_cost: dict = {}
        self._worker = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-engine")

    def _call(self, *args, bucket=None):
        """``serve_fn(*args)`` on the engine's thread, under the caller's
        trace context if it has one."""
        ctx = profiler.current()
        if ctx is None:
            return self._worker.submit(self._fn, *args).result()
        return self._worker.submit(self._traced_call, ctx, bucket,
                                   args).result()

    def _traced_call(self, ctx, bucket, args):
        with profiler.activate(ctx), profiler.span("engine.call",
                                                   bucket=bucket):
            return self._fn(*args)

    def close(self):
        """Stop the engine's thread after the calls already submitted.
        Idempotent."""
        self._worker.shutdown(wait=True)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n. Requests above max_batch are the caller's
        responsibility to split (DynamicBatcher never forms one)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"request batch {n} exceeds the largest bucket "
                         f"{self.max_batch}; split it or add a bucket")

    def validate(self, images, centers, scales) -> int:
        """Host-side request validation; returns the batch size."""
        images, centers, scales = (np.asarray(images), np.asarray(centers),
                                   np.asarray(scales))
        if images.ndim != 4:
            raise ValueError(f"images must be (B, H, W, 3), got shape "
                             f"{images.shape}")
        n = images.shape[0]
        if self.image_shape and tuple(images.shape[1:]) != self.image_shape:
            raise ValueError(f"images must be (B, {', '.join(map(str, self.image_shape))}), "
                             f"got {images.shape}")
        if centers.shape != (n, 2) or scales.shape != (n, 2):
            raise ValueError(f"centers/scales must be ({n}, 2), got "
                             f"{centers.shape} / {scales.shape}")
        return n

    def run(self, images, centers, scales) -> Tuple:
        """Pad to the nearest bucket, execute, slice back to the true size.

        Returns device tensors (materialize with ``to_host`` when the
        response is actually sent). Padding repeats the first row, so a
        padded row can never hit a degenerate branch a real row would not."""
        n = self.validate(images, centers, scales)
        b = self.bucket_for(n)
        images, centers, scales = (np.asarray(images),
                                   np.asarray(centers, np.float32),
                                   np.asarray(scales, np.float32))
        if self.image_dtype is not None and images.dtype != self.image_dtype:
            images = images.astype(self.image_dtype)
        if b != n:
            pad = b - n
            images = np.concatenate(
                [images, np.repeat(images[:1], pad, axis=0)])
            centers = np.concatenate(
                [centers, np.repeat(centers[:1], pad, axis=0)])
            scales = np.concatenate(
                [scales, np.repeat(scales[:1], pad, axis=0)])
        preds, maxvals = self._call(images, centers, scales, bucket=b)
        with self._lock:
            self._bucket_calls[b] += 1
        return preds[:n], maxvals[:n]

    def warmup(self, buckets: Sequence[int] | None = None,
               timing_repeats: int = 2):
        """Run every bucket (default: all) once on dummy requests so the
        first real request pays no first-call cost (kernel build, cuDNN
        algorithm choice, allocator growth). Requires ``image_shape``.

        Then times ``timing_repeats`` calls per bucket, each to a host
        copy of the results, and records the MIN in ``bucket_cost`` for the
        batcher's split-vs-pad decisions (min because dispatch noise is
        additive: one slow sample must not skew every later decision)."""
        if self.image_shape is None:
            raise ValueError("warmup needs image_shape to build dummy input")
        dtype = self.image_dtype or np.float32
        for b in (buckets or self.buckets):
            with profiler.span("serve.warmup", setup=True, bucket=b):
                self.bucket_cost[b] = self._warm(b, dtype, timing_repeats)

    def _warm(self, b, dtype, timing_repeats):
        """Warm bucket ``b``; returns the least of the timed calls."""
        imgs = np.zeros((b, *self.image_shape), dtype)
        args = (imgs, np.full((b, 2), 32.0, np.float32),
                np.ones((b, 2), np.float32))
        with profiler.span("serve.warmup.call", setup=True, bucket=b):
            _wait(self._call(*args, bucket=b))
        best = float("inf")
        for _ in range(max(1, timing_repeats)):
            with profiler.span("serve.warmup.repeat", setup=True, bucket=b):
                t0 = time.perf_counter()
                out = self._call(*args, bucket=b)
                for t in out:
                    to_host(t)
                best = min(best, time.perf_counter() - t0)
        return best

    def stats(self) -> dict:
        """Calls by bucket, and the function's own counters where it keeps
        them: the port's inference functions count ``graph_replays``
        (calls replayed from CUDA graphs) and ``eager_calls``, warm-up
        included."""
        with self._lock:
            calls = dict(self._bucket_calls)
        out = {"bucket_calls": calls, "batches": int(sum(calls.values()))}
        for k in ("graph_replays", "eager_calls"):
            if hasattr(self._fn, k):
                out[k] = int(getattr(self._fn, k))
        return out
