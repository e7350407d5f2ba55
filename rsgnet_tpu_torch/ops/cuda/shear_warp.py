"""The hand-written CUDA shear-warp kernel (csrc/shear_warp.cu) as the
operator ``torch.ops.rsgnet_tpu_torch.shear_warp``.

``shear_warp(images, pos)`` takes (N, S, S, C) square sources (uint8 or
float32, contiguous) and ``ops/shear_warp.py::shear_prepare``'s positions,
and returns the (N, C, out_h, out_w) float32 warp.

The operator is a ``torch.library`` custom op, ``(Tensor images, Tensor
swap, Tensor p_a, Tensor s_a, Tensor p_b, Tensor s_b, int out_h, int
out_w) -> Tensor``, with two implementations and nothing else dispatching.
On a CUDA tensor the kernel, one launch on PyTorch's current stream that
computes both passes with no intermediate in device memory: the source is
read in its own dtype (no float copy of a uint8 batch), nothing but the
output is allocated, and anything the kernel refuses raises (a sample of
S * S * C or C * out_h * out_w elements beyond 31-bit offsets among it).
On a CPU tensor the plain version,
``ops/shear_warp.py::shear_warp_reference``. Its fake implementation
gives the output shape from symbolic input shapes, so ``torch.export``
records one call of the operator. The output size is a static argument.

``shear_warp.launches`` counts the kernel's launches that ran: it is raised by
one right after each successful launch and nowhere else, except inside a
CUDA graph's capture, where the launch runs only at the graph's replays:
the capture adds nothing, and each replay adds the launches its graph
holds (``ops/cuda/__init__.py``: ``count_launch``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rsgnet_tpu_torch.ops.cuda import count_launch
from rsgnet_tpu_torch.ops.shear_warp import (ShearPositions,
                                             shear_warp_reference)


@functools.lru_cache(maxsize=1)
def _library():
    from rsgnet_tpu_torch.ops.cuda.build import load_library
    lib = load_library("shear_warp")
    lib.shear_warp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.shear_warp_launch.restype = ctypes.c_int
    return lib


def _check(images, pos, out_h, out_w):
    if not isinstance(images, torch.Tensor) or images.ndim != 4:
        raise ValueError("images must be a (N, S, S, C) tensor")
    n, s, s2, ch = images.shape
    if s != s2:
        raise ValueError(f"the shear warp needs square sources, got {s}x{s2}")
    if ch < 1 or s < 1:
        raise ValueError(f"images of shape {tuple(images.shape)} hold no "
                         f"pixels")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got "
                        f"{images.dtype}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous (N, S, S, C)")
    if not isinstance(pos, ShearPositions):
        raise TypeError("pos must be shear_prepare's ShearPositions")
    want = {"swap": (n,), "p_a": (n, out_w), "s_a": (n, s),
            "p_b": (n, out_h), "s_b": (n, out_w)}
    for name, shape in want.items():
        t = getattr(pos, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"pos.{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        dtype = torch.bool if name == "swap" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"pos.{name} must be {dtype}, got {t.dtype}")
        if t.device != images.device:
            raise ValueError(f"pos.{name} is on {t.device}, images on "
                             f"{images.device}")
        if not t.is_contiguous():
            raise ValueError(f"pos.{name} must be contiguous")
    if max(s * s * ch, ch * out_h * out_w) >= 2 ** 31:
        raise ValueError(f"shear warp of {tuple(images.shape)} to "
                         f"{out_h}x{out_w}: a sample does not fit the "
                         f"kernel's 31-bit offsets")
    return n, s, ch, out_h, out_w


@torch.library.custom_op("rsgnet_tpu_torch::shear_warp", mutates_args=(),
                         device_types="cpu")
def shear_warp_op(images: torch.Tensor, swap: torch.Tensor,
                  p_a: torch.Tensor, s_a: torch.Tensor, p_b: torch.Tensor,
                  s_b: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The operator on a CPU tensor: the plain version."""
    pos = ShearPositions(swap, p_a, s_a, p_b, s_b)
    _check(images, pos, out_h, out_w)
    return shear_warp_reference(images, pos)


@shear_warp_op.register_kernel("cuda")
def _shear_warp_cuda(images, swap, p_a, s_a, p_b, s_b, out_h, out_w):
    """The operator on a CUDA tensor: the kernel, or a raise."""
    pos = ShearPositions(swap, p_a, s_a, p_b, s_b)
    n, s, ch, out_h, out_w = _check(images, pos, out_h, out_w)
    out = torch.empty((n, ch, out_h, out_w), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.shear_warp_launch(
            images.data_ptr(), int(images.dtype == torch.uint8),
            p_a.data_ptr(), s_a.data_ptr(), p_b.data_ptr(), s_b.data_ptr(),
            swap.data_ptr(), out.data_ptr(), n, s, ch, out_h, out_w, stream)
    if err != 0:
        raise RuntimeError(f"shear_warp kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(shear_warp)
    return out


@shear_warp_op.register_fake
def _shear_warp_fake(images, swap, p_a, s_a, p_b, s_b, out_h, out_w):
    return images.new_empty((images.shape[0], images.shape[3], out_h, out_w),
                            dtype=torch.float32)


def shear_warp(images: torch.Tensor, pos: ShearPositions) -> torch.Tensor:
    """One-pass shear warp through the operator; see the module docstring.
    A tensor on neither a CUDA device nor the CPU raises."""
    if not isinstance(pos, ShearPositions):
        raise TypeError("pos must be shear_prepare's ShearPositions")
    out_w, out_h = pos.p_a.shape[-1], pos.p_b.shape[-1]
    _check(images, pos, out_h, out_w)
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no shear-warp kernel for device {images.device}")
    return torch.ops.rsgnet_tpu_torch.shear_warp(images, *pos, out_h, out_w)


shear_warp.launches = 0
