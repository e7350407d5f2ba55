"""The hand-written ConvBN epilogue (csrc/convbn_epilogue.cu) as the operator
``torch.ops.rsgnet_tpu_torch.convbn_epilogue``.

``convbn_epilogue(y, weight, bias, running_mean, running_var, eps, addend,
relu)`` is an eval-mode BatchNorm of a conv's output ``y`` (N, C, H, W),
bf16 or fp32, dense in NCHW or channels-last order, with its running
statistics, then ``+ addend`` (a block's fp32 residual, optional), then
ReLU (optional), in fp32 and in ``y``'s order: what
``models/hrnet.py::BatchNorm`` computes in eval mode, in one pass over
``y`` where the plain chain made up to four (upcast, BatchNorm, add,
ReLU). It replaces no TPU kernel: the JAX package leaves the chain to
XLA's fusion.

The operator is a ``torch.library`` custom op, ``(Tensor y, Tensor weight,
Tensor bias, Tensor running_mean, Tensor running_var, Tensor? addend,
float eps, bool relu) -> Tensor`` (fp32, ``y``'s shape and strides), with two
implementations and nothing else dispatching: on a CUDA tensor the
kernel, launched on PyTorch's current stream, and anything the kernel
refuses raises; on a CPU tensor the plain version,
``convbn_epilogue_reference``. Its fake implementation gives the output's
shape from symbolic input shapes, so ``torch.export`` records one call of
the operator where the eager path launches the kernel.

``convbn_epilogue.launches`` counts the kernel's launches that ran, as
``dark_decode.launches`` does (``ops/cuda/__init__.py``: ``count_launch``;
inside a CUDA graph's capture each replay adds them). A call launches the
kernel once at every shape of the port's models.

Its backward is the plain chain's formula
(``torch.library.register_autograd``), so an eval forward with gradients
on runs the kernel too and differentiates as the plain chain does.
``models/hrnet.py::BatchNorm`` calls the operator for every eval-mode
tensor off the CPU, and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from rsgnet_tpu_torch.ops.cuda import count_launch

DTYPES = (torch.bfloat16, torch.float32)      # the kernel's y


def convbn_epilogue_reference(y, weight, bias, running_mean, running_var,
                              eps, addend=None, relu=False):
    """The plain version: ``y`` in fp32 (float64 kept, the tests' anchor),
    eval ``F.batch_norm`` with the running statistics, ``+ addend``, ReLU:
    the chain the eval forward ran before the kernel, op for op."""
    x = y if y.dtype == torch.float64 else y.float()
    x = F.batch_norm(x, running_mean, running_var, weight, bias, False, 0.0,
                     eps)
    if addend is not None:
        x = x + addend
    return F.relu(x) if relu else x


@functools.lru_cache(maxsize=1)
def _library():
    from rsgnet_tpu_torch.ops.cuda.build import load_library
    lib = load_library("convbn_epilogue")
    ptr = ctypes.c_void_p
    lib.convbn_epilogue_launch.argtypes = [
        ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ptr, ctypes.POINTER(ctypes.c_int)]
    lib.convbn_epilogue_launch.restype = ctypes.c_int
    return lib


def _check(y, weight, bias, running_mean, running_var, addend):
    if not isinstance(y, torch.Tensor) or y.ndim != 4:
        raise ValueError("y must be a (N, C, H, W) tensor")
    if y.dtype not in DTYPES:
        raise TypeError(f"y must be bfloat16 or float32, got {y.dtype}")
    c = y.shape[1]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {y.device}")
    if addend is not None and (addend.dtype != torch.float32
                               or addend.shape != y.shape
                               or addend.device != y.device):
        raise ValueError("addend must be a float32 tensor of y's shape on "
                         "y's device")
    if y.device.type == "cuda" and not (
            (y.is_contiguous()
             or y.is_contiguous(memory_format=torch.channels_last))
            and (addend is None or addend.stride() == y.stride())):
        raise ValueError("the kernel takes y dense in NCHW or channels-last "
                         "order, and an addend of y's strides")


@torch.library.custom_op("rsgnet_tpu_torch::convbn_epilogue",
                         mutates_args=(), device_types="cpu")
def convbn_epilogue_op(y: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, running_mean: torch.Tensor,
                       running_var: torch.Tensor,
                       addend: Optional[torch.Tensor], eps: float,
                       relu: bool) -> torch.Tensor:
    """The operator on a CPU tensor: the plain version."""
    _check(y, weight, bias, running_mean, running_var, addend)
    return convbn_epilogue_reference(y, weight, bias, running_mean,
                                     running_var, eps, addend, relu)


@convbn_epilogue_op.register_kernel("cuda")
def _convbn_epilogue_cuda(y, weight, bias, running_mean, running_var, addend,
                          eps, relu):
    """The operator on a CUDA tensor: the kernel, or a raise."""
    _check(y, weight, bias, running_mean, running_var, addend)
    out = torch.empty_like(y, dtype=torch.float32)
    if y.numel() == 0:
        return out
    n, c, h, w = y.shape
    lib = _library()
    launches = ctypes.c_int(0)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.convbn_epilogue_launch(
            y.data_ptr(), int(y.dtype == torch.bfloat16),
            None if addend is None else addend.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), out.data_ptr(), n, c, h * w,
            int(not y.is_contiguous()), float(eps), int(relu), stream,
            ctypes.byref(launches))
    for _ in range(launches.value):
        count_launch(convbn_epilogue)
    if err != 0:
        raise RuntimeError(f"convbn_epilogue kernel launch failed: CUDA "
                           f"error {err}")
    return out


@convbn_epilogue_op.register_fake
def _convbn_epilogue_fake(y, weight, bias, running_mean, running_var, addend,
                          eps, relu):
    return torch.empty_like(y, dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    y, weight, _, running_mean, running_var, addend, eps, relu = inputs
    ctx.save_for_backward(y, weight, running_mean, running_var,
                          output if relu else None)
    ctx.eps = eps
    ctx.with_addend = addend is not None


def _backward(ctx, grad):
    """The plain chain's gradients: ReLU's mask from the output, then an
    eval BatchNorm's (the running statistics are constants); y's in y's
    type, as the upcast's backward gives it."""
    y, weight, running_mean, running_var, out = ctx.saved_tensors
    if out is not None:
        grad = grad.masked_fill(out <= 0, 0.0)
    invstd = torch.rsqrt(running_var + ctx.eps)
    per_c = (1, -1, 1, 1)
    need = ctx.needs_input_grad
    grad_y = grad_w = grad_b = None
    if need[0]:
        grad_y = (grad * (weight * invstd).view(per_c)).to(y.dtype)
    if need[1]:
        xhat = (y.float() - running_mean.view(per_c)) * invstd.view(per_c)
        grad_w = (grad * xhat).sum((0, 2, 3))
    if need[2]:
        grad_b = grad.sum((0, 2, 3))
    return (grad_y, grad_w, grad_b, None, None,
            grad if ctx.with_addend else None, None, None)


torch.library.register_autograd("rsgnet_tpu_torch::convbn_epilogue",
                                _backward, setup_context=_setup_context)


def convbn_epilogue(y, weight, bias, running_mean, running_var, eps,
                    addend=None, relu=False):
    """The epilogue through the operator; see the module docstring."""
    return torch.ops.rsgnet_tpu_torch.convbn_epilogue(
        y, weight, bias, running_mean, running_var, addend, float(eps),
        bool(relu))


convbn_epilogue.launches = 0
