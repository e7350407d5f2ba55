"""The hand-written CUDA DARK decode kernel (csrc/dark_decode.cu) as the
operator ``torch.ops.rsgnet_tpu_torch.dark_decode``.

``dark_decode(heatmaps, blur_kernel)`` takes (N, K, H, W) float32 heatmaps
and returns (coords (N, K, 2) heatmap-space xy, Taylor-refined; maxvals
(N, K, 1)); with ``return_peaks=True`` also each map's flat first-match
argmax index (N, K) int32, which lets a check hold the kernel's peaks
against the plain version's.

The operator is a ``torch.library`` custom op, ``(Tensor heatmaps, int
blur_kernel, bool return_peaks) -> (coords, maxvals, peaks)`` (``peaks``
is empty unless asked for), with two implementations and nothing else
dispatching: on a CUDA tensor the kernel, launched on PyTorch's current
stream, and anything the kernel refuses raises; on a CPU tensor the plain
version, ``ops/decode.py::dark_decode_reference``. Its fake
implementation gives the output shapes from symbolic input shapes, so
``torch.export`` records one call of the operator in the graph and an
exported program launches the kernel where the eager path does. The blur
size and ``return_peaks`` are static arguments.

``dark_decode.launches`` counts the kernel's launches that ran: it is raised by
one right after each successful launch and nowhere else, except inside a
CUDA graph's capture, where the launch runs only at the graph's replays:
the capture adds nothing, and each replay adds the launches its graph
holds (``ops/cuda/__init__.py``: ``count_launch``).

The kernel runs one block of ``BLOCK_THREADS`` per map and keeps one copy
of the map in shared memory (``shared_bytes``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rsgnet_tpu_torch.ops.cuda import count_launch
from rsgnet_tpu_torch.ops.decode import (_cv2_gaussian_kernel_1d,
                                         dark_decode_reference)

MAX_BLUR_KERNEL = 31                  # DARK_MAX_KSIZE in the .cu source
MAX_SHARED_BYTES = 232448             # per block on an H100 (227 KB)
_SCRATCH_WORDS = 80                   # DARK_SCRATCH_WORDS in the .cu source
_GROUPS = 4                           # DARK_GROUPS in the .cu source
BLOCK_THREADS = 128                   # DARK_THREADS in the .cu source
MAX_WIDTH = _GROUPS * BLOCK_THREADS   # a round of the x pass holds a row


def shared_bytes(h: int, w: int, blur_kernel: int) -> int:
    """Shared memory of one block: the staged rows, each after a gap of
    round_up(r, 4) zeros and one more gap after the last, then the 5x5
    tile and the reduction words (``dark_decode_shared_bytes`` in C)."""
    gap = ((blur_kernel - 1) // 2 + 3) & ~3
    return 4 * (gap + h * (w + gap) + _SCRATCH_WORDS)


@functools.lru_cache(maxsize=1)
def _library():
    from rsgnet_tpu_torch.ops.cuda.build import load_library
    lib = load_library("dark_decode")
    lib.dark_decode_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
    lib.dark_decode_launch.restype = ctypes.c_int
    lib.dark_decode_max_ksize.restype = ctypes.c_int
    lib.dark_decode_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.dark_decode_shared_bytes.restype = ctypes.c_longlong
    if (lib.dark_decode_max_ksize() != MAX_BLUR_KERNEL
            or any(lib.dark_decode_shared_bytes(h, w, ks)
                   != shared_bytes(h, w, ks)
                   for h, w, ks in ((96, 72, 11), (8, 6, 1), (64, 64, 31)))):
        raise RuntimeError("dark_decode.cu and its wrapper disagree on the "
                           "largest blur kernel or the shared memory")
    return lib


def _check(heatmaps, blur_kernel):
    if not isinstance(heatmaps, torch.Tensor) or heatmaps.ndim != 4:
        raise ValueError("heatmaps must be a (N, K, H, W) tensor")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"heatmaps must be float32, got {heatmaps.dtype}")
    if not heatmaps.is_contiguous():
        raise ValueError("heatmaps must be contiguous (N, K, H, W)")
    if (not isinstance(blur_kernel, int) or blur_kernel < 1
            or blur_kernel % 2 == 0 or blur_kernel > MAX_BLUR_KERNEL):
        raise ValueError(f"blur_kernel must be an odd int in "
                         f"[1, {MAX_BLUR_KERNEL}], got {blur_kernel!r}")


def _empty_peaks(heatmaps, return_peaks):
    n, k = heatmaps.shape[:2]
    return heatmaps.new_empty((n, k) if return_peaks else (0,),
                              dtype=torch.int32)


@torch.library.custom_op("rsgnet_tpu_torch::dark_decode", mutates_args=(),
                         device_types="cpu")
def dark_decode_op(heatmaps: torch.Tensor, blur_kernel: int,
                   return_peaks: bool) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The operator on a CPU tensor: the plain version."""
    _check(heatmaps, blur_kernel)
    coords, maxvals = dark_decode_reference(heatmaps, blur_kernel)
    if return_peaks:
        n, k = heatmaps.shape[:2]
        peaks = torch.argmax(heatmaps.reshape(n, k, -1), dim=2)
        return coords, maxvals, peaks.to(torch.int32)
    return coords, maxvals, _empty_peaks(heatmaps, False)


@dark_decode_op.register_kernel("cuda")
def _dark_decode_cuda(heatmaps, blur_kernel, return_peaks):
    """The operator on a CUDA tensor: the kernel, or a raise."""
    _check(heatmaps, blur_kernel)
    n, k, h, w = heatmaps.shape
    need = shared_bytes(h, w, blur_kernel)
    if h * w == 0 or w > MAX_WIDTH or need > MAX_SHARED_BYTES:
        raise ValueError(f"{h}x{w} maps need {need} B of shared memory per "
                         f"block at blur {blur_kernel}; the kernel holds "
                         f"non-empty maps up to {MAX_WIDTH} wide in at most "
                         f"{MAX_SHARED_BYTES}")
    coords = torch.empty((n, k, 2), dtype=torch.float32,
                         device=heatmaps.device)
    maxvals = torch.empty((n, k, 1), dtype=torch.float32,
                          device=heatmaps.device)
    peaks = _empty_peaks(heatmaps, return_peaks)
    if n * k == 0:
        return coords, maxvals, peaks
    lib = _library()
    taps = (ctypes.c_float * blur_kernel)(
        *_cv2_gaussian_kernel_1d(blur_kernel).tolist())
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream(heatmaps.device).cuda_stream
        err = lib.dark_decode_launch(
            heatmaps.data_ptr(), coords.data_ptr(), maxvals.data_ptr(),
            peaks.data_ptr() if return_peaks else None,
            n * k, h, w, taps, blur_kernel, stream)
    if err != 0:
        raise RuntimeError(f"dark_decode kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(dark_decode)
    return coords, maxvals, peaks


@dark_decode_op.register_fake
def _dark_decode_fake(heatmaps, blur_kernel, return_peaks):
    n, k = heatmaps.shape[:2]
    return (heatmaps.new_empty((n, k, 2)), heatmaps.new_empty((n, k, 1)),
            _empty_peaks(heatmaps, return_peaks))


def dark_decode(heatmaps: torch.Tensor, blur_kernel: int = 11,
                return_peaks: bool = False):
    """Fused DARK decode through the operator; see the module docstring.
    A tensor on neither a CUDA device nor the CPU raises."""
    _check(heatmaps, blur_kernel)
    if heatmaps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no DARK kernel for device {heatmaps.device}")
    coords, maxvals, peaks = torch.ops.rsgnet_tpu_torch.dark_decode(
        heatmaps, blur_kernel, return_peaks)
    return (coords, maxvals, peaks) if return_peaks else (coords, maxvals)


dark_decode.launches = 0
