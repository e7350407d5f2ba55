"""Heatmap decoding: argmax peaks, quarter-pixel shift, and DARK sub-pixel.

Heatmaps are NCHW ``(N, K, H, W)`` float32 throughout.

- ``get_max_preds``: per-map argmax over the flattened map (first match, as
  ``np.argmax``), coords ``(x, y) = (idx % W, idx // W)``, zeroed where
  ``maxval <= 0``.
- ``quarter_offset``: the reference POST_PROCESS, 0.25 px toward the larger
  neighbor on each axis (only when ``1 < p < size - 1``).
- DARK (``dark_gaussian_blur`` + ``dark_refine``): cv2-style Gaussian blur
  with zero-filled borders, per-map max renormalization, ``clip(1e-10, 50)``
  and ``log``, then one Newton step ``-H^{-1} grad`` at the integer peak,
  taken only when ``1 < p < size - 2`` and the Hessian is invertible.

``dark_decode_reference`` (argmax + DARK refine) is the plain version of the
CUDA kernel in ``csrc/dark_decode.cu``: its blur is the kernel's tap loop
written as shifted elementwise sums, in the same order, so both round alike.
``get_final_preds`` reaches DARK only through ``ops.cuda.dark_decode``, which
sends CUDA tensors to the kernel and CPU tensors here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rsgnet_tpu_torch.ops.affine import transform_preds


def get_max_preds(heatmaps):
    """Batched argmax decode. Returns coords (N, K, 2) xy float32 and
    maxvals (N, K, 1)."""
    n, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, k, h * w)
    maxvals = flat.amax(dim=2, keepdim=True)
    idx = torch.argmax(flat, dim=2)          # first maximal index
    preds = torch.stack([(idx % w).to(torch.float32),
                         torch.div(idx, w, rounding_mode="floor")
                         .to(torch.float32)], dim=-1)
    return preds * (maxvals > 0.0).to(torch.float32), maxvals


def _gather_nk(hm, py, px):
    """hm[n, k, py[n,k], px[n,k]] -> (N, K), indices clamped to the map."""
    n, k, h, w = hm.shape
    lin = py.clamp(0, h - 1) * w + px.clamp(0, w - 1)
    return torch.gather(hm.reshape(n, k, h * w), 2, lin[..., None])[..., 0]


def quarter_offset(heatmaps, coords):
    """The reference POST_PROCESS: +-0.25 px toward the larger neighbor."""
    n, k, h, w = heatmaps.shape
    px = torch.floor(coords[..., 0] + 0.5).to(torch.int64)
    py = torch.floor(coords[..., 1] + 0.5).to(torch.int64)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    diff_x = _gather_nk(heatmaps, py, px + 1) - _gather_nk(heatmaps, py, px - 1)
    diff_y = _gather_nk(heatmaps, py + 1, px) - _gather_nk(heatmaps, py - 1, px)
    delta = torch.stack([torch.sign(diff_x), torch.sign(diff_y)], dim=-1) * 0.25
    return coords + delta * ok[..., None].to(torch.float32)


# cv2.getGaussianKernel(ksize, sigma<=0) takes ksize 1/3/5/7 from fixed
# tables (OpenCV's small_gaussian_tab), not from the sigma formula.
_CV2_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125], np.float32),
}


def _cv2_gaussian_kernel_1d(ksize):
    """cv2.getGaussianKernel(ksize, sigma=0) coefficients as float32."""
    if ksize in _CV2_SMALL_GAUSSIAN_TAB:
        return _CV2_SMALL_GAUSSIAN_TAB[ksize]
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _blur_pass(x, k1d, dim):
    """Zero-fill 1-D tap sum along ``dim`` (3 = x, 2 = y):
    out[i] = sum_t k[t] * x[i - (t - r)], accumulated for t = 0..ks-1."""
    ks = len(k1d)
    r = (ks - 1) // 2
    size = x.shape[dim]
    pad = (r, r, 0, 0) if dim == 3 else (0, 0, r, r)
    xp = F.pad(x, pad)
    acc = torch.zeros_like(x)
    for t in range(ks):
        # tap offset d = t - r reads x[i - d] = xp[i - d + r] = xp[i + ks-1-t]
        acc = acc + float(k1d[t]) * xp.narrow(dim, ks - 1 - t, size)
    return acc


def dark_gaussian_blur(heatmaps, kernel):
    """DARK's modulation blur: zero-fill separable Gaussian (x pass, then y
    pass) and per-map max renormalization to the raw peak."""
    k1d = _cv2_gaussian_kernel_1d(kernel)
    origin_max = heatmaps.amax(dim=(2, 3), keepdim=True)
    x = _blur_pass(heatmaps, k1d, 3)
    x = _blur_pass(x, k1d, 2)
    new_max = x.amax(dim=(2, 3), keepdim=True)
    return x * (origin_max / torch.clamp(new_max, min=1e-20))


def dark_refine(heatmaps, coords, blur_kernel=11):
    """DARK Taylor refinement of integer peaks (batched Newton step)."""
    n, k, h, w = heatmaps.shape
    hm = torch.log(torch.clamp(dark_gaussian_blur(heatmaps, blur_kernel),
                               1e-10, 50.0))
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)
    ok = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)

    def g(dy, dx):
        return _gather_nk(hm, py + dy, px + dx)

    dx = 0.5 * (g(0, 1) - g(0, -1))
    dy = 0.5 * (g(1, 0) - g(-1, 0))
    c = g(0, 0)
    dxx = 0.25 * (g(0, 2) - 2.0 * c + g(0, -2))
    dyy = 0.25 * (g(2, 0) - 2.0 * c + g(-2, 0))
    dxy = 0.25 * (g(1, 1) - g(-1, 1) - g(1, -1) + g(-1, -1))

    det = dxx * dyy - dxy * dxy
    ok = ok & (det != 0.0)
    inv_det = torch.where(det == 0.0, torch.zeros_like(det), 1.0 / det)
    off_x = -(dyy * dx - dxy * dy) * inv_det
    off_y = -(-dxy * dx + dxx * dy) * inv_det
    offset = torch.stack([off_x, off_y], dim=-1)
    return coords + offset * ok[..., None].to(torch.float32)


def dark_decode_reference(heatmaps, blur_kernel=11):
    """Plain version of the CUDA DARK kernel: (coords (N, K, 2) heatmap-space
    xy, Taylor-refined; maxvals (N, K, 1))."""
    coords, maxvals = get_max_preds(heatmaps)
    return dark_refine(heatmaps, coords, blur_kernel), maxvals


def get_final_preds(heatmaps, center, scale, *, post_process=True,
                    use_dark=False, blur_kernel=11):
    """Full decode: peaks -> sub-pixel refinement -> image coordinates.

    DARK replaces the quarter-offset when enabled; ``post_process=False`` is
    the raw-argmax ablation and bypasses DARK too. center/scale: (N, 2)
    float32 tensors on the heatmaps' device.
    Returns preds (N, K, 2) in image coords and maxvals (N, K, 1).
    """
    use_dark = use_dark and post_process
    if use_dark:
        from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
        coords, maxvals = dark_decode(heatmaps, blur_kernel)
    else:
        coords, maxvals = get_max_preds(heatmaps)
        if post_process:
            coords = quarter_offset(heatmaps, coords)
    h, w = heatmaps.shape[2], heatmaps.shape[3]
    return transform_preds(coords, center, scale, (w, h)), maxvals
