"""Image normalization, affine warps, the eval crop and the warp resolvers
(the port of the JAX package's ``ops/warp.py``).

- ``host_affine_crop`` is ``cv2.warpAffine`` (INTER_LINEAR, constant-0
  border) when cv2 is importable, else ``warp_affine_np``, the same sampling
  in NumPy.
- ``affine_warp_batch`` is the exact bilinear gather with the same
  semantics, batched in torch on any device: ``TRAIN.WARP=gather``,
  ``TEST.WARP=gather`` and non-square train sources take it.
- ``separable_warp_batch`` is the rotation-free eval warp as two fp32
  batched matmuls (``TEST.WARP`` "separable", the default, and "auto").
  JAX runs its einsums at ``Precision.HIGHEST``; here TF32 must be off
  (``core/inference.py::configure_precision``), or the crops move by ~0.1
  on the 0-255 scale.
- ``crop_and_normalize`` is the eval crop: warp, optional horizontal flip
  of the crop, ImageNet normalization, channels first for the model.
  ``TEST.WARP`` "shear" and "pallas" run the shear warp, on a CUDA tensor
  its hand-written kernel (``ops/cuda/shear_warp.py``).
- ``resolve_train_warp`` maps TRAIN.WARP to "shear" (the two-pass shear
  warp of ``ops/shear_warp.py``; its CUDA kernel on a CUDA tensor) or
  "gather"; ``resolve_eval_warp`` validates TEST.WARP.
"""
from __future__ import annotations

import numpy as np
import torch

try:
    import cv2 as _cv2
except ImportError:      # pragma: no cover - exercised where cv2 is absent
    _cv2 = None

# ImageNet normalization constants used by the whole HRNet family (RGB).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(image: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD, channels_first=False) -> torch.Tensor:
    """(pix/255 - mean) / std on a float32 channels-last tensor, or on a
    (N, C, H, W) one with ``channels_first``. ``mean`` and ``std`` are
    values, filled on the image's device at each call (a host tensor
    copied to the card would make the host wait for the stream), or
    float32 tensors already there (``core/inference.py::DevicePipeline``
    keeps them as buffers, so its calls fill none)."""
    shape = (-1, 1, 1) if channels_first else (-1,)

    def const(values):
        if isinstance(values, torch.Tensor):
            return values.reshape(shape)
        return torch.stack([torch.full((), v, dtype=torch.float32,
                                       device=image.device)
                            for v in values]).reshape(shape)

    return (image / 255.0 - const(mean)) / const(std)


def invert_affine(trans: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices in closed form, elementwise fp32
    (no solve: nothing waits on the host)."""
    a, b, c = trans[..., 0, 0], trans[..., 0, 1], trans[..., 0, 2]
    d, e, f = trans[..., 1, 0], trans[..., 1, 1], trans[..., 1, 2]
    inv_det = 1.0 / (a * e - b * d)
    ia = e * inv_det
    ib = -b * inv_det
    id_ = -d * inv_det
    ie = a * inv_det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    return torch.stack([torch.stack([ia, ib, ic], dim=-1),
                        torch.stack([id_, ie, if_], dim=-1)], dim=-2)


def affine_warp_batch(images: torch.Tensor, trans: torch.Tensor,
                      out_size) -> torch.Tensor:
    """Exact batched affine warp (cv2.warpAffine INTER_LINEAR,
    BORDER_CONSTANT 0): for every output pixel, the 4-tap bilinear sample
    of the source at ``inv(trans) @ (x, y, 1)``.

    images: (N, H, W, C) any dtype, read in that dtype and cast per tap;
    trans: (N, 2, 3) src->dst; out_size: (out_w, out_h). Returns
    (N, C, out_h, out_w) float32, channels first for the model.
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    n, h, w, _ = images.shape
    inv = invert_affine(trans.to(torch.float32))[:, :, :, None, None]
    dev = images.device
    dst_x = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    dst_y = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    src_x = inv[:, 0, 0] * dst_x + inv[:, 0, 1] * dst_y + inv[:, 0, 2]
    src_y = inv[:, 1, 0] * dst_x + inv[:, 1, 1] * dst_y + inv[:, 1, 2]
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    batch = torch.arange(n, device=dev)[:, None, None]

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = images[batch, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals.to(torch.float32), 0.0)

    top = tap(y0i, x0i) * (1.0 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1.0 - wx) + tap(y0i + 1, x0i + 1) * wx
    out = top * (1.0 - wy) + bot * wy
    return out.permute(0, 3, 1, 2).contiguous()


def _bilinear_resample_matrix(starts, steps, out_n: int, src_n: int):
    """Batched (N, out_n, src_n) bilinear weights: row i holds the two-tap
    weights ``max(0, 1 - |c_i - u|)`` of source coordinate ``c_i = starts +
    i * steps`` (per sample); a coordinate outside the source gets a zero
    row (BORDER_CONSTANT 0, as the gather)."""
    dev = starts.device
    i = torch.arange(out_n, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(src_n, dtype=torch.float32, device=dev)[None, :]
    coords = starts[:, None, None] + i * steps[:, None, None]
    return torch.clamp_min(1.0 - torch.abs(coords - u), 0.0)


def separable_warp_batch(images: torch.Tensor, trans: torch.Tensor,
                         out_size) -> torch.Tensor:
    """Axis-separable affine warp for rotation-free transforms (zero cross
    terms, as every ``get_affine_transform(center, scale, rot=0)``): a
    row-weight matmul, then a column-weight one, in fp32.

    images: (N, H, W, C) any dtype, cast to float32; trans: (N, 2, 3)
    src->dst on the images' device; out_size: (out_w, out_h). Returns
    (N, C, out_h, out_w) float32, equal to ``affine_warp_batch`` up to the
    matmuls' summation order.
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    n, src_h, src_w, ch = images.shape
    inv = invert_affine(trans.to(torch.float32))
    # src_x = inv[0,0]*dst_x + inv[0,2];  src_y = inv[1,1]*dst_y + inv[1,2]
    wx = _bilinear_resample_matrix(inv[:, 0, 2], inv[:, 0, 0], out_w, src_w)
    wy = _bilinear_resample_matrix(inv[:, 1, 2], inv[:, 1, 1], out_h, src_h)
    img = images.to(torch.float32).reshape(n, src_h, src_w * ch)
    rows = torch.bmm(wy, img).reshape(n, out_h, src_w, ch)   # (N, oh, W, C)
    rows = rows.permute(0, 3, 1, 2).reshape(n, ch * out_h, src_w)
    out = torch.bmm(rows, wx.transpose(1, 2))                # (N, C*oh, ow)
    return out.reshape(n, ch, out_h, out_w)


def resolve_train_warp(warp: str) -> str:
    """TRAIN.WARP -> "shear" or "gather".

    "auto", "pallas" and "shear" all name the two-pass shear warp: on a
    CUDA tensor its hand-written kernel (``ops/cuda/shear_warp.py``), on a
    CPU tensor its plain version. "gather" is the exact 4-tap warp
    (``affine_warp_batch``), which non-square sources take too.
    """
    if warp in ("auto", "pallas", "shear"):
        return "shear"
    if warp == "gather":
        return "gather"
    raise ValueError(f"TRAIN.WARP={warp!r}: expected auto|pallas|shear|gather")


def resolve_eval_warp(warp: str, name: str = "warp") -> str:
    """Resolve a TEST.WARP value to a sampler name: "auto" is "separable";
    "gather", "separable", "shear" and "pallas" name themselves."""
    if warp == "auto":
        return "separable"
    if warp not in ("gather", "separable", "shear", "pallas"):
        raise ValueError(f"{name}={warp!r}: expected "
                         "auto|separable|shear|pallas|gather")
    return warp


def crop_and_normalize(images: torch.Tensor, trans: torch.Tensor, out_size,
                       flip=None, warp="separable", mean=IMAGENET_MEAN,
                       std=IMAGENET_STD) -> torch.Tensor:
    """The eval crop: warp -> (optional horizontal flip) -> normalize.

    images: (N, H, W, 3) uint8 or float32 source canvases; trans: (N, 2, 3)
    src->dst matrices on the images' device; out_size: (out_w, out_h).
    flip: optional (N,) bool, mirrors the *cropped* output. ``warp`` is a
    TEST.WARP value ("auto" | "gather" | "separable" | "shear" | "pallas",
    by default "separable", TEST.WARP's own default). "shear" and
    "pallas" need a square source and take "separable" otherwise (all
    three are exact-footprint at rot 0, the only case eval produces); both
    run the shear warp's CUDA kernel on a CUDA tensor and its plain version
    on a CPU tensor. ``mean``, ``std``: as ``normalize_image`` takes them.

    Returns (N, 3, out_h, out_w) float32 normalized model inputs.
    """
    warp = resolve_eval_warp(warp)
    if warp in ("shear", "pallas") and images.shape[1] != images.shape[2]:
        warp = "separable"
    if warp in ("shear", "pallas"):
        from rsgnet_tpu_torch.ops.cuda.shear_warp import shear_warp
        from rsgnet_tpu_torch.ops.shear_warp import shear_prepare
        pos = shear_prepare(trans, images.shape[1], out_size)
        crops = shear_warp(images.contiguous(), pos)
    elif warp == "separable":
        crops = separable_warp_batch(images, trans, out_size)
    else:
        crops = affine_warp_batch(images, trans, out_size)
    if flip is not None:
        flip = torch.as_tensor(flip, dtype=torch.bool, device=crops.device)
        crops = torch.where(flip[:, None, None, None],
                            torch.flip(crops, dims=(3,)), crops)
    return normalize_image(crops, mean, std, channels_first=True)


def warp_affine_np(img, trans, out_size):
    """NumPy ``cv2.warpAffine`` equivalent: INTER_LINEAR, constant-0 border.

    img: (H, W, C) or (H, W); trans: (2, 3) src->dst; out_size: (w, h).
    Returns (out_h, out_w[, C]) float32, zeros outside the source.
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    m = np.vstack([np.asarray(trans, np.float64), [0.0, 0.0, 1.0]])
    minv = np.linalg.inv(m)
    xs = np.arange(out_w, dtype=np.float64)[None, :]
    ys = np.arange(out_h, dtype=np.float64)[:, None]
    src_x = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    src_y = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    x0 = np.floor(src_x).astype(np.int64)
    y0 = np.floor(src_y).astype(np.int64)
    fx = (src_x - x0).astype(np.float32)
    fy = (src_y - y0).astype(np.float32)
    h, w = img.shape[:2]
    flat = np.ascontiguousarray(img, dtype=np.float32).reshape(h, w, -1)
    out = np.zeros((out_h, out_w, flat.shape[2]), np.float32)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            vals = flat[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            out += (wx * wy * valid)[..., None] * vals
    return out.reshape((out_h, out_w) + img.shape[2:])


def host_affine_crop(img, trans, out_size):
    """Crop/warp one host image to ``out_size`` (w, h). uint8 in -> uint8
    out (rounded like cv2's fixed-point path); float in -> float32 out."""
    size = (int(out_size[0]), int(out_size[1]))
    if _cv2 is not None:
        return _cv2.warpAffine(img, np.asarray(trans, np.float64), size,
                               flags=_cv2.INTER_LINEAR)
    out = warp_affine_np(img, trans, size)
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
