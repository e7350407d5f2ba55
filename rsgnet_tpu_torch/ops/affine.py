"""Affine geometry: center/scale/rot <-> 2x3 transforms, point mapping.

Two flavors, as in the JAX package's ``ops/affine.py``:

- NumPy host functions (``get_affine_transform``, ``box_to_center_scale``):
  the reference 3-point construction with HRNet's ``pixel_std = 200``, solved
  in float64 like ``cv2.getAffineTransform``.
- Batched torch functions (``get_affine_transform_t``,
  ``rot0_transform_t``, ``transform_preds``): float32 throughout. Points are mapped with elementwise fp32 products and
  sums, never a matmul, so TF32 cannot touch the coordinates (the JAX side
  pins its einsum to HIGHEST precision for the same reason).
"""
from __future__ import annotations

import numpy as np
import torch

PIXEL_STD = 200.0


# ---------------------------------------------------------------------------
# NumPy host implementations
# ---------------------------------------------------------------------------

def get_dir(src_point, rot_rad):
    """Rotate a 2-vector by ``rot_rad`` radians (reference `get_dir`)."""
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn,
         src_point[0] * sn + src_point[1] * cs],
        dtype=np.float32,
    )


def get_3rd_point(a, b):
    """Third point completing a right angle at ``b``."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src, dst):
    """Exact 2x3 affine mapping src[i] -> dst[i] for 3 point pairs
    (the 6x6 system cv2.getAffineTransform solves)."""
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros((6,), dtype=np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1.0
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i][0]
        b[2 * i + 1] = dst[i][1]
    return np.linalg.solve(a, b).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv=0):
    """Build the 2x3 crop transform (reference `get_affine_transform`).

    center: (2,) box center in source pixels; scale: (2,) box size / 200
    (a scalar is promoted to an isotropic pair); rot in degrees;
    output_size: (w, h). Returns a float64 (2, 3) src->dst matrix, or
    dst->src when ``inv``.
    """
    center = np.asarray(center, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    scale_tmp = scale * PIXEL_STD
    src_w = scale_tmp[0]
    dst_w = float(output_size[0])
    dst_h = float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = get_dir([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], dtype=np.float32) + dst_dir
    src[2, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def box_to_center_scale(box, aspect_ratio, scale_padding=1.25):
    """COCO bbox [x, y, w, h] -> (center, scale): aspect fixed to the model
    input's, divided by pixel_std 200, padded by ``scale_padding``."""
    x, y, w, h = box[:4]
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD], dtype=np.float32)
    if center[0] != -1:
        scale = scale * scale_padding
    return center, scale


# ---------------------------------------------------------------------------
# Batched torch implementations
# ---------------------------------------------------------------------------

def _rot90(d):
    return torch.stack([-d[..., 1], d[..., 0]], dim=-1)


def get_affine_transform_t(center, scale, rot_deg, output_size, inv=False):
    """Batched 2x3 crop transforms.

    center, scale: (..., 2) float32 tensors; rot_deg: (...,) degrees;
    output_size: static (w, h). Returns (..., 2, 3) float32 on the inputs'
    device. The 3x3 system is solved by LU with partial pivoting, as
    ``jnp.linalg.solve``, through ``torch.linalg.solve_ex`` without its
    error check, so a solve on a CUDA tensor never waits on the host (a
    singular system gives non-finite entries instead of raising). The
    train path solves on the CPU, where the joints arrive, and copies the
    (N, 2, 3) result to the card; the eval paths solve their crop
    transforms where the canvases lie (``core/inference.py::
    DevicePipeline``).
    """
    center = center.to(torch.float32)
    scale = scale.to(torch.float32)
    rot_deg = rot_deg.to(torch.float32)
    scale_tmp = scale * PIXEL_STD
    src_w = scale_tmp[..., 0]
    dst_w = float(output_size[0])
    dst_h = float(output_size[1])

    rot_rad = torch.pi * rot_deg / 180.0
    sn, cs = torch.sin(rot_rad), torch.cos(rot_rad)
    sp_x, sp_y = torch.zeros_like(src_w), src_w * -0.5
    src_dir = torch.stack([sp_x * cs - sp_y * sn, sp_x * sn + sp_y * cs],
                          dim=-1)
    # the constant points are filled on the inputs' device: a host tensor
    # copied to the card would make the host wait for the stream
    dst_dir = torch.stack([sp_x, torch.full_like(src_w, dst_w * -0.5)],
                          dim=-1)

    src0 = center                       # no shift on the eval path
    src1 = src0 + src_dir
    src2 = src1 + _rot90(src0 - src1)
    dst0 = torch.stack([torch.full_like(src_w, dst_w * 0.5),
                        torch.full_like(src_w, dst_h * 0.5)], dim=-1)
    dst1 = dst0 + dst_dir
    dst2 = dst1 + _rot90(dst0 - dst1)

    src = torch.stack([src0, src1, src2], dim=-2)      # (..., 3, 2)
    dst = torch.stack([dst0, dst1, dst2], dim=-2)
    if inv:
        src, dst = dst, src
    a = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)   # (..., 3, 3)
    return torch.linalg.solve_ex(a, dst, check_errors=False)[0] \
        .transpose(-1, -2)


def rot0_transform_t(center, scale, output_size, inv=False):
    """Batched rotation-free 2x3 crop transforms in closed form: the
    3-point construction with rot 0 is an isotropic scale ``s = w_dst /
    (scale_x * 200)`` about the center, so src->dst is ``[[s, 0, w_dst/2 -
    s*cx], [0, s, h_dst/2 - s*cy]]`` and dst->src (``inv``) the same with
    ``1/s`` about the output's center.

    center, scale: (N, 2) float32 tensors; output_size: static (w, h).
    Returns (N, 2, 3) float32 on the inputs' device. Every entry is a few
    elementwise fp32 operations (``rot0_scale_shift``), so the CPU and the
    card give the same bits. ``get_affine_transform_t`` solves the same
    system by LU and agrees to a few ulps.
    """
    s, shift = rot0_scale_shift(center, scale, output_size, inv)
    zero = torch.zeros_like(s)
    return torch.stack([torch.stack([s, zero, shift[:, 0]], dim=-1),
                        torch.stack([zero, s, shift[:, 1]], dim=-1)], dim=-2)


def rot0_scale_shift(center, scale, output_size, inv=False):
    """``rot0_transform_t`` as its parts: the scale s (N,) and the shift
    (N, 2), so a point maps to ``s * p + shift``."""
    center = center.to(torch.float32)
    src_w = scale.to(torch.float32)[:, 0] * PIXEL_STD
    # the output's half width and height, filled on the inputs' device
    half = torch.full_like(center, float(output_size[0]) * 0.5)
    half[:, 1].fill_(float(output_size[1]) * 0.5)
    # a tensor divisor: the card divides by a Python scalar as a product
    # with its reciprocal, an ulp from the host's quotient
    dst_w = torch.full_like(src_w, float(output_size[0]))
    if inv:
        s = src_w / dst_w
        return s, center - s[:, None] * half
    s = dst_w / src_w
    return s, half - s[:, None] * center


def affine_apply(pts, t):
    """Apply (..., 2, 3) transforms to (..., 2) points in elementwise fp32
    (the JAX package's ``affine_transform_jax``)."""
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([
        t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2],
        t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2]], dim=-1)


def transform_preds(coords, center, scale, output_size):
    """Heatmap-space coords (N, K, 2) -> image space.

    center, scale: (N, 2) float32 tensors on ``coords``' device.
    output_size: heatmap (w, h). The rot-0 transform's cross terms are 0,
    so each coordinate is ``s * p + shift`` (``rot0_scale_shift``): for
    finite points the bits ``affine_apply`` gives with the 2x3 matrix, in
    nine elementwise kernels on the card instead of twenty.
    """
    s, shift = rot0_scale_shift(center, scale, output_size, inv=True)
    return coords * s[:, None, None] + shift[:, None]
