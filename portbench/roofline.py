"""The yardstick's arithmetic: the chip's published peaks, the work of the
whole model counted on the reference architecture, and the bytes each
hand-written kernel must move, all from shapes (and, for the shear warp,
the matrices), never from what the program executes."""
from __future__ import annotations

import functools
import json

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3, fp32 without
# tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12


@functools.lru_cache(maxsize=8)
def _model_flops(model_json, train):
    """FLOPs of one image through the reference model (forward, or
    forward and backward in train mode), counted by torch's FLOP counter
    on meta tensors: 2 a multiply-add of every conv, matmul and einsum."""
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference.model import PoseRSGNet
    from portbench.reference.pipeline import COCO_SKELETON
    m = json.loads(model_json)
    w, h = m["image_size"]
    n = 2
    with torch.device("meta"):
        net = PoseRSGNet(m, COCO_SKELETON)
        x = torch.empty(n, 3, h, w)
        with FlopCounterMode(display=False) as fc:
            if train:
                final, initial = net.train()(x)
                (final.sum() + initial.sum()).backward()
            else:
                with torch.no_grad():
                    net.eval()(x)
    return fc.get_total_flops() / n


def model_flops(model_cfg, train=False):
    return _model_flops(json.dumps(model_cfg, sort_keys=True), train)


def dark_decode_bytes(n, k, h, w):
    """DARK decode of (n, k, h, w) fp32 maps: each map read once, x, y and
    the peak written once."""
    return n * k * h * w * 4 + n * k * 3 * 4


def dark_decode_flops(n, k, h, w, blur):
    """The blur's multiply-adds: two passes of ``blur`` taps a pixel."""
    return n * k * h * w * 2 * blur * 2


def shear_warp_bytes(size, trans, out_size, channels=3, src_bytes=1):
    """Least bytes of the two-pass shear warp of (N, size, size, channels)
    sources with src->dst matrices ``trans`` (N, 2, 3): the fp32 output
    written once plus every source pixel that a nonzero-weight tap of
    either pass reaches, read once (as chip_smoke.py::shear_bound_ms
    counts them). Returns (total bytes, source-footprint bytes)."""
    ow, oh = int(out_size[0]), int(out_size[1])
    t = trans.double()
    a, b, c = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    d, e, f = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    det = a * e - b * d
    m = torch.stack([torch.stack([e, -b, b * f - c * e], -1),
                     torch.stack([-d, a, c * d - a * f], -1)], 1) \
        / det[:, None, None]
    m = m.float()
    swap = m[:, 1, 1].abs() < m[:, 1, 0].abs()
    m = torch.where(swap[:, None, None], m.flip(1), m)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    xs = torch.arange(ow, dtype=torch.float32)
    rs = torch.arange(size, dtype=torch.float32)
    ys = torch.arange(oh, dtype=torch.float32)
    p_a = (m00 - m01 * m10 / m11)[:, None] * xs
    s_a = (m01 / m11)[:, None] * rs + (m02 - m01 * m12 / m11)[:, None]
    p_b = m11[:, None] * ys + m12[:, None]
    s_b = m10[:, None] * xs
    n = trans.shape[0]

    def split(p, s):
        pf, sf = torch.floor(p), torch.floor(s)
        phi = (p - pf) + (s - sf)
        w0 = torch.clamp_min(1.0 - phi, 0.0)
        w2 = torch.clamp_min(phi - 1.0, 0.0)
        return (pf + sf).long(), (w0, 1.0 - w0 - w2, w2)

    base_b, wb = split(p_b[:, :, None], s_b[:, None, :])       # (N, oh, ow)
    seen = torch.zeros(n, size * size, dtype=torch.bool)
    bidx = torch.arange(n)[:, None, None].expand(n, oh, ow)
    for j in range(3):
        r = base_b + j
        ok_b = (wb[j] > 0) & (r >= 0) & (r < size)
        rc = r.clamp(0, size - 1)
        pa = p_a[:, None, :].expand(n, oh, ow)
        sa = torch.gather(s_a, 1, rc.reshape(n, -1)).reshape(rc.shape)
        base_a, wa = split(pa, sa)
        for i in range(3):
            col = base_a + i
            ok = ok_b & (wa[i] > 0) & (col >= 0) & (col < size)
            flat = rc * size + col.clamp(0, size - 1)
            seen[bidx[ok], flat[ok]] = True
    src = int(seen.sum()) * channels * src_bytes
    return src + n * channels * oh * ow * 4, src
