"""Inputs made from the seed: uint8 canvases and crops (drawn on the
device in one call, then kept in pinned host memory as the traffic's
source), boxes, joints and the augmentation's random draws. Every seed
gives the same sizes; the seed changes only the values."""
from __future__ import annotations

import numpy as np
import torch

DRAW_KEYS = ("half_body_side", "half_body_gate", "scale", "rot", "rot_gate",
             "flip")
_NORMAL = ("half_body_side", "scale", "rot")


def rng(seed, *stream):
    """NumPy generator for one stream of the seed (any size of int)."""
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


def pinned_uint8(seed, stream, shape, device):
    """A seeded uint8 array of ``shape`` drawn on ``device`` and held in
    pinned host memory (on the CPU: ordinary memory)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + stream) % 2 ** 63)
    t = torch.randint(0, 256, shape, generator=gen, device=device,
                      dtype=torch.uint8)
    host = t.cpu()
    del t
    return host.pin_memory() if torch.device(device).type == "cuda" else host


def boxes(r, n, lo=200.0, hi=440.0):
    """(centers, scales) float32 (n, 2): centers uniform in [lo, hi),
    boxes 0.8-1.5 x 200 px tall at the 3:4 width of a person box (the
    program's bench draws these ranges)."""
    centers = r.uniform(lo, hi, (n, 2)).astype(np.float32)
    scales = np.stack([r.uniform(0.8, 1.5, n) * 0.75,
                       r.uniform(0.8, 1.5, n)], -1).astype(np.float32)
    return centers, scales


def joints(r, n, k, lo=150.0, hi=450.0, visible=0.8):
    """(joints (n, k, 2), visibility (n, k)) float32."""
    j = r.uniform(lo, hi, (n, k, 2)).astype(np.float32)
    v = (r.uniform(size=(n, k)) < visible).astype(np.float32)
    return j, v


def draws(seed, step, n):
    """The augmentation's six random numbers per sample for one step:
    normals for the half-body side, the scale and the rotation, uniforms
    for the two gates and the flip ((n,) float32 each, on the host)."""
    gen = torch.Generator().manual_seed((int(seed) * 7919 + step) % 2 ** 63)
    return {k: (torch.randn if k in _NORMAL else torch.rand)(
        n, generator=gen, dtype=torch.float32) for k in DRAW_KEYS}


def truncated_geometric_sizes(count, mean, top):
    """``count`` request sizes in 1..top: the quantiles of a geometric
    distribution of the given mean truncated at ``top``, so that every
    seed sends the same multiset of sizes (in its own order)."""
    p = 1.0 / mean
    ks = np.arange(1, top + 1)
    pmf = p * (1 - p) ** (ks - 1)
    cdf = np.cumsum(pmf / pmf.sum())
    q = (np.arange(count) + 0.5) / count
    return ks[np.searchsorted(cdf, q)]
