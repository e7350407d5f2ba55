"""The numbers that decide ``correct``: what the timed path produced
against the plain reference. Each is a percentage; the limits are in
``portbench/limits/<cell>.json``, with the readings they were set from in
PERF.md."""
from __future__ import annotations

import sys

import numpy as np
import torch

# a keypoint within this many heatmap pixels of the reference's has kept
# its argmax (rounding moves a kept one by ~1e-5 px, a moved one by >= 1)
BOX_OFF_PX = 0.5


def pose_numbers(preds, maxvals, ref_preds, ref_maxvals, scales, hm_w):
    """Keypoints against the reference's.

    - ``kpt_gap_q25_px``: the 25th percentile of the keypoints' distances
      from the reference's, in heatmap pixels (scale_x * 200 / hm_w image
      pixels). With random weights the heatmaps are flat enough that the
      configuration's own bfloat16 moves up to about half of the argmaxes
      (the reference run in bfloat16 does the same), so the quartile, not
      the median or a share, is what stays at rounding for the program and
      leaves it under a lower precision or a moved answer;
    - ``boxes_off_pct``: the share of boxes none of whose keypoints lies
      within ``BOX_OFF_PX`` heatmap pixels of the reference's, in %. The
      quartile above passes a fault that touches a minority of the boxes
      (a quarter of a batch, one request of a serving batch); this counts
      the boxes. Rounding moves a box's argmaxes one by one, so a sound
      box keeps some of them at rounding distance (all but ~1 box in 200
      do); a box whose answer was left out, swapped or computed in a
      coarser precision keeps none.

    The peak values are not compared (``pose_diag`` gives their median
    gap): their gaps scale with the random weights' peaks, and the
    program's median on one seed in twelve reads half the control's.

    preds (N, K, 2) image coords, maxvals (N, K, 1), scales (N, 2) boxes."""
    dist, _ = _gaps(preds, maxvals, ref_preds, ref_maxvals, scales, hm_w)
    return {"kpt_gap_q25_px": float(np.percentile(dist, 25)),
            "boxes_off_pct": float(100.0 * np.mean(
                dist.min(axis=1) >= BOX_OFF_PX))}


def pose_check(preds, maxvals, ref_preds, ref_maxvals, scales, hm_w):
    """(``pose_numbers``, ``pose_diag``) of the same outputs."""
    args = (preds, maxvals, ref_preds, ref_maxvals, scales, hm_w)
    return pose_numbers(*args), pose_diag(*args)


def _gaps(preds, maxvals, ref_preds, ref_maxvals, scales, hm_w):
    """(N, K) keypoint distances in heatmap pixels and peak-value gaps."""
    preds, ref_preds = (np.asarray(a, np.float64) for a in (preds, ref_preds))
    mv = np.asarray(maxvals, np.float64).reshape(len(preds), -1)
    rmv = np.asarray(ref_maxvals, np.float64).reshape(len(preds), -1)
    px = np.asarray(scales, np.float64)[:, 0] * 200.0 / hm_w
    dist = np.linalg.norm(preds - ref_preds, axis=-1) / px[:, None]
    dist = np.where(np.isfinite(dist), dist, np.inf)
    floor = max(np.median(np.abs(rmv)), 1e-30)
    gap = np.abs(mv - rmv) / np.maximum(np.abs(rmv), floor)
    return dist, np.where(np.isfinite(gap), gap, np.inf)


def pose_diag(preds, maxvals, ref_preds, ref_maxvals, scales, hm_w):
    """Quantiles of the keypoints' gaps in heatmap pixels, of the peak
    values' relative gaps and of each box's nearest keypoint, for the
    record."""
    dist, gap = _gaps(preds, maxvals, ref_preds, ref_maxvals, scales, hm_w)
    kept = (dist < BOX_OFF_PX).sum(axis=1)
    q = [50, 75, 90, 99]
    return {"n": int(dist.size), "boxes": int(len(dist)),
            "maxval_gap_pct": float(100.0 * np.median(gap)),
            "dist_q": np.round(np.percentile(dist, q), 5).tolist(),
            "off_0.5_2_8": [float(np.mean(dist > t)) for t in (0.5, 2, 8)],
            "maxval_gap_q": np.round(np.percentile(gap, q), 6).tolist(),
            "ref_maxval_q": np.round(np.percentile(
                np.asarray(ref_maxvals, np.float64), [1, 50, 99]),
                6).tolist(),
            "box_kept_min_q10": [int(kept.min()),
                                 float(np.percentile(kept, 10))],
            "box_nearest_px_max": float(np.round(dist.min(axis=1).max(), 6))}


def leaf_gaps(prog, ref):
    """Per leaf | |prog_i| - |ref_i| | / max(|ref_i|, median_j |ref_j|): a
    gap of norms, not the norm of a difference, against the leaf's own
    norm or the median leaf's, whichever is larger (some gradients are all
    but zero)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    gap = np.abs(prog - ref) / np.maximum(ref, max(np.median(ref), 1e-30))
    return np.where(np.isfinite(gap), gap, np.inf)


def train_numbers(prog, ref):
    """Training, in %:

    - ``grad1_gap_pct``: the median leaf's gap of first-step gradient
      norms. The worst leaf is a BatchNorm scale of 32-64 elements whose
      gradient is a cancelling sum: there the configuration's bfloat16
      alone reads a fifth to a half (the reference run in bfloat16 does
      too), so the worst leaf separates nothing;
    - ``update3_gap_pct``: the worst leaf's gap of the parameters' change
      over the three steps, over the leaves whose reference gradient is at
      least a thousandth of the median leaf's (below it Adam moves a leaf
      by round-off alone).

    The losses are not compared: the first step's agrees to 0.13% on
    every seed, and neither the control nor a fault moves it ten times
    that; the later steps carry Adam's first update, which moves every
    element of near-zero gradient by a full step of a sign that rounding
    sets, and spread by the seed (PERF.md).

    Leaf gaps are | |prog_i| - |ref_i| | / max(|ref_i|, median_j |ref_j|).
    ``prog`` and ``ref``: ``losses`` (3,), ``grad1`` and ``update3`` (one
    norm a leaf, the same leaf order)."""
    lp = np.asarray(prog["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    g = np.asarray(ref["grad1"], np.float64)
    keep = g >= 1e-3 * np.median(g)
    loss = np.abs(lp - lr) / np.abs(lr)
    gg = leaf_gaps(prog["grad1"], g)
    uu = leaf_gaps(prog["update3"], ref["update3"])[keep]
    print(f"diag train loss_gaps {np.round(100 * loss, 4).tolist()} grad1 "
          f"worst {100 * gg.max():.3f} (leaf {int(np.argmax(gg))}) update3 "
          f"median {100 * np.median(uu):.4f}", file=sys.stderr)
    return {"grad1_gap_pct": float(100.0 * np.median(gg)),
            "update3_gap_pct": float(100.0 * uu.max()) if uu.size
            else float("inf")}


def leaf_norms(tensors):
    """One float64 norm per tensor, computed where they lie, read once."""
    return torch.stack([t.detach().double().norm() for t in tensors]).cpu() \
        .numpy()
