"""Plain PyTorch versions of everything around the model: the eval crop,
normalization, flip-test, DARK decode, the mapping back to the image, the
train augmentation (half body, scale, rotation, flip, the two-pass shear
warp), Gaussian targets, the joints MSE loss and Adam.

Each follows the published method (the reference HRNet / DARK code's
semantics) and is written from it, not from the measured program; it
imports nothing of the program. Inputs are the benchmark's own: canvases,
boxes, joints and the augmentation's random draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_STD = 200.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# COCO-17: nose, l/r eye, l/r ear, l/r shoulder, l/r elbow, l/r wrist,
# l/r hip, l/r knee, l/r ankle
COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16))
COCO_SKELETON = ((15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
                 (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2),
                 (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6))
COCO_UPPER_BODY = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)


def flip_perm(num_joints=17, pairs=COCO_FLIP_PAIRS):
    perm = list(range(num_joints))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def normalize(x):
    """(N, 3, H, W) float pixels in [0, 255] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x / 255.0 - mean[:, None, None]) / std[:, None, None]


# ---------------------------------------------------------------------------
# Inference: crop, flip-test, DARK, back to the image
# ---------------------------------------------------------------------------

def rot0_scale(scales, out_w):
    """Isotropic src->dst scale of the reference's 3-point crop transform
    at rotation 0: it uses the box width alone."""
    return out_w / (scales[:, 0] * PIXEL_STD)


def bilinear_crop(canvases, centers, scales, out_size):
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) of rotation-free box
    crops: (N, H, W, 3) uint8 canvases, (N, 2) centers and scales (float64
    on the canvases' device), out_size (w, h) -> (N, 3, h, w) float32."""
    n, h, w, _ = canvases.shape
    ow, oh = out_size
    dev = canvases.device
    s = rot0_scale(scales, ow)                                 # (N,)
    xs = torch.arange(ow, dtype=torch.float64, device=dev)
    ys = torch.arange(oh, dtype=torch.float64, device=dev)
    sx = (xs[None] - ow * 0.5) / s[:, None] + centers[:, 0:1]  # (N, ow)
    sy = (ys[None] - oh * 0.5) / s[:, None] + centers[:, 1:2]  # (N, oh)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0).float(), (sy - y0).float()
    x0, y0 = x0.long(), y0.long()
    img = canvases.float().permute(0, 3, 1, 2)                 # (N, 3, H, W)

    def rows(yi):          # (N, 3, oh, W), zero outside
        ok = (yi >= 0) & (yi < h)
        g = torch.gather(img, 2, yi.clamp(0, h - 1)[:, None, :, None]
                         .expand(n, 3, oh, w))
        return g * ok[:, None, :, None]

    def cols(x, xi):       # (N, 3, oh, ow), zero outside
        ok = (xi >= 0) & (xi < w)
        g = torch.gather(x, 3, xi.clamp(0, w - 1)[:, None, None, :]
                         .expand(n, 3, oh, ow))
        return g * ok[:, None, None, :]

    r = rows(y0) * (1 - fy)[:, None, :, None] + \
        rows(y0 + 1) * fy[:, None, :, None]
    return cols(r, x0) * (1 - fx)[:, None, None, :] + \
        cols(r, x0 + 1) * fx[:, None, None, :]


def flip_back(hm, perm, shift=True):
    """Un-flip heatmaps of the mirrored input: mirror x, swap left and
    right joints, and (SHIFT_HEATMAP) shift one column right."""
    hm = torch.flip(hm, dims=(3,))[:, perm]
    if shift:
        hm = torch.cat([hm[..., :1], hm[..., :-1]], dim=3)
    return hm


def cv2_gaussian_1d(ksize):
    """cv2.getGaussianKernel(ksize, 0) (ksize > 7: the sigma formula)."""
    table = {1: [1.0], 3: [0.25, 0.5, 0.25],
             5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]}
    if ksize in table:
        return np.asarray(table[ksize], np.float64)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-xs ** 2 / (2 * sigma ** 2))
    return k / k.sum()


def dark_decode(hm, ksize):
    """DARK (Zhang et al., CVPR 2020) on (N, K, H, W) heatmaps: the argmax
    (zeroed where the peak is <= 0), then the blurred, renormalized,
    log-taken map's Newton step at it where 1 < p < size - 2 and the
    Hessian is invertible. Returns heatmap-space coords (N, K, 2) and
    maxvals (N, K, 1)."""
    n, k, h, w = hm.shape
    flat = hm.reshape(n, k, h * w)
    maxvals, idx = flat.max(dim=2)
    coords = torch.stack([idx % w, idx // w], -1).to(hm.dtype)
    coords = coords * (maxvals > 0)[..., None]
    kern = torch.as_tensor(cv2_gaussian_1d(ksize), dtype=hm.dtype,
                           device=hm.device)
    r = (ksize - 1) // 2
    x = hm.reshape(n * k, 1, h, w)
    x = F.conv2d(F.pad(x, (r, r, 0, 0)), kern.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r)), kern.view(1, 1, -1, 1))
    x = x.reshape(n, k, h, w)
    x = x * (hm.amax((2, 3), keepdim=True)
             / x.amax((2, 3), keepdim=True).clamp_min(1e-20))
    lg = torch.log(x.clamp(1e-10, 50.0)).reshape(n, k, h * w)
    px, py = coords[..., 0].long(), coords[..., 1].long()

    def at(dy, dx):
        lin = (py + dy).clamp(0, h - 1) * w + (px + dx).clamp(0, w - 1)
        return torch.gather(lg, 2, lin[..., None])[..., 0]

    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    c = at(0, 0)
    dxx = 0.25 * (at(0, 2) - 2 * c + at(0, -2))
    dyy = 0.25 * (at(2, 0) - 2 * c + at(-2, 0))
    dxy = 0.25 * (at(1, 1) - at(-1, 1) - at(1, -1) + at(-1, -1))
    det = dxx * dyy - dxy * dxy
    ok = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2) & (det != 0)
    inv = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    off = torch.stack([-(dyy * dx - dxy * dy) * inv,
                       -(-dxy * dx + dxx * dy) * inv], -1)
    return coords + off * ok[..., None], maxvals[..., None]


def to_image(coords, centers, scales, hm_size):
    """Heatmap-space coords (N, K, 2) -> image space through the inverse of
    the rotation-free crop transform of heatmap size (w, h)."""
    hw, hh = hm_size
    s = rot0_scale(scales, hw)[:, None]
    x = (coords[..., 0] - hw * 0.5) / s + centers[:, None, 0]
    y = (coords[..., 1] - hh * 0.5) / s + centers[:, None, 1]
    return torch.stack([x, y], -1)


@torch.no_grad()
def predict(model, inputs, centers, scales, pipe, block=16):
    """Normalized (N, 3, H, W) float32 model inputs -> (preds (N, K, 2)
    float64 image coords, maxvals (N, K, 1)), flip-test and DARK as
    ``pipe`` (the configuration's ``pipeline`` entry) says, in blocks of
    rows so the float32 forwards fit beside nothing else."""
    perm = flip_perm(pipe["num_joints"])
    preds, maxvals = [], []
    for i in range(0, inputs.shape[0], block):
        x = inputs[i:i + block]
        hm = model(x)[0]
        if pipe["flip_test"]:
            hm = (hm + flip_back(model(torch.flip(x, dims=(3,)))[0], perm,
                                 pipe["shift_heatmap"])) * 0.5
        c, m = dark_decode(hm.double(), pipe["blur_kernel"])
        preds.append(to_image(c, centers[i:i + block], scales[i:i + block],
                              pipe["heatmap_size"]))
        maxvals.append(m)
    return torch.cat(preds), torch.cat(maxvals)


# ---------------------------------------------------------------------------
# Training: augmentation geometry, shear warp, targets, loss, Adam
# ---------------------------------------------------------------------------

def affine_3pt(center, scale, rot_deg, out_size):
    """The reference's ``get_affine_transform`` (src->dst, no shift),
    float64: three point pairs (center, a point half a box width above it
    rotated by ``rot``, and the third point at a right angle) solved
    exactly."""
    n = center.shape[0]
    src_w = scale[:, 0] * PIXEL_STD
    dw, dh = float(out_size[0]), float(out_size[1])
    rad = math.pi * rot_deg / 180.0
    sn, cs = torch.sin(rad), torch.cos(rad)
    d = torch.stack([-(src_w * -0.5) * sn, (src_w * -0.5) * cs], -1)
    src0, src1 = center, center + d
    v = src0 - src1
    src2 = src1 + torch.stack([-v[:, 1], v[:, 0]], -1)
    dst0 = torch.tensor([dw * 0.5, dh * 0.5], dtype=center.dtype).expand(n, 2)
    dst1 = dst0 + torch.tensor([0.0, dw * -0.5], dtype=center.dtype)
    v = dst0 - dst1
    dst2 = dst1 + torch.stack([-v[:, 1], v[:, 0]], -1)
    src = torch.stack([src0, src1, src2], 1)
    dst = torch.stack([dst0, dst1, dst2], 1)
    a = torch.cat([src, torch.ones_like(src[..., :1])], -1)        # (N, 3, 3)
    return torch.linalg.solve(a, dst).transpose(1, 2)              # (N, 2, 3)


def augment_geometry(draws, joints, vis, centers, scales, src_w, aug,
                     image_size):
    """The reference train transform of one batch from its six draws per
    sample (float64, host): half body, scale, rotation (60% of samples),
    flip folded into the matrix. Returns (trans (N, 2, 3), warped joints
    (N, K, 2), visibility (N, K))."""
    j = joints.double()
    n, k, _ = j.shape
    seen = vis > 0
    upper = torch.zeros(k, dtype=torch.bool)
    upper[list(COCO_UPPER_BODY)] = True
    up, low = upper & seen, ~upper & seen
    use_up = (draws["half_body_side"] < 0.5) & (up.sum(1) > 2)
    use_low = ~use_up & (low.sum(1) > 2)
    sel = torch.where(use_up[:, None], up,
                      torch.where(use_low[:, None], low, up))
    nsel = sel.sum(1)
    hb_c = (j * sel[..., None]).sum(1) / nsel.clamp_min(1)[:, None]
    lo = torch.where(sel[..., None], j, math.inf).amin(1)
    hi = torch.where(sel[..., None], j, -math.inf).amax(1)
    bw, bh = (hi - lo)[:, 0], (hi - lo)[:, 1]
    ar = image_size[0] / image_size[1]
    wide = bw > ar * bh
    hb_s = torch.stack([torch.where(wide, bw, bh * ar),
                        torch.where(wide, bw / ar, bh)], -1) / PIXEL_STD * 1.5
    hb_on = ((seen.sum(1) > aug["num_joints_half_body"])
             & (draws["half_body_gate"] < aug["prob_half_body"])
             & (nsel >= 2))
    c = torch.where(hb_on[:, None], hb_c, centers.double())
    s = torch.where(hb_on[:, None], hb_s, scales.double())
    sf, rf = aug["scale_factor"], aug["rot_factor"]
    s = s * (draws["scale"].double() * sf + 1).clamp(1 - sf, 1 + sf)[:, None]
    r = (draws["rot"].double() * rf).clamp(-2 * rf, 2 * rf)
    r = torch.where(draws["rot_gate"] <= 0.6, r, 0.0)
    flip = (draws["flip"] <= 0.5) & bool(aug["flip"])
    c = torch.where(flip[:, None],
                    torch.stack([src_w - c[:, 0] - 1, c[:, 1]], -1), c)
    t = affine_3pt(c, s, r, image_size)
    # the source mirrored: x -> src_w - 1 - x
    tf = torch.stack([-t[:, :, 0], t[:, :, 1],
                      t[:, :, 0] * (src_w - 1) + t[:, :, 2]], -1)
    t = torch.where(flip[:, None, None], tf, t)
    warped = torch.einsum("nij,nkj->nki", t[:, :, :2], j) + t[:, None, :, 2]
    perm = flip_perm(k)
    warped = torch.where(flip[:, None, None], warped[:, perm], warped)
    vis = torch.where(flip[:, None], vis[:, perm], vis)
    return t, warped, vis


def _pass(x, pos, shift, axis):
    """One resampling pass of the two-pass warp along ``axis`` of (N, A, B,
    C): sample at ``pos + shift`` with the three-tap weights (1 - phi)+,
    1 - w0 - w2, (phi - 1)+, phi = frac(pos) + frac(shift), taps at
    floor(pos) + floor(shift) + j; taps outside the source read 0."""
    size = x.shape[axis]
    pf, sf = torch.floor(pos), torch.floor(shift)
    if axis == 2:
        base = (sf[:, :, None] + pf[:, None, :]).long()
        phi = (pos - pf)[:, None, :] + (shift - sf)[:, :, None]
    else:
        base = (pf[:, :, None] + sf[:, None, :]).long()
        phi = (pos - pf)[:, :, None] + (shift - sf)[:, None, :]
    w0 = (1 - phi).clamp_min(0)
    w2 = (phi - 1).clamp_min(0)
    out = 0
    for jj, wt in enumerate((w0, 1 - w0 - w2, w2)):
        idx = base + jj
        ok = (idx >= 0) & (idx < size)
        g = torch.gather(x, axis, idx.clamp(0, size - 1)[..., None]
                         .expand(*idx.shape, x.shape[3]))
        out = out + g.float() * (wt * ok)[..., None]
    return out


def shear_warp(images, trans, out_size):
    """The configuration's TRAIN.WARP: the affine warp as two 1-D bilinear
    passes (Catmull-Smith). With M = inv(trans) (dst -> src), pass A
    resamples every source row r at u = A x + (B r + C), A = m00 - m01
    m10 / m11, B = m01 / m11, C = m02 - m01 m12 / m11; pass B resamples
    that along rows at v = (m11 y + m12) + m10 x. Where |m11| < |m10| the
    source is transposed first (rows of M swapped). (N, S, S, C) images ->
    (N, C, out_h, out_w) float32."""
    ow, oh = int(out_size[0]), int(out_size[1])
    s = images.shape[1]
    t = trans.double()
    a, b, c = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    d, e, f = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    det = a * e - b * d
    m = torch.stack([torch.stack([e, -b, b * f - c * e], -1),
                     torch.stack([-d, a, c * d - a * f], -1)], 1) / det[:, None, None]
    m = m.float()
    swap = m[:, 1, 1].abs() < m[:, 1, 0].abs()
    m = torch.where(swap[:, None, None], m.flip(1), m)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    dev = images.device
    xs = torch.arange(ow, dtype=torch.float32, device=dev)
    rs = torch.arange(s, dtype=torch.float32, device=dev)
    ys = torch.arange(oh, dtype=torch.float32, device=dev)
    m00, m01, m02, m10, m11, m12 = (v.to(dev) for v in
                                    (m00, m01, m02, m10, m11, m12))
    p_a = (m00 - m01 * m10 / m11)[:, None] * xs
    s_a = (m01 / m11)[:, None] * rs + (m02 - m01 * m12 / m11)[:, None]
    p_b = m11[:, None] * ys + m12[:, None]
    s_b = m10[:, None] * xs
    x = torch.where(swap.to(dev)[:, None, None, None], images.transpose(1, 2),
                    images)
    inter = _pass(x, p_a, s_a, 2)                 # (N, S, ow, C)
    out = _pass(inter, p_b, s_b, 1)               # (N, oh, ow, C)
    return out.permute(0, 3, 1, 2).contiguous()


def gaussian_targets(joints, vis, hm_size, image_size, sigma):
    """Gaussian heatmaps at the integer cells int(joint / stride + 0.5),
    cut to the 3-sigma window; a joint whose window misses the grid gets
    weight 0. Returns (target (N, K, H, W) float32, weight (N, K))."""
    hw, hh = hm_size
    dev = joints.device
    stride = torch.tensor([image_size[0] / hw, image_size[1] / hh],
                          dtype=torch.float64, device=dev)
    mu = torch.trunc(joints.double() / stride + 0.5).long()
    mx, my = mu[..., 0], mu[..., 1]
    t = 3 * sigma
    inside = (mx - t < hw) & (my - t < hh) & (mx + t + 1 >= 0) & \
        (my + t + 1 >= 0)
    weight = vis.float() * inside
    dx = torch.arange(hw, device=dev) - mx[..., None]
    dy = torch.arange(hh, device=dev) - my[..., None]
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2).double()
                  / (2 * sigma ** 2)).float()
    win = (dx.abs() <= t)[..., None, :] & (dy.abs() <= t)[..., :, None]
    g = g * win * (weight > 0.5)[..., None, None]
    return g, weight


def joints_mse(pred, target, weight):
    """The reference JointsMSELoss with target weights: per joint 0.5 x
    MSE(pred_k w_k, gt_k w_k) over (N, H*W), averaged over joints."""
    n, k = pred.shape[:2]
    w = weight[..., None]
    d = pred.reshape(n, k, -1) * w - target.reshape(n, k, -1) * w
    return (0.5 * (d ** 2).mean(dim=(0, 2))).sum() / k


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), written
    out: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr / bc1 x
    m / (sqrt(v) / sqrt(bc2) + eps)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + self.eps,
                       value=-self.lr / bc1)
