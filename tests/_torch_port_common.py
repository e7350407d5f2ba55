"""Shared helpers of the ``test_torch_port_*`` files: the same seeded
inputs and weights for the JAX package and its PyTorch port.

Weights are made once on the JAX side (flax init, then every leaf
randomized with numpy so BatchNorm statistics are not the trivial 0/1) and
carried to the port by ``rsgnet_tpu_torch.utils.convert``. JAX is imported
inside the helpers that need it, so the card-only tests can import this
file on a machine without JAX.
"""
import numpy as np
import torch


def tiny_cfgs(dataset="coco", name="pose_rsgnet", **test_keys):
    """The same tiny config in both packages' config trees."""
    from rsgnet_tpu.config import defaults as jd
    from rsgnet_tpu_torch.config import defaults as td
    cfgs = []
    for mod in (jd, td):
        cfg = mod.tiny_rsgnet()
        cfg.MODEL.NAME = name
        cfg.MODEL.RSG.ENABLED = name == "pose_rsgnet"
        cfg.DATASET.DATASET = dataset
        cfg.MODEL.NUM_JOINTS = {"coco": 17, "crowdpose": 14}[dataset]
        for k, v in test_keys.items():
            setattr(cfg.TEST, k, v)
        cfgs.append(cfg)
    return cfgs


def randomized_variables(model, cfg, seed):
    """flax init, then every leaf redrawn from a seeded numpy generator."""
    import jax
    from flax import traverse_util
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, h, w, 3), np.float32), train=False)
    rng = np.random.RandomState(seed)
    out = {}
    for col in ("params", "batch_stats"):
        flat = traverse_util.flatten_dict(variables[col])
        new = {}
        for path, leaf in flat.items():
            shape = np.shape(leaf)
            if path[-1] in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, shape)
            elif path[-1] == "kernel":
                fan_in = max(int(np.prod(shape[:-1])), 1)
                v = rng.normal(0, 1.0 / np.sqrt(fan_in), shape)
            else:                      # bias / mean
                v = rng.normal(0, 0.1, shape)
            new[path] = v.astype(np.float32)
        out[col] = traverse_util.unflatten_dict(new)
    return out


def jax_and_port_models(dataset="coco", name="pose_rsgnet", seed=0,
                        **test_keys):
    """(jax_cfg, jax_model, variables, port_cfg, port_model) with the same
    weights; the port model is on the CPU in eval mode."""
    from rsgnet_tpu.models import get_pose_net as jax_get_pose_net
    from rsgnet_tpu_torch.models import get_pose_net
    from rsgnet_tpu_torch.utils.convert import (flatten_variables,
                                                state_dict_from_flax)
    jcfg, tcfg = tiny_cfgs(dataset, name, **test_keys)
    jmodel = jax_get_pose_net(jcfg)
    variables = randomized_variables(jmodel, jcfg, seed)
    tmodel = get_pose_net(tcfg)
    tmodel.load_state_dict(
        state_dict_from_flax(flatten_variables(variables), tcfg), strict=True)
    return jcfg, jmodel, variables, tcfg, tmodel


def make_heatmaps(n=2, h=64, w=48, k=5, seed=0, sigma=2.0):
    """(N, H, W, K) Gaussian peaks at random sub-pixel spots + noise, the
    JAX package's layout, with the true centers (N, K, 2)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hm = np.zeros((n, h, w, k), np.float32)
    centers = np.zeros((n, k, 2), np.float32)
    for i in range(n):
        for j in range(k):
            cx = rng.uniform(4, w - 5)
            cy = rng.uniform(4, h - 5)
            centers[i, j] = (cx, cy)
            hm[i, :, :, j] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                    / (2 * sigma ** 2))
            hm[i, :, :, j] += rng.uniform(0, 0.01, (h, w))
    return hm, centers


def nchw(x_nhwc):
    """NHWC numpy -> contiguous NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc,
                                                              (0, 3, 1, 2))))


def jax_augment_draws(key, n):
    """The random numbers the JAX package's ``augment_batch(key, ...)``
    draws for a batch of ``n``, from the same key splits, as the port's
    ``draw_augment`` dict (numpy float32 arrays)."""
    import jax

    def per_sample(k):
        k_hb, k_s, k_r, k_rgate, k_f = jax.random.split(k, 5)
        k_prob, k_side = jax.random.split(k_hb, 2)
        return (jax.random.normal(k_side), jax.random.uniform(k_prob),
                jax.random.normal(k_s), jax.random.normal(k_r),
                jax.random.uniform(k_rgate), jax.random.uniform(k_f))

    from rsgnet_tpu_torch.data.augment import DRAW_KEYS
    vals = jax.vmap(per_sample)(jax.random.split(key, n))
    return {k: np.array(v, np.float32) for k, v in zip(DRAW_KEYS, vals)}


# Matrices that stress the shear warp, as (center in source widths, box
# size in source widths, rotation, flip) on an S-pixel source; a center of
# None is 5 px from the right and top edges. "outside" warps to all zeros.
HARD_WARPS = {
    "zoom_out_4x_rot45": ((0.5, 0.5), 4.0, 45.0, False),   # |m11| ~ |m10|
    "zoom_in_0.05x": ((0.5, 0.5), 0.05, 20.0, False),
    "corner_5px": (None, 1.0, 30.0, False),
    "outside": ((-1.0, -1.0), 0.5, 0.0, False),
    "rot_-135_flipped": ((0.5, 0.5), 1.0, -135.0, True),
}


def hard_warp_matrix(case, size, out_size):
    """(1, 2, 3) float32 src->dst matrix of ``HARD_WARPS[case]``, from
    ``get_affine_transform`` (the flip folded in as augmentation does)."""
    from rsgnet_tpu_torch.ops.affine import get_affine_transform
    center, box, rot, flip = HARD_WARPS[case]
    c = (np.array([size - 5.0, 5.0], np.float32) if center is None
         else np.array(center, np.float32) * size)
    m = get_affine_transform(c, box * size / 200.0, rot,
                             out_size).astype(np.float32)
    if flip:
        m = np.stack([-m[:, 0], m[:, 1], m[:, 0] * (size - 1) + m[:, 2]],
                     axis=-1)
    return m[None].astype(np.float32)


# Heatmaps that stress the DARK decode, as name -> blur kernel; the maps
# come from ``hard_dark_heatmaps(name)``. They cover the blur's edge cases
# (ks 1 and 31, maps smaller than the blur), the argmax tie order, the
# Newton step's 2-px border, maxval <= 0, a blurred max that is not at the
# raw peak, the MPII map shape and a map count that fills no warp or block.
HARD_DARK = {
    "blur1_64x48": 1,
    "blur5_64x48": 5,
    "blur31_64x48": 31,
    "smaller_than_blur_8x6": 11,
    "plateau_tie_rows": 11,
    "newton_border": 11,
    "all_negative": 11,
    "blurred_max_off_peak": 11,
    "mpii_64x64": 11,
    "nk_21": 11,
}


def _gaussian_map(h, w, cx, cy, sigma, amp=1.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return (amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                         / (2 * sigma ** 2))).astype(np.float32)


def hard_dark_heatmaps(name):
    """(N, H, W, K) float32 heatmaps of ``HARD_DARK[name]`` (the JAX
    package's layout; ``nchw`` gives the port's), made from a seed. The
    64x48 cases share one shape, (3, 64, 48, 7): 21 maps, so the JAX side
    compiles once per blur kernel."""
    rng = np.random.RandomState(sorted(HARD_DARK).index(name))
    if name == "smaller_than_blur_8x6":
        hm = rng.uniform(0, 0.2, (2, 8, 6, 3)).astype(np.float32)
        for i, (y, x) in enumerate([(2, 2), (5, 3), (0, 5), (3, 2), (7, 0),
                                    (4, 3)]):
            hm[i // 3, y, x, i % 3] = 1.0
        return hm
    if name == "mpii_64x64":
        return make_heatmaps(n=1, h=64, w=64, k=16, seed=8)[0]
    h, w = 64, 48
    if name == "all_negative":
        return -rng.uniform(0.1, 1.0, (3, h, w, 7)).astype(np.float32)
    hm = make_heatmaps(n=3, h=h, w=w, k=7, seed=9, sigma=3.0)[0]
    if name == "plateau_tie_rows":
        hm[0, :, :, 0] = _gaussian_map(h, w, 20.0, 30.0, 4.0)
        hm[0, 28:33, 17:24, 0] = 1.0         # five rows of equal maxima
        hm[0, :, :, 1] = rng.uniform(0, 0.01, (h, w))
        hm[0, 10, 40, 1] = hm[0, 12, 5, 1] = hm[0, 50, 20, 1] = 0.5
    elif name == "newton_border":
        for j, (cx, cy) in enumerate([(2, 30), (w - 3, 30), (20, 2),
                                      (20, h - 3)]):
            hm[1, :, :, j] = _gaussian_map(h, w, cx + 0.3, cy - 0.2, 2.0)
            hm[1, :, :, j] += rng.uniform(0, 0.01, (h, w))
            hm[1, cy, cx, j] += 0.05         # the integer peak stays put
    elif name == "blurred_max_off_peak":
        for j in range(2):
            hm[2, :, :, j] = _gaussian_map(h, w, 30.0 + j, 40.0, 6.0, 0.9)
            hm[2, 10 + j, 10, j] = 1.0       # a lone spike: the raw peak
    elif name not in ("blur1_64x48", "blur5_64x48", "blur31_64x48",
                      "nk_21"):
        raise KeyError(name)
    return hm
