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
