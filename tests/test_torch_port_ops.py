"""Port vs JAX package on CPU: config, skeletons, flip, affine geometry,
normalization and the host crop.

Tolerances: these are the same float32 operations in the same order on
both sides, so results are exact, except the batched 3x3 solves (LU in
``torch.linalg.solve`` vs ``jnp.linalg.solve``): rtol 1e-6, plus atol 1e-5
for the entries that are 0 in exact arithmetic and come out as LU rounding
noise (~1e-6; times a heatmap coordinate <= 96 that is < 1e-3 px). The
port maps keypoints back with the closed-form rot-0 transform, which
agrees with JAX's LU to the same tolerances.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsgnet_tpu.config.defaults import load_config as jax_load_config
from rsgnet_tpu.data.skeletons import SPECS as JAX_SPECS
from rsgnet_tpu.ops import affine as jaff
from rsgnet_tpu.ops.flip import flip_back_jax
from rsgnet_tpu.ops.warp import host_affine_crop as jax_host_affine_crop
from rsgnet_tpu.ops.warp import normalize_image as jax_normalize_image
from rsgnet_tpu.serving.preprocess import crops_from_boxes as jax_crops
from rsgnet_tpu_torch.config.defaults import VitConfig, load_config
from rsgnet_tpu_torch.data.skeletons import SPECS
from rsgnet_tpu_torch.ops import affine as taff
from rsgnet_tpu_torch.ops.flip import flip_back
from rsgnet_tpu_torch.ops.warp import host_affine_crop, normalize_image
from rsgnet_tpu_torch.serving.preprocess import crops_from_boxes

from _torch_port_common import nchw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.mark.parametrize("name", ["w48_384x288", "w32_256x192"])
def test_config_loads_like_jax(name):
    yaml = os.path.join(REPO, "experiments", "coco", "rsgnet", f"{name}.yaml")
    ours = dataclasses.asdict(load_config(yaml))
    theirs = dataclasses.asdict(jax_load_config(yaml))
    # MODEL.VIT (pose_vit) is the port's own section, at its defaults here
    assert ours["MODEL"].pop("VIT") == dataclasses.asdict(VitConfig())
    assert ours == theirs


def test_w48_yaml_is_the_dark_rsgnet():
    cfg = load_config(os.path.join(REPO, "experiments", "coco", "rsgnet",
                                   "w48_384x288.yaml"))
    assert cfg.MODEL.NAME == "pose_rsgnet" and cfg.MODEL.RSG.ENABLED
    assert cfg.TEST.DECODE == "dark" and cfg.TEST.BLUR_KERNEL == 11
    assert tuple(cfg.MODEL.IMAGE_SIZE) == (288, 384)
    assert tuple(cfg.MODEL.HEATMAP_SIZE) == (72, 96)
    assert cfg.MODEL.EXTRA.STAGE4.NUM_CHANNELS == (48, 96, 192, 384)


def test_config_rejects_unknown_keys_and_single_value_keys():
    with pytest.raises(KeyError):
        load_config(overrides={"MODEL": {"NO_SUCH_KEY": 1}})
    with pytest.raises(ValueError):
        load_config(overrides={"MODEL": {"TARGET_TYPE": "offset"}})


@pytest.mark.parametrize("name", ["coco", "crowdpose", "mpii"])
def test_skeleton_specs_match(name):
    ours, theirs = SPECS[name], JAX_SPECS[name]
    np.testing.assert_array_equal(ours.flip_perm, theirs.flip_perm)
    np.testing.assert_array_equal(ours.adjacency(), theirs.adjacency())
    np.testing.assert_array_equal(ours.sigmas, theirs.sigmas)
    assert ours.upper_body_ids == theirs.upper_body_ids


@pytest.mark.parametrize("shift", [False, True])
def test_flip_back_exact(shift):
    rng = np.random.RandomState(0)
    hm = rng.randn(2, 6, 5, 17).astype(np.float32)       # NHWC
    perm = SPECS["coco"].flip_perm
    theirs = np.asarray(flip_back_jax(jnp.asarray(hm), jnp.asarray(perm),
                                      shift=shift))
    ours = flip_back(nchw(hm), torch.as_tensor(perm), shift=shift)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), theirs)


def _boxes(n=6, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 600, (n, 2)).astype(np.float32)
    scales = rng.uniform(0.2, 3.0, (n, 2)).astype(np.float32)
    return centers, scales


@pytest.mark.parametrize("inv", [False, True])
def test_batched_affine_transform(inv):
    centers, scales = _boxes()
    rot = np.zeros(len(centers), np.float32)
    theirs = np.asarray(jaff.get_affine_transform_jax(
        centers, scales, rot, (72, 96), inv=inv))
    ours = taff.get_affine_transform_t(
        torch.from_numpy(centers), torch.from_numpy(scales),
        torch.from_numpy(rot), (72, 96), inv=inv).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-5)
    host = np.stack([jaff.get_affine_transform(c, s, 0, (72, 96), inv=inv)
                     for c, s in zip(centers, scales)])
    np.testing.assert_allclose(ours, host, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("inv", [False, True])
def test_rot0_transform_closed_form(inv):
    """The closed-form rot-0 transform (which ``transform_preds`` maps
    keypoints back with) against the host's fp64 3-point solve, at the
    batched solve's host tolerance; its cross terms are exactly 0."""
    centers, scales = _boxes()
    ours = taff.rot0_transform_t(torch.from_numpy(centers),
                                 torch.from_numpy(scales), (72, 96),
                                 inv=inv).numpy()
    host = np.stack([jaff.get_affine_transform(c, s, 0, (72, 96), inv=inv)
                     for c, s in zip(centers, scales)])
    np.testing.assert_allclose(ours, host, rtol=1e-5, atol=1e-4)
    assert (ours[:, 0, 1] == 0).all() and (ours[:, 1, 0] == 0).all()


def test_transform_preds():
    centers, scales = _boxes()
    rng = np.random.RandomState(1)
    coords = rng.uniform(0, 72, (len(centers), 17, 2)).astype(np.float32)
    theirs = np.asarray(jaff.transform_preds_jax(coords, centers, scales,
                                                 (72, 96)))
    ours = taff.transform_preds(torch.from_numpy(coords),
                                torch.from_numpy(centers),
                                torch.from_numpy(scales), (72, 96)).numpy()
    # image coords reach ~1000 px, where one fp32 ulp is 6e-5
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-4)


def test_transform_preds_gives_the_matrix_s_bits():
    """``transform_preds`` maps points as ``s * p + shift`` and gives the
    bits of ``affine_apply`` with the 2x3 matrix: its cross terms are 0."""
    centers, scales = _boxes()
    rng = np.random.RandomState(2)
    for scale in (1.0, 1e15):
        coords = torch.from_numpy((rng.uniform(-10, 90, (len(centers), 17, 2))
                                   * scale).astype(np.float32))
        coords[0, 0] = 0.0
        c, s = torch.from_numpy(centers), torch.from_numpy(scales)
        matrix = taff.rot0_transform_t(c, s, (72, 96), inv=True)
        torch.testing.assert_close(
            taff.transform_preds(coords, c, s, (72, 96)),
            taff.affine_apply(coords, matrix[:, None]), rtol=0, atol=0)


@pytest.mark.parametrize("aspect", [0.75, 1.0])
def test_host_geometry_exact(aspect):
    box = np.array([30.5, 12.0, 80.0, 150.0], np.float32)
    c1, s1 = taff.box_to_center_scale(box, aspect)
    c2, s2 = jaff.box_to_center_scale(box, aspect)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(
        taff.get_affine_transform(c1, s1, 17.0, (288, 384)),
        jaff.get_affine_transform(c2, s2, 17.0, (288, 384)))


def test_normalize_exact():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 8, 6, 3)).astype(np.float32)
    theirs = np.asarray(jax_normalize_image(jnp.asarray(img)))
    ours = normalize_image(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(ours, theirs)


def test_host_crop_and_crops_from_boxes_exact():
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    trans = jaff.get_affine_transform(np.array([80, 60], np.float32),
                                      np.array([0.5, 0.66], np.float32), 0,
                                      (48, 64))
    np.testing.assert_array_equal(host_affine_crop(frame, trans, (48, 64)),
                                  jax_host_affine_crop(frame, trans, (48, 64)))
    boxes = np.array([[10, 10, 50, 90], [60, 20, 40, 60]], np.float32)
    for a, b in zip(crops_from_boxes(frame, boxes, (48, 64)),
                    jax_crops(frame, boxes, (48, 64))):
        np.testing.assert_array_equal(a, b)
