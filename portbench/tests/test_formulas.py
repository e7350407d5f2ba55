"""The yardstick's byte and FLOP counts reproduce the figures PERF.md gives
for the kernels (30.1 MB, 32.1 MB, 104.2 MB) and count the models' work."""
import numpy as np
import pytest
import torch

from portbench import roofline
from portbench.tests._tiny import load


def test_dark_decode_bytes_at_bucket_64():
    assert round(roofline.dark_decode_bytes(64, 17, 96, 72) / 1e6, 1) == 30.1


def _port_matrices(n, seed_batch, seed_draws, sets):
    from rsgnet_tpu_torch import bench
    from rsgnet_tpu_torch.config.defaults import rsgnet_w32_256x192
    from rsgnet_tpu_torch.data.augment import augment_geometry, draw_augment
    from rsgnet_tpu_torch.data.skeletons import get_spec
    from rsgnet_tpu_torch.data.synthetic import synthetic_train_batch
    cfg = rsgnet_w32_256x192()
    if sets:
        _, j, v, c, s = bench.train_inputs(n, 17)
    else:
        b = synthetic_train_batch(n, 640, seed=seed_batch)
        j, v, c, s = (b[k] for k in ("joints", "joints_vis", "center",
                                     "scale"))
    draws = draw_augment(torch.Generator().manual_seed(seed_draws), n)
    return augment_geometry(draws, *(torch.from_numpy(np.asarray(a))
                                     for a in (j, v, c, s)),
                            640.0, cfg, get_spec("coco"))[0]


@pytest.mark.parametrize("n,seed_batch,seed_draws,sets,mb", [
    (128, None, 0, True, 104.2),     # the port bench's train shape
    (32, 6, 6, False, 32.1),         # chip_smoke's kernel phase
])
def test_shear_warp_bytes(n, seed_batch, seed_draws, sets, mb):
    trans = _port_matrices(n, seed_batch, seed_draws, sets)
    total, src = roofline.shear_warp_bytes(640, trans, (192, 256))
    assert total - src == n * 3 * 256 * 192 * 4
    assert round(total / 1e6, 1) == mb


@pytest.mark.parametrize("name,train,gflop", [
    ("rsgnet_w48_384x288_dark", False, 71.59),
    ("rsgnet_w32_256x192", False, 15.66),
    ("rsgnet_w32_256x192", True, 46.95),
])
def test_model_flops(name, train, gflop):
    got = roofline.model_flops(load(name)["model"], train=train) / 1e9
    assert abs(got - gflop) < 0.01
