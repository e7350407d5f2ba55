"""The port's host tools against the JAX package's: the model summary
(``utils/summary.py``: parameter counts per top-level module equal to
JAX's ``count_params`` of the same flax scope), the debug images
(``utils/vis.py``: pixel-equal PNGs), the eval debug images, and the
tracing helpers (``utils/profiler.py``: trace files, the NaN checks;
its spans are ``test_torch_tracing.py``'s).
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rsgnet_tpu.utils import summary as jax_summary
from rsgnet_tpu.utils import vis as jax_vis
from rsgnet_tpu_torch.models import get_pose_net
from rsgnet_tpu_torch.utils import profiler, summary, vis

from _torch_port_common import jax_and_port_models, resnet_cfgs


@pytest.mark.parametrize("family", ["pose_rsgnet", "pose_resnet"])
def test_summary_counts_match_jax_count_params(family):
    if family == "pose_rsgnet":
        jcfg, jmodel, variables, tcfg, tmodel = jax_and_port_models(
            from_shapes=True)
    else:
        jcfg, jmodel, variables, tcfg, tmodel = jax_and_port_models(
            from_shapes=True, cfgs=resnet_cfgs(layers=18))
    want = {name: jax_summary.count_params(sub)
            for name, sub in variables["params"].items()}
    assert summary.params_per_module(tmodel) == want
    assert summary.count_params(tmodel) == jax_summary.count_params(
        variables["params"])
    tmodel.train()
    text = summary.get_model_summary(tcfg, tmodel, batch_size=2)
    assert tmodel.training                 # the caller's mode comes back
    assert f"input: 2x{tcfg.MODEL.IMAGE_SIZE[1]}x" in text
    flops = float(text.split("forward FLOPs: ")[1].split(" G")[0])
    assert flops > 0


def _debug_cfgs():
    from rsgnet_tpu.config.defaults import tiny_rsgnet as jax_tiny
    from rsgnet_tpu_torch.config.defaults import tiny_rsgnet
    cfgs = (jax_tiny(), tiny_rsgnet())
    for cfg in cfgs:
        cfg.DEBUG.DEBUG = True
        cfg.DEBUG.SAVE_BATCH_IMAGES_GT = cfg.DEBUG.SAVE_BATCH_IMAGES_PRED = True
        cfg.DEBUG.SAVE_HEATMAPS_GT = cfg.DEBUG.SAVE_HEATMAPS_PRED = True
    return cfgs


def test_save_debug_images_pixel_equal_to_jax(tmp_path):
    jcfg, tcfg = _debug_cfgs()
    rng = np.random.RandomState(0)
    n, h, w, k = 5, 96, 64, 17
    inputs = rng.normal(0, 1, (n, h, w, 3)).astype(np.float32)
    joints = rng.uniform(-5, 70, (n, k, 2)).astype(np.float32)
    vis_ = (rng.uniform(0, 1, (n, k, 1)) > 0.3).astype(np.float32)
    target = rng.uniform(0, 1, (n, 24, 16, k)).astype(np.float32)
    output = rng.normal(0, 1, (n, 24, 16, k)).astype(np.float32)
    jax_vis.save_debug_images(jcfg, inputs, joints, vis_, target, output,
                              str(tmp_path / "jax" / "b"))
    vis.save_debug_images(tcfg, inputs, joints, vis_, target, output,
                          str(tmp_path / "port" / "b"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["b_gt.png", "b_hm_gt.png", "b_hm_pred.png",
                     "b_pred.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a = np.asarray(Image.open(tmp_path / "jax" / name))
        b = np.asarray(Image.open(tmp_path / "port" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    tcfg.DEBUG.DEBUG = False
    vis.save_debug_images(tcfg, inputs, joints, vis_, target, output,
                          str(tmp_path / "off" / "b"))
    assert not (tmp_path / "off").exists()


def test_eval_debug_images_pixel_equal_to_jax(tmp_path):
    """``_save_eval_debug``: the first images' predictions drawn on the
    frames, as the JAX package draws them."""
    from rsgnet_tpu.core.validate import _save_eval_debug as jax_save
    from rsgnet_tpu.data import get_dataset as jax_get_dataset
    from rsgnet_tpu_torch.core.validate import _save_eval_debug
    from rsgnet_tpu_torch.data import get_dataset

    from _torch_port_common import write_eval_fixture
    write_eval_fixture(str(tmp_path / "data"))
    jcfg, tcfg = _debug_cfgs()
    for cfg in (jcfg, tcfg):
        cfg.DATASET.TEST_SET = "val"
        cfg.TEST.IN_VIS_THRE = 0.2
    jds = jax_get_dataset(jcfg, root=str(tmp_path / "data"))
    tds = get_dataset(tcfg, root=str(tmp_path / "data"))
    rng = np.random.RandomState(1)
    preds = np.concatenate([rng.uniform(0, 640, (len(tds), 17, 2)),
                            rng.uniform(0, 1, (len(tds), 17, 1))],
                           -1).astype(np.float32)
    jax_save(jcfg, jds, preds, str(tmp_path / "jax"))
    _save_eval_debug(tcfg, tds, preds, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax" / "val_debug"))
    assert len(names) == 4
    assert sorted(os.listdir(tmp_path / "port" / "val_debug")) == names
    for name in names:
        a = np.asarray(Image.open(tmp_path / "jax" / "val_debug" / name))
        b = np.asarray(Image.open(tmp_path / "port" / "val_debug" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_trace_timer_and_meter(tmp_path):
    with profiler.trace(str(tmp_path / "t")):
        torch.mm(torch.rand(32, 32), torch.rand(32, 32))
    (path,) = list((tmp_path / "t").glob("*.json"))
    with open(path) as f:
        assert any("mm" in e.get("name", "")
                   for e in json.load(f)["traceEvents"])


def test_nan_checks_name_the_tensor():
    model = get_pose_net(_debug_cfgs()[1])
    try:
        profiler.enable_nan_checks(True)
        assert profiler.nan_checks_enabled() and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="loss at step 3"):
            profiler.check_finite(torch.tensor(float("nan")), step=3)
        p = next(model.parameters())
        p.grad = torch.full_like(p, float("inf"))
        name = next(n for n, _ in model.named_parameters())
        with pytest.raises(FloatingPointError, match=f"gradient of {name}"):
            profiler.check_finite(torch.tensor(1.0), model)
    finally:
        profiler.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
