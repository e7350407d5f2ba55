"""Each driver runs end to end at a tiny size on the CPU (float32), and
its outputs agree with the plain reference: every compared number far
inside its limit."""
import pytest
import torch

from portbench.tests import _tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["w48_dark.infer_b64",
                                  "w48_dark.serve_poisson"])
def test_pose_driver_agrees_with_the_reference(cell):
    line, res = _tiny.drive(_tiny.context(cell))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert res["numbers"]["kpt_gap_q25_px"] < 1e-3
    assert res["diag"]["maxval_gap_pct"] < 0.01
    assert res["numbers"]["boxes_off_pct"] == 0.0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) >= {"setup_s"}


def test_train_driver_agrees_with_the_reference():
    line, res = _tiny.drive(_tiny.context("w32.train_b128"))
    assert line["attempted"] > 0 and line["failed"] == 0
    n = res["numbers"]
    # float32 on both sides; the leaves still move apart by the
    # augmentation geometry's float32 round-off, which BatchNorm over 4
    # rows amplifies
    assert n["grad1_gap_pct"] < 1 and n["update3_gap_pct"] < 20


def test_data_parallel_driver_agrees_with_the_reference():
    """Four gloo ranks on the CPU, two rows each, against the reference at
    the global batch of eight."""
    line, res = _tiny.drive(_tiny.context("w32.train_dp4"))
    n = res["numbers"]
    assert line["attempted"] > 0 and n["rank_gap"] == 0.0
    assert n["grad1_gap_pct"] < 1 and n["update3_gap_pct"] < 20
