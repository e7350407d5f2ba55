"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven on the CPU
at a tiny size, with each fault the cell can have planted in the program.

- inference and serving: an answer altered where it is produced (every
  keypoint the pipeline returns moved by a heatmap pixel), and a share of
  every batch left out (its last rows carry the first rows' answers:
  ``controls.partial_batch``);
- training: a step that returns its state unchanged, and a step that
  leaves half of the batch out and takes the mean over the rest;
- data-parallel training: the exchange between the ranks left out.
"""
import numpy as np
import pytest
import torch

from portbench import controls
from portbench.tests import _tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _moved(fn):
    def call(images, centers, scales):
        preds, maxvals = fn(images, centers, scales)
        shift = torch.as_tensor(scales, dtype=preds.dtype)[:, :1, None] \
            * 200.0 / 16
        return preds + shift.to(preds.device), maxvals
    return call


@pytest.mark.parametrize("cell", ["w48_dark.infer_b64",
                                  "w48_dark.serve_poisson"])
def test_altered_answers_are_not_correct(cell):
    line, _ = _tiny.drive(_tiny.context(cell, hooks={"wrap": _moved}))
    assert line["correct"] is False


@pytest.mark.parametrize("cell,fault", [
    ("w48_dark.infer_b64", "half_batch"),
    ("w48_dark.infer_b64", "quarter_batch"),
    ("w48_dark.serve_poisson", "half_batch")])
def test_batches_with_rows_left_out_are_not_correct(cell, fault):
    """At the tests' size a serving batch holds a request or two, so the
    quarter is read on the card only (PERF.md)."""
    line, res = _tiny.drive(_tiny.context(
        cell, hooks={"wrap": controls.PROGRAM_FAULTS[fault]}))
    assert line["correct"] is False
    assert res["numbers"]["boxes_off_pct"] > \
        line["checks"]["boxes_off_pct"]["limit"]


def test_padding_is_not_a_real_row():
    c = np.array([[1.0, 2.0], [3.0, 4.0], [1.0, 2.0], [1.0, 2.0]])
    s = np.ones((4, 2))
    assert controls.real_rows(c, s) == 2
    assert controls.real_rows(c[:1], s[:1]) == 1
    assert controls.real_rows(torch.as_tensor(c[:2]), s[:2]) == 2


def _noop(step):
    def call(state, batch, draws):
        _, metrics = step(state, batch, draws)
        return state, metrics
    return call


def _half_batch(step):
    def call(state, batch, draws):
        h = batch["image"].shape[0] // 2
        return step(state, {k: v[:h] for k, v in batch.items()},
                    {k: v[:h] for k, v in draws.items()})
    return call


def _unchanged(step):
    """The step computes its loss but the state never moves."""
    def call(state, batch, draws):
        params = [p.detach().clone() for p in state.model.parameters()]
        state, metrics = step(state, batch, draws)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(q)
        state.optimizer.state.clear()
        return state, metrics
    return call


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_broken_train_steps_are_not_correct(fault):
    line, _ = _tiny.drive(_tiny.context("w32.train_b128",
                                        hooks={"wrap_step": fault}))
    assert line["correct"] is False


def test_exchange_left_out_is_not_correct():
    """Four gloo ranks on the CPU whose gradients are never averaged."""
    line, _ = _tiny.drive(_tiny.context("w32.train_dp4",
                                        hooks={"fault": "no_exchange"}))
    assert line["correct"] is False
