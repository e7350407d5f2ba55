"""The reader of ``graph_replay_pct`` (``portbench/metrics/graph_replay_pct.py``)
on synthetic spans planted in the program's recorder: the share of the
traced stretch's ``pipeline.call`` spans whose ``graph`` argument is true,
calls outside the stretch left out, and nothing where no call carries the
argument (a program that does not replay) or without a recorder."""
import sys

import pytest

from portbench import run
from portbench.trace import Trace
from rsgnet_tpu_torch.utils import profiler

ORIGIN = 1_700_000_000_000_000_000      # the recorder's ns at trace 0 µs
NAMES = ("graph_replay_pct.infer", "graph_replay_pct.serve")


@pytest.fixture
def recorder(monkeypatch):
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _call(t0_us, graph=None):
    args = None if graph is None else {"graph": graph}
    return profiler.Span("pipeline.call", ORIGIN + int(t0_us * 1e3),
                         ORIGIN + int((t0_us + 500) * 1e3), "t", 1, (),
                         None, profiler.new_id(), False, True, args)


def _result(recorder, flags):
    """A traced call every 1000 µs from 0 with ``flags`` as its ``graph``
    argument, and an earlier eager call outside the stretch."""
    recorder.add(_call(-90000, graph=False))
    host = [("pipeline.call", -90000, -89500)]
    for k, flag in enumerate(flags):
        recorder.add(_call(1000 * k, graph=flag))
        host.append(("pipeline.call", 1000 * k, 1000 * k + 500))
    kernels = [("k", 0, 1000 * len(flags))]
    return {"trace": Trace(kernels, host[1:], 1000.0 * len(flags),
                           len(flags))}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("flags,want", [([True] * 4, 100.0),
                                        ([False, True, True, True], 75.0),
                                        ([False] * 3, 0.0)])
def test_the_share_of_calls_replayed(recorder, name, flags, want):
    res = _result(recorder, flags)
    assert run.metric_reader(name)(res) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_the_argument(recorder, name):
    res = _result(recorder, [None] * 3)
    assert run.metric_reader(name)(res) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_recorder(recorder, monkeypatch, name):
    res = _result(recorder, [True] * 2)
    monkeypatch.setitem(sys.modules, "rsgnet_tpu_torch.utils.profiler", None)
    assert run.metric_reader(name)(res) is None
