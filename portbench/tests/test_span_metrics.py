"""The readers of the program's spans (``portbench/spans.py`` and the
``program_span`` metrics) on synthetic results: a ``Trace`` and spans
planted in the program's recorder give the hand-computed numbers, and a
reader gives nothing without its spans or without a recorder at all. On a
card (``gpu``), a ``--trace 1`` run of each cell reads every one of them."""
import json
import math
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests._tiny import ROOT
from portbench.trace import Trace
from rsgnet_tpu_torch.utils import profiler

ORIGIN = 1_700_000_000_000_000_000      # the recorder's ns at trace 0 µs
NEW = {"w48_dark.serve_poisson": ("queue_wait_p95_ms.serve",
                                  "idle_with_work_pct.serve",
                                  "warmup_s.serve"),
       "w48_dark.infer_b64": ("pipeline_glue_ms.infer",
                              "first_call_s.infer")}


def _read(name, res):
    return run.metric_reader(name)(res)


def _span(name, t0_us, t1_us, *, anchored=False, setup=False, ids=(),
          parent=None, device_ms=None):
    s = profiler.Span(name, ORIGIN + int(t0_us * 1e3),
                      ORIGIN + int(t1_us * 1e3), "t", 1, tuple(ids), parent,
                      profiler.new_id(), setup, anchored)
    s.device_ms = device_ms
    return s


@pytest.fixture
def recorder(monkeypatch):
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _serve_result(recorder):
    """Three requests submitted at 100, 300 and 500 µs of the trace."""
    host = []
    for i, (t, q, r) in enumerate([(100, 150, 600), (300, 400, 900),
                                   (500, 520, 1200)]):
        recorder.add(_span("serve.submit", t, t + 1, anchored=True,
                           ids=(i,)))
        host.append(("serve.submit", t, t + 1))
        recorder.add(_span("serve.queue", t, q, ids=(i,)))
        recorder.add(_span("serve.request", t, r, ids=(i,)))
    for s, kids in ((1.5, 3), (2.5, 3)):
        w = _span("serve.warmup", 0, s * 1e6, setup=True)
        recorder.add(w)
        for _ in range(kids):
            recorder.add(_span("serve.warmup.call", 0, 0.5e6, setup=True,
                               parent=w.span_id))
    kernels = [("k", 0, 200), ("k", 250, 700), ("k", 1000, 1300)]
    return {"trace": Trace(kernels, host, 1400.0, 3)}


def test_serve_readers_give_the_hand_computed_numbers(recorder):
    res = _serve_result(recorder)
    # queue waits 0.05 / 0.1 / 0.02 ms: the 95th percentile between the
    # two largest, 0.05 + 0.9 x 0.05
    assert _read("queue_wait_p95_ms.serve", res) == pytest.approx(0.095)
    # requests held over [100, 1200]; kernel gaps (200, 250), (700, 1000)
    assert _read("idle_with_work_pct.serve", res) == pytest.approx(
        100 * 350 / 1400)
    assert _read("warmup_s.serve", res) == pytest.approx(4.0)
    idle = _read("device_idle_pct.serve", res)
    assert idle == pytest.approx(100 * (1 - 950 / 1400))
    assert _read("idle_with_work_pct.serve", res) <= idle


def test_idle_with_work_is_at_most_the_idle_share(recorder):
    """Requests held over the whole stretch: every gap counts, and the
    number meets ``device_idle_pct`` but for the stretch's edges."""
    recorder.add(_span("serve.submit", 0, 1, anchored=True, ids=(0,)))
    recorder.add(_span("serve.request", 0, 5000, ids=(0,)))
    kernels = [("k", 10, 20), ("k", 30, 4000), ("k", 4500, 4990)]
    res = {"trace": Trace(kernels, [("serve.submit", 0, 1)], 5000.0, 1)}
    work = _read("idle_with_work_pct.serve", res)
    assert work == pytest.approx(100 * (10 + 500) / 5000)
    assert work <= _read("device_idle_pct.serve", res)


def _infer_result(recorder):
    """Two traced calls at 0 and 1000 µs, and an earlier one outside the
    stretch whose glue must not count."""
    host = []
    stages = [[("pipeline.crop", 1.0), ("pipeline.forward", 10.0),
               ("pipeline.flip", 0.5), ("pipeline.forward", 10.0),
               ("pipeline.flip", 0.7), ("pipeline.decode", 0.3)],
              [("pipeline.crop", 2.0), ("pipeline.forward", 11.0),
               ("pipeline.flip", 0.5), ("pipeline.forward", 11.0),
               ("pipeline.flip", 0.5), ("pipeline.decode", 0.5)]]
    early = _span("pipeline.call", -90000, -89000, anchored=True)
    recorder.add(early)
    recorder.add(_span("pipeline.decode", -89500, -89100, anchored=True,
                       parent=early.span_id, device_ms=100.0))
    for k, call_stages in enumerate(stages):
        t = 1000 * k
        call = _span("pipeline.call", t, t + 900, anchored=True)
        host.append(("pipeline.call", t, t + 900))
        for j, (name, ms) in enumerate(call_stages):
            recorder.add(_span(name, t + 100 * j, t + 100 * j + 50,
                               anchored=True, parent=call.span_id,
                               device_ms=ms))
        recorder.add(call)
    for s in (3.0, 0.5):
        recorder.add(_span("pipeline.first_call", -5e6, -5e6 + s * 1e6,
                           setup=True))
    return {"trace": Trace([("k", 0, 1900)], host, 2000.0, 2)}


def test_infer_readers_give_the_hand_computed_numbers(recorder):
    res = _infer_result(recorder)
    # glue 1.0 + 0.5 + 0.7 + 0.3 and 2.0 + 0.5 + 0.5 + 0.5 over two calls
    assert _read("pipeline_glue_ms.infer", res) == pytest.approx(3.0)
    assert _read("first_call_s.infer", res) == pytest.approx(3.5)


def test_glue_needs_every_stage_s_device_time(recorder):
    res = _infer_result(recorder)
    glue = [s for s in recorder.spans() if s.name == "pipeline.flip"]
    glue[-1].device_ms = None
    assert _read("pipeline_glue_ms.infer", res) is None


@pytest.mark.parametrize("name", [n for names in NEW.values()
                                  for n in names])
def test_a_reader_gives_nothing_without_its_spans(recorder, name):
    trace = Trace([("k", 0, 10)], [("aten::mm", 0, 5)], 20.0, 1)
    assert _read(name, {"trace": trace}) is None


@pytest.mark.parametrize("name", [n for names in NEW.values()
                                  for n in names])
def test_a_reader_gives_nothing_from_a_program_without_a_recorder(
        recorder, monkeypatch, name):
    res = (_serve_result if name.endswith(".serve") else
           _infer_result)(recorder)
    monkeypatch.setitem(sys.modules, "rsgnet_tpu_torch.utils.profiler", None)
    assert _read(name, res) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reads_every_span_metric(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", "4100000017", "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"]
    got = line["metrics"]
    for name in NEW[cell]:
        assert math.isfinite(got[name]["value"]), name
    if cell == "w48_dark.serve_poisson":
        assert got["idle_with_work_pct.serve"]["value"] <= \
            got["device_idle_pct.serve"]["value"]
