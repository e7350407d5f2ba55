"""The port's spans (``utils/profiler.py``) on the CPU: untraced work
records only set-up spans; a request submitted on a profiled thread is
followed across the batcher's and the engine's threads; the spans land on
the profiler's clock (``align``); the recorder's ring is bounded; a
``trace()`` file holds the batcher threads' spans; the batcher's counters.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rsgnet_tpu_torch.config.defaults import tiny_rsgnet
from rsgnet_tpu_torch.core.inference import make_e2e_fn, make_inference_fn
from rsgnet_tpu_torch.models import get_pose_net, init_weights
from rsgnet_tpu_torch.serving import DynamicBatcher, ServingEngine
from rsgnet_tpu_torch.utils import profiler

BUCKETS = (1, 2, 4)
SETUP = {"serve.warmup", "serve.warmup.call", "serve.warmup.repeat",
         "pipeline.first_call"}
DISPATCHER = ("serve.idle", "serve.collect", "serve.slot_wait",
              "serve.dispatch")
COMPLETER = ("serve.complete_idle", "serve.to_host", "serve.fanout")


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_rsgnet()
    model = init_weights(get_pose_net(cfg), seed=3)
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    return cfg, model, (h, w, 3)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the test."""
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _req(shape, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, *shape)).astype(np.uint8),
            rng.uniform(30, 200, (n, 2)).astype(np.float32),
            rng.uniform(0.3, 1.2, (n, 2)).astype(np.float32))


def _served(tiny):
    cfg, model, shape = tiny
    fn = make_inference_fn(cfg, model, normalize_input=True, device="cpu")
    engine = ServingEngine(fn, buckets=BUCKETS, image_shape=shape,
                           image_dtype=np.uint8)
    engine.warmup(timing_repeats=1)
    return fn, engine


def _round_trip(batcher, shape, n_requests):
    futs = [batcher.submit(*_req(shape, 1 + i % 2, i))
            for i in range(n_requests)]
    return [f.result(timeout=120) for f in futs]


def test_untraced_work_records_only_set_up_spans(tiny, recorder):
    fn, engine = _served(tiny)
    shape = tiny[2]
    try:
        with DynamicBatcher(engine, max_wait_ms=5.0) as batcher:
            _round_trip(batcher, shape, 5)
        fn(*_req(shape, 2, 9))
    finally:
        engine.close()
    got = recorder.spans()
    assert {s.name for s in got} == SETUP
    assert all(s.setup for s in got)
    warm = [s for s in got if s.name == "serve.warmup"]
    assert sorted(s.args["bucket"] for s in warm) == list(BUCKETS)
    first = [s for s in got if s.name == "pipeline.first_call"]
    assert sorted(s.args["shape"][0] for s in first) == list(BUCKETS)
    # each warm-up's call and repeat are its children, inside it
    by_id = {s.span_id: s for s in got}
    for s in got:
        if s.name in ("serve.warmup.call", "serve.warmup.repeat"):
            parent = by_id[s.parent]
            assert parent.name == "serve.warmup"
            assert parent.start_ns <= s.start_ns <= s.end_ns <= \
                parent.end_ns
    assert recorder.dropped == 0


def test_a_traced_request_is_followed_across_threads(tiny, recorder):
    fn, engine = _served(tiny)
    shape = tiny[2]
    n = 6
    try:
        with DynamicBatcher(engine, max_wait_ms=20.0) as batcher:
            with profile(activities=[ProfilerActivity.CPU]):
                _round_trip(batcher, shape, n)
            dispatcher = batcher._dispatcher.name
    finally:
        engine.close()
    got = [s for s in recorder.spans() if not s.setup]
    submits = [s for s in got if s.name == "serve.submit"]
    rids = sorted(s.ids[0] for s in submits)
    assert len(rids) == n and all(len(s.ids) == 1 for s in submits)
    for rid in rids:
        (q,) = [s for s in got if s.name == "serve.queue" and s.ids == (rid,)]
        (r,) = [s for s in got if s.name == "serve.request"
                and s.ids == (rid,)]
        assert r.start_ns == q.start_ns <= q.end_ns <= r.end_ns
    # every batch span lists its requests: together, every request
    for name in ("serve.dispatch", "serve.slot_wait", "engine.call",
                 "pipeline.call", "serve.to_host", "serve.fanout"):
        batch = [s for s in got if s.name == name]
        ids = sorted(i for s in batch for i in s.ids)
        assert ids == rids, name
    # the batch's work under the dispatch, on the engine's thread
    by_id = {s.span_id: s for s in got}
    for s in got:
        if s.name == "engine.call":
            assert by_id[s.parent].name == "serve.dispatch"
            assert s.args["bucket"] in BUCKETS
        if s.name.startswith("pipeline.") and s.name != "pipeline.call":
            assert by_id[s.parent].name == "pipeline.call"
    calls = [s for s in got if s.name == "pipeline.call"]
    for c in calls:
        stages = [s.name for s in sorted(got, key=lambda s: s.start_ns)
                  if s.parent == c.span_id]
        assert stages == ["pipeline.normalize", "pipeline.forward",
                          "pipeline.flip", "pipeline.forward",
                          "pipeline.flip", "pipeline.decode"]
    # the dispatcher's four states tile its thread, without overlap
    states = sorted((s for s in got if s.thread == dispatcher),
                    key=lambda s: s.start_ns)
    assert {s.name for s in states} == set(DISPATCHER)
    for a, b in zip(states, states[1:]):
        assert a.start_ns <= a.end_ns == b.start_ns, (a.name, b.name)
    completer = [s for s in got if s.name in COMPLETER]
    assert {s.name for s in completer} == set(COMPLETER)


def test_traced_e2e_call_records_its_stages(tiny, recorder):
    cfg, model, _ = tiny
    fn = make_e2e_fn(cfg, model, (160, 200), device="cpu")
    rng = np.random.RandomState(0)
    canvases = rng.randint(0, 256, (2, 160, 200, 3)).astype(np.uint8)
    boxes = (np.full((2, 2), 90.0, np.float32),
             np.full((2, 2), 0.5, np.float32))
    plain = fn(canvases, *boxes)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fn(canvases, *boxes)
    for a, b in zip(plain, traced):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    got = [s for s in recorder.spans() if not s.setup]
    (call,) = [s for s in got if s.name == "pipeline.call"]
    assert [s.name for s in got if s.parent == call.span_id] == [
        "pipeline.crop", "pipeline.forward", "pipeline.flip",
        "pipeline.forward", "pipeline.flip", "pipeline.decode"]
    assert all(s.anchored and s.device_ms is None for s in got)


def _aligned_stretch(batcher, shape):
    """One profiled stretch of marks and requests: its host events, the
    recorder's spans after ``align``, and the worst gap (µs) between a
    span of the stretch and its ``record_function`` copy."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("stretch"):
            for i in range(20):
                with profiler.span("test.mark", step=i):
                    time.sleep(0.0005)
            _round_trip(batcher, shape, 4)
    host = [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()]
    on = profiler.align(host)
    (lo, hi), = [(s, e) for n, s, e in host if n == "stretch"]
    worst = 0.0
    for name in ("test.mark", "serve.submit"):
        copies = sorted((s, e) for n, s, e in host if n == name)
        mine = sorted((s, e) for n, s, e, sp in on
                      if n == name and lo <= s <= hi)
        assert len(copies) == len(mine) > 0
        worst = max([worst] + [max(abs(cs - ms), abs(ce - me))
                               for (cs, ce), (ms, me) in zip(copies, mine)])
    return host, on, worst


def test_spans_align_with_their_profiler_copies(tiny, recorder):
    fn, engine = _served(tiny)
    shape = tiny[2]
    try:
        with DynamicBatcher(engine, max_wait_ms=5.0) as batcher:
            # a span's clock read and its copy's are two reads: on a loaded
            # machine the scheduler can switch threads between them, so a
            # disturbed stretch is measured again, three times at most (the
            # earlier stretches' spans stay in the recorder: ``align``
            # matches each name's copies to the right ones)
            for _ in range(3):
                host, on, worst = _aligned_stretch(batcher, shape)
                if worst < 200:
                    break
    finally:
        engine.close()
    assert worst < 200
    (lo, hi), = [(s, e) for n, s, e in host if n == "stretch"]
    dispatch = [(s, e) for n, s, e, sp in on
                if n == "serve.dispatch" and s >= lo]
    assert len(dispatch) >= 1 and all(s <= e <= hi for s, e in dispatch)


def test_a_full_ring_drops_the_oldest_and_counts_them():
    rec = profiler.Recorder(capacity=4)
    for i in range(6):
        rec.add(profiler.Span(f"s{i}", i, i + 1, "t", None))
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2


def test_recorder_keeps_count_under_concurrent_writers():
    """Threads recording at once, more of them than cores, with a short
    switch interval: every span is kept or counted as dropped, and no two
    share an id."""
    import sys
    rec = profiler.Recorder(capacity=1000)
    n_threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write():
            for i in range(per):
                rec.add(profiler.Span("w", i, i, "t", None,
                                      span_id=profiler.new_id()))
        threads = [threading.Thread(target=write) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    kept = rec.spans()
    assert len(kept) == 1000 and rec.dropped == n_threads * per - 1000
    assert len({s.span_id for s in kept}) == len(kept)


def test_trace_file_holds_the_batcher_threads_spans(tiny, recorder,
                                                    tmp_path):
    fn, engine = _served(tiny)
    shape = tiny[2]
    try:
        with DynamicBatcher(engine, max_wait_ms=5.0) as batcher:
            with profiler.trace(str(tmp_path / "t")):
                _round_trip(batcher, shape, 3)
            tids = {batcher._dispatcher.native_id: "serve.dispatch",
                    batcher._completer.native_id: "serve.to_host"}
    finally:
        engine.close()
    (path,) = list((tmp_path / "t").glob("*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    for tid, name in tids.items():
        assert any(e.get("name") == name and e.get("tid") == tid
                   and e["ph"] == "X" for e in events), name
    assert any(e.get("name") == "engine.call" for e in events)
    begun = [e for e in events if e.get("name") == "serve.request"
             and e["ph"] == "b"]
    assert len(begun) == 3
    assert any(e.get("name") == "thread_name"
               and e["args"].get("name") == "batcher-dispatch"
               for e in events)


def test_batcher_counts_queue_wait_and_dispatcher_states(tiny):
    fn, engine = _served(tiny)
    shape = tiny[2]
    try:
        t0 = time.perf_counter()
        with DynamicBatcher(engine, max_wait_ms=5.0) as batcher:
            threads = [threading.Thread(target=_round_trip,
                                        args=(batcher, shape, 3))
                       for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            stats = batcher.stats()
        wall = time.perf_counter() - t0
    finally:
        engine.close()
    assert 0 <= stats["queue_wait_p50_ms"] <= stats["queue_wait_p95_ms"]
    assert stats["queue_wait_p95_ms"] <= stats["latency_p95_ms"]
    states = stats["dispatcher_s"]
    assert set(states) == {"idle", "collect", "slot_wait", "dispatch"}
    assert all(v >= 0 for v in states.values())
    assert states["dispatch"] > 0 and sum(states.values()) <= wall
