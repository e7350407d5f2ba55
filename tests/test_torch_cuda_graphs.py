"""The eager inference functions' CUDA graphs (``core/inference.py``).

On the CPU: a CPU function never captures, counts every call as eager and
marks its traced calls ``graph=False``; the serving engine reports the
function's counters; the kernels' launch counting under a capture
(``ops/cuda``: ``count_launch``, ``launch_tally``, ``replayed``); the
weights' stamp that drops a function's graphs.

On a card (``gpu``; each test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is False), with the W48 DARK model of
``experiments/coco/rsgnet/w48_384x288.yaml`` at random weights: a replay
gives the eager call's bits for the e2e function at 64 boxes on 640x640
canvases and for the crop function at buckets 1, 8 and 64; two calls in
flight keep their own outputs; a weight changed in place is read by the
next calls; the DARK kernel's counter rises by one a replay and not at a
capture; a traced replay records its stage spans with device time, and a
trace taken after the capture holds the replayed kernels. No JAX is
imported, so the file runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda_graphs.py -q
"""
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rsgnet_tpu_torch.config.defaults import load_config, tiny_rsgnet
from rsgnet_tpu_torch.core.inference import (DevicePipeline, _Graphs,
                                             configure_cudnn, make_e2e_fn,
                                             make_inference_fn)
from rsgnet_tpu_torch.models import get_pose_net, init_weights
from rsgnet_tpu_torch.models.hrnet import CastConv2d
from rsgnet_tpu_torch.ops import cuda as kernels
from rsgnet_tpu_torch.serving import ServingEngine
from rsgnet_tpu_torch.utils import profiler

W48_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments", "coco", "rsgnet", "w48_384x288.yaml")
STAGES = ["pipeline.normalize", "pipeline.forward", "pipeline.flip",
          "pipeline.forward", "pipeline.flip", "pipeline.decode"]
CANVAS = 640


@pytest.fixture
def recorder(monkeypatch):
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _crops(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
            rng.uniform(60, 220, (n, 2)).astype(np.float32),
            rng.uniform(0.4, 1.4, (n, 2)).astype(np.float32))


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


# -- on the CPU ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_rsgnet()
    return cfg, init_weights(get_pose_net(cfg), seed=5)


@pytest.mark.parametrize("kind", ["crops", "e2e"])
def test_a_cpu_function_never_captures(tiny, recorder, kind):
    cfg, model = tiny
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    if kind == "crops":
        fn = make_inference_fn(cfg, model, normalize_input=True,
                               device="cpu")
        args = _crops(2, h, w, 0)
    else:
        fn = make_e2e_fn(cfg, model, (160, 200), device="cpu")
        args = _crops(2, 160, 200, 0)
    first = fn(*args)
    for _ in range(2):
        _equal(fn(*args), first)
    with profile(activities=[ProfilerActivity.CPU]):
        _equal(fn(*args), first)
    assert (fn.eager_calls, fn.graph_replays) == (4, 0)
    names = {s.name for s in recorder.spans()}
    assert "pipeline.capture" not in names
    (call,) = [s for s in recorder.spans() if s.name == "pipeline.call"]
    assert call.args == {"graph": False}


def test_the_engine_reports_the_function_s_counters(tiny):
    cfg, model = tiny
    h, w = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    fn = make_inference_fn(cfg, model, normalize_input=True, device="cpu")
    engine = ServingEngine(fn, buckets=(1, 2), image_shape=(h, w, 3),
                           image_dtype=np.uint8)
    plain = ServingEngine(lambda *a: fn(*a), buckets=(1, 2))
    try:
        engine.warmup(timing_repeats=1)           # two calls a bucket
        engine.run(*_crops(2, h, w, 1))
        plain.run(*_crops(1, h, w, 2))
        stats = engine.stats()
        assert stats["graph_replays"] == 0
        assert stats["eager_calls"] == fn.eager_calls == 6
        assert stats["batches"] == 1
        assert "graph_replays" not in plain.stats()
    finally:
        engine.close()
        plain.close()


class _Counted:
    launches = 0


def test_launches_under_a_tally_count_at_each_replay():
    a, b = _Counted(), _Counted()
    kernels.count_launch(a)
    with kernels.launch_tally() as outer:
        kernels.count_launch(a)
        with kernels.launch_tally() as inner:
            kernels.count_launch(b)
            kernels.count_launch(b)
        kernels.count_launch(a)
    kernels.count_launch(b)
    assert (a.launches, b.launches) == (1, 1)
    assert outer == [a, a] and inner == [b, b]
    for _ in range(3):
        kernels.replayed(outer)
    kernels.replayed(inner)
    assert (a.launches, b.launches) == (7, 3)


def test_a_tally_holds_only_its_own_thread_s_launches():
    a = _Counted()
    with kernels.launch_tally() as tally:
        t = threading.Thread(target=kernels.count_launch, args=(a,))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert tally == [] and a.launches == 1


def test_a_weight_changed_in_place_is_seen(tiny):
    cfg, model = tiny
    model = init_weights(get_pose_net(cfg), seed=6)
    graphs = _Graphs(DevicePipeline(cfg, model), torch.device("cpu"))
    assert not graphs.weights_changed()
    with torch.no_grad():
        next(model.parameters()).mul_(0.5)
    assert graphs.weights_changed()
    assert not graphs.weights_changed()
    model.load_state_dict(model.state_dict())
    assert graphs.weights_changed()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def w48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = load_config(W48_YAML)
    configure_cudnn(cfg)
    return cfg, init_weights(get_pose_net(cfg), seed=11).cuda()


def _maker(cfg, model, kind):
    if kind == "e2e":
        return lambda: make_e2e_fn(cfg, model, (CANVAS, CANVAS))
    return lambda: make_inference_fn(cfg, model, normalize_input=True)


def _inputs(cfg, kind, n, seed):
    if kind == "e2e":
        return _crops(n, CANVAS, CANVAS, seed)
    return _crops(n, cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0], seed)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n", [("e2e", 64), ("crops", 1), ("crops", 8),
                                    ("crops", 64)])
def test_a_replay_gives_the_eager_call_s_bits(cuda, w48, kind, n):
    cfg, model = w48
    make = _maker(cfg, model, kind)
    fn = make()
    a, b = _inputs(cfg, kind, n, 1), _inputs(cfg, kind, n, 2)
    eager_a = fn(*a)
    _equal(fn(*a), eager_a)                       # captured, replayed
    replay_b = fn(*b)
    _equal(replay_b, make()(*b))                  # a new function: eager
    assert (fn.eager_calls, fn.graph_replays) == (1, 2)


@pytest.mark.gpu
def test_two_calls_in_flight_keep_their_outputs(cuda, w48):
    cfg, model = w48
    fn = _maker(cfg, model, "crops")()
    a, b = _inputs(cfg, "crops", 8, 3), _inputs(cfg, "crops", 8, 4)
    eager_a = fn(*a)
    eager_b = _maker(cfg, model, "crops")()(*b)
    fn(*a)
    got_a, got_b = fn(*a), fn(*b)                 # both queued, unread
    _equal(got_b, eager_b)
    _equal(got_a, eager_a)
    assert fn.graph_replays == 3


@pytest.mark.gpu
def test_a_weight_changed_in_place_is_read_by_the_next_calls(cuda):
    cfg = load_config(W48_YAML)
    configure_cudnn(cfg)
    model = init_weights(get_pose_net(cfg), seed=12).cuda()
    fn = _maker(cfg, model, "crops")()
    a = _inputs(cfg, "crops", 8, 5)
    fn(*a)
    before = fn(*a)
    # a bf16 conv: the forward reads a cached cast of its weight
    conv = next(m for m in model.modules() if isinstance(m, CastConv2d))
    with torch.no_grad():
        conv.weight.mul_(-2.0)
    after = fn(*a)                                # eager: the casts rebuilt
    want = _maker(cfg, model, "crops")()(*a)
    _equal(after, want)
    _equal(fn(*a), want)                          # captured again
    assert not np.array_equal(before[1].cpu().numpy(),
                              want[1].cpu().numpy())
    assert (fn.eager_calls, fn.graph_replays) == (2, 2)


@pytest.mark.gpu
def test_the_dark_counter_counts_replays_not_captures(cuda, w48):
    from rsgnet_tpu_torch.ops.cuda.dark_decode import dark_decode
    cfg, model = w48
    fn = _maker(cfg, model, "crops")()
    a = _inputs(cfg, "crops", 8, 6)
    counts = [dark_decode.launches]
    for _ in range(4):
        fn(*a)
        counts.append(dark_decode.launches)
    # eager; captured and replayed; replayed; replayed
    assert np.diff(counts).tolist() == [1, 1, 1, 1]


@pytest.mark.gpu
def test_a_traced_replay_records_its_stages_with_device_time(cuda, w48,
                                                             recorder):
    cfg, model = w48
    fn = _maker(cfg, model, "crops")()
    a = _inputs(cfg, "crops", 8, 7)
    fn(*a)
    fn(*a)
    (capture,) = [s for s in recorder.spans()
                  if s.name == "pipeline.capture"]
    assert capture.setup and capture.args == {"shape": [8, 384, 288, 3]}
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*a)
    torch.cuda.synchronize()
    got = [s for s in recorder.spans() if not s.setup]
    (call,) = [s for s in got if s.name == "pipeline.call"]
    assert call.args == {"graph": True}
    stages = sorted((s for s in got if s.parent == call.span_id),
                    key=lambda s: s.start_ns)
    assert [s.name for s in stages] == STAGES
    assert all(s.device_ms is not None and s.device_ms > 0 for s in stages)


def _kernels(fn, args):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.gpu
def test_a_trace_after_the_capture_holds_the_replayed_kernels(cuda, w48):
    cfg, model = w48
    make = _maker(cfg, model, "e2e")
    a = _inputs(cfg, "e2e", 8, 8)
    make()(*a)                    # cuDNN's autotuning of the shape
    fn = make()
    eager = _kernels(fn, a)
    fn(*a)                                        # captured
    replay = _kernels(fn, a)
    assert sum("dark_decode_kernel" in n for n in replay) == 1
    # the same kernels but for the keypoints' mapping back, now on the
    # card, and the outputs' clones
    assert abs(len(replay) - len(eager)) <= 0.01 * len(eager)
