"""The ViTPose cell (``vitpose_h.infer_b64``) on the CPU: its configuration
is the published ViTPose-H (parameters, the program's config against the
file's topology); the FLOP counts from shapes agree with torch's counter
on the reference; the driver runs at a tiny size and agrees with the
reference; the two new readers give the hand-computed numbers on
synthetic results, and nothing without what they read. On a card
(``gpu``), a ``--trace 1`` run of the cell reads all four of its
per-layer metrics."""
import copy
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline, run
from portbench.drivers import infer_vitpose
from portbench.reference import vitpose as ref_vit
from portbench.tests._tiny import ROOT, drive, load
from portbench.trace import Trace
from rsgnet_tpu_torch.utils import profiler

CELL = "vitpose_h.infer_b64"
CONFIG = "vitpose_h_256x192"
ORIGIN = 1_700_000_000_000_000_000      # the recorder's ns at trace 0 µs
METRICS = ("mfu_pct.vitpose", "vit_blocks.roofline_pct",
           "device_idle_pct.vitpose", "graph_replay_pct.vitpose")


def tiny_config():
    """The configuration cut to the CPU tests' size: width 64, depth 2, 4
    heads, 16-filter deconvs, 64x48 crops, float32."""
    t = copy.deepcopy(load(CONFIG))
    t["dtype"] = t["program"]["DTYPE"] = "float32"
    prog = t["program"]["MODEL"]
    prog["IMAGE_SIZE"], prog["HEATMAP_SIZE"] = [48, 64], [12, 16]
    prog["VIT"].update(EMBED_DIM=64, DEPTH=2, NUM_HEADS=4)
    prog["EXTRA"]["NUM_DECONV_FILTERS"] = [16, 16]
    t["model"].update(image_size=[48, 64], heatmap_size=[12, 16],
                      embed_dim=64, depth=2, num_heads=4,
                      deconv_filters=[16, 16])
    t["pipeline"].update(image_size=[48, 64], heatmap_size=[12, 16])
    return t


def tiny_context():
    manifest = run.read_json("BENCHMARK.json")
    cell = {w["name"]: w for w in manifest["workloads"]}[CELL]
    traffic = dict(run.read_json("portbench", "traffic",
                                 cell["traffic"] + ".json"),
                   batch=4, boxes_per_canvas=2, distinct=2, check_calls=3,
                   warm_calls=1, trace_calls=2)
    return run.Context(CELL, cell, tiny_config(), traffic,
                       run.read_json("portbench", "limits", CELL + ".json"),
                       2 ** 31 + 11, 1.0, False, device="cpu")


def test_the_configuration_is_the_published_vitpose_h():
    f = load(CONFIG)
    assert f["reduced"] == [] and f["cut"].startswith("none")
    with torch.device("meta"):
        net = ref_vit.ViTPose(f["model"])
    assert sum(p.numel() for p in net.parameters()) == f["parameters"] \
        == 637208849
    cfg = infer_vitpose.config(f)
    assert cfg.MODEL.NAME == "pose_vit" and cfg.MODEL.VIT.DEPTH == 32
    bad = copy.deepcopy(f)
    bad["model"]["num_heads"] = 8
    with pytest.raises(ValueError, match="differs"):
        infer_vitpose.config(bad)


@pytest.mark.parametrize("which", ["full", "tiny"])
def test_flops_from_shapes_match_torch_s_counter(which):
    m = load(CONFIG)["model"] if which == "full" else tiny_config()["model"]
    w, h = m["image_size"]
    with torch.device("meta"):
        net = ref_vit.ViTPose(m).eval()
        x = torch.empty(2, 3, h, w)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            net(x)
    assert ref_vit.vitpose_flops(m) == fc.get_total_flops() / 2
    if which == "full":
        assert round(ref_vit.vitpose_flops(m) / 1e9, 1) == 251.7
        assert round(ref_vit.vit_blocks_flops(m, 64) / 1e12, 2) == 15.85


def test_the_driver_agrees_with_the_reference_at_a_tiny_size():
    torch.set_num_threads(4)
    line, res = drive(tiny_context())
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert res["numbers"]["kpt_gap_q25_px"] < 1e-3
    assert res["numbers"]["boxes_off_pct"] == 0.0
    assert res["diag"]["maxval_gap_pct"] < 0.01
    assert set(line["metrics"]) == {"setup_s", "infer_images_per_s"}
    # the facts ``infer.run`` gives, so the shared layers' readers apply
    assert res["facts"]["dark_shape"] == (4, 17, 16, 12)
    assert res["facts"]["blur_kernel"] == 11
    assert res["facts"]["kernel_launches"] is None      # untraced


def _span(name, t0_us, t1_us, parent=None, device_ms=None):
    s = profiler.Span(name, ORIGIN + int(t0_us * 1e3),
                      ORIGIN + int(t1_us * 1e3), "t", 1, (), parent,
                      profiler.new_id(), False, True)
    s.device_ms = device_ms
    return s


@pytest.fixture
def recorder(monkeypatch):
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _result(recorder, blocks_ms=(40.0, 42.0, 41.0, 41.0)):
    """Two traced calls, each with its two forwards' ``vit.blocks``."""
    m = load(CONFIG)["model"]
    host = []
    for k in range(2):
        t = 1000 * k
        call = _span("pipeline.call", t, t + 900)
        host.append(("pipeline.call", t, t + 900))
        for j, ms in enumerate(blocks_ms[2 * k:2 * k + 2]):
            recorder.add(_span("vit.blocks", t + 100 + 300 * j,
                               t + 150 + 300 * j, call.span_id, ms))
        recorder.add(call)
    return {"trace": Trace([("k", 0, 1900)], host, 2000.0, 2),
            "facts": {"cfg": {"model": m}, "batch": 64, "flip_test": True,
                      "images_per_s": 500.0}}


def test_the_readers_give_the_hand_computed_numbers(recorder):
    res = _result(recorder)
    m = res["facts"]["cfg"]["model"]
    blocks = run.metric_reader("vit_blocks.roofline_pct")(res)
    assert blocks == pytest.approx(
        100 * ref_vit.vit_blocks_flops(m, 64) / 0.041
        / roofline.PEAK_BF16_FLOPS)
    assert 30 < blocks < 50                      # 15.85 TFLOP in 41 ms
    mfu = run.metric_reader("mfu_pct.vitpose")(res)
    assert mfu == pytest.approx(100 * 2 * 251.659812864e9 * 500 / 989e12)
    assert run.metric_reader("device_idle_pct.vitpose")(res) == \
        pytest.approx(5.0)


def test_the_blocks_reader_needs_every_span_s_device_time(recorder):
    res = _result(recorder)
    recorder.spans()[0].device_ms = None
    assert run.metric_reader("vit_blocks.roofline_pct")(res) is None


def test_the_blocks_reader_gives_nothing_without_its_spans(recorder):
    res = _result(recorder, blocks_ms=())
    assert run.metric_reader("vit_blocks.roofline_pct")(res) is None


def test_each_metric_has_its_reader_and_the_cell_reports_it():
    manifest = run.read_json("BENCHMARK.json")
    got = {m["name"] for m in run.cell_metrics(manifest, CELL, "per_layer")}
    assert got == set(METRICS)
    e2e = {m["name"] for m in run.cell_metrics(manifest, CELL, "end_to_end")}
    assert e2e == {"setup_s", "infer_images_per_s"}
    for name in METRICS:
        assert run.metric_path(name) is not None


@pytest.mark.gpu
def test_a_traced_run_reads_every_metric_of_the_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", "3000000019", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert set(line["metrics"]) == set(METRICS)
    assert 0 < line["metrics"]["mfu_pct.vitpose"]["value"] < 100
    assert 0 < line["metrics"]["vit_blocks.roofline_pct"]["value"] < 100
    assert line["metrics"]["graph_replay_pct.vitpose"]["value"] == 100.0


@pytest.mark.gpu
def test_the_shared_layers_readers_read_a_traced_run():
    """The readers of the layers this cell shares with W48 (B1's roofline,
    the kernels, the glue and the first call) find what they read in a
    traced run of this cell, though the cell does not report them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cell, cfg, traffic, limits = run.load_cell(CELL)
    ctx = run.Context(CELL, cell, cfg, traffic, limits, 3000000037, 2.0,
                      True)
    line, res = drive(ctx)
    assert line["correct"]
    assert res["facts"]["kernel_launches"] == traffic["trace_calls"]
    for name in ("dark_decode.roofline_pct", "kernels_per_call.infer",
                 "pipeline_glue_ms.infer", "first_call_s.infer"):
        value = run.metric_reader(name)(res)
        assert value is not None and value > 0, name
    assert run.metric_reader("dark_decode.roofline_pct")(res) < 100


def test_the_reference_and_readers_load_nothing_of_the_program():
    code = ("import sys, portbench.reference.vitpose, portbench.roofline\n"
            "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin",
                            "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert not set(p.stdout.split()) & {"jax", "jaxlib", "flax",
                                        "rsgnet_tpu", "rsgnet_tpu_torch"}
    assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                       "vit_blocks.roofline_pct.py"))
