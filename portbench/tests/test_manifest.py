"""BENCHMARK.json against the benchmark's contract: legal names, units and
lengths; every file a cell, configuration or metric names exists; each
configuration is the published model (parameter counts)."""
import os
import re

import pytest
import torch

from portbench import run
from portbench.reference.model import PoseRSGNet
from portbench.reference.pipeline import COCO_SKELETON
from portbench.tests._tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
M = run.read_json("BENCHMARK.json")


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(map(text_ok, M["command"]))
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_legal(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and text_ok(c["source"]) and text_ok(c["why"])
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        f = run.read_json(c["file"])
        assert f["reduced"] == c["reduced"]


@pytest.mark.parametrize("name,params", [("rsgnet_w48_384x288_dark",
                                          63692722),
                                         ("rsgnet_w32_256x192", 28621826)])
def test_config_is_the_published_model(name, params):
    f = run.read_json("portbench", "configs", name + ".json")
    with torch.device("meta"):
        net = PoseRSGNet(f["model"], COCO_SKELETON)
    assert sum(p.numel() for p in net.parameters()) == params == \
        f["parameters"]


def test_workloads():
    ws = M["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        for part in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.isfile(os.path.join(ROOT, "portbench", part[0],
                                               part[1] + ".json"))
        drv = run.read_json("portbench", "traffic", w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(ROOT, "portbench", "drivers",
                                           drv["driver"] + ".py"))


def test_metrics():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", []):
            reports = e2e[m["moves"]].get("workloads", cells)
            assert w in cells and w in reports
        assert run.metric_path(m["name"]) is not None
        layers.add(m["layer"])
    for w in cells:
        e = run.cell_metrics(M, w, "end_to_end")
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert run.cell_metrics(M, w, "per_layer")


def test_limits_name_the_compared_numbers():
    for w in M["workloads"]:
        lim = run.read_json("portbench", "limits", w["name"] + ".json")
        assert lim and all(isinstance(v["limit"], (int, float))
                           for v in lim.values())


def test_a_metric_is_read_by_its_own_file_or_its_prefix_s():
    def rel(name):
        return os.path.relpath(run.metric_path(name), ROOT)
    assert rel("dark_decode.roofline_pct") == \
        "portbench/metrics/dark_decode.roofline_pct.py"
    assert rel("device_idle_pct.serve") == \
        "portbench/metrics/device_idle_pct.py"
    assert rel("mfu_pct.infer") == "portbench/metrics/mfu_pct.py"
    assert run.metric_path("no_such_metric.serve") is None
