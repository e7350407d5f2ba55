"""Tiny float32 copies of the benchmark's configurations for the CPU tests:
the module graph of the full model (every stage, transition and the RSG
head) with shrunk channels, blocks and input, as the program's own
``tiny_rsgnet`` preset."""
from __future__ import annotations

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_STAGES = (([8, 16], [1, 1]), ([8, 16, 32], [1, 1, 1]),
           ([8, 16, 32, 64], [1, 1, 1, 1]))


def load(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def tiny(name, image_size=(64, 96), heatmap_size=(16, 24)):
    """The configuration file ``name`` cut to the CPU tests' size."""
    t = copy.deepcopy(load(name))
    t["dtype"] = "float32"
    prog = t["program"]
    prog["DTYPE"] = "float32"
    prog["MODEL"]["IMAGE_SIZE"] = list(image_size)
    prog["MODEL"]["HEATMAP_SIZE"] = list(heatmap_size)
    prog["MODEL"]["RSG"]["NODE_CHANNELS"] = 8
    prog["MODEL"]["RSG"]["RELATION_CHANNELS"] = 8
    for key, (ch, nb) in zip(("STAGE2", "STAGE3", "STAGE4"), _STAGES):
        st = prog["MODEL"]["EXTRA"][key]
        st["NUM_CHANNELS"], st["NUM_BLOCKS"], st["NUM_MODULES"] = ch, nb, 1
    m = t["model"]
    m["image_size"], m["heatmap_size"] = list(image_size), list(heatmap_size)
    m["rsg"]["node_channels"] = m["rsg"]["relation_channels"] = 8
    for st, (ch, nb) in zip(m["stages"], _STAGES):
        st["channels"], st["blocks"], st["modules"] = ch, nb, 1
    for part in ("pipeline",):
        t[part]["image_size"] = list(image_size)
        t[part]["heatmap_size"] = list(heatmap_size)
    return t


# the cells' traffic cut to the CPU tests' size
TRAFFIC = {
    "infer_b64": dict(batch=4, canvas=640, boxes_per_canvas=2, distinct=2,
                      check_calls=3, warm_calls=1, trace_calls=2),
    "train_b128": dict(batch=4, canvas=640, distinct=3),
    "train_dp4": dict(batch=8, canvas=640, distinct=3),
    "serve_poisson": dict(rate=8.0, pool=16, buckets=[1, 2, 4, 8, 16],
                          check_requests=8, wait_s=30.0, trace_seconds=0.5,
                          max_instances=8),
}


# cells whose driver and traffic exist but which BENCHMARK.json does not
# hold (PERF.md, open questions): their entries, and the limits the CPU
# tests hold them to
_TRAIN_LIMITS = {"grad1_gap_pct": {"limit": 1.0},
                 "update3_gap_pct": {"limit": 45.0}}
UNLISTED = {
    "w32.train_b128": (
        {"name": "w32.train_b128", "config": "rsgnet_w32_256x192",
         "traffic": "train_b128", "chips": 1}, _TRAIN_LIMITS),
    "w32.train_dp4": (
        {"name": "w32.train_dp4", "config": "rsgnet_w32_256x192",
         "traffic": "train_dp4", "chips": 4},
        dict(_TRAIN_LIMITS, rank_gap={"limit": 0.0}))}


def context(cell_name, seed=2 ** 31 + 11, seconds=1.0, hooks=None):
    """A CPU ``run.Context`` of the cell at the tests' size."""
    from portbench import run
    manifest = run.read_json("BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name in cells:
        cell = cells[cell_name]
        limits = run.read_json("portbench", "limits", cell_name + ".json")
    else:
        cell, limits = UNLISTED[cell_name]
    traffic = dict(run.read_json("portbench", "traffic",
                                 cell["traffic"] + ".json"),
                   **TRAFFIC[cell["traffic"]])
    return run.Context(cell_name, cell, tiny(cell["config"]), traffic,
                       limits, seed, seconds, False, device="cpu",
                       hooks=dict(hooks or {}))


def drive(ctx):
    """Run the cell's driver and judge it as the harness does; returns
    (result line, driver result)."""
    import contextlib
    import importlib
    import io
    import json

    from portbench import run
    driver = importlib.import_module(
        "portbench.drivers." + ctx.traffic["driver"])
    res = driver.run(ctx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.finish(run.read_json("BENCHMARK.json"), ctx, res,
                   {"platform": "cpu", "kind": "cpu", "count": 1})
    return json.loads(out.getvalue().strip().splitlines()[-1]), res
