"""Run one benchmark cell once and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``) and its traffic
(``portbench/traffic/<traffic>.json``, which names the driver in
``portbench/drivers/``); its limits are ``portbench/limits/<cell>.json``
and each per-layer metric is read by ``portbench/metrics/<metric>.py``
(or by the file of a prefix of its name: ``metric_path``).
The driver loads the program, warms up, measures for ``--seconds``, and
checks what the timed path produced against the plain reference
(``portbench/reference/``). The last line on standard output is one JSON
object; the compared numbers and their limits are the last lines on
standard error too.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "rsgnet_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")


class Refused(Exception):
    """The run cannot measure: no result line, a non-zero exit."""


@dataclass
class Context:
    """What a driver gets: the cell as the manifest and its files give it,
    the run's arguments, and the process's start on the host clock."""
    name: str
    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = T0
    hooks: dict = field(default_factory=dict)   # tests plant faults here


def read_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_cell(name):
    """(manifest, cell entry, configuration, traffic, limits) of ``name``."""
    manifest = read_json("BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return (manifest, cell, read_json("portbench", "configs",
                                      cell["config"] + ".json"),
            read_json("portbench", "traffic", cell["traffic"] + ".json"),
            read_json("portbench", "limits", name + ".json"))


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def metric_path(name):
    """``portbench/metrics/<name>.py``, or else the file of the longest
    prefix of ``name`` ending before a dot: ``device_idle_pct.serve`` is
    read by ``device_idle_pct.py`` unless ``device_idle_pct.serve.py``
    exists. None if neither does."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        path = os.path.join(ROOT, "portbench", "metrics",
                            ".".join(parts[:i]) + ".py")
        if os.path.isfile(path):
            return path
    return None


def metric_reader(name):
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest, name, kind):
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def card_info(torch, chips):
    import subprocess
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        limit = []
    return info, limit


def set_cache_dirs():
    """Kernel and extension caches at fixed paths inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    manifest, cell, cfg, traffic, limits = load_cell(args.workload)

    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA card(s); "
                      f"available: {torch.cuda.is_available()}, count "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device, power = card_info(torch, chips)
    for line in power:
        print(f"card: {line}", file=sys.stderr, flush=True)

    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = Context(args.workload, cell, cfg, traffic, limits, args.seed,
                  args.seconds, bool(args.trace))
    res = driver.run(ctx)
    return finish(manifest, ctx, res, device)


def finish(manifest, ctx, res, device):
    """Judge, read the metrics, print the result; returns the exit code."""
    print(f"setup_s {res['setup_s']!r}", file=sys.stderr)
    banned = banned_modules()
    if banned:
        raise Refused(f"modules of JAX or the JAX package were loaded: "
                      f"{banned}")
    device = dict(device, memory_peak_bytes=int(res["memory_peak_bytes"]))
    metrics = {}
    line = {}
    if ctx.trace:
        tr = res.get("trace")
        if tr is None:
            raise Refused("the profiler saw no device events")
        device["busy_s"] = tr.busy_us() / 1e6
        device["window_s"] = tr.wall_us / 1e6
        for m in cell_metrics(manifest, ctx.name, "per_layer"):
            value = metric_reader(m["name"])(res)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["breakdown"] = tr.breakdown()
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in cell_metrics(manifest, ctx.name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks = {k: {"value": v, "limit": ctx.limits[k]["limit"]}
              for k, v in res["numbers"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": device, **line, "checks": checks}
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


def entry():
    try:
        code = main()
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        code = 2
    sys.exit(code)


if __name__ == "__main__":
    entry()
