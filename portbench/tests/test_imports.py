"""In a fresh interpreter: a cell's run (drivers, program, reference)
loads no module whose top-level name is jax, jaxlib, flax or rsgnet_tpu,
and the reference loads nothing of the program."""
import json
import subprocess
import sys

from portbench.tests._tiny import ROOT

BANNED = {"jax", "jaxlib", "flax", "rsgnet_tpu"}


def _modules(code):
    p = subprocess.run([sys.executable, "-c", code +
                        "\nimport json, sys\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "list(sys.modules)})))"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin",
                            "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_cell_run_loads_no_jax():
    code = ("import torch\ntorch.set_num_threads(2)\n"
            "from portbench.tests import _tiny\n"
            "for c in ('w48_dark.infer_b64', 'w32.train_b128', "
            "'w48_dark.serve_poisson'):\n"
            "    _tiny.drive(_tiny.context(c))\n"
            "import portbench.controls, portbench.sweep_serve\n")
    mods = _modules(code)
    assert "rsgnet_tpu_torch" in mods
    assert not mods & BANNED


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import portbench.reference.model, "
                    "portbench.reference.pipeline, portbench.weights, "
                    "portbench.compare, portbench.roofline, portbench.inputs")
    assert not mods & (BANNED | {"rsgnet_tpu_torch"})
