"""The control of ``correct``: the reference computed in float8 where the
configuration computes in bfloat16. On the card, at each cell's own size,
it fails the cell's limits (``gpu``); here, at a tiny size on the CPU, it
reads far above what the program reads there against the same reference
(the tiny model's gaps are smaller than the full model's, so the cells'
limits do not apply to it)."""
import pytest
import torch

from portbench import controls, run
from portbench.tests import _tiny

CONTROL_SEEDS = {
    "w48_dark.infer_b64": (4100000021, 4100000022, 4100000023),
    "w48_dark.serve_poisson": (4000000021, 4000000022, 4000000023),
}
CELLS = ["w48_dark.infer_b64", "w48_dark.serve_poisson", "w32.train_b128",
         "w32.train_dp4"]
# the number each control is held by at the tiny size
TINY = {"w48_dark.infer_b64": "maxval_gap_pct",
        "w48_dark.serve_poisson": "maxval_gap_pct",
        "w32.train_b128": "grad1_gap_pct", "w32.train_dp4": "grad1_gap_pct"}


def _fails(cell, numbers):
    limits = run.read_json("portbench", "limits", cell + ".json")
    return any(numbers[k] > v["limit"] for k, v in limits.items()
               if k in numbers)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program(cell):
    torch.set_num_threads(4)
    ctx = _tiny.context(cell)
    _, res = _tiny.drive(_tiny.context(cell))
    program_reading = dict(res["numbers"], **res.get("diag", {}))[TINY[cell]]
    control = controls.read(ctx, "control")[TINY[cell]]
    assert control > 30 * max(program_reading, 1e-4), (control,
                                                        program_reading)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CONTROL_SEEDS))
def test_control_fails_the_limits_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    manifest, c, cfg, traffic, limits = run.load_cell(cell)
    # the seeds whose control readings PERF.md gives
    for seed in CONTROL_SEEDS[cell]:
        ctx = run.Context(cell, c, cfg, traffic, limits, seed,
                          manifest["run_seconds"], False)
        assert _fails(cell, controls.read(ctx, "control"))
