"""Without a card, or without the program beside it, a run prints no
result and exits with another code than 0."""
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests._tiny import ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "w48_dark.infer_b64", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run(ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    p = _run(tmp_path, env)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.mark.gpu
def test_refuses_on_a_card_with_only_the_benchmark(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    test_refuses_with_only_the_benchmark(tmp_path)
