"""One short run of each cell on the card (skips without one):

    python -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]
                                  if w["chips"] == 1])
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000029", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
