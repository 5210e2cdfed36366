"""The comparison that decides ``correct`` fails its control and every
fault a datagen cell can have, at sizes a CPU test holds: the TF32 control
in the program's place, and full runs of the harness (without its look for
a card) with the timed path broken underneath."""

import io
import json
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import registry  # noqa: E402
from portbench.harness.main import _args, run  # noqa: E402

SPEC = json.loads((Path(__file__).resolve().parents[2]
                   / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def small_cell(name):
    """The cell with 16 lanes a batch, 8 of them judged, and at most 100
    epochs, so that the CPU runs it."""
    cell = registry.cell(name)
    cell["traffic"] = dict(cell["traffic"], lanes=16, sample_per_batch=8)
    cell["config"]["optimizer"]["max_epochs"] = 100
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _failed(cell, numbers):
    limits = cell["workload"]["limits"]
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name):
    from portbench.checks.calibrate import control

    cell = small_cell(name)
    cell["traffic"]["lanes"] = 64
    out = control(cell, 3000000021, 16, "cpu")
    assert out["numbers"]["scenario_mismatch"] == 0
    assert _failed(cell, out["numbers"])


def _run(name, seed=3000000023, trace=0):
    """A whole run of the small cell on the CPU, past the look for a
    card."""
    args = _args(["--workload", name, "--seed", str(seed), "--seconds",
                  "0.1", "--trace", str(trace)])
    cell = small_cell(name)
    session = registry.load_module("entries", cell["workload"]["entry"]) \
        .Session(cell, seed, "cpu", bool(trace))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run(cell, session, args, time.perf_counter())
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    # the numbers compared are the last lines of standard error
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    return line


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 16 and set(line["metrics"]) == {
        m["name"] for m in registry.cell(name)["end_to_end"]}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_under_the_timed_path_is_caught(name, fault):
    from portbench.checks.faults import planted

    with planted(fault):
        line = _run(name)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_epoch_loop(name):
    """The traced run's wrappers count the work the batch program needed
    and the lanes it launched: every launched step carries at least the
    lanes still running, so the ratio is at least 1."""
    line = _run(name, trace=1)
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["lane_epochs_per_s"] > 0 and m["datagen_mfu"] > 0
    assert m["launched_lane_epochs_ratio"] >= 1.0
    assert "device_idle_share" not in m      # no device ran an operation
