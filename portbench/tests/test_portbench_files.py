"""The benchmark's files: ``BENCHMARK.json`` against the contract, every
cell, configuration, traffic mix, metric reader and entry found by name,
the frozen yardstick against the script it was copied from, and what the
benchmark's modules import."""

import ast
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import registry, roofline  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
        assert len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(name):
    cell = registry.cell(name)
    wl = cell["workload"]
    assert (BENCH / "entries" / f"{wl['entry']}.py").is_file()
    assert hasattr(registry.load_module("entries", wl["entry"]), "Session")
    assert cell["config"]["reduced"] == []
    assert cell["traffic"]["lanes"] >= 1
    from portbench.reference.judge import NUMBERS

    assert set(wl["limits"]) == set(NUMBERS)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["end_to_end"]
                                  + SPEC["per_layer"]])
def test_metric_reader_found_by_name(name):
    from portbench.harness.readings import Readings

    reader = registry.load_module("metrics", name)
    # a reader that finds nothing to read returns nothing, never 0
    assert reader.read(Readings()) is None or name == "setup_s"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", roofline.KINDS)
@pytest.mark.parametrize("n", [101, 201])
def test_frozen_roofline_counts_equal_the_smoke_script(kind, n):
    cs = _chip_smoke()
    for refine in (0, 1, 2):
        assert roofline.flops_per_lane(n, refine, kind) == \
            cs.flops_per_lane(n, refine, kind)
        assert abs(roofline.bound_s(16384, n, refine, kind) * 1e3
                   - cs.bound_ms(16384, n, refine, kind)[0]) < 1e-12
    assert roofline.bytes_per_lane(n, kind) == cs.bytes_per_lane(n, kind)
    assert (roofline.HBM_BYTES_PER_S, roofline.F32_FLOPS_PER_S,
            roofline.F64_FLOPS_PER_S) == (cs.HBM_BYTES_PER_S,
                                          cs.F32_FLOPS_PER_S,
                                          cs.F64_FLOPS_PER_S)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "openpystruct_tpu"}
    if "reference" in path.relative_to(BENCH).parts:
        assert "openpystruct_tpu_torch" not in tops
    # and nothing the benchmark runs reads the smoke script, the tools or
    # the older benchmarks (a test compares the yardstick with the script)
    if "tests" not in path.relative_to(BENCH).parts:
        assert not tops & {"chip_smoke", "benchmarks", "tools", "bench"}
        assert "chip_smoke.py" not in path.read_text()


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(CUDA_VISIBLE_DEVICES="", PATH="/usr/bin:/bin",
               HOME=str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", "3000000001", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert out.returncode != 0
    assert '"metrics"' not in out.stdout and out.stdout.strip() == ""
