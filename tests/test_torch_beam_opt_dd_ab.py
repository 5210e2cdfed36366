"""The compare step of tools/beam_opt_dd_ab.py on small synthetic dumps.

The tool's ``run`` needs a CUDA card; ``compare`` reads two dumps (a JSON
of hashes and times beside an npz of the kernel's outputs) and decides
whether two checkouts' kernels agree.  For #8 (``--kernel opt_dd``): I, mu,
nu and the pivot bit for bit, stats to rounding, every other kernel's hash
exactly.  For #2 (``--kernel opt``): its outputs are reported in float32
ulps, not held to bits; every other kernel's hash exactly.  For #7
(``--kernel analysis_dd``): the pivot bit for bit, u, V and M within 1 ulp.
For #1 (``--kernel analysis``): reported in ulps, and no lane's validity at
1e-9 may flip.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "beam_opt_dd_ab.py"


def _tool():
    spec = importlib.util.spec_from_file_location("beam_opt_dd_ab", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dump(prefix, arrays, hashes, kernel):
    np.savez(prefix.with_suffix(".npz"), **arrays)
    prefix.with_suffix(".json").write_text(json.dumps(dict(
        kernel=kernel, hashes=hashes,
        times={"n=101 B=256": dict(kernel=0.5, wrapper=0.6)})))


def _arrays(seed, kernel):
    """#8's fields per input set, or #2's per input set and mode (no
    pivot)."""
    rng = np.random.default_rng(seed)
    out = {}
    for case, nelem in (("rb101", 6), ("fixed201", 9)):
        for mode in ((None,) if kernel == "opt_dd" else ("semi", "adjoint")):
            key = case if mode is None else f"{case}.{mode}"
            out[f"{key}.I"] = rng.random((5, nelem), dtype=np.float32) + 0.1
            out[f"{key}.mu"] = rng.standard_normal((5, nelem)).astype(
                np.float32)
            out[f"{key}.nu"] = rng.random((5, nelem), dtype=np.float32)
            out[f"{key}.stats"] = rng.random((5, 4), dtype=np.float32)
            if kernel == "opt_dd":
                out[f"{key}.pivot"] = rng.random(5, dtype=np.float32)
    if kernel == "opt_dd":
        out["rb101.pivot"][2] = np.nan      # a NaN lane stays NaN in both
    else:
        out["rb101.semi.I"][2, 1] = np.nan
    return out


def _flip_last_bit(a, index):
    b = a.copy()
    b.view(np.uint32)[index] ^= 1
    return b


@pytest.mark.parametrize("change", ["none", "I", "pivot", "stats", "hash",
                                    "opt:none", "opt:I", "opt:hash"])
def test_compare(tmp_path, change):
    """Equal dumps compare equal.  #8: one bit off in I or the pivot, or
    another kernel's hash off, makes them differ; one bit off in stats does
    not.  #2: one bit off in I is reported as 1 ulp and does not make them
    differ; another kernel's hash off does."""
    tool = _tool()
    kernel, _, change = change.rpartition(":")
    kernel = kernel or "opt_dd"
    own = "#8 rb101 I" if kernel == "opt_dd" else "#2 fixed101 semi"
    other = "#7 rb101" if kernel == "opt_dd" else "#8 rb101 I"
    hashes = {own: "a", "#1 fixed101": "b", other: "c"}
    a = _arrays(0, kernel)
    b = {k: v.copy() for k, v in a.items()}
    hashes_b = dict(hashes)
    prefix = "rb101" if kernel == "opt_dd" else "rb101.semi"
    if change in ("I", "pivot", "stats"):
        key = f"{prefix}.{change}"
        b[key] = _flip_last_bit(a[key], (1, 3) if change != "pivot" else 4)
    if change == "hash":
        hashes_b[other] = "d"
    _dump(tmp_path / "a", a, hashes, kernel)
    _dump(tmp_path / "b", b, hashes_b, kernel)
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    held = ("none", "stats") if kernel == "opt_dd" else ("none", "I")
    assert r["equal"] == (change in held)
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        0 if r["equal"] else 1)
    for key, row in r["outputs"].items():
        off = change in ("I", "pivot", "stats") and key == f"{prefix}.{change}"
        assert row["bitwise"] == (not off)
        assert row["max_ulps"] == (1 if off else 0)
        assert (row["max_abs"] > 0) == off
        assert row["exact"] == (kernel == "opt_dd"
                                and not key.endswith(".stats"))
    assert r["hashes"][other] == (change != "hash")
    assert own not in r["hashes"]   # the kernel is held by its arrays


def _analysis_arrays(seed):
    """#1's or #7's fields per input set: u (B, n, 3), V, M, pivot, with
    pivots on both sides of the validity gate."""
    rng = np.random.default_rng(seed)
    out = {}
    for case, n in (("rb101", 6), ("fixed201", 9)):
        out[f"{case}.u"] = rng.standard_normal((5, n, 3)).astype(np.float32)
        out[f"{case}.u"][..., 0] = 0.0
        out[f"{case}.V"] = rng.standard_normal((5, n - 1)).astype(np.float32)
        out[f"{case}.M"] = rng.standard_normal((5, n - 1)).astype(np.float32)
        out[f"{case}.pivot"] = np.array([2e-9, 1e-3, 5e-10, 0.1, 3e-9],
                                        np.float32)
    out["rb101.u"][2] = np.nan          # a NaN lane stays NaN in both
    return out


@pytest.mark.parametrize("kernel", ["analysis", "analysis_dd"])
@pytest.mark.parametrize("change", ["none", "u 1 ulp", "u 2 ulp",
                                    "pivot 1 ulp", "pivot flips", "hash"])
def test_compare_analysis(tmp_path, kernel, change):
    """#7: the pivot held bitwise, u, V, M to 1 ulp; #1: u, V, M and the
    pivot reported in ulps, a lane whose validity flips makes the dumps
    differ; for both another kernel's hash off does."""
    tool = _tool()
    own = "#1 fixed101" if kernel == "analysis" else "#7 rb101"
    other = "#7 rb101" if kernel == "analysis" else "#1 fixed101"
    hashes = {own: "a", "#2 fixed101 semi": "b", other: "c"}
    a = _analysis_arrays(1)
    b = {k: v.copy() for k, v in a.items()}
    hashes_b = dict(hashes)
    if change == "u 1 ulp":
        b["rb101.u"] = _flip_last_bit(a["rb101.u"], (1, 2, 1))
    if change == "u 2 ulp":
        b["rb101.u"].view(np.uint32)[1, 2, 1] ^= 2
    if change == "pivot 1 ulp":
        b["fixed201.pivot"] = _flip_last_bit(a["fixed201.pivot"], 1)
    if change == "pivot flips":
        b["fixed201.pivot"][0] = 9e-10
    if change == "hash":
        hashes_b[other] = "d"
    _dump(tmp_path / "a", a, hashes, kernel)
    _dump(tmp_path / "b", b, hashes_b, kernel)
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    held = {"analysis": ("none", "u 1 ulp", "u 2 ulp", "pivot 1 ulp"),
            "analysis_dd": ("none", "u 1 ulp")}[kernel]
    assert r["equal"] == (change in held)
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        0 if r["equal"] else 1)
    assert r["outputs"]["fixed201.pivot"]["flips"] == (
        1 if change == "pivot flips" else 0)
    ulps = r["outputs"]["rb101.u"]["max_ulps"]
    assert ulps == {"u 1 ulp": 1, "u 2 ulp": 2}.get(change, 0)
    assert r["outputs"]["rb101.pivot"]["exact"] == (kernel == "analysis_dd")
    assert r["hashes"][other] == (change != "hash")
    assert own not in r["hashes"]   # the kernel is held by its arrays


def _solve_arrays(seed):
    """#3's fields per input set and refinement count: x (B, n, 3) with
    exact zeros at constrained DOFs, and pivots on both sides of the
    validity gate; one NaN lane."""
    rng = np.random.default_rng(seed)
    out = {}
    for case, n in (("fixed101", 6), ("random51", 4)):
        for r in (0, 1, 2):
            x = rng.standard_normal((5, n, 3)).astype(np.float32)
            x[:, 0, :2] = 0.0
            x[3] = np.nan
            out[f"{case}.refine{r}.x"] = x
            out[f"{case}.refine{r}.pivot"] = np.array(
                [2e-9, 1e-3, 5e-10, np.nan, 3e-9], np.float32)
    return out


@pytest.mark.parametrize("change", ["none", "signed zero", "x 1 ulp",
                                    "pivot 1 ulp", "pivot flips", "nan",
                                    "hash"])
def test_compare_solve(tmp_path, change):
    """#3: x and the pivot held equal in value; a zero of the other sign is
    counted apart and does not make the dumps differ, one ulp off in x or
    the pivot does, as does a lane whose validity flips, a lane that is
    NaN on one side only, or another kernel's hash."""
    tool = _tool()
    hashes = {"#3 fixed101": "a", "#1 fixed101": "b", "#8 rb101 I": "c"}
    a = _solve_arrays(2)
    b = {k: v.copy() for k, v in a.items()}
    hashes_b = dict(hashes)
    key = "fixed101.refine1.x"
    if change == "signed zero":
        b[key][1, 0, 0] = -0.0
    if change == "x 1 ulp":
        b[key] = _flip_last_bit(a[key], (2, 1, 2))
    if change == "pivot 1 ulp":
        b["random51.refine2.pivot"] = _flip_last_bit(
            a["random51.refine2.pivot"], 1)
    if change == "pivot flips":
        b["random51.refine0.pivot"][4] = 9e-10
    if change == "nan":
        b[key][0, 2, 1] = np.nan
    if change == "hash":
        hashes_b["#1 fixed101"] = "d"
    _dump(tmp_path / "a", a, hashes, "solve")
    _dump(tmp_path / "b", b, hashes_b, "solve")
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert r["equal"] == (change in ("none", "signed zero"))
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        0 if r["equal"] else 1)
    row = r["outputs"][key]
    assert row["signed_zeros"] == (1 if change == "signed zero" else 0)
    assert row["bitwise"] == (change not in ("signed zero", "x 1 ulp",
                                             "nan"))
    assert row["value_equal"] == (change in ("none", "signed zero",
                                             "pivot 1 ulp", "pivot flips",
                                             "hash"))
    # a NaN against a number is as far as the bit patterns lie
    assert (row["max_ulps"] > 1 if change == "nan" else
            row["max_ulps"] == (1 if change == "x 1 ulp" else 0))
    assert r["outputs"]["random51.refine0.pivot"]["flips"] == (
        1 if change == "pivot flips" else 0)
    assert all(v["held_value"] and not v["exact"]
               for v in r["outputs"].values())
    assert r["hashes"]["#1 fixed101"] == (change != "hash")
    assert "#3 fixed101" not in r["hashes"]   # held by its arrays
