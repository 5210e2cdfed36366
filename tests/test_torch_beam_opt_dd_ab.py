"""The compare step of tools/beam_opt_dd_ab.py on small synthetic dumps.

The tool's ``run`` needs a CUDA card; ``compare`` reads two dumps (a JSON
of hashes and times beside an npz of #8's outputs) and decides whether two
checkouts' kernels agree: I, mu, nu and the pivot bit for bit, stats to
rounding, every other kernel's hash exactly.
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


def _dump(prefix, arrays, hashes):
    np.savez(prefix.with_suffix(".npz"), **arrays)
    prefix.with_suffix(".json").write_text(json.dumps(dict(
        hashes=hashes, times={"n=101 B=256": dict(kernel=0.5, wrapper=0.6)})))


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for case, nelem in (("rb101", 6), ("fixed201", 9)):
        out[f"{case}.I"] = rng.random((5, nelem), dtype=np.float32) + 0.1
        out[f"{case}.mu"] = rng.standard_normal((5, nelem)).astype(np.float32)
        out[f"{case}.nu"] = rng.random((5, nelem), dtype=np.float32)
        out[f"{case}.stats"] = rng.random((5, 4), dtype=np.float32)
        out[f"{case}.pivot"] = rng.random(5, dtype=np.float32)
    out["rb101.pivot"][2] = np.nan      # a NaN lane stays NaN in both
    return out


def _flip_last_bit(a, index):
    b = a.copy()
    b.view(np.uint32)[index] ^= 1
    return b


@pytest.mark.parametrize("change", ["none", "I", "pivot", "stats", "hash"])
def test_compare(tmp_path, change):
    """Equal dumps compare equal; one bit off in I or the pivot, or another
    kernel's hash off, makes them differ; one bit off in stats does not."""
    tool = _tool()
    hashes = {"#8 rb101 I": "a", "#1 fixed101": "b", "#7 rb101": "c"}
    a = _arrays(0)
    b = {k: v.copy() for k, v in a.items()}
    hashes_b = dict(hashes)
    if change in ("I", "pivot", "stats"):
        key = f"rb101.{change}"
        b[key] = _flip_last_bit(a[key], (1, 3) if change != "pivot" else 4)
    if change == "hash":
        hashes_b["#7 rb101"] = "d"
    _dump(tmp_path / "a", a, hashes)
    _dump(tmp_path / "b", b, hashes_b)
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert r["equal"] == (change in ("none", "stats"))
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        0 if r["equal"] else 1)
    for key, row in r["outputs"].items():
        off = change in ("I", "pivot", "stats") and key == f"rb101.{change}"
        assert row["bitwise"] == (not off)
        assert row["max_ulps"] == (1 if off else 0)
        assert (row["max_abs"] > 0) == off
    assert r["hashes"]["#7 rb101"] == (change != "hash")
    assert "#8 rb101 I" not in r["hashes"]   # #8 is held by its arrays
