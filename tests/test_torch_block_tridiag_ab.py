"""The compare step of tools/block_tridiag_ab.py on small synthetic dumps.

The tool's ``run`` needs a CUDA card; ``compare`` reads two dumps (a JSON
of hashes and times beside an npz of kernels #4's and #6's outputs) and
decides whether two checkouts' block-Thomas kernels agree: #4, #5 and #9
(its escalation route included) bit for bit, or but for the sign of zeros,
#4 and #6 reported as bitwise equal or by their gaps in float32 ulps.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "block_tridiag_ab.py"


def _tool():
    spec = importlib.util.spec_from_file_location("block_tridiag_ab", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dump(prefix, six, hashes):
    np.savez(prefix.with_suffix(".npz"), **six)
    prefix.with_suffix(".json").write_text(json.dumps(dict(
        hashes=hashes, errors={"#6 fixed bridge, n=101": 1e-6},
        times={"n=101 B=512": dict(kernel=0.02, wrapper=0.03,
                                   device_us=dict(fwd=12.5, bwd=4.5))})))


@pytest.mark.parametrize("change", ["none", "#4", "#5", "#9", "#6"])
def test_compare(tmp_path, change, capsys):
    """Equal dumps compare equal.  A #4, #5 or #9 hash off makes them
    differ; #6 one bit off is reported as 1 ulp and does not."""
    tool = _tool()
    rng = np.random.default_rng(0)
    six = {k: rng.standard_normal((4, 7, 3)).astype(np.float32)
           for k in ("fixed bridge, n=101", "random bridge, n=201")}
    six["random bridge, n=201"][2] = np.nan   # a NaN lane stays NaN in both
    hashes = {"#4 fixed bridge, n=101": "a", "#5 fixed bridge, n=101": "b",
              "#6 fixed bridge, n=101": "c", "#9 overhang, n=1001 x": "d",
              "#4 card test systems, seed 7": "e"}
    six_b = {k: v.copy() for k, v in six.items()}
    hashes_b = dict(hashes)
    if change in ("#4", "#5", "#9"):
        key = next(k for k in hashes if k.startswith(change))
        hashes_b[key] = "x"
    if change == "#6":
        six_b["fixed bridge, n=101"].view(np.uint32)[1, 3, 2] ^= 1
        hashes_b["#6 fixed bridge, n=101"] = "y"
    _dump(tmp_path / "a", six, hashes)
    _dump(tmp_path / "b", six_b, hashes_b)
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert r["equal"] == (change in ("none", "#6"))
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        0 if r["equal"] else 1)
    for key, row in r["six"].items():
        off = change == "#6" and key == "fixed bridge, n=101"
        assert row["bitwise"] == (not off)
        assert row["max_ulps"] == (1 if off else 0)
    out = capsys.readouterr().out
    assert ("differs by up to 1 ulp" in out) == (change == "#6")
    assert "device us fwd 12.5 / 12.5 | bwd 4.5 / 4.5" in out


@pytest.mark.parametrize("case", ["equal", "differs", "lanes_last parent"])
def test_compare_four(tmp_path, case, capsys):
    """#4's outputs beside #6's in the npz ("#4 " keys): bitwise equal
    outputs compare equal whatever layout the parent's launcher took; one
    bit off (its hash off too) makes the trees differ, with the gap in
    ulps; #4's times print with their device us."""
    tool = _tool()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 7, 3)).astype(np.float32)
    arrays = {"fixed bridge, n=101": x, "#4 fixed bridge, n=101": x}
    hashes = {"#4 fixed bridge, n=101": "a", "#5 fixed bridge, n=101": "b",
              "#9 overhang, n=1001 x": "d"}
    arrays_b = {k: v.copy() for k, v in arrays.items()}
    hashes_b = dict(hashes)
    if case == "differs":
        arrays_b["#4 fixed bridge, n=101"].view(np.uint32)[0, 0, 0] ^= 1
        hashes_b["#4 fixed bridge, n=101"] = "z"
    times = {"#4 n=51 B=512": dict(kernel=0.03, wrapper=0.04,
                                   device_us=dict(kernel=15.25))}
    for prefix, arr, hs, layout in (
            (tmp_path / "a", arrays, hashes,
             "lanes_last" if case == "lanes_last parent" else "lanes_first"),
            (tmp_path / "b", arrays_b, hashes_b, "lanes_first")):
        np.savez(prefix.with_suffix(".npz"), **arr)
        prefix.with_suffix(".json").write_text(json.dumps(dict(
            layout=layout, hashes=hs, errors={}, times=times)))
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert set(r["four"]) == {"fixed bridge, n=101"}
    assert set(r["six"]) == {"fixed bridge, n=101"}
    assert r["equal"] == (case != "differs")
    assert r["four"]["fixed bridge, n=101"] == dict(
        bitwise=case != "differs", max_ulps=int(case == "differs"))
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        1 if case == "differs" else 0)
    out = capsys.readouterr().out
    assert ("#4 fixed bridge, n=101: differs by up to 1 ulp" in out) == (
        case == "differs")
    assert ("lane-innermost copies of the / the lanes-first" in out) == (
        case == "lanes_last parent")
    assert "device us kernel 15.2 / 15.2" in out


@pytest.mark.parametrize("case", ["equal", "sign of zeros", "differs"])
def test_compare_nine(tmp_path, case, capsys):
    """#9's hashes, the route's included: a raw hash off while the one with
    -0 made +0 agrees is reported as ±0 and held equal; both off make the
    trees differ.  The route's times print beside #9's kernel and wrapper
    times, and each tree's #9 launcher contract is named."""
    tool = _tool()
    x = np.zeros((2, 3, 3), np.float32)
    keys = ("#9 overhang, n=1001 x", "#9 route overhang, n=1001 u")
    times = {"#9 n=101 B=512": dict(kernel=0.05, wrapper=0.06,
                                    device_us=dict(fwd=30.5, bwd=12.0)),
             "#9 route n=101 B=512": dict(route=0.07,
                                          device_us=dict(kernel=55.5))}
    for prefix, dd_layout in ((tmp_path / "a", "lanes_last"),
                              (tmp_path / "b", "lanes_first")):
        off = prefix.name == "b" and case != "equal"
        hashes = {k: "h" + k for k in keys}
        pm0 = {k: "p" + k for k in keys}
        if off:
            hashes[keys[1]] = "other"
            if case == "differs":
                pm0[keys[1]] = "other"
        np.savez(prefix.with_suffix(".npz"), **{"fixed bridge, n=101": x})
        prefix.with_suffix(".json").write_text(json.dumps(dict(
            layout="lanes_first", dd_layout=dd_layout, hashes=hashes,
            hashes_pm0=pm0, errors={}, times=times)))
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert r["hashes"][keys[0]] == "equal"
    assert r["hashes"][keys[1]] == {"equal": "equal", "sign of zeros": "±0",
                                    "differs": "differ"}[case]
    assert r["equal"] == (case != "differs")
    assert tool.compare(tmp_path / "a", tmp_path / "b") == (
        1 if case == "differs" else 0)
    out = capsys.readouterr().out
    assert ("equal but for the sign of zeros (±0)" in out) == (
        case == "sign of zeros")
    assert ("(1 up to ±0)" in out) == (case == "sign of zeros")
    assert ("route overhang, n=1001 u: DIFFER" in out) == (case == "differs")
    assert "#9 launcher takes lane-innermost copies of the / the lanes-first" \
        in out
    assert "#9 route n=101 B=512: route 0.0700 / 0.0700 ms" in out
    assert "#9 n=101 B=512: kernel 0.0500 / 0.0500 | wrapper 0.0600" in out
    assert "device us kernel 55.5 / 55.5" in out


@pytest.mark.parametrize("parent", ["lanes_last", "lanes_first", "unnamed"])
def test_compare_five(tmp_path, parent, capsys):
    """#5's launcher contract is named for each tree (a dump that names
    none is from before ``--bidi-layout``, when #5 took lane-innermost
    copies), its times print with their device us, and its hash is held
    to bits."""
    tool = _tool()
    x = np.ones((2, 3, 3), np.float32)
    times = {"#5 n=101 B=512": dict(kernel=0.04, wrapper=0.045,
                                    device_us=dict(kernel=21.5))}
    for prefix, bidi_layout in ((tmp_path / "a", parent),
                                (tmp_path / "b", "lanes_first")):
        dump = dict(layout="lanes_first", hashes={
            "#5 fixed bridge, n=101": "b"}, errors={}, times=times)
        if bidi_layout != "unnamed":
            dump["bidi_layout"] = bidi_layout
        np.savez(prefix.with_suffix(".npz"), **{"fixed bridge, n=101": x})
        prefix.with_suffix(".json").write_text(json.dumps(dump))
    r = tool.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert r["equal"]
    assert r["bidi_layouts"] == (
        "lanes_first" if parent == "lanes_first" else "lanes_last",
        "lanes_first")
    assert tool.compare(tmp_path / "a", tmp_path / "b") == 0
    out = capsys.readouterr().out
    assert ("#5 launcher takes lane-innermost copies of the / the "
            "lanes-first systems" in out) == (parent != "lanes_first")
    assert "#5 n=101 B=512: kernel 0.0400 / 0.0400 | wrapper 0.0450" in out
    assert "device us kernel 21.5 / 21.5" in out
