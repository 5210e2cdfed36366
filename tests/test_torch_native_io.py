"""Port: the native dataset writer and reader (``datagen/native.py``)
against the JAX package's.

- On the same numpy fields the port's native writer, its streamed writer
  and its Python fragment route write the JAX package's bytes, route for
  route (the Python route forced by patching ``_build_and_load`` in both
  packages, as tests/test_json_stream.py:41-46 does).
- Invalid lanes are dropped.
- The native reader gives what ``json.load`` and the JAX package's reader
  give on the same file, rejects garbage, and keeps the last of duplicate
  keys.
- The libraries build from the port's own copies of the sources into the
  port's build directory.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from openpystruct_tpu.datagen import native as jnative
from openpystruct_tpu.datagen.io import read_json_dataset as j_read_json
from openpystruct_tpu_torch.datagen import io as tio
from openpystruct_tpu_torch.datagen import native as tnative

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "openpystruct_tpu_torch"


@pytest.fixture(autouse=True)
def _toolchain(monkeypatch):
    _retry_jax_build(monkeypatch)
    if not (tnative.native_available() and tnative.reader_available()):
        pytest.skip("no C++ toolchain")


def _retry_jax_build(monkeypatch):
    """The JAX package builds its libraries in place, so a test process that
    loads one while another process writes it can fail once and remember
    the failure; load again, the file whole by now."""
    monkeypatch.setattr(jnative, "_lib_failed", False)
    monkeypatch.setattr(jnative, "_rlib_failed", False)


def _fields(B=12, n=21, seed=0, orders=True, valid_share=0.75):
    """Random schema fields: ascending node positions, rollers and loads on
    a few nodes with draw-order ranks, values over several decades."""
    rng = np.random.default_rng(seed)
    L = rng.uniform(15.0, 215.0, size=(B, 1))
    node_x = (L * np.linspace(0.0, 1.0, n)[None]).astype(np.float32)
    roller = np.zeros((B, n), bool)
    loads = np.zeros((B, n), np.float32)
    r_order = np.full((B, n), n, np.int32)
    f_order = np.full((B, n), n, np.int32)
    for b in range(B):
        r = rng.choice(np.arange(1, n), size=rng.integers(1, 5), replace=False)
        f = rng.choice(np.arange(1, n), size=rng.integers(1, 5), replace=False)
        roller[b, r] = True
        r_order[b, r] = np.arange(len(r))
        loads[b, f] = rng.uniform(-355857.0, -35585.7, size=len(f))
        f_order[b, f] = np.arange(len(f))

    def wide(*shape):
        return (rng.normal(size=shape)
                * 10.0 ** rng.integers(-9, 6, size=shape)).astype(np.float32)

    fields = dict(node_x=node_x, roller=roller, loads=loads,
                  I=wide(B, n - 1), shear=wide(B, n - 1),
                  moment=wide(B, n - 1), defl=wide(B, n), rot=wide(B, n),
                  valid=rng.random(B) < valid_share)
    if orders:
        fields.update(roller_order=r_order, force_order=f_order)
    return fields


def _python_route(monkeypatch):
    monkeypatch.setattr(tnative, "_build_and_load", lambda: None)
    monkeypatch.setattr(jnative, "_build_and_load", lambda: None)


@pytest.mark.parametrize("orders", [True, False])
def test_native_writer_bytes_match_jax(tmp_path, orders):
    fields = _fields(orders=orders)
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    n_a = tnative.write_json_dataset_native(fields, str(a))
    n_b = jnative.write_json_dataset_native(fields, str(b))
    assert n_a == n_b == int(fields["valid"].sum())
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("route", ["native", "python"])
def test_stream_writer_bytes_match_jax(tmp_path, monkeypatch, route):
    if route == "python":
        _python_route(monkeypatch)
    chunks = [_fields(B=7, seed=s) for s in range(3)]
    chunks.append(dict(_fields(B=4, seed=9), valid=np.zeros(4, bool)))
    out = {}
    for name, mod in (("port", tnative), ("jax", jnative)):
        w = mod.JsonStreamWriter(str(tmp_path / f"{name}.json"))
        assert (w._lib is None) == (route == "python")
        total = sum(w.append(c) for c in chunks)
        assert w.finalize() == total
        out[name] = (tmp_path / f"{name}.json").read_bytes()
    assert out["port"] == out["jax"]
    # no fragment directory left behind
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".json")]
    doc = json.loads(out["port"])
    assert tuple(doc) == tio.SCHEMA_KEYS
    assert len(doc["I_values"]) == sum(int(c["valid"].sum()) for c in chunks)


def test_native_and_python_routes_parse_equal(tmp_path, monkeypatch):
    """The two routes format numbers their own way (the C++ writer prints
    shortest float64 round trips) but carry the same values."""
    fields = _fields()
    nat = tmp_path / "n.json"
    tnative.write_json_dataset_native(fields, str(nat))
    _python_route(monkeypatch)
    w = tnative.JsonStreamWriter(str(tmp_path / "p.json"))
    w.append(fields)
    w.finalize()
    assert json.loads(nat.read_text()) == json.loads(
        (tmp_path / "p.json").read_text())


def test_invalid_lanes_dropped(tmp_path):
    fields = _fields(valid_share=0.5)
    valid = fields["valid"]
    assert 0 < valid.sum() < len(valid)
    p = tmp_path / "d.json"
    assert tnative.write_json_dataset_native(fields, str(p)) == valid.sum()
    doc = json.loads(p.read_text())
    np.testing.assert_array_equal(np.asarray(doc["I_values"], np.float32),
                                  fields["I"][valid])
    np.testing.assert_array_equal(np.asarray(doc["L"], np.float32),
                                  fields["node_x"][valid, -1])
    assert doc["num_nodes"] == [21] * int(valid.sum())


def test_native_reader_matches_json_load_and_jax(tmp_path):
    fields = _fields(B=16)
    p = str(tmp_path / "d.json")
    tnative.write_json_dataset_native(fields, p)
    nat = tio.read_json_dataset(p)
    ref = tio.read_json_dataset(p, native=False)
    jax_nat = j_read_json(p)
    assert set(nat) == set(ref) == set(jax_nat) == set(tio.SCHEMA_KEYS)
    for k in tio.SCHEMA_KEYS:
        if k in ("num_nodes", "L"):
            assert nat[k].dtype == np.float64
            np.testing.assert_array_equal(nat[k], np.asarray(ref[k]))
        elif isinstance(nat[k], np.ndarray):
            assert nat[k].dtype == np.float32 and nat[k].ndim == 2
            np.testing.assert_array_equal(nat[k],
                                          np.asarray(ref[k], np.float32))
        else:   # ragged
            assert len(nat[k]) == len(ref[k])
            for row, want in zip(nat[k], ref[k]):
                np.testing.assert_array_equal(row, np.float32(want))
        if isinstance(nat[k], list):
            for row, want in zip(nat[k], jax_nat[k]):
                np.testing.assert_array_equal(row, want)
        else:
            np.testing.assert_array_equal(nat[k], jax_nat[k])
    # the float columns are the written float32 arrays, bit for bit
    valid = fields["valid"]
    for key, field in (("I_values", "I"), ("shear_forces", "shear"),
                       ("deflections", "defl"), ("node_positions", "node_x")):
        np.testing.assert_array_equal(nat[key], fields[field][valid])


def test_native_reader_rejects_garbage(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"I_values": [[1, 2], [3, oops]]}')
    assert tnative.read_json_dataset_native(str(p), tio.SCHEMA_KEYS) is None
    assert jnative.read_json_dataset_native(str(p), tio.SCHEMA_KEYS) is None
    with pytest.raises(ValueError):   # json.load's JSONDecodeError
        tio.read_json_dataset(str(p))
    missing = tmp_path / "missing.json"
    assert tnative.read_json_dataset_native(str(missing), ["L"]) is None


def test_native_reader_duplicate_keys_last_wins(tmp_path):
    p = tmp_path / "dup.json"
    p.write_text('{"I_values": [[1, 2]], "L": [5], "I_values": [[3, 4.5]]}')
    nat = tnative.read_json_dataset_native(str(p), ["I_values", "L"])
    with open(p) as f:
        ref = json.load(f)
    np.testing.assert_array_equal(nat["I_values"],
                                  np.asarray(ref["I_values"], np.float32))
    np.testing.assert_array_equal(nat["L"], [5.0])
    jax_nat = jnative.read_json_dataset_native(str(p), ["I_values", "L"])
    np.testing.assert_array_equal(nat["I_values"], jax_nat["I_values"])


def test_builds_land_in_the_port_build_dir():
    build = PORT / "ops" / "_build"
    for source, flags, load in (
            ("dataset_writer.cpp", tnative.WRITER_FLAGS,
             tnative._build_and_load),
            ("dataset_reader.cpp", tnative.READER_FLAGS,
             tnative._build_and_load_reader)):
        lib = load()
        path = Path(lib._name)
        assert path.parent == build and path.exists()
        assert path == tnative.library_path(source, flags)
        # the port's copy of the source, unchanged from the JAX package's
        assert ((PORT / "datagen" / "csrc" / source).read_bytes()
                == (REPO / "native" / source).read_bytes())
    assert "-pthread" in tnative.WRITER_FLAGS
    # nothing in the module names the JAX package's native/ directory
    text = (PORT / "datagen" / "native.py").read_text()
    assert '"native"' not in text and "native/build" not in text
