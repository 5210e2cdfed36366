"""Port: crash-safe shards and the streamed JSON (``datagen/generate.py``,
``datagen/io.py``) on the CPU, against the JAX package's converters.

- ``generate_to_shards`` with one shard removed regenerates exactly that
  shard, bitwise, from its (seed, index) generator.
- ``read_npz_shards`` concatenates the shards as the JAX package's does.
- ``shards_to_json`` of the port and of the JAX package over the same
  ``.npz`` files write the same bytes, through the native writer and
  through the Python fragments.
- ``generate_dataset_json`` writes what ``generate_dataset`` returns for the
  same seed.
"""

import json
import os

import numpy as np
import pytest

from openpystruct_tpu.datagen import native as jnative
from openpystruct_tpu.datagen import read_npz_shards as j_read_npz_shards
from openpystruct_tpu.datagen import shards_to_json as j_shards_to_json
from openpystruct_tpu_torch.config import OptimizerConfig, ScenarioConfig
from openpystruct_tpu_torch.datagen import (
    generate_dataset,
    generate_dataset_json,
    generate_to_shards,
    read_json_dataset,
    read_npz_shards,
    shard_generator,
    shards_to_json,
)
from openpystruct_tpu_torch.datagen import native as tnative

FAST = OptimizerConfig(max_epochs=20, tolerance=5e-3, patience=5)
# a short random-bridge mesh: the float64 host rescue runs on the CPU
SHORT_RB = ScenarioConfig(num_nodes=31, random_bridge=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny batches: one intra-op thread runs them faster than many, above
    all beside other test processes."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shards(tmp_path_factory, _one_thread):
    d = tmp_path_factory.mktemp("shards")
    paths = generate_to_shards(5, 10, str(d), batch_size=4, scen_cfg=SHORT_RB,
                               opt_cfg=FAST, device="cpu")
    return d, paths


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_shards_layout(shards):
    d, paths = shards
    assert [os.path.basename(p) for p in paths] == [
        "shard_00000.npz", "shard_00001.npz", "shard_00002.npz"]
    assert sorted(os.listdir(d)) == [os.path.basename(p) for p in paths]
    sizes = [_arrays(p)["I"].shape for p in paths]
    assert sizes == [(4, 30), (4, 30), (2, 30)]
    # each shard draws from its own generator: no two shards alike
    assert not np.array_equal(_arrays(paths[0])["node_x"],
                              _arrays(paths[1])["node_x"])


def test_removed_shard_regenerated_bitwise(shards, tmp_path):
    d, paths = shards
    before = [_arrays(p) for p in paths]
    os.remove(paths[1])
    seen = []
    again = generate_to_shards(5, 10, str(d), batch_size=4,
                               scen_cfg=SHORT_RB, opt_cfg=FAST, device="cpu",
                               on_batch=seen.append)
    assert again == paths and len(seen) == 1
    assert seen[0].valid.shape == (4,)
    for old, p in zip(before, paths):
        new = _arrays(p)
        assert set(new) == set(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    assert not [f for f in os.listdir(d) if ".tmp" in f]


def test_shard_generator_is_a_function_of_seed_and_index():
    import torch

    a = torch.rand(4, generator=shard_generator(5, 1))
    assert torch.equal(a, torch.rand(4, generator=shard_generator(5, 1)))
    assert not torch.equal(a, torch.rand(4, generator=shard_generator(5, 2)))
    assert not torch.equal(a, torch.rand(4, generator=shard_generator(6, 1)))


def test_read_npz_shards_matches_jax(shards):
    _, paths = shards
    got = read_npz_shards(paths)
    want = j_read_npz_shards(paths)
    assert set(got) == set(want) >= {"I", "valid", "roller_order"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["I"].shape == (10, 30)


@pytest.mark.parametrize("route", ["native", "python"])
def test_shards_to_json_bytes_match_jax(shards, tmp_path, monkeypatch,
                                        route):
    if route == "python":
        monkeypatch.setattr(tnative, "_build_and_load", lambda: None)
        monkeypatch.setattr(jnative, "_build_and_load", lambda: None)
    elif not tnative.native_available():
        pytest.skip("no C++ toolchain")
    else:
        # the JAX package builds in place: a load racing another test
        # process's build can fail once; load again
        monkeypatch.setattr(jnative, "_lib_failed", False)
    _, paths = shards
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    n = shards_to_json(paths, str(a))
    assert n == j_shards_to_json(paths, str(b))
    assert a.read_bytes() == b.read_bytes()
    arrays = read_npz_shards(paths)
    assert n == int(arrays["valid"].sum()) > 0
    back = read_json_dataset(str(a))
    np.testing.assert_array_equal(np.asarray(back["I_values"], np.float32),
                                  arrays["I"][arrays["valid"]])


def test_generate_dataset_json_matches_generate_dataset(tmp_path):
    p = tmp_path / "ds.json"
    n = generate_dataset_json(2, 7, str(p), batch_size=3, opt_cfg=FAST,
                              device="cpu")
    cols = generate_dataset(2, 7, batch_size=3, opt_cfg=FAST, device="cpu")
    with open(p) as f:
        doc = json.load(f)
    assert n == len(cols["I_values"]) > 0
    assert doc == cols
    assert not [f for f in tmp_path.iterdir() if f.name.startswith(".json")]
