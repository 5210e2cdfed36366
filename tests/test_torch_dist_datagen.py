"""Port: sharded datagen (``generate_batch(mesh=)``, the file writers under a
mesh, ``generate_frame_batch(mesh=)``, ``generate_frame_dataset(mesh=)``)
on the CPU over two gloo ranks, against the one-rank runs, bitwise.

The JAX package's rule (``datagen/generate.py:262-326``, ``frames.py:60-114``)
is that lanes are independent: every rank draws the whole batch, runs its
rows, rescues its own rejected lanes, and the gathered batch is the
one-process batch.  Two ranks are spawned once for the module
(``parallel.spawn``, a ``file://`` rendezvous under ``tmp_path``, one
intra-op thread each); they run

- ``generate_batch`` on 16 fixed-bridge lanes and on 16 random-bridge lanes
  with the "f64" rescue (8 of them rejected by the float32 gate), each rank
  rescuing only its own 8 lanes;
- ``generate_frame_batch`` on 4 lanes of a 3x3 frame and
  ``generate_frame_dataset`` over four topologies;
- ``generate_to_shards`` (two shards, each written once, by rank 0; a second
  call writes none) and ``generate_dataset_json`` (rank 0 writes the file).

Every gathered field is held bitwise to the one-rank run's on both ranks; a
one-rank gloo group in this process (its mesh of size 1) is bitwise
``mesh=None``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openpystruct_tpu_torch import parallel
from openpystruct_tpu_torch.config import (
    FrameConfig,
    OptimizerConfig,
    ScenarioConfig,
)
from openpystruct_tpu_torch.datagen import (
    generate_batch,
    generate_dataset_json,
    generate_frame_batch,
    generate_frame_dataset,
    generate_to_shards,
)
from openpystruct_tpu_torch.datagen import generate as gen_mod

WORLD = 2
OPT = OptimizerConfig(max_epochs=20, tolerance=5e-3, patience=5)
FRAME = FrameConfig(max_epochs=10)
CASES = {
    "fixed": (3, ScenarioConfig(), {}),
    "random": (7, ScenarioConfig(random_bridge=True), {"rescue": "f64"}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _beam(case, mesh=None):
    seed, scen, kw = CASES[case]
    return generate_batch(torch.Generator().manual_seed(seed), 16, scen,
                          opt_cfg=OPT, refine=0, device="cpu", mesh=mesh,
                          **kw)


def _frame(mesh=None):
    return generate_frame_batch(torch.Generator().manual_seed(1), 4, 3, 3,
                                FRAME, device="cpu", mesh=mesh)[1]


def _frame_dataset(mesh=None):
    return generate_frame_dataset(5, 6, FrameConfig(max_epochs=5),
                                  bays_range=(1, 2), stories_range=(1, 2),
                                  device="cpu", mesh=mesh)


def _files(d, mesh=None):
    kw = dict(batch_size=8, opt_cfg=OPT, refine=0, device="cpu", mesh=mesh)
    paths = generate_to_shards(11, 16, os.path.join(d, "shards"), **kw)
    again = generate_to_shards(11, 16, os.path.join(d, "shards"), **kw)
    n = generate_dataset_json(11, 16, os.path.join(d, "ds.json"), **kw)
    return paths, again, n


def _worker(rank, out_dir):
    torch.set_num_threads(1)
    mesh = parallel.default_mesh(device="cpu")
    rescues, writes = [], []
    real_rescue, real_write = gen_mod._rescue_local, gen_mod.write_npz_shard
    gen_mod._rescue_local = lambda batch, *a: (rescues.append(
        (batch.valid.shape[0], int((~batch.valid).sum()))),
        real_rescue(batch, *a))[1]
    gen_mod.write_npz_shard = lambda batch, path: (writes.append(path),
                                                   real_write(batch, path))[1]
    got = {k: _beam(k, mesh) for k in CASES}
    got["frame"] = _frame(mesh)
    got["frame_dataset"] = _frame_dataset(mesh)
    d = os.path.join(out_dir, f"files{rank}")
    got["paths"], got["again"], got["n_json"] = _files(
        out_dir if rank == 0 else d, mesh)
    got["rescues"], got["writes"] = rescues, writes
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_datagen")
    parallel.spawn(_worker, WORLD, d / "store", args=(str(d),),
                   backend="gloo", device="cpu", timeout=300)
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_rank():
    return {k: _beam(k) for k in CASES}


@pytest.fixture
def size_one_mesh(tmp_path):
    parallel.initialize_multihost(
        backend="gloo", device="cpu", world_size=1, rank=0,
        init_method=f"file://{tmp_path / 'store'}")
    try:
        yield parallel.default_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _same(a, b, where=""):
    """Bitwise equality of tensors, dataclasses of them, dicts and lists."""
    if isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=where)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_are_the_one_rank_batch(ranks, one_rank, case):
    _, got = ranks
    for r in range(WORLD):
        _same(got[r][case], one_rank[case], f"rank {r} {case}")


def test_each_rank_rescues_its_own_lanes(ranks, one_rank):
    """The random-bridge batch: the float32 gate rejects lanes on both
    ranks, and each rank's rescue sees only its own 8 lanes and its own
    rejected ones; together they are the one-rank run's."""
    _, got = ranks
    seed, scen, _ = CASES["random"]
    kept = generate_batch(torch.Generator().manual_seed(seed), 16, scen,
                          opt_cfg=OPT, refine=0, device="cpu",
                          rescue=False).valid
    calls = [g["rescues"] for g in got]
    # the fixed bridge rescues nothing (rescue=None skips it there)
    assert [len(c) for c in calls] == [1, 1]
    want = [(8, int((~kept[:8]).sum())), (8, int((~kept[8:]).sum()))]
    assert [c[0] for c in calls] == want and all(n for _, n in want)
    assert bool(one_rank["random"].valid.all())


def test_frame_batch_over_two_ranks(ranks):
    _, got = ranks
    one = _frame()
    assert bool(one.valid.any())
    for r in range(WORLD):
        _same(got[r]["frame"], one, f"rank {r} frame")


def test_frame_dataset_over_two_ranks(ranks):
    _, got = ranks
    one = _frame_dataset()
    assert len(one["I_values"]) > 0
    for r in range(WORLD):
        assert got[r]["frame_dataset"] == one


def test_files_written_once_by_rank_zero(ranks, tmp_path):
    d, got = ranks
    assert got[0]["writes"] and not got[1]["writes"]
    # two shards, each written once, and none on the second call
    assert [os.path.basename(p) for p in got[0]["writes"]] == [
        "shard_00000.tmp.npz", "shard_00001.tmp.npz"]
    assert not os.path.exists(d / "files1")    # rank 1 wrote nothing
    paths, again, n = _files(str(tmp_path))
    for r in range(WORLD):
        assert [os.path.basename(p) for p in got[r]["paths"]] == [
            os.path.basename(p) for p in paths]
        assert got[r]["n_json"] == n
    for p in paths:
        with np.load(p) as want, np.load(d / "shards" /
                                         os.path.basename(p)) as have:
            assert want.files == have.files
            for k in want.files:
                np.testing.assert_array_equal(have[k], want[k], k)
    assert (d / "ds.json").read_bytes() == (tmp_path / "ds.json").read_bytes()


def test_size_one_mesh_is_no_mesh(size_one_mesh, one_rank):
    assert size_one_mesh.world_size == 1 and dist.is_initialized()
    _same(_beam("fixed", size_one_mesh), one_rank["fixed"])
    _same(_frame(size_one_mesh), _frame())


def test_uneven_batch_raises(size_one_mesh):
    mesh = dataclasses.replace(size_one_mesh, shape={"data": 3},
                               world_size=3)
    with pytest.raises(ValueError, match="do not split evenly"):
        generate_batch(torch.Generator().manual_seed(0), 16, opt_cfg=OPT,
                       device="cpu", mesh=mesh)
