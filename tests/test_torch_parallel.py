"""Port: ``parallel/`` (meshes and collectives over ``torch.distributed``)
against the JAX package's ``parallel/mesh.py`` and the JAX harness's batch
rules, on the CPU with gloo.

- The mesh-shape rule against JAX's ``default_mesh`` on the 8-device CPU
  mesh of ``tests/conftest.py``, k = 1..8 devices, one and two axes.
- Two ranks spawned once for the module (``parallel.spawn``, a ``file://``
  rendezvous under ``tmp_path``, no TCP port, one intra-op thread each):
  ``all_processes_min_max`` on rows split over the ranks against JAX's
  value on the whole array; ``make_global_batch(local=False/True)``,
  ``shard_batch`` and ``replicate_to_mesh`` round trips; the unequal-count
  ``all_gather_rows``; the differentiable gather and sum's gradients; a
  second ``initialize_multihost`` returning.
- Importing the package starts no process group.
- ``initialize_multihost`` without a cluster environment warns and stays
  one process; NCCL asked for where there is none raises (no gloo in its
  place); ``default_mesh`` without a card raises, and so do more ranks on
  a node than cards without a device named; across nodes (faked groups
  and cards) a rank's card is ``cuda:LOCAL_RANK``, never its global rank.
- ``fit``'s batch rounding and its error, and the per-shard trim count,
  against the JAX harness's rules (``harness.py:251-316``) on the same
  (rows, batch, shards), and one JAX ``fit`` on an 8-device mesh.

The JAX package is imported inside the tests: the spawned ranks import this
module and need none of it.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openpystruct_tpu_torch import parallel
from openpystruct_tpu_torch.parallel import collectives as coll
from openpystruct_tpu_torch.train.harness import _fit_batch

WORLD = 2


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(n, cols=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, cols))


def _worker(rank, out_dir):
    torch.set_num_threads(1)
    parallel.initialize_multihost(backend="gloo")   # a second call returns
    mesh = parallel.default_mesh(device="cpu")
    got = {"rank": mesh.rank, "world": mesh.world_size,
           "shape": mesh.shape, "backend": dist.get_backend(mesh.group)}
    x = _rows(10)
    mine = x[:4] if rank == 0 else x[4:]     # unequal rows
    got["minmax_np"] = parallel.all_processes_min_max(mine)
    got["minmax_t"] = parallel.all_processes_min_max(torch.from_numpy(mine))
    # local=False: every rank holds the full array and keeps its half
    full = torch.from_numpy(_rows(8, seed=1))
    half = parallel.make_global_batch(full, mesh)
    got["half"] = half
    got["half_back"] = coll.all_gather_rows(half, mesh.group)
    # local=True: each rank keeps its own (unequal) rows
    own = parallel.make_global_batch(mine, mesh, local=True)
    got["own_back"] = coll.all_gather_rows(own, mesh.group)
    # zero rows on one rank
    got["empty_back"] = coll.all_gather_rows(
        torch.from_numpy(x[:3] if rank == 0 else x[:0]), mesh.group)
    tree = {"a": full, "b": [torch.tensor(3.0), full[:, :2]]}
    sh = parallel.shard_batch(tree, mesh)
    got["shard_a"], got["shard_s"], got["shard_b"] = (sh["a"], sh["b"][0],
                                                      sh["b"][1])
    got["shard_back"] = coll.all_gather_rows(sh["b"][1], mesh.group)
    got["rep"] = parallel.replicate_to_mesh(
        {"w": torch.full((2, 2), float(rank + 5))}, mesh)["w"]
    try:
        parallel.make_global_batch(full[:7], mesh)
    except ValueError as e:
        got["uneven"] = str(e)
    # two ranks, one card, no device named: refused, not folded onto it
    torch.cuda.is_available, torch.cuda.device_count = (lambda: True,
                                                         lambda: 1)
    try:
        parallel.default_mesh()
    except RuntimeError as e:
        got["too_many"] = str(e)
    # the differentiable gather: every rank's loss of the gathered rows,
    # its gradient the world size times the rank's share
    w = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    rows = torch.from_numpy(mine[:2]).float() * w
    gathered = coll.gather_for_loss(rows, mesh.group)
    (gathered.sum(0) ** 2).sum().backward()
    got["gathered"], got["gather_grad"] = gathered.detach(), w.grad.clone()
    v = torch.tensor([float(rank + 1), 2.0], requires_grad=True)
    s = coll.all_reduce_sum(v * v, mesh.group)
    s.sum().backward()
    got["sum"], got["sum_grad"] = s.detach(), v.grad.clone()
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    parallel.spawn(_worker, WORLD, d / "store", args=(str(d),),
                   backend="gloo", device="cpu", timeout=120)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
@pytest.mark.parametrize("k", range(1, 9))
def test_mesh_shape_matches_jax(k, axes):
    import jax

    from openpystruct_tpu.parallel import default_mesh as jmesh

    want = dict(jmesh(axes, devices=jax.devices()[:k]).shape)
    assert parallel.mesh_shape(k, axes) == want


def test_mesh_shape_refuses_three_axes():
    import jax

    from openpystruct_tpu.parallel import default_mesh as jmesh

    with pytest.raises(ValueError, match="1- or 2-axis"):
        jmesh(("a", "b", "c"), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="1- or 2-axis"):
        parallel.mesh_shape(4, ("a", "b", "c"))


def test_the_ranks_form_a_mesh(ranks):
    for r, got in enumerate(ranks):
        assert (got["rank"], got["world"], got["backend"]) == (r, WORLD,
                                                                 "gloo")
        assert got["shape"] == {"data": WORLD}


def test_min_max_over_the_ranks_matches_jax(ranks):
    from openpystruct_tpu.parallel import all_processes_min_max as jminmax

    want = jminmax(_rows(10))
    for got in ranks:
        for key in ("minmax_np", "minmax_t"):
            assert tuple(float(t) for t in got[key]) == want


def test_make_global_batch_round_trips(ranks):
    full = torch.from_numpy(_rows(8, seed=1))
    x = torch.from_numpy(_rows(10))
    for r, got in enumerate(ranks):
        assert torch.equal(got["half"], full[4 * r:4 * r + 4])
        assert torch.equal(got["half_back"], full)
        assert torch.equal(got["own_back"], x)
        assert "do not split evenly" in got["uneven"]


def test_more_ranks_than_cards_raises(ranks):
    for got in ranks:
        assert "2 ranks but 1 visible CUDA device" in got["too_many"]


def test_all_gather_rows_of_unequal_counts(ranks):
    x = torch.from_numpy(_rows(10))
    for got in ranks:
        assert torch.equal(got["empty_back"], x[:3])


def test_shard_batch_and_replicate(ranks):
    full = torch.from_numpy(_rows(8, seed=1))
    for r, got in enumerate(ranks):
        assert torch.equal(got["shard_a"], full[4 * r:4 * r + 4])
        assert torch.equal(got["shard_b"], full[4 * r:4 * r + 4, :2])
        assert float(got["shard_s"]) == 3.0
        assert torch.equal(got["shard_back"], full[:, :2])
        assert torch.equal(got["rep"], torch.full((2, 2), 5.0))


def test_differentiable_collectives(ranks):
    """The gathered loss's gradient, summed over the ranks (the fit's
    all-reduce), is the one-process gradient times the world size; the
    sum's gradient is the sum of the ranks' output gradients."""
    x = _rows(10)
    both = torch.from_numpy(np.concatenate([x[:2], x[4:6]])).float()
    w = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    ((both * w).sum(0) ** 2).sum().backward()
    total = ranks[0]["gather_grad"] + ranks[1]["gather_grad"]
    torch.testing.assert_close(total, WORLD * w.grad, rtol=1e-6, atol=0)
    for r, got in enumerate(ranks):
        torch.testing.assert_close(got["gathered"], both * w.detach())
        assert torch.equal(got["sum"], torch.tensor([5.0, 8.0]))
        # d/dv of sum_ranks(v_r^2), seen by both ranks' outputs: 2 v * 2
        assert torch.equal(got["sum_grad"],
                           torch.tensor([4.0 * (r + 1), 8.0]))


def test_initialize_multihost_without_cluster_warns(monkeypatch, caplog):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with caplog.at_level(logging.WARNING):
        parallel.initialize_multihost(device="cpu")
    assert "continuing single-process" in caplog.text
    assert not dist.is_initialized()
    mesh = parallel.default_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    x = torch.arange(6.0).reshape(3, 2)
    assert parallel.make_global_batch(x, mesh) is not None
    assert torch.equal(coll.all_gather_rows(x), x)


def test_nccl_where_there_is_none_raises(tmp_path):
    with pytest.raises(RuntimeError):
        parallel.initialize_multihost(
            backend="nccl", device="cpu", world_size=1, rank=0,
            init_method=f"file://{tmp_path / 'store'}")
    assert not dist.is_initialized()


def test_default_mesh_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        parallel.default_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        parallel.initialize_multihost(init_method="file:///nonexistent",
                                      world_size=1, rank=0)


def _fake_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def _fake_group(monkeypatch, world, rank):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: world)
    monkeypatch.setattr(dist, "get_rank", lambda *a: rank)


def test_default_mesh_across_nodes_takes_the_local_rank(monkeypatch):
    """Four nodes of one card each: rank 3 of 4 is local rank 0 of its
    node, and its card is cuda:0 (the global rank is no card index)."""
    _fake_cards(monkeypatch, 1)
    _fake_group(monkeypatch, 4, 3)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    mesh = parallel.default_mesh()
    assert (mesh.world_size, mesh.rank, mesh.shape) == (4, 3, {"data": 4})
    assert mesh.device == torch.device("cuda", 0)
    # two ranks on that node's one card: refused
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 ranks but 1 visible CUDA"):
        parallel.default_mesh()
    # without LOCAL_RANK the rank's node is unknown
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(RuntimeError, match="LOCAL_RANK unset"):
        parallel.default_mesh()
    assert parallel.default_mesh(device="cpu").world_size == 4


def test_initialize_multihost_across_nodes_takes_the_local_rank(
        monkeypatch):
    """torchrun's rank 5 of 8, local rank 1 of 2 on a node of two cards:
    NCCL on cuda:1, not cuda:5."""
    _fake_cards(monkeypatch, 2)
    calls = {}
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("set_device", d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.setdefault("init", kw))
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "29500"),
                 ("RANK", "5"), ("WORLD_SIZE", "8"), ("LOCAL_RANK", "1"),
                 ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    parallel.initialize_multihost()
    assert calls["set_device"] == torch.device("cuda", 1)
    assert calls["init"] == {"backend": "nccl",
                             "device_id": torch.device("cuda", 1)}


def _jax_fit_batch(requested, total, n_shards):
    """The JAX harness's ``_fit_batch`` (harness.py:306-316)."""
    b = min(requested, total)
    b = max((b // n_shards) * n_shards, n_shards)
    if b > total:
        raise ValueError("cannot fill one batch")
    return b


def _jax_keep(rows_by_process, n_shards):
    """The JAX harness's per-shard trim (harness.py:251-267), one device a
    process as in the port."""
    local_shards = max(n_shards // len(rows_by_process), 1)
    rows = min(rows_by_process)
    return (rows // local_shards) * local_shards


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_fit_batch_rule_matches_jax(shards):
    for total in range(1, 70):
        for requested in (1, 5, 16, 32, 100):
            try:
                want = _jax_fit_batch(requested, total, shards)
            except ValueError:
                with pytest.raises(ValueError, match="cannot fill"):
                    _fit_batch(requested, total, shards)
                continue
            assert _fit_batch(requested, total, shards) == want


def test_per_shard_trim_matches_jax():
    """The port trims to the least row count over the ranks: the JAX rule
    with one device a process (130 and 126 rows keep 126 each)."""
    assert _jax_keep([130, 126], 2) == 126
    for rows in ([130, 126], [7, 9, 8], [5]):
        assert _jax_keep(rows, len(rows)) == min(rows)


def test_fit_batch_against_a_jax_fit():
    """On the 8-device mesh: 96 rows at batch 30 round to 24 (4 steps),
    and 5 val rows cannot fill a batch; the port's rule says the same."""
    import jax
    import jax.numpy as jnp

    from openpystruct_tpu.config import TrainConfig
    from openpystruct_tpu.models import FNNWithResidual
    from openpystruct_tpu.parallel import default_mesh as jmesh
    from openpystruct_tpu.train import fit as jfit

    mesh = jmesh(("data",))
    model = FNNWithResidual(hidden_dim=8, num_blocks=1, output_dim=3,
                            dropout_rate=0.0, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(96, 4)), rng.normal(size=(96, 3))
    cfg = TrainConfig(num_epochs=1, batch_size=30, sigma_0=0.0, seed=0,
                      compute_dtype="float32")
    res = jfit(model, X, Y, X[:16], Y[:16], cfg, mesh=mesh)
    assert int(res.state.step) == 96 // _fit_batch(30, 96, 8) == 4
    with pytest.raises(ValueError, match="cannot fill"):
        jfit(model, X, Y, X[:5], Y[:5], cfg, mesh=mesh)
    with pytest.raises(ValueError, match="cannot fill"):
        _fit_batch(30, 5, 8)
    assert jax.device_count() == 8


def test_import_starts_no_group():
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          .parent))
    code = ("import torch.distributed as dist\n"
            "import openpystruct_tpu_torch.parallel\n"
            "import openpystruct_tpu_torch.cli, openpystruct_tpu_torch.train\n"
            "import openpystruct_tpu_torch.datagen\n"
            "assert not dist.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
