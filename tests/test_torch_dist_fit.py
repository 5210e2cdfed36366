"""Port: data-parallel ``fit(mesh=, shuffle_scope=)`` on the CPU over two
gloo ranks, held as ``tests/test_multihost.py`` holds the JAX harness.

Two ranks are spawned once for the module (``parallel.spawn``, a
``file://`` rendezvous under ``tmp_path``, one intra-op thread each).  Each
passes its own train rows and the full val set (the JAX data contract,
``train/harness.py:226-231``):

- the FNN of ``tests/multihost_worker.py`` (256 rows split 128/128, 44 val
  rows, 4 epochs of batch 32, ``dropout_rate=0``, ``sigma_0=0``): the ranks
  bitwise identical, the losses within rtol 1e-4 of the one-rank fit
  (``tests/test_multihost.py:164-170``), one checkpoint written by rank 0
  alone and resumed by both; a multi-process fit without a mesh raises;
- the first step's gradient after the all-reduce, the one-rank gradient
  of the same global batch within 1e-6 relative (in norm);
- a float64 MLP's two-rank fit over 8 epochs, within 1e-12 relative of
  the one-rank fit: the float32 gap above is rounding;
- ``shuffle_scope="per_shard"`` on 130 and 126 rows: finite, identical on
  both ranks, each trimmed to 126 rows (7 steps an epoch), the first
  step's labels and loss those of the rows the ranks' permutations pick;
- a PINN (BatchNorm, the family's box bounds through
  ``all_processes_min_max``) on 32 + 32 rows with input noise, one step on
  the global batch: the box bounds equal the one-rank fit's and the
  BatchNorm running statistics match it within 1e-6 of their scale (they
  normalise over the global batch).

In this process: ``per_shard`` without a mesh warns and shuffles globally,
and a one-rank gloo group's mesh of size 1 is bitwise ``mesh=None`` (the
FNN with dropout and noise, and the PINN).
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch import parallel
from openpystruct_tpu_torch.config import TrainConfig
from openpystruct_tpu_torch.models import FNNWithResidual, PINNWithResidual
from openpystruct_tpu_torch.train import fit
from openpystruct_tpu_torch.train import harness

WORLD = 2
CFG = TrainConfig(num_epochs=4, batch_size=32, hidden_units=32,
                  dropout_rate=0.0, sigma_0=0.0, compute_dtype="float32",
                  seed=0)
# the float64 witness: the two-rank fit stays at the one-rank fit's
# rounding over more epochs than float32 can
CFG_F64 = dataclasses.replace(CFG, num_epochs=8)
# one step on the global batch of 64 rows: past it the biases ahead of
# each BatchNorm, whose gradient is 0 up to rounding, take Adam steps of
# sign(rounding) and the runs part (measured: running means 1e-4 of their
# scale apart after 8 steps, 1e-7 after one)
PINN_CFG = TrainConfig(num_epochs=1, batch_size=64, compute_dtype="float32",
                       seed=0)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fnn_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 18)).astype(np.float32)
    W = (rng.normal(size=(18, 20)) * 0.3).astype(np.float32)
    Xv = rng.normal(size=(44, 18)).astype(np.float32)
    return X, X @ W, Xv, Xv @ W


def _fnn(dropout=0.0):
    return FNNWithResidual(input_dim=18, hidden_dim=32, num_blocks=1,
                           output_dim=20, dropout_rate=dropout,
                           dtype=torch.float32)


def _pinn_data():
    rng = np.random.default_rng(1)
    W = rng.normal(size=(48, 302)) / np.sqrt(48)

    def split(n):
        X = rng.normal(size=(n, 6, 8)).astype(np.float32)
        return X, (X.reshape(n, -1) @ W).astype(np.float32)

    return (*split(64), *split(11))


def _pinn_fit(rows=slice(None), mesh=None, bounds=None):
    X, Y, Xv, Yv = _pinn_data()
    kw = tfam.build_family("pinn", 8, label_dim=302)[2]
    model = PINNWithResidual(input_dim=48, hidden_dim=32, num_blocks=1,
                             output_dim=302, dropout_rate=0.0)
    real = tfam.all_processes_min_max

    def seen(x):
        lo, hi = real(x)
        if bounds is not None:
            bounds.append((float(lo), float(hi)))
        return lo, hi

    tfam.all_processes_min_max = seen
    try:
        return fit(model, X[rows], Y[rows], Xv, Yv, PINN_CFG, mesh=mesh,
                   device="cpu", **kw)
    finally:
        tfam.all_processes_min_max = real


class _Net64(torch.nn.Module):
    """A float64 MLP with ``fit``'s model interface: the harness's
    data-parallel arithmetic without float32 rounding."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(18, 32, dtype=torch.float64)
        self.b = torch.nn.Linear(32, 20, dtype=torch.float64)

    def reset_parameters(self, generator):
        with torch.no_grad():
            for lin in (self.a, self.b):
                lin.weight.copy_(torch.randn(
                    lin.weight.shape, generator=generator,
                    dtype=torch.float64) / lin.in_features ** 0.5)
                lin.bias.zero_()

    def forward(self, x, *, generator=None, train=False):
        return self.b(torch.tanh(self.a(x.double())))


@contextlib.contextmanager
def _first_step_grads():
    """While the block runs, record the gradients the first optimizer step
    applies, after the ranks' all-reduce and before the clip."""
    got, real = [], harness._Optimizer.step

    def step(self, sync=None):
        def record(grads):
            if sync is not None:
                sync(grads)
            if not got:
                got.append([g.detach().clone() for g in grads])
        real(self, record)

    harness._Optimizer.step = step
    try:
        yield got
    finally:
        harness._Optimizer.step = real


@contextlib.contextmanager
def _first_loss():
    """While the block runs, record the first training step's
    ``trainable_l1l2_loss`` call: its targets and value."""
    got, real = {}, harness.trainable_l1l2_loss

    def loss(alpha, preds, targets, *a):
        out = real(alpha, preds, targets, *a)
        if not got:
            got.update(targets=targets.detach().clone(),
                       loss=out.detach().clone())
        return out

    harness.trainable_l1l2_loss = loss
    try:
        yield got
    finally:
        harness.trainable_l1l2_loss = real


def _worker(rank, out_dir):
    torch.set_num_threads(1)
    mesh = parallel.default_mesh(device="cpu")
    X, Y, Xv, Yv = _fnn_data()
    mine = slice(128 * rank, 128 * (rank + 1))
    got = {}
    try:
        fit(_fnn(), X[mine], Y[mine], Xv, Yv, CFG, device="cpu")
    except ValueError as e:
        got["no_mesh"] = str(e)
    saves = []
    real_save = harness.save_checkpoint
    harness.save_checkpoint = lambda path, state: (saves.append(path),
                                                   real_save(path, state))[1]
    ck = os.path.join(out_dir, "ck")
    with _first_step_grads() as grads:
        got["fnn"] = fit(_fnn(), X[mine], Y[mine], Xv, Yv, CFG, mesh=mesh,
                         epochs_per_sync=2, checkpoint_dir=ck)
    got["grads"] = grads[0]
    harness.save_checkpoint = real_save
    got["saves"] = saves
    got["resumed"] = fit(_fnn(), X[mine], Y[mine], Xv, Yv, CFG, mesh=mesh,
                         resume_from=ck)
    got["f64"] = fit(_Net64(), X[mine], Y[mine], Xv, Yv, CFG_F64, mesh=mesh)
    rows = slice(0, 130) if rank == 0 else slice(130, 256)
    with _first_loss() as first:
        got["per_shard"] = fit(_fnn(), X[rows], Y[rows], Xv, Yv, CFG,
                               mesh=mesh, shuffle_scope="per_shard")
    got["per_shard_first"] = first
    got["bounds"] = []
    got["pinn"] = _pinn_fit(slice(32 * rank, 32 * (rank + 1)), mesh,
                            got["bounds"])
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_fit")
    parallel.spawn(_worker, WORLD, d / "store", args=(str(d),),
                   backend="gloo", device="cpu", timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture
def size_one_mesh(tmp_path):
    parallel.initialize_multihost(
        backend="gloo", device="cpu", world_size=1, rank=0,
        init_method=f"file://{tmp_path / 'store'}")
    try:
        yield parallel.default_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _tensors(res):
    return dict(res.params["model"], alpha=res.params["alpha"],
                **{f"final.{k}": v
                   for k, v in res.state["params"]["model"].items()})


def _bitwise(a, b):
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_ranks_identical_and_near_one_rank(ranks):
    for got in ranks[1:]:
        _bitwise(got["fnn"], ranks[0]["fnn"])
    one = fit(_fnn(), *_fnn_data(), CFG, device="cpu")
    res = ranks[0]["fnn"]
    assert res.state["step"] == one.state["step"] == 4 * 8
    np.testing.assert_allclose(res.train_losses, one.train_losses, rtol=1e-4)
    np.testing.assert_allclose(res.val_losses, one.val_losses, rtol=1e-4)
    assert res.val_losses[-1] < res.val_losses[0]


def _grad_gap(a, b):
    """||a - b|| / ||b|| over every tensor of two gradient lists."""
    a, b = (torch.cat([g.double().reshape(-1) for g in x]) for x in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_synced_gradient_is_the_one_rank_gradient(ranks):
    """The first step's gradient after the all-reduce is the one-rank
    gradient of the same global batch (a missing 1/W or a misplaced row
    would show here; Adam and the clip hide both from the losses)."""
    with _first_step_grads() as one:
        fit(_fnn(), *_fnn_data(), dataclasses.replace(CFG, num_epochs=1),
            device="cpu")
    for got in ranks:
        assert len(got["grads"]) == len(one[0])
        assert _grad_gap(got["grads"], one[0]) <= 1e-6


def test_float64_ranks_stay_at_the_one_rank_fit(ranks):
    """In float64 the two-rank fit keeps to the one-rank fit's losses
    within 1e-12 relative over 8 epochs: its float32 gap is rounding of
    the changed sum order, not a fault of the data-parallel arithmetic."""
    _bitwise(ranks[1]["f64"], ranks[0]["f64"])
    X, Y, Xv, Yv = _fnn_data()
    one = fit(_Net64(), X, Y, Xv, Yv, CFG_F64, device="cpu")
    res = ranks[0]["f64"]
    assert res.state["step"] == one.state["step"] == 8 * 8
    np.testing.assert_allclose(res.train_losses, one.train_losses,
                               rtol=1e-12)
    np.testing.assert_allclose(res.val_losses, one.val_losses, rtol=1e-12)


def test_multi_process_fit_needs_a_mesh(ranks):
    for got in ranks:
        assert "requires a mesh" in got["no_mesh"]


def test_checkpoint_written_by_rank_zero_and_read_by_all(ranks):
    assert len(ranks[0]["saves"]) == 2 and ranks[1]["saves"] == []
    for got in ranks:
        _bitwise(got["resumed"], ranks[0]["fnn"])


def test_per_shard_on_unequal_rows(ranks):
    a, b = ranks[0]["per_shard"], ranks[1]["per_shard"]
    _bitwise(a, b)
    assert np.isfinite(a.train_losses).all()
    # both trimmed to 126 rows: 252 global rows, 7 steps of 32
    assert a.state["step"] == 4 * 7


def test_per_shard_first_step_is_the_plain_loss(ranks):
    """The first per-shard step's loss is the plain loss of the rows that
    the two ranks' permutations pick, each row with its own label: rank
    0's 16 then rank 1's 16 of the rows trimmed to 126 each."""
    X, Y, _, _ = _fnn_data()
    own = [(X[:126], Y[:126]), (X[130:256], Y[130:256])]
    # the epochs count from 1
    picks = [torch.randperm(126, generator=harness._generator(
        "cpu", CFG.seed, 1, harness._SHARD_STREAM, r))[:16]
        for r in range(WORLD)]
    Xg, Yg = (torch.cat([torch.from_numpy(xy[i])[p]
                         for xy, p in zip(own, picks)]) for i in (0, 1))
    model = _fnn()
    model.reset_parameters(torch.Generator().manual_seed(CFG.seed))
    Yall = torch.from_numpy(np.concatenate([y for _, y in own]))
    with torch.no_grad():
        want = harness.trainable_l1l2_loss(
            torch.tensor(CFG.initial_alpha), model(
                Xg, generator=torch.Generator(), train=True),
            Yg, Yall.min(), Yall.max(), CFG.box_constraint_coeff)
    for got in ranks:
        first = got["per_shard_first"]
        assert torch.equal(first["targets"], Yg)
        torch.testing.assert_close(first["loss"], want, rtol=1e-6, atol=0)


def test_per_shard_without_mesh_warns():
    X, Y, Xv, Yv = _fnn_data()
    cfg = dataclasses.replace(CFG, num_epochs=1)
    with pytest.warns(UserWarning, match="per_shard"):
        res = fit(_fnn(), X[:64], Y[:64], Xv, Yv, cfg, device="cpu",
                  shuffle_scope="per_shard")
    _bitwise(res, fit(_fnn(), X[:64], Y[:64], Xv, Yv, cfg, device="cpu"))


def test_pinn_statistics_and_bounds_match_one_rank(ranks):
    bounds = []
    one = _pinn_fit(bounds=bounds)
    for got in ranks:
        assert got["bounds"] == bounds
        assert torch.equal(got["pinn"].params["model"]["norm_0.running_var"],
                           ranks[0]["pinn"].params["model"][
                               "norm_0.running_var"])
        stats = [k for k in one.params["model"] if "running_" in k]
        assert stats
        for k in stats:
            want = one.params["model"][k]
            torch.testing.assert_close(
                got["pinn"].params["model"][k], want, rtol=0,
                atol=1e-6 * float(want.abs().max()))
    np.testing.assert_allclose(ranks[0]["pinn"].train_losses,
                               one.train_losses, rtol=1e-5)


def test_size_one_mesh_is_no_mesh(size_one_mesh):
    X, Y, Xv, Yv = _fnn_data()
    cfg = dataclasses.replace(CFG, sigma_0=0.03, num_epochs=2)
    _bitwise(fit(_fnn(0.1), X, Y, Xv, Yv, cfg, mesh=size_one_mesh),
             fit(_fnn(0.1), X, Y, Xv, Yv, cfg, device="cpu"))
    _bitwise(_pinn_fit(mesh=size_one_mesh), _pinn_fit())
