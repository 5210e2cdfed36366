"""Port: the chain GNN (``models/gnn.py``), the FNO (``models/fno.py``),
their families and ``fit``'s AdamW, against the JAX package's.

- Forwards on weights carried by ``interop`` against flax at
  ``train=False``: the GNN in float32 within 1e-5 of the output's scale and
  in bfloat16 within 2e-2 (the FNN's and the PINN's bounds: bfloat16 keeps
  ~3 digits and both sides round the same products in another order); the
  FNO (float32 only) within 1e-5.
- The FNO in ``train=True`` mode with dropout 0: outputs and the updated
  running statistics against flax's mutated ``batch_stats`` within 1e-5.
- The port's ``SpectralConv1d`` against tests/test_models.py's numpy
  complex-FFT oracle on its six cases (even and odd lengths, the Nyquist
  bin, modes past Nyquist, the degenerate mixing) within 1e-5 of scale.
- ``_Optimizer``'s AdamW (``decoupled=True``) against optax's chain in
  float64 to 1e-12 relative, alpha trained and frozen.
- ``build_family("gnn" | "fno")`` at the published widths (parameter
  shapes equal to flax's); ``fit`` bitwise across ``epochs_per_sync`` at a
  small size; ``evaluate_r2`` against JAX's within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpystruct_tpu import families as jfam
from openpystruct_tpu.config import TrainConfig as JTrainConfig
from openpystruct_tpu.data.pipeline import Scaler as JScaler
from openpystruct_tpu.models import fno as jfno
from openpystruct_tpu.models import gnn as jgnn
from openpystruct_tpu.train import evaluate_r2 as j_evaluate_r2
from openpystruct_tpu.train.harness import _make_optimizer
from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch.config import TrainConfig
from openpystruct_tpu_torch.data import Scaler
from openpystruct_tpu_torch.interop import (
    fno_params_from_flax,
    fno_params_to_flax,
    gnn_params_from_flax,
    gnn_params_to_flax,
)
from openpystruct_tpu_torch.models import (
    ChainGNN,
    FNO1dModel,
    SpectralConv1d,
    normalized_chain_adjacency,
)
from openpystruct_tpu_torch.train import evaluate_r2, fit
from openpystruct_tpu_torch.train.harness import _Optimizer

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
N_CASES, FEAT, NELEM = 6, 5, 7
GNN_SMALL = dict(n_elem=NELEM, encoder_hidden_dim=12, gnn_hidden_dim=8,
                 num_gnn_layers=2)
FNO_SMALL = dict(n_cases=N_CASES, n_elem=NELEM, fno_modes=4, fno_width=8,
                 num_fno_layers=2, hidden_units=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """These models are small: one intra-op thread runs them several times
    faster than many, above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(B=9, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, N_CASES, FEAT)).astype(np.float32)


def _init(jm):
    """flax variables of ``jm`` (jitted: eager init compiles op by op)."""
    v = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                jnp.zeros((2, N_CASES, FEAT))))()
    return jax.tree.map(np.asarray, dict(v))


def _same_tree(a, b):
    la, lb = jax.tree.leaves_with_path(a), jax.tree.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=str(p))


def _gnn(dtype_name, dropout_rate=0.5):
    jd, td, _ = DTYPES[dtype_name]
    jm = jgnn.ChainGNN(dropout_rate=dropout_rate, dtype=jd, **GNN_SMALL)
    params = _init(jm)["params"]
    tm = ChainGNN(N_CASES * FEAT, dropout_rate=dropout_rate, dtype=td,
                  **GNN_SMALL)
    tm.load_state_dict(gnn_params_from_flax(params, device="cpu"))
    return jm, params, tm


def _fno(dropout_rate=0.1, degenerate=False):
    jm = jfno.FNO1dModel(dropout_rate=dropout_rate,
                         degenerate_mixing=degenerate, **FNO_SMALL)
    v = _init(jm)
    rng = np.random.default_rng(1)
    # running statistics away from flax's 0 / 1 start
    stats = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    tm = FNO1dModel(feat_dim=FEAT, dropout_rate=dropout_rate,
                    degenerate_mixing=degenerate, **FNO_SMALL)
    tm.load_state_dict(fno_params_from_flax(v["params"], stats,
                                            device="cpu"))
    return jm, v["params"], stats, tm


def test_chain_adjacency_matches_jax():
    for n in (1, 2, 7, 100):
        assert np.array_equal(normalized_chain_adjacency(n),
                              jgnn.normalized_chain_adjacency(n))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gnn_forward_matches_flax(dtype_name):
    jm, params, tm = _gnn(dtype_name)
    x = _x()
    y_j = np.asarray(jm.apply({"params": params}, x, train=False))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None)
        y_flat = tm(torch.from_numpy(x.reshape(9, -1)), generator=None)
    assert y_t.dtype == torch.float32 and y_t.shape == (9, NELEM)
    assert torch.equal(y_t, y_flat)
    tol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=tol * np.abs(y_j).max())
    _same_tree(gnn_params_to_flax(tm.state_dict()), params)


@pytest.mark.parametrize("degenerate", [False, True])
def test_fno_forward_matches_flax(degenerate):
    jm, params, stats, tm = _fno(degenerate=degenerate)
    x = _x()
    y_j = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x,
                              train=False))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None)
    assert y_t.dtype == torch.float32 and y_t.shape == (9, NELEM)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())
    back_params, back_stats = fno_params_to_flax(tm.state_dict())
    _same_tree(back_params, params)
    _same_tree(back_stats, stats)


def test_fno_train_step_statistics_match_flax():
    jm, params, stats, tm = _fno(dropout_rate=0.0)
    x = _x(B=11, seed=4)
    y_j, mutated = jm.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(3)})
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None, train=True).numpy()
    y_j = np.asarray(y_j)
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())
    want = jax.tree.map(np.asarray, mutated["batch_stats"])
    got = fno_params_to_flax(tm.state_dict())[1]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b, s in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(stats)):
        assert not np.array_equal(b, s)   # the step moved them
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0))


def test_fno_gelu_is_the_tanh_approximation():
    """flax's ``nn.gelu`` defaults to the tanh form, torch's to erf."""
    x = jnp.linspace(-4.0, 4.0, 101)
    want = np.asarray(jax.nn.gelu(x))
    got = torch.nn.functional.gelu(torch.from_numpy(np.array(x)),
                                   approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    erf = torch.nn.functional.gelu(torch.from_numpy(np.array(x))).numpy()
    assert np.abs(erf - want).max() > 1e-4


def spectral_oracle(x, wr, wi, n, modes, degen):
    """tests/test_models.py's complex rfft -> truncate -> mix -> zero-pad
    -> irfft oracle (numpy, complex128)."""
    m_eff = min(modes, n // 2 + 1)
    w = (wr + 1j * wi)[:, :, :m_eff]
    x_ft = np.fft.rfft(x, n=n, axis=-1)
    xm = x_ft[:, :, :m_eff]
    if degen:
        out_m = xm.sum(axis=1)[:, None, :] * w.sum(axis=1)[None, :, :]
    else:
        out_m = np.einsum("bim,iom->bom", xm, w)
    out_ft = np.zeros((x.shape[0], wr.shape[1], x_ft.shape[-1]),
                      np.complex128)
    out_ft[:, :, :m_eff] = out_m
    return np.fft.irfft(out_ft, n=n, axis=-1)


@pytest.mark.parametrize("n,modes,degen", [
    (6, 4, False), (6, 4, True), (8, 4, False), (7, 4, False), (9, 5, True),
    (6, 10, False)])
def test_spectral_conv_matches_complex_fft_oracle(n, modes, degen):
    rng = np.random.default_rng(n * 100 + modes)
    B, C, O = 3, 5, 5
    x = rng.normal(size=(B, C, n)).astype(np.float32)
    conv = SpectralConv1d(C, O, modes, degenerate_mixing=degen)
    conv.reset_parameters(torch.Generator().manual_seed(n))
    with torch.no_grad():
        y = conv(torch.from_numpy(x)).numpy()
    ref = spectral_oracle(x, conv.weights_real.detach().numpy(),
                          conv.weights_imag.detach().numpy(), n, modes,
                          degen)
    err = np.abs(y - ref).max() / (np.abs(ref).max() + 1e-12)
    assert err < 1e-5, err
    # the weights start U(0, 1 / (in out))
    w = conv.weights_real.detach().numpy()
    assert w.min() >= 0 and w.max() <= 1 / (C * O)


@pytest.mark.parametrize("train_alpha", [True, False])
def test_adamw_matches_optax(train_alpha):
    """The chain's AdamW: clip, Adam, decay on the model's parameters only,
    the lr schedule; 5 steps over 2-step epochs, norms below and above 1."""
    kw = dict(learning_rate=0.05, lr_gamma=0.5, weight_decay=0.3)
    rng = np.random.default_rng(0)
    p0 = {"model": {"b": rng.normal(size=4), "w": rng.normal(size=(3, 4))},
          "alpha": np.float64(0.5)}
    grads = [jax.tree.map(lambda a, s=s: s * rng.normal(size=np.shape(a)), p0)
             for s in (0.05, 2.0, 0.1, 5.0, 0.02)]
    tx = _make_optimizer(JTrainConfig(**kw), 2, train_alpha, True)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)

    w = torch.tensor(p0["model"]["w"], requires_grad=True)
    b = torch.tensor(p0["model"]["b"], requires_grad=True)
    alpha = torch.tensor(0.5, dtype=torch.float64, requires_grad=train_alpha)
    opt = _Optimizer(TrainConfig(**kw), 2, [b, w], alpha, train_alpha,
                     decoupled=True)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        b.grad = torch.tensor(g["model"]["b"])
        w.grad = torch.tensor(g["model"]["w"])
        if train_alpha:
            alpha.grad = torch.tensor(g["alpha"])
        opt.step()
        for t, j in ((w, jp["model"]["w"]), (b, jp["model"]["b"]),
                     (alpha, jp["alpha"])):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=1e-12, atol=0)
    assert (float(alpha.detach()) == 0.5) != train_alpha


@pytest.mark.parametrize("name", ["gnn", "fno"])
def test_build_family_at_published_widths(name):
    model, spec, kw = tfam.build_family(name, 20)
    jmodel, jspec, jkw = jfam.build_family(name, 20)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    if name == "gnn":
        assert model.dtype == torch.bfloat16 == DTYPES["bfloat16"][1]
        assert jmodel.dtype == jnp.bfloat16
        assert kw == {"decoupled_weight_decay": True}
        carried = gnn_params_to_flax(model.state_dict())
    else:
        assert model.dtype == torch.float32 and kw == {}
        carried, stats = fno_params_to_flax(model.state_dict())
    assert jkw["decoupled_weight_decay"] == (name == "gnn")
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 6, 20))))
    assert (jax.tree.map(lambda a: a.shape, carried)
            == jax.tree.map(lambda a: a.shape, shapes["params"]))
    if name == "fno":
        assert (jax.tree.map(lambda a: a.shape, stats)
                == jax.tree.map(lambda a: a.shape, shapes["batch_stats"]))
    assert model.dropout_rate == jmodel.dropout_rate == spec.train.dropout_rate
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 6, 20)).astype(np.float32))
    with torch.no_grad():
        y = model(x, generator=None)
    assert y.shape == (3, 100) and y.dtype == torch.float32


def _fit_data(n_tr=40, n_va=11, seed=1):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(N_CASES * FEAT, NELEM)) / np.sqrt(N_CASES * FEAT)

    def split(n):
        X = rng.normal(size=(n, N_CASES, FEAT)).astype(np.float32)
        return X, (X.reshape(n, -1) @ W).astype(np.float32)

    return (*split(n_tr), *split(n_va))


def _small(name):
    if name == "gnn":
        return ChainGNN(N_CASES * FEAT, dropout_rate=0.5,
                        dtype=torch.float32, **GNN_SMALL)
    return FNO1dModel(feat_dim=FEAT, dropout_rate=0.1, **FNO_SMALL)


@pytest.mark.parametrize("name", ["gnn", "fno"])
def test_family_fit_bitwise_across_sync(name):
    data = _fit_data()
    _, spec, kw = tfam.build_family(name, FEAT)
    cfg = dataclasses.replace(spec.train, num_epochs=6, batch_size=16)

    def run(epochs_per_sync):
        model = _small(name)
        return fit(model, *data, cfg, seed=3,
                   epochs_per_sync=epochs_per_sync, device="cpu", **kw)

    a, b = run(1), run(4)
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    assert (a.best_epoch, a.stopped_early) == (b.best_epoch, b.stopped_early)
    for res_a, res_b in ((a.params, b.params),
                         (a.state["params"], b.state["params"])):
        assert res_a["model"].keys() == res_b["model"].keys()
        for k in res_a["model"]:
            assert torch.equal(res_a["model"][k], res_b["model"][k]), k
        assert torch.equal(res_a["alpha"], res_b["alpha"])
    assert np.isfinite(a.train_losses).all()
    assert a.train_losses[-1] < a.train_losses[0]
    if name == "fno":
        stats = [k for k in a.params["model"] if "running_" in k]
        assert len(stats) == 2 * FNO_SMALL["num_fno_layers"]


@pytest.mark.parametrize("name", ["gnn", "fno"])
def test_evaluate_r2_matches_jax(name):
    rng = np.random.default_rng(5)
    if name == "fno":
        jm, params, stats, tm = _fno()
        tparams = fno_params_from_flax({"model": params, "alpha": 0.5},
                                       stats, device="cpu")
    else:
        jm, params, tm = _gnn("float32")
        stats = None
        tparams = gnn_params_from_flax({"model": params, "alpha": 0.5},
                                       device="cpu")
    X = _x(B=23, seed=6)
    Y_std = rng.normal(size=(23, NELEM)).astype(np.float32)
    mean = rng.uniform(1.0, 3.0, NELEM).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, NELEM).astype(np.float32)
    r2_j = j_evaluate_r2(jm, {"model": params, "alpha": 0.5}, X, Y_std,
                         JScaler(mean=mean, scale=scale), batch_stats=stats)
    r2_t = evaluate_r2(tm, tparams, X, Y_std, Scaler(mean=mean, scale=scale),
                       batch_size=10, device="cpu")
    assert abs(r2_t - r2_j) <= 1e-6
