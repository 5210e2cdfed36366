"""Port: the FNN and the PINN surrogates (``models/fnn.py``,
``models/pinn.py``), their families, the harness's BatchNorm statistics and
``loss_fn_builder``, and the persisted scalers, against the JAX package's.

- Forwards on weights carried by ``interop`` against flax at
  ``train=False``: float32 within 1e-5 of the output's scale, bfloat16
  within 2e-2.
- The PINN in ``train=True`` mode with dropout 0: outputs and the updated
  running statistics against flax's mutated ``batch_stats`` within 1e-5,
  for ``norm_type`` "batch" and "layer".
- ``composite_pinn_loss`` and the PINN family's loss against JAX in
  float64 within 1e-12.
- ``build_family("fnn" | "pinn")`` builds at the published widths; ``fit``
  lowers the loss and is bitwise across ``epochs_per_sync``, BatchNorm
  statistics included.
- ``evaluate_r2`` against JAX's within 1e-6 on the same weights and data.
- ``save_preprocessing``/``load_preprocessing`` files cross between the
  packages with equal arrays and metadata.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu import families as jfam
from openpystruct_tpu.data import persist as jpersist
from openpystruct_tpu.data.pipeline import Scaler as JScaler
from openpystruct_tpu.data.pipeline import prepare_dataset as j_prepare
from openpystruct_tpu.models import fnn as jfnn
from openpystruct_tpu.models import pinn as jpinn
from openpystruct_tpu.train import evaluate_r2 as j_evaluate_r2
from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch.data import (
    Scaler,
    load_preprocessing,
    prepare_dataset,
    save_preprocessing,
)
from openpystruct_tpu_torch.datagen.io import columnar_from_fields
from openpystruct_tpu_torch.interop import (
    fnn_params_from_flax,
    fnn_params_to_flax,
    pinn_params_from_flax,
    pinn_params_to_flax,
)
from openpystruct_tpu_torch.models import (
    BatchNorm,
    FNNWithResidual,
    PINNWithResidual,
    composite_pinn_loss,
)
from openpystruct_tpu_torch.train import evaluate_r2, fit, predict

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
N_CASES, FEAT, HID = 3, 6, 16


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


def _stirred(stats, seed=1):
    """Running statistics away from flax's 0 / 1 start."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        stats)


def _fnn(dtype_name, out=5):
    jd, td, _ = DTYPES[dtype_name]
    jm = jfnn.FNNWithResidual(hidden_dim=HID, num_blocks=2, output_dim=out,
                              dropout_rate=0.5, dtype=jd)
    params = _init(jm)["params"]
    tm = FNNWithResidual(N_CASES * FEAT, HID, 2, out, 0.5, dtype=td)
    tm.load_state_dict(fnn_params_from_flax(params, device="cpu"))
    return jm, params, tm


def _pinn(dtype_name, norm_type="batch", out=7, dropout_rate=0.0):
    jd, td, _ = DTYPES[dtype_name]
    jm = jpinn.PINNWithResidual(hidden_dim=HID, num_blocks=2, output_dim=out,
                                dropout_rate=dropout_rate,
                                norm_type=norm_type, dtype=jd)
    v = _init(jm)
    params, stats = v["params"], _stirred(v["batch_stats"])
    tm = PINNWithResidual(N_CASES * FEAT, HID, 2, out, dropout_rate,
                          norm_type=norm_type, dtype=td)
    tm.load_state_dict(pinn_params_from_flax(params, stats, device="cpu"))
    return jm, params, stats, tm


def _same_tree(a, b):
    la, lb = jax.tree.leaves_with_path(a), jax.tree.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=str(p))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fnn_forward_matches_flax(dtype_name):
    jm, params, tm = _fnn(dtype_name)
    x = _x()
    y_j = np.asarray(jm.apply({"params": params}, x, train=False))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None)
        # a flat (B, n_cases * feat) input is the same model
        y_flat = tm(torch.from_numpy(x.reshape(9, -1)), generator=None)
    assert y_t.dtype == torch.float32 and y_t.shape == (9, 5)
    assert torch.equal(y_t, y_flat)
    tol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=tol * np.abs(y_j).max())
    _same_tree(fnn_params_to_flax(tm.state_dict()), params)


@pytest.mark.parametrize("norm_type", ["batch", "layer"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_pinn_forward_matches_flax(dtype_name, norm_type):
    jm, params, stats, tm = _pinn(dtype_name, norm_type)
    x = _x()
    y_j = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x,
                              train=False))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None).numpy()
    tol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(y_t, y_j, rtol=0,
                               atol=tol * np.abs(y_j).max())
    back_params, back_stats = pinn_params_to_flax(tm.state_dict())
    _same_tree(back_params, params)
    _same_tree(back_stats, stats)


@pytest.mark.parametrize("norm_type", ["batch", "layer"])
def test_pinn_train_step_statistics_match_flax(norm_type):
    jm, params, stats, tm = _pinn("float32", norm_type)
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
    got = pinn_params_to_flax(tm.state_dict())[1]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b, s in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(stats)):
        assert not np.array_equal(b, s)   # the step moved them
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0))


def test_batch_norm_is_flax_not_torch():
    """Biased variance and momentum 0.9 on the running side: one step from
    (0, 1) on a batch whose unbiased variance differs."""
    x = torch.tensor([[1.0], [2.0], [4.0]])
    bn = BatchNorm(1)
    y = bn(x, train=True)
    var = x.var(unbiased=False)
    assert torch.allclose(bn.running_mean, 0.1 * x.mean())
    assert torch.allclose(bn.running_var, 0.9 + 0.1 * var)
    assert torch.allclose(y, (x - x.mean()) / torch.sqrt(var + 1e-5))
    y_eval = bn(x, train=False)
    assert torch.allclose(y_eval, (x - bn.running_mean)
                          / torch.sqrt(bn.running_var + 1e-5))


@pytest.mark.parametrize("bounds", [False, True])
def test_composite_pinn_loss_matches_jax(bounds):
    rng = np.random.default_rng(2)
    nelem = 4
    preds = rng.normal(size=(6, nelem + 2 * 5))
    targets = rng.normal(size=(6, nelem + 2 * 5))
    kw = dict(nelem=nelem, box_constraint_coeff=0.3, penalty_pinn=0.7)
    if bounds:
        kw.update(min_constraint=-0.5, max_constraint=0.6)
    for alpha in (0.3, 2.0, -1.0):   # clamped to [1e-6, 1] inside
        j = float(jpinn.composite_pinn_loss(
            jnp.float64(alpha), jnp.asarray(preds), jnp.asarray(targets),
            **kw))
        t = float(composite_pinn_loss(
            torch.tensor(alpha, dtype=torch.float64),
            torch.from_numpy(preds), torch.from_numpy(targets), **kw))
        assert abs(t - j) <= 1e-12 * max(abs(j), 1.0)


def test_pinn_family_loss_matches_jax():
    rng = np.random.default_rng(3)
    Y = rng.normal(size=(10, 302))
    preds, targets = rng.normal(size=(2, 5, 302))
    j_loss = jfam.build_family("pinn", 8)[2]["loss_fn_builder"](
        jnp.asarray(Y))
    t_loss = tfam.build_family("pinn", 8)[2]["loss_fn_builder"](
        torch.from_numpy(Y))
    j = float(j_loss(jnp.float64(0.5), jnp.asarray(preds),
                     jnp.asarray(targets)))
    t = float(t_loss(torch.tensor(0.5, dtype=torch.float64),
                     torch.from_numpy(preds), torch.from_numpy(targets)))
    assert abs(t - j) <= 1e-12 * abs(j)


@pytest.mark.parametrize("name", ["fnn", "pinn"])
def test_build_family(name):
    label_dim = 302 if name == "pinn" else 100
    model, spec, kw = tfam.build_family(name, 8, label_dim=label_dim)
    jmodel, jspec, jkw = jfam.build_family(name, 8, label_dim=label_dim)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert model.dtype == torch.bfloat16
    assert model.dense_0.in_features == spec.train.n_cases * 8
    assert model.dense_0.out_features == spec.train.hidden_units
    assert model.dense_1.out_features == label_dim
    assert len(model.blocks) == (4 if name == "fnn" else 2)
    assert model.dropout_rate == jmodel.dropout_rate == spec.train.dropout_rate
    assert set(kw) == ({"loss_fn_builder"} if name == "pinn" else set())
    assert set(kw) <= set(jkw)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 6, 8)).astype(np.float32))
    with torch.no_grad():
        y = model(x, generator=None)
    assert y.shape == (4, label_dim) and y.dtype == torch.float32
    m32 = tfam.build_family(name, 8, compute_dtype="float32")[0]
    assert m32.dtype == torch.float32


def _fit_data(n_tr=40, n_va=11, feat=8, label=302, seed=1):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(6 * feat, label)) / np.sqrt(6 * feat)

    def split(n):
        X = rng.normal(size=(n, 6, feat)).astype(np.float32)
        return X, (X.reshape(n, -1) @ W).astype(np.float32)

    return (*split(n_tr), *split(n_va))


def _fit(name, data, epochs_per_sync, **cfg_kw):
    # float32: bfloat16 matmuls are slow on the CPU (the card test fits in
    # the families' bfloat16, tests/test_torch_cuda.py)
    model, spec, kw = tfam.build_family(name, 8, label_dim=data[1].shape[1],
                                        compute_dtype="float32")
    cfg = dataclasses.replace(spec.train, num_epochs=6, batch_size=16,
                              **cfg_kw)
    return model, fit(model, *data, cfg, seed=3,
                      epochs_per_sync=epochs_per_sync, device="cpu", **kw)


@pytest.mark.parametrize("name,patience", [("fnn", 10), ("pinn", 10),
                                           ("pinn", 1)])
def test_family_fit_bitwise_across_sync(name, patience):
    data = _fit_data(label=302 if name == "pinn" else 100)
    # patience 1 at a high learning rate: a stop inside a 4-epoch chunk
    kw = dict(patience=patience, **({"learning_rate": 3e-2}
                                    if patience == 1 else {}))
    _, a = _fit(name, data, 1, **kw)
    _, b = _fit(name, data, 4, **kw)
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    assert (a.best_epoch, a.stopped_early) == (b.best_epoch, b.stopped_early)
    for res_a, res_b in ((a.params, b.params),
                         (a.state["params"], b.state["params"])):
        assert res_a["model"].keys() == res_b["model"].keys()
        for k in res_a["model"]:
            assert torch.equal(res_a["model"][k], res_b["model"][k]), k
        assert torch.equal(res_a["alpha"], res_b["alpha"])
    if patience == 1:
        assert a.stopped_early and len(a.train_losses) < 6
    else:
        assert np.isfinite(a.train_losses).all()
        assert a.train_losses[-1] < a.train_losses[0]
        assert a.val_losses.min() < a.val_losses[0]
    if name == "pinn":
        # the best epoch's running statistics travel with its params
        stats = [k for k in a.params["model"] if "running_" in k]
        assert len(stats) == 2 * 5
        assert not torch.equal(a.params["model"]["norm_0.running_var"],
                               torch.ones(350))


def test_fit_uses_and_checks_the_loss_builder():
    data = _fit_data(n_tr=16, n_va=5)
    model, spec, kw = tfam.build_family("pinn", 8, label_dim=302)
    cfg = dataclasses.replace(spec.train, num_epochs=1, batch_size=16)
    with pytest.raises(ValueError, match="not both"):
        fit(model, *data, cfg, device="cpu",
            loss_fn=lambda a, p, t: (p - t).abs().mean(), **kw)
    seen = []

    def builder(Y_train):
        seen.append(Y_train)
        return kw["loss_fn_builder"](Y_train)

    fit(model, *data, cfg, device="cpu", loss_fn_builder=builder)
    assert len(seen) == 1 and torch.equal(seen[0], torch.from_numpy(data[1]))


def test_predict_reads_the_running_statistics():
    data = _fit_data(n_tr=32, n_va=7)
    model, res = _fit("pinn", data, 2)
    X = torch.from_numpy(data[2])
    y = predict(model, res.params, X, device="cpu")
    model.load_state_dict(res.params["model"])
    with torch.no_grad():
        assert torch.equal(y, model(X, generator=None))
        stale = {k: (torch.zeros_like(v) if "running_mean" in k else v)
                 for k, v in res.params["model"].items()}
        assert not torch.equal(y, predict(model, {"model": stale}, X,
                                          device="cpu"))


@pytest.mark.parametrize("name", ["fnn", "pinn"])
def test_evaluate_r2_matches_jax(name):
    rng = np.random.default_rng(5)
    out = 3 + 2 * 4 if name == "pinn" else 5
    if name == "pinn":
        jm, params, stats, tm = _pinn("float32", out=out)
        tparams = pinn_params_from_flax({"model": params, "alpha": 0.5},
                                        stats, device="cpu")
    else:
        jm, params, tm = _fnn("float32", out=out)
        stats = None
        tparams = fnn_params_from_flax({"model": params, "alpha": 0.5},
                                       device="cpu")
    X = _x(B=23, seed=6)
    Y_std = rng.normal(size=(23, out)).astype(np.float32)
    mean = rng.uniform(1.0, 3.0, out).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, out).astype(np.float32)
    sl = slice(0, 3) if name == "pinn" else None
    r2_j = j_evaluate_r2(jm, {"model": params, "alpha": 0.5}, X, Y_std,
                         JScaler(mean=mean, scale=scale), batch_stats=stats,
                         label_slice=sl)
    r2_t = evaluate_r2(tm, tparams, X, Y_std, Scaler(mean=mean, scale=scale),
                       label_slice=sl, batch_size=10, device="cpu")
    assert abs(r2_t - r2_j) <= 1e-6


def _columnar(B=48, n=11, seed=0):
    rng = np.random.default_rng(seed)
    node_x = np.tile(np.linspace(0.0, 100.0, n, dtype=np.float32), (B, 1))
    roller = rng.random((B, n)) < 0.2
    loads = np.where(rng.random((B, n)) < 0.2,
                     rng.uniform(-3e5, -3e4, (B, n)), 0.0).astype(np.float32)
    return columnar_from_fields(dict(
        node_x=node_x, roller=roller, loads=loads,
        I=rng.uniform(0.1, 2.0, (B, n - 1)).astype(np.float32),
        shear=rng.normal(size=(B, n - 1)).astype(np.float32),
        moment=rng.normal(size=(B, n - 1)).astype(np.float32),
        defl=rng.normal(size=(B, n)).astype(np.float32),
        rot=rng.normal(size=(B, n)).astype(np.float32),
        valid=np.ones(B, bool)))


def _same_preprocessing(a, b):
    assert {k: a[k] for k in ("max_lengths", "n_cases", "feat_dim",
                              "label_dim", "nelem")} == {
        k: b[k] for k in ("max_lengths", "n_cases", "feat_dim", "label_dim",
                          "nelem")}
    for name in a["scalers"]:
        np.testing.assert_array_equal(a["scalers"][name].mean,
                                      b["scalers"][name].mean)
        np.testing.assert_array_equal(a["scalers"][name].scale,
                                      b["scalers"][name].scale)
    np.testing.assert_array_equal(a["scaler_Y"].mean, b["scaler_Y"].mean)
    np.testing.assert_array_equal(a["scaler_Y"].scale, b["scaler_Y"].scale)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_preprocessing_files_cross_packages(tmp_path, writer):
    data = _columnar()
    kw = dict(n_cases=4, c=0.5, extra_label_keys=("deflections",))
    ds = (j_prepare if writer == "jax" else prepare_dataset)(data, **kw)
    path = str(tmp_path / "pre.npz")
    (jpersist.save_preprocessing if writer == "jax"
     else save_preprocessing)(ds, path, nelem=10)
    got_t = load_preprocessing(path)
    got_j = jpersist.load_preprocessing(path)
    _same_preprocessing(got_t, got_j)
    assert got_t["nelem"] == 10 and got_t["label_dim"] == 10 + 11
    np.testing.assert_array_equal(got_t["scaler_Y"].mean, ds.scaler_Y.mean)
    assert got_t["max_lengths"] == ds.max_lengths
    # the in-memory and the reloaded scalers build the same user input
    from openpystruct_tpu_torch.data import build_user_input

    lists = [data[k][:4] for k in ("roller_x_locations",
                                   "force_x_locations", "force_values",
                                   "node_positions")]
    np.testing.assert_array_equal(
        build_user_input(*lists, ds.scalers, 4, ds.max_lengths),
        build_user_input(*lists, got_t["scalers"], got_t["n_cases"],
                         got_t["max_lengths"]))
