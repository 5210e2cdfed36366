"""Port: the training harness against the JAX package's.

- The optimizer: k steps on given float64 gradients against optax
  (``openpystruct_tpu.train.harness._make_optimizer``) to 1e-12 relative,
  with the global norm below and above 1, an epoch boundary of the
  learning-rate schedule crossed, alpha trained and frozen.
- The early-stop rule on scripted val losses.
- ``fit`` on a small TFD on the CPU: histories, best params and final state
  bitwise the same for ``epochs_per_sync`` 1 and 4 (with and without an
  early stop, as tests/test_train_fnn.py:162 holds the JAX package); the
  ragged val tail counted (tests/test_train_fnn.py:109); alpha trained and
  frozen; the metrics logger fed.
- ``evaluate_r2`` against JAX's on carried weights and injected diffusion
  draws (float32; R^2 within 1e-5).
- A checkpoint of the best params reloads to a bitwise-equal ``predict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpystruct_tpu.config import TrainConfig as JTrainConfig
from openpystruct_tpu.data.pipeline import Scaler as JScaler
from openpystruct_tpu.models import transformer_diffusion as jtd
from openpystruct_tpu.train import evaluate_r2 as j_evaluate_r2
from openpystruct_tpu.train.harness import _make_optimizer
from openpystruct_tpu_torch.config import TrainConfig
from openpystruct_tpu_torch.data import Scaler
from openpystruct_tpu_torch.interop import tfd_params_from_flax
from openpystruct_tpu_torch.models import transformer_diffusion as ttd
from openpystruct_tpu_torch.models.losses import trainable_l1l2_loss
from openpystruct_tpu_torch.train import (
    evaluate_r2,
    fit,
    load_checkpoint,
    predict,
    save_checkpoint,
)
from openpystruct_tpu_torch.train.harness import _early_stop_step, _Optimizer
from openpystruct_tpu_torch.utils import MetricsLogger
from openpystruct_tpu_torch.utils.tb_writer import read_scalars

SMALL = dict(n_cases=3, feat_dim=16, n_elem=5, hidden_units=8, num_heads=4,
             dim_feedforward=12, diffusion_hidden_dim=10)


@pytest.fixture(autouse=True)
def _one_thread():
    """These models are small: one intra-op thread runs them several times
    faster than many, above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n_tr=24, n_va=9, seed=1):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, 3, 16)).astype(np.float32)
        return X, X[:, :, :5].sum(axis=1).astype(np.float32)

    return (*split(n_tr), *split(n_va))


def _model(dropout_rate=0.2):
    return ttd.TransformerDiffusionModel(dtype=torch.float32,
                                         dropout_rate=dropout_rate, **SMALL)


@pytest.mark.parametrize("train_alpha", [True, False])
def test_optimizer_matches_optax(train_alpha):
    kw = dict(learning_rate=0.05, lr_gamma=0.5, weight_decay=0.1)
    rng = np.random.default_rng(0)
    p0 = {"model": {"b": rng.normal(size=4), "w": rng.normal(size=(3, 4))},
          "alpha": np.float64(0.5)}
    # 5 steps over 2-step epochs; global norms ~0.2, 8, 0.4, 20, 0.08
    grads = [jax.tree.map(lambda a, s=s: s * rng.normal(size=np.shape(a)), p0)
             for s in (0.05, 2.0, 0.1, 5.0, 0.02)]
    norms = [np.sqrt(sum((a ** 2).sum() for a in jax.tree.leaves(
        g if train_alpha else g["model"]))) for g in grads]
    assert min(norms) < 1 < max(norms)

    tx = _make_optimizer(JTrainConfig(**kw), 2, train_alpha, False)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)

    w = torch.tensor(p0["model"]["w"], requires_grad=True)
    b = torch.tensor(p0["model"]["b"], requires_grad=True)
    alpha = torch.tensor(0.5, dtype=torch.float64, requires_grad=train_alpha)
    opt = _Optimizer(TrainConfig(**kw), 2, [b, w], alpha, train_alpha)
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


def test_early_stop_rule():
    """Strict improvement, a stop after ``patience`` epochs without one, the
    stopping epoch kept, later epochs inactive (even an improving one)."""
    vals = [3.0, 2.0, 2.5, 2.0, 1.5, 1.6, 1.7, 1.8, 1.0]
    best = torch.tensor(float("inf"))
    no_improve = torch.zeros((), dtype=torch.int32)
    stopped = torch.zeros((), dtype=torch.bool)
    active, improved = [], []
    for v in vals:
        a, i, best, no_improve, stopped = _early_stop_step(
            torch.tensor(v), best, no_improve, stopped, patience=3)
        active.append(bool(a))
        improved.append(bool(i))
    assert active == [True] * 8 + [False]
    assert improved == [True, True, False, False, True, False, False, False,
                        False]
    assert float(best) == 1.5 and bool(stopped)


@pytest.mark.parametrize("patience", [50, 1])
def test_fit_bitwise_for_any_epochs_per_sync(patience):
    data = _data(n_tr=40)
    cfg = TrainConfig(num_epochs=7, batch_size=4, patience=patience,
                      sigma_0=0.05, dropout_rate=0.2, learning_rate=1e-2)
    model = _model()
    a, b = (fit(model, *data, cfg, epochs_per_sync=k, device="cpu")
            for k in (1, 4))
    assert a.stopped_early == (patience == 1)
    assert len(a.val_losses) == (3 if patience == 1 else 7)
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    assert (a.best_epoch, a.stopped_early, a.state["step"]) == (
        b.best_epoch, b.stopped_early, b.state["step"])
    assert a.best_epoch == int(np.argmin(a.val_losses)) + 1
    for x, y in ((a.params, b.params), (a.state["params"],
                                        b.state["params"])):
        assert torch.equal(x["alpha"], y["alpha"])
        for k in x["model"]:
            assert torch.equal(x["model"][k], y["model"][k]), k


def test_fit_counts_the_val_tail(monkeypatch):
    """11 val samples at batch 4: two full batches and a tail of 3, the
    val loss the mean over all three (the diffusion step is skipped so that
    the evaluation draws nothing and can be redone by hand)."""
    monkeypatch.setattr(ttd.DiffusionModule, "forward",
                        lambda self, x, generator: x)
    X_tr, Y_tr, X_va, Y_va = _data(n_tr=32, n_va=11, seed=2)
    cfg = TrainConfig(num_epochs=1, batch_size=4, patience=10, sigma_0=0.0)
    model = _model(dropout_rate=0.0)
    res = fit(model, X_tr, Y_tr, X_va, Y_va, cfg, device="cpu")
    alpha = res.state["params"]["alpha"]
    lo, hi = torch.from_numpy(Y_tr).min(), torch.from_numpy(Y_tr).max()
    losses = []
    with torch.no_grad():
        for i in range(0, 11, 4):
            preds = model(torch.from_numpy(X_va[i:i + 4]), generator=None)
            losses.append(float(trainable_l1l2_loss(
                alpha, preds, torch.from_numpy(Y_va[i:i + 4]), lo, hi,
                cfg.box_constraint_coeff) + (0.5 - alpha) ** 2))
    assert len(losses) == 3
    got = float(res.val_losses[-1])
    assert got == pytest.approx(sum(losses) / 3, rel=1e-6)
    assert abs(got - sum(losses[:2]) / 2) > 1e-6


def test_fit_alpha_trains_and_freezes():
    data = _data()
    cfg = TrainConfig(num_epochs=2, batch_size=8, patience=50, sigma_0=0.0)
    model = _model(dropout_rate=0.0)
    trained = fit(model, *data, cfg, device="cpu")
    frozen = fit(model, *data, cfg, train_alpha=False, device="cpu")
    assert abs(float(trained.state["params"]["alpha"]) - 0.5) > 1e-6
    assert float(frozen.state["params"]["alpha"]) == 0.5


def test_fit_feeds_metrics(tmp_path):
    data = _data()
    cfg = TrainConfig(num_epochs=3, batch_size=8, patience=50, sigma_0=0.0)
    m = MetricsLogger(jsonl=str(tmp_path / "m.jsonl"),
                      tensorboard_dir=str(tmp_path / "tb"))
    res = fit(_model(), *data, cfg, metrics=m, epochs_per_sync=2,
              device="cpu")
    m.close()
    assert m.column("val_loss") == list(res.val_losses)
    assert m.column("step") == [1, 2, 3]
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
    # the TensorBoard sink: one scalar per metric and epoch
    (events,) = (tmp_path / "tb").iterdir()
    assert read_scalars(str(events)) == [
        (e + 1, k, float(np.float32(v))) for e in range(3)
        for k, v in (("train_loss", res.train_losses[e]),
                     ("val_loss", res.val_losses[e]))]


def test_fit_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(_model(), *_data(), TrainConfig(num_epochs=1))


def test_evaluate_r2_matches_jax(monkeypatch):
    """Both chunk the 16 val groups by 8 with the same injected draws (the
    JAX package's jitted chunk traces its draws once)."""
    jm = jtd.TransformerDiffusionModel(dtype=jnp.float32, **SMALL)
    params = jax.tree.map(np.asarray, jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.zeros((2, 3, 16))))()["params"])
    rng = np.random.default_rng(3)
    X = rng.normal(size=(16, 3, 16)).astype(np.float32)
    Y = rng.normal(size=(16, 5)).astype(np.float32)
    mean = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    scale = rng.uniform(0.2, 0.6, 5).astype(np.float32)
    t = rng.integers(0, 512, size=(8, 3))
    eps = rng.normal(size=(8, 3, 16))

    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            eps, dtype))
    r2_j = j_evaluate_r2(jm, {"model": params, "alpha": 0.5}, X, Y,
                         JScaler(mean=mean, scale=scale),
                         rng=jax.random.PRNGKey(0),
                         model_rng_keys=("dropout", "diffusion"),
                         batch_size=8)
    monkeypatch.undo()
    monkeypatch.setattr(
        ttd.DiffusionModule, "_draw",
        lambda self, x, generator: (torch.as_tensor(t), torch.as_tensor(
            eps).to(x.dtype)))
    tm = _model()
    r2_t = evaluate_r2(tm, tfd_params_from_flax({"model": params,
                                                  "alpha": 0.5},
                                                 device="cpu"),
                       X, Y, Scaler(mean=mean, scale=scale), batch_size=8,
                       device="cpu")
    assert r2_t == pytest.approx(r2_j, rel=1e-5, abs=1e-5)


def test_checkpoint_round_trip_predicts_the_same(tmp_path):
    data = _data()
    model = _model()
    res = fit(model, *data, TrainConfig(num_epochs=2, batch_size=8,
                                        sigma_0=0.0), device="cpu")
    path = tmp_path / "best.pt"
    save_checkpoint(str(path), res.params)
    assert [p.name for p in tmp_path.iterdir()] == ["best.pt"]
    back = load_checkpoint(str(path))
    assert torch.equal(back["alpha"], res.params["alpha"])
    sY = Scaler(mean=np.full(5, 1.0, np.float32),
                scale=np.full(5, 0.5, np.float32))
    a = predict(model, res.params, data[2], sY, seed=4, batch_size=4,
                device="cpu")
    b = predict(model, back, data[2], sY, seed=4, batch_size=4,
                device="cpu")
    assert a.shape == (9, 5) and (a >= 0).all()
    assert torch.equal(a, b)
    # per-chunk draws: another seed gives other (float32, noisy) outputs
    assert not torch.equal(a, predict(model, back, data[2], sY, seed=5,
                                      batch_size=4, device="cpu"))
