"""Port: the Bayesian TFDs (``models/bayesian.py``), their families and
``fit(param_loss_fn=)``, against the JAX package's.

- The forward on weights carried by ``interop.bnn_params_from_flax`` with
  the same draws on both sides: ``jax.random.normal``/``randint`` are
  patched with draws that are a function of the shape (so each
  ``BayesLinear`` gets the same epsilon on both sides), the port's
  ``bayesian._normal``/``_randint`` likewise.  float32: within 2e-5 of the
  output's scale (the TFD's bound: the schedule's ``cumprod`` in another
  order moves the noise scale by up to 2.9e-6).  bfloat16: within 0.1 of
  the output's scale, the TFD's bound, the size of bfloat16's own gap to
  float32 (the diffusion step is an identity on both sides); the output
  and every ``BayesLinear`` are float32 there by JAX's type promotion,
  checked in both packages.
- ``bayes_kl`` against JAX's in float64 within 1e-12 relative.
- ``mc_output_stats``: the population std and the scaler transform,
  against JAX's ``mc_output_stats`` on the same stack of samples.
- ``fit(param_loss_fn=)`` adds the term to the train and the val loss;
  ``build_family("bnn" | "bnn-meta")`` at the published widths; ``fit``
  bitwise across ``epochs_per_sync`` with the KL and the "bayes" draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu import families as jfam
from openpystruct_tpu.data.pipeline import Scaler as JScaler
from openpystruct_tpu.models import bayesian as jbayes
from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch.data import Scaler
from openpystruct_tpu_torch.interop import (
    bnn_params_from_flax,
    bnn_params_to_flax,
)
from openpystruct_tpu_torch.models import bayesian as tbayes
from openpystruct_tpu_torch.train import fit

SMALL = dict(n_cases=3, feat_dim=8, n_elem=5, hidden_units=12,
             num_transformer_layers=2, num_heads=4, dim_feedforward=12,
             diffusion_hidden_dim=10)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.1)}
RNGS = ("bayes", "diffusion", "dropout")


@pytest.fixture(autouse=True)
def _one_thread():
    """These models are small: one intra-op thread runs them several times
    faster than many, above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal_of(shape):
    return np.random.default_rng([*shape, 1]).normal(size=shape)


def _randint_of(shape):
    return np.random.default_rng([*shape, 2]).integers(0, 512, size=shape)


def _patch_draws(monkeypatch):
    monkeypatch.setattr(
        jax.random, "normal", lambda key, shape, dtype=jnp.float32:
        jnp.asarray(_normal_of(tuple(shape)), dtype))
    monkeypatch.setattr(
        jax.random, "randint", lambda key, shape, lo, hi, *a, **k:
        jnp.asarray(_randint_of(tuple(shape))))
    monkeypatch.setattr(
        tbayes, "_normal", lambda shape, generator, device, dtype:
        torch.from_numpy(_normal_of(tuple(shape))).to(dtype))
    monkeypatch.setattr(
        tbayes, "_randint", lambda high, shape, generator, device:
        torch.from_numpy(_randint_of(tuple(shape))))


def _init(jm):
    """flax params of ``jm`` (jitted: eager init compiles op by op)."""
    return jax.tree.map(np.asarray, jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "bayes": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)},
        jnp.zeros((2, jm.n_cases, jm.feat_dim))))()["params"])


def _carried(dtype_name, meta):
    jd, td, _ = DTYPES[dtype_name]
    jm = jbayes.BayesianTransformerDiffusionModel(
        dtype=jd, use_output_scales=meta, **SMALL)
    params = _init(jm)
    if meta:   # output scales away from their start at 1
        params["output_scales"] = np.linspace(
            0.5, 1.5, SMALL["n_elem"]).astype(np.float32)
    tm = tbayes.BayesianTransformerDiffusionModel(
        dtype=td, use_output_scales=meta, **SMALL)
    tm.load_state_dict(bnn_params_from_flax(params, device="cpu"))
    return jm, params, tm


def _x(B=7, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, SMALL["n_cases"], SMALL["feat_dim"])).astype(np.float32)


@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_forward_matches_jax(monkeypatch, dtype_name, meta):
    jm, params, tm = _carried(dtype_name, meta)
    x = _x()
    _patch_draws(monkeypatch)
    # one jitted program: the patched draws are traced in as constants
    y_j = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, train=False,
        rngs={k: jax.random.PRNGKey(3) for k in RNGS}))(params, x))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None)
    assert y_t.dtype == torch.float32 and y_t.shape == (7, SMALL["n_elem"])
    tol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=tol * np.abs(y_j).max())
    back = bnn_params_to_flax(tm.state_dict(), num_heads=SMALL["num_heads"])
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_bfloat16_promotes_to_float32_like_jax(monkeypatch):
    """bfloat16 product + float32 sampled bias: float32 in both packages,
    and the diffusion module's output with it (its step is an identity)."""
    _patch_draws(monkeypatch)
    x = np.random.default_rng(1).normal(size=(4, 3, 8)).astype(np.float32)
    jl = jbayes.BayesLinear(6, dtype=jnp.bfloat16)
    v = jax.jit(lambda: jl.init({"params": jax.random.PRNGKey(0),
                                 "bayes": jax.random.PRNGKey(1)}, x))()
    y_j = jax.jit(lambda v, x: jl.apply(
        v, x, rngs={"bayes": jax.random.PRNGKey(2)}))(v, x)
    tl = tbayes.BayesLinear(8, 6, dtype=torch.bfloat16)
    tl.load_state_dict({k: torch.from_numpy(np.array(a))
                        for k, a in v["params"].items()})
    y_t = tl(torch.from_numpy(x), None)
    assert y_j.dtype == jnp.float32 and y_t.dtype == torch.float32
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))

    jd = jbayes.BayesianDiffusionModule(8, hidden_dim=10,
                                        dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    vd = jax.jit(lambda: jd.init({"params": jax.random.PRNGKey(0),
                                  "bayes": jax.random.PRNGKey(1),
                                  "diffusion": jax.random.PRNGKey(2)}, xb,
                                 train=False))()
    d_j = jax.jit(lambda v, x: jd.apply(
        v, x, train=False, rngs={"bayes": jax.random.PRNGKey(3),
                                 "diffusion": jax.random.PRNGKey(4)}))(vd, xb)
    td = tbayes.BayesianDiffusionModule(8, hidden_dim=10,
                                        dtype=torch.bfloat16)
    d_t = td(torch.from_numpy(x).to(torch.bfloat16), generator=None,
             train=False)
    assert d_j.dtype == jnp.float32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(d_j), np.asarray(xb, np.float32))
    assert torch.equal(d_t, torch.from_numpy(x).to(torch.bfloat16).float())


def test_bayes_kl_matches_jax():
    rng = np.random.default_rng(4)
    # away from the start: sigma != prior sigma, mu spread
    state = {k: v.double() + torch.from_numpy(rng.normal(scale=0.3,
                                                          size=v.shape))
             for k, v in _small().state_dict().items()}
    params = bnn_params_to_flax(state, num_heads=SMALL["num_heads"])
    j = float(jbayes.bayes_kl(params))
    t = tbayes.bayes_kl(state)
    assert t.dtype == torch.float64
    assert abs(float(t) - j) <= 1e-12 * abs(j)
    # kernels and biases of every BayesLinear: 4 layers here
    n = sum(k.endswith(("mu_kernel", "mu_bias")) for k in state)
    assert n == 8
    # the family's term is the scaled KL
    kl = tfam.build_family("bnn", 24)[2]["param_loss_fn"](state)
    assert float(kl) == pytest.approx(tfam.BNN_KL_SCALE * j, rel=1e-12)


@pytest.mark.parametrize("scaled", [False, True])
def test_mc_output_stats_matches_jax(monkeypatch, scaled):
    tm = _small(meta=True)
    x = _x(B=4, seed=3)
    tparams = {"model": tm.state_dict()}
    rng = np.random.default_rng(6)
    mean_y = rng.uniform(1.0, 3.0, 5).astype(np.float32)
    scale_y = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    kw = {"scaler_Y": Scaler(mean=mean_y, scale=scale_y)} if scaled else {}
    mean, std = tbayes.mc_output_stats(tm, tparams, x, n_samples=6, seed=2,
                                       device="cpu", **kw)
    # the same samples: sample i from the generator seeded from (2, i)
    from openpystruct_tpu_torch.train.harness import _generator

    with torch.no_grad():
        stack = np.stack([tm(torch.from_numpy(x),
                             generator=_generator("cpu", 2, i)).numpy()
                          for i in range(6)])
    assert np.abs(stack.std(0)).min() > 0   # the weights' spread
    monkeypatch.setattr(jbayes, "_mc_forward",
                        lambda model: lambda v, x, keys: jnp.asarray(stack))
    jkw = ({"scaler_Y": JScaler(mean=mean_y, scale=scale_y)} if scaled
           else {})
    j_mean, j_std = jbayes.mc_output_stats(None, None, x, n_samples=6,
                                           **jkw)
    np.testing.assert_allclose(mean.numpy(), j_mean, rtol=1e-6, atol=0)
    np.testing.assert_allclose(std.numpy(), j_std, rtol=1e-5, atol=0)
    # the population std (ddof 0), not torch's default correction
    assert not np.allclose(std.numpy(), np.asarray(j_std) * np.sqrt(6 / 5))


def _fit_data(n_tr=24, n_va=9, seed=1):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, 3, 8)).astype(np.float32)
        return X, X[:, :, :5].sum(axis=1).astype(np.float32)

    return (*split(n_tr), *split(n_va))


def _small(meta=False):
    return tbayes.BayesianTransformerDiffusionModel(
        dtype=torch.float32, use_output_scales=meta, dropout_rate=0.1,
        **SMALL)


def test_fit_adds_the_param_loss_to_train_and_val():
    data = _fit_data()
    cfg = dataclasses.replace(tfam.FAMILIES["bnn"].train, num_epochs=3,
                              batch_size=8)
    base = fit(_small(), *data, cfg, device="cpu")
    seen = []

    def term(params):
        seen.append(set(params))
        return torch.tensor(5.0)

    shifted = fit(_small(), *data, cfg, device="cpu", param_loss_fn=term)
    # a constant has no gradient: the same trajectory, every loss + 5
    np.testing.assert_allclose(shifted.train_losses, base.train_losses + 5,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(shifted.val_losses, base.val_losses + 5,
                               rtol=0, atol=1e-5)
    assert seen[0] == {k for k, _ in _small().named_parameters()}
    # 3 train steps and 2 val batches an epoch
    assert len(seen) == 3 * (3 + 2)


@pytest.mark.parametrize("name", ["bnn", "bnn-meta"])
def test_build_family_at_published_widths(name):
    model, spec, kw = tfam.build_family(name, 24)
    jmodel, jspec, jkw = jfam.build_family(name, 24)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert set(kw) == {"param_loss_fn"} and "param_loss_fn" in jkw
    assert model.dtype == torch.bfloat16 and jmodel.dtype == jnp.bfloat16
    n_cases = spec.train.n_cases
    assert n_cases == (8 if name == "bnn-meta" else 6)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "bayes": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)},
        jnp.zeros((2, n_cases, 24))))["params"]
    carried = bnn_params_to_flax(model.state_dict(), num_heads=24)
    assert (jax.tree.map(lambda a: a.shape, carried)
            == jax.tree.map(lambda a: a.shape, shapes))
    assert (len(model.layers), model.layers[0].attn.num_heads,
            model.layers[0].dense_0.out_features,
            model.head.bayes_0.mu_kernel.shape[1],
            model.diffusion.mlp.bayes_0.mu_kernel.shape[1],
            model.use_output_scales) == (4, 24, 512, 512, 512,
                                         name == "bnn-meta")
    # the start: U(-1/sqrt(in), 1/sqrt(in)) means, log 0.01, zero cls
    mu = model.head.bayes_0.mu_kernel.detach()
    assert mu.abs().max() <= 1 / np.sqrt(24) and mu.std() > 0.1 / np.sqrt(24)
    assert torch.all(model.head.bayes_1.log_sigma_bias == np.log(0.01))
    assert not model.cls_token.any()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, n_cases, 24)).astype(np.float32))
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        y = model(x, generator=g)
        assert not torch.equal(y, model(x, generator=g))   # resampled
    assert y.shape == (2, 100) and y.dtype == torch.float32


@pytest.mark.parametrize("name", ["bnn", "bnn-meta"])
def test_family_fit_bitwise_across_sync(name):
    data = _fit_data()
    _, spec, kw = tfam.build_family(name, 24)
    cfg = dataclasses.replace(spec.train, num_epochs=5, batch_size=8,
                              learning_rate=3e-3)

    def run(epochs_per_sync):
        return fit(_small(meta=name == "bnn-meta"), *data, cfg, seed=3,
                   epochs_per_sync=epochs_per_sync, device="cpu", **kw)

    a, b = run(1), run(3)
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    assert a.best_epoch == b.best_epoch
    for res_a, res_b in ((a.params, b.params),
                         (a.state["params"], b.state["params"])):
        for k in res_a["model"]:
            assert torch.equal(res_a["model"][k], res_b["model"][k]), k
        assert torch.equal(res_a["alpha"], res_b["alpha"])
    assert np.isfinite(a.train_losses).all()
    assert a.train_losses[-1] < a.train_losses[0]
    # weight decay reaches log sigma (all of the model's parameters)
    ls = a.state["params"]["model"]["head.bayes_0.log_sigma_kernel"]
    assert not torch.all(ls == np.float32(np.log(0.01)))
