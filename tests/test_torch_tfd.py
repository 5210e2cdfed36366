"""Port: the Transformer-Diffusion surrogate, its loss and the family table
against the JAX package.

The forward runs on weights carried from flax (``interop.tfd_params_from_
flax``) with the same diffusion draws on both sides: the JAX module's
``jax.random.randint`` / ``jax.random.normal`` are patched for the test, the
port's ``DiffusionModule._draw`` likewise.  Tolerances:

- float32: within 2e-5 of the output's scale (max |y|).  Both compute the
  schedule's ``cumprod`` in float32 in another order (JAX's associative
  scan, torch's sequential product): alpha_cumprod differs by up to
  2.4e-7, the noise scale by up to 2.9e-6, which leaves ~7e-6 at the
  output.
- bfloat16: the diffusion step is an exact identity on both sides (the
  output does not change with epsilon in JAX, and equals the port's forward
  with the diffusion module skipped, bit for bit); the two packages' outputs
  agree within 0.1 of the output's scale, the size of bfloat16's own gap to
  float32 here (~0.06 of it on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu import families as jfam
from openpystruct_tpu.models import losses as jlosses
from openpystruct_tpu.models import transformer_diffusion as jtd
from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch.interop import (
    tfd_params_from_flax,
    tfd_params_to_flax,
)
from openpystruct_tpu_torch.models import losses as tlosses
from openpystruct_tpu_torch.models import transformer_diffusion as ttd

SMALL = dict(n_cases=3, feat_dim=16, n_elem=5, hidden_units=8, num_heads=4,
             dim_feedforward=12, diffusion_hidden_dim=10)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    """These models are small: one intra-op thread runs them several times
    faster than many, above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(B, n_cases, feat, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, size=(B, n_cases)),
            rng.normal(size=(B, n_cases, feat)))


def _jax_forward(monkeypatch, model, params, x, t, eps, train=False):
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            eps, dtype))
    # one jitted program: the patched draws are traced in as constants
    out = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, train=train,
        rngs={"diffusion": jax.random.PRNGKey(1),
              "dropout": jax.random.PRNGKey(2)}))(params, jnp.asarray(x))
    monkeypatch.undo()
    return np.asarray(out)


def _inject(monkeypatch, t, eps):
    monkeypatch.setattr(
        ttd.DiffusionModule, "_draw",
        lambda self, x, generator: (torch.as_tensor(t), torch.as_tensor(
            eps).to(x.dtype)))


def _carried(dtype_name, **kw):
    jd, td = DTYPES[dtype_name]
    jm = jtd.TransformerDiffusionModel(dtype=jd, **(kw or SMALL))
    params = jax.tree.map(np.asarray, _init(jm))
    tm = ttd.TransformerDiffusionModel(dtype=td, **(kw or SMALL))
    tm.load_state_dict(tfd_params_from_flax(params, device="cpu"))
    return jm, params, tm


def _init(jm):
    """flax params of ``jm`` (jitted: eager init compiles op by op)."""
    return jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jnp.zeros((2, jm.n_cases, jm.feat_dim))))()["params"]


def _x(B=7, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, SMALL["n_cases"], SMALL["feat_dim"])).astype(np.float32)


def test_forward_float32_matches_jax(monkeypatch):
    jm, params, tm = _carried("float32")
    x = _x()
    t, eps = _draws(7, 3, 16, seed=1)
    y_j = _jax_forward(monkeypatch, jm, params, x, t, eps)
    _inject(monkeypatch, t, eps)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None).numpy()
    assert y_t.dtype == np.float32 and y_t.shape == (7, 5)
    scale = np.abs(y_j).max()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=2e-5 * scale)
    # the noise reaches the output in float32
    _inject(monkeypatch, t, 3 * eps)
    with torch.no_grad():
        assert not torch.equal(tm(torch.from_numpy(x), generator=None),
                               torch.from_numpy(y_t))


def test_forward_bfloat16_skips_the_diffusion_like_jax(monkeypatch):
    jm, params, tm = _carried("bfloat16")
    x = _x()
    t, eps = _draws(7, 3, 16, seed=1)
    y_j = _jax_forward(monkeypatch, jm, params, x, t, eps)
    # JAX: 1 - beta rounds to 1 in bfloat16, so epsilon never reaches y
    assert np.array_equal(y_j, _jax_forward(monkeypatch, jm, params, x, t,
                                            3 * eps))
    _inject(monkeypatch, t, eps)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), generator=None)
        monkeypatch.setattr(ttd.DiffusionModule, "forward",
                            lambda self, x, generator: x)
        y_skip = tm(torch.from_numpy(x), generator=None)
    assert y_t.dtype == torch.float32
    assert torch.equal(y_t, y_skip)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=0.1 * np.abs(y_j).max())


def test_bfloat16_schedule_is_one():
    """The property the identity rests on, in both packages."""
    beta = torch.linspace(1e-12, 1e-5, 512, dtype=torch.bfloat16)
    assert (torch.cumprod(1.0 - beta, 0) == 1).all()
    jbeta = jnp.linspace(1e-12, 1e-5, 512, dtype=jnp.bfloat16)
    assert (np.asarray(jnp.cumprod(1.0 - jbeta)) == 1).all()
    ac = torch.cumprod(1.0 - torch.linspace(1e-12, 1e-5, 512), 0)
    assert abs(float(torch.sqrt(1 - ac[-1])) - 0.0506) < 1e-4


def test_train_mode_draws_from_the_generator():
    tm = ttd.TransformerDiffusionModel(dtype=torch.float32, **SMALL)
    x = torch.from_numpy(_x())

    def run(seed):
        return tm(x, generator=torch.Generator().manual_seed(seed),
                  train=True)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    y = run(3)
    y.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tm.parameters())


@pytest.mark.parametrize("bounds", [False, True])
@pytest.mark.parametrize("alpha", [0.3, -2.0, 1.7])
def test_loss_matches_jax(bounds, alpha):
    rng = np.random.default_rng(5)
    preds, targets = rng.normal(size=(2, 9, 5))
    kw = dict(min_constraint=-0.5, max_constraint=0.7) if bounds else {}
    j = float(jlosses.trainable_l1l2_loss(jnp.asarray(alpha),
                                          jnp.asarray(preds),
                                          jnp.asarray(targets), **kw))
    t = float(tlosses.trainable_l1l2_loss(
        torch.tensor(alpha, dtype=torch.float64), torch.from_numpy(preds),
        torch.from_numpy(targets), **kw))
    assert t == pytest.approx(j, rel=1e-12)


def test_carried_params_round_trip():
    _, params, tm = _carried("float32")
    tree = {"model": params, "alpha": np.float32(0.25)}
    state = tfd_params_from_flax(tree, device="cpu")
    back = tfd_params_to_flax(state, num_heads=SMALL["num_heads"])
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert set(state["model"]) == set(tm.state_dict())


def test_build_family_tfd_widths_match_jax():
    model, spec, fit_kwargs = tfam.build_family("tfd", 120)
    jmodel, jspec, _ = jfam.build_family("tfd", 120)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert fit_kwargs == {}
    assert model.dtype == torch.bfloat16 and jmodel.dtype == jnp.bfloat16
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "diffusion": jax.random.PRNGKey(1)},
                            jnp.zeros((2, 6, 120))))["params"]
    carried = tfd_params_to_flax(model.state_dict(), num_heads=8)
    assert (jax.tree.map(lambda a: a.shape, carried)
            == jax.tree.map(lambda a: a.shape, shapes))
    layer = model.layers[0]
    assert (len(model.layers), layer.attn.num_heads,
            layer.dense_0.out_features, model.dense_0.out_features,
            model.diffusion.dense_0.out_features, model.diffusion.T,
            model.n_cases, model.n_elem) == (2, 8, 256, 256, 256, 512, 6,
                                             100)


def test_family_table_matches_jax():
    assert list(tfam.FAMILIES) == list(jfam.FAMILIES)
    for name, spec in tfam.FAMILIES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jfam.FAMILIES[name])
    assert (tfam.BNN_KL_SCALE, tfam.PINN_PENALTY) == (jfam.BNN_KL_SCALE,
                                                      jfam.PINN_PENALTY)
    assert set(tfam.COMPUTE_DTYPES) == set(jfam.COMPUTE_DTYPES)


@pytest.mark.parametrize("name", ["fno", "gnn", "bnn", "bnn-meta"])
def test_other_families_build(name):
    """Every family builds: the JAX package's model class, and what ``fit``
    needs beyond the data as JAX's ``fit_kwargs`` says."""
    model, spec, fit_kwargs = tfam.build_family(name, 120)
    jmodel, _, jkw = jfam.build_family(name, 120)
    assert type(model).__name__ == type(jmodel).__name__
    assert fit_kwargs.get("decoupled_weight_decay", False) == jkw[
        "decoupled_weight_decay"]
    assert ("param_loss_fn" in fit_kwargs) == ("param_loss_fn" in jkw)
    assert model.dtype == (torch.float32 if name == "fno"
                           else torch.bfloat16)


def test_family_errors():
    with pytest.raises(ValueError, match="pinned float32"):
        tfam.build_family("fno", 120, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="unknown family"):
        tfam.build_family("mlp", 120)
    model, spec, _ = tfam.build_family("tfd", 120, compute_dtype="float32")
    assert model.dtype == torch.float32
    assert spec.train.compute_dtype == "float32"


def test_init_follows_flax():
    """lecun-normal kernels (normal truncated at 2 sigma, variance
    1/fan_in), zero biases, unit LayerNorm scales, cls_token normal(0.02):
    the port's draws against flax's on the full-width model."""
    model, _, _ = tfam.build_family("tfd", 120)
    model.reset_parameters(torch.Generator().manual_seed(1))
    ours = tfd_params_to_flax(model.state_dict(), num_heads=8)
    jmodel, _, _ = jfam.build_family("tfd", 120)
    theirs = jax.tree.map(np.asarray, _init(jmodel))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree.leaves(theirs)):
        keys = [p.key for p in path]
        if keys[-1] in ("bias", "scale"):
            assert np.array_equal(a, b), keys
            continue
        assert abs(a.std() / b.std() - 1) < 0.15, keys   # the same law
        if keys[-1] == "kernel":
            fan_in = a.shape[0] * (a.shape[1] if keys[-2] == "out" else 1)
            bound = 2 * np.sqrt(1 / fan_in) / 0.87962566103423978
            assert np.abs(a).max() <= bound * (1 + 1e-6), keys
