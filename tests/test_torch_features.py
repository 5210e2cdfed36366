"""Port: feature extraction and preprocessing against the JAX package.

- ``batch_feature_arrays`` on scenarios drawn with the JAX sampler and
  carried by ``interop.scenario_from_numpy``: equal to JAX's, exactly.
- The port's numpy ``prepare_dataset``: bitwise the JAX package's.
- The device pipeline's transform, given the host pipeline's permutation:
  within 1e-12 of the host pipeline's steps run in float64, and within
  float32 rounding (atol 2e-5 on standardized values) of JAX
  ``prepare_dataset`` itself on the same columnar dict.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import ScenarioConfig as JScenarioConfig
from openpystruct_tpu.data import pipeline as jpipe
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.datagen.features import (
    batch_feature_arrays as j_batch_feature_arrays,
)
from openpystruct_tpu_torch.data import pipeline as tpipe
from openpystruct_tpu_torch.data import prepare_dataset_device
from openpystruct_tpu_torch.data.device_pipeline import _prepare
from openpystruct_tpu_torch.datagen import batch_feature_arrays
from openpystruct_tpu_torch.interop import scenario_from_numpy

FEATS = ("roller_x", "force_x", "force_values", "node_positions")
KEYS = ("roller_x_locations", "force_x_locations", "force_values",
        "node_positions")


def _jax_scenarios(B, random_bridge, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    cfg = JScenarioConfig(random_bridge=random_bridge)
    return jax.vmap(lambda k: sample_scenario(k, cfg))(keys)


def _batch(scenario, I, valid, solution):
    return types.SimpleNamespace(
        scenario=scenario, valid=valid,
        result=types.SimpleNamespace(I=I, solution=solution))


@pytest.mark.parametrize("random_bridge", [False, True])
@pytest.mark.parametrize("draw_order", [True, False])
def test_batch_feature_arrays_match_jax(random_bridge, draw_order):
    B = 64
    jsc = _jax_scenarios(B, random_bridge, seed=3)
    if not draw_order:
        jsc = jsc.replace(roller_order=None, force_order=None)
    rng = np.random.default_rng(0)
    I = rng.uniform(1e-3, 1.0, (B, 100)).astype(np.float32)
    valid = rng.uniform(size=B) < 0.8
    sol = rng.normal(size=(2, B, 101)).astype(np.float32)
    jout = j_batch_feature_arrays(
        _batch(jsc, jnp.asarray(I), jnp.asarray(valid),
               types.SimpleNamespace(deflections=jnp.asarray(sol[0]),
                                     rotations=jnp.asarray(sol[1]))),
        include_solution=True)

    arrays = {k: np.asarray(v) for k, v in vars(jsc).items()
              if v is not None}
    # the JAX tests run in float64 (tests/conftest.py), so do the scenarios
    tsc = scenario_from_numpy(arrays, device="cpu", dtype=torch.float64)
    tout = batch_feature_arrays(
        _batch(tsc, torch.from_numpy(I), torch.from_numpy(valid),
               types.SimpleNamespace(deflections=torch.from_numpy(sol[0]),
                                     rotations=torch.from_numpy(sol[1]))),
        include_solution=True)
    assert set(tout) == set(jout)
    for k in jout:
        assert tout[k].numpy().dtype == np.asarray(jout[k]).dtype, k
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    # the draw order reaches the features: forces are not ascending
    fx = tout["force_x"].numpy()
    ascending = all((np.diff(r[r > 0]) >= 0).all() for r in fx)
    assert ascending != draw_order


def _synthetic(B, seed, n=11, nelem=10, invalid=0.25):
    """Padded feature arrays with ragged counts, and the valid mask."""
    rng = np.random.default_rng(seed)

    def ragged(width, lo, hi, scale):
        k = rng.integers(lo, width + 1, size=B)
        k[0] = width    # one full row: the padded width is the max length
        v = rng.uniform(0.5, 1.5, (B, width)) * scale
        return np.where(np.arange(width) < k[:, None], v, 0.0), k

    roller_x, _ = ragged(5, 1, 5, 100.0)
    force_x, nf = ragged(4, 1, 4, 100.0)
    force_values = np.where(force_x > 0, rng.uniform(-3.5e5, -3.5e4,
                                                     (B, 4)), 0.0)
    L = rng.uniform(15.0, 215.0, B)
    arrays = dict(
        roller_x=roller_x, force_x=force_x, force_values=force_values,
        node_positions=np.linspace(0.0, 1.0, n)[None, :] * L[:, None],
        I=rng.uniform(1e-3, 1.0, (B, nelem)),
        deflections=rng.normal(size=(B, n)),
        valid=rng.uniform(size=B) >= invalid,
    )
    arrays["valid"][:2] = True
    return arrays


def _tensors(arrays, dtype):
    return {k: torch.from_numpy(a).to(dtype) if a.dtype == np.float64
            else torch.from_numpy(a) for k, a in arrays.items()}


def _columnar(arrays, extra=()):
    """The valid rows as the ragged columnar dict the host pipeline reads
    (trailing zero padding stripped)."""
    v = arrays["valid"]

    def rows(a, strip):
        out = []
        for r in a[v]:
            if strip:
                nz = np.nonzero(r)[0]
                r = r[: nz[-1] + 1] if nz.size else r[:0]
            out.append(list(r))
        return out

    cols = {key: rows(arrays[f], f != "node_positions")
            for f, key in zip(FEATS, KEYS)}
    cols["I_values"] = rows(arrays["I"], False)
    for k in extra:
        cols[k] = rows(arrays[k], False)
    return cols


@pytest.mark.parametrize("agg,extra,nheads", [
    ("mean_std", (), 8), ("median_mad", ("deflections",), None),
    ("mode_mad", (), 3)])
def test_prepare_dataset_bitwise_jax(agg, extra, nheads):
    cols = _columnar(_synthetic(90, seed=1), extra)
    kw = dict(n_cases=6, train_split=0.7, c=0.5, agg=agg, seed=4,
              nheads_pad=nheads, extra_label_keys=extra)
    j = jpipe.prepare_dataset(cols, **kw)
    t = tpipe.prepare_dataset(cols, **kw)
    for f in ("X_train", "X_val", "Y_train", "Y_val", "Y_train_raw",
              "Y_val_raw"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (t.max_lengths, t.n_cases, t.feat_dim, t.label_dim) == (
        j.max_lengths, j.n_cases, j.feat_dim, j.label_dim)
    for name in FEATS:
        assert np.array_equal(t.scalers[name].mean, j.scalers[name].mean)
        assert np.array_equal(t.scalers[name].scale, j.scalers[name].scale)
    user = [[list(r) for r in cols[k][:6]] for k in KEYS]
    np.testing.assert_array_equal(
        tpipe.build_user_input(*user, t.scalers, 6, t.max_lengths),
        jpipe.build_user_input(*user, j.scalers, 6, j.max_lengths))


def _host_float64(arrays, perm, n_cases, tr_sz, c, nheads, label_keys):
    """The host pipeline's steps (prepare_dataset, pipeline.py:219-243) on
    float64 arrays, with the JAX package's own functions."""
    v = arrays["valid"]
    total = perm.size

    def group(x):
        return x[v][: total * n_cases].reshape(total, n_cases, -1)

    tr, va = perm[:tr_sz], perm[tr_sz:]
    parts_tr, parts_va, scalers = [], [], {}
    for name in FEATS:
        g = group(arrays[name])
        x_tr, sc = jpipe.fit_transform_3d(g[tr])
        parts_tr.append(x_tr)
        parts_va.append(jpipe.transform_3d(g[va], sc))
        scalers[name] = sc
    X_tr = jpipe.merge_sub_features(*parts_tr)
    X_va = jpipe.merge_sub_features(*parts_va)
    if nheads:
        X_tr, _ = jpipe.pad_feat_dim_to_multiple_of_nheads(X_tr, nheads)
        X_va, _ = jpipe.pad_feat_dim_to_multiple_of_nheads(X_va, nheads)
    Y_tr = np.concatenate([jpipe.unify_label(group(arrays[k])[tr], c=c)
                           for k in label_keys], axis=1)
    Y_va = np.concatenate([jpipe.unify_label(group(arrays[k])[va], c=c)
                           for k in label_keys], axis=1)
    sY = jpipe.Scaler.fit(Y_tr)
    return dict(X_tr=X_tr, X_va=X_va, Y_tr=sY.transform(Y_tr),
                Y_va=sY.transform(Y_va), Y_tr_raw=Y_tr, Y_va_raw=Y_va,
                scalers=scalers, scaler_Y=sY)


@pytest.mark.parametrize("B,label_keys,nheads", [
    (96, ("I",), 8), (24, ("I", "deflections"), None)])
def test_device_transform_matches_host_float64(B, label_keys, nheads):
    """Given the host pipeline's permutation, the device transform in
    float64 equals the host steps in float64 to 1e-12; invalid rows are
    dropped before grouping (B = 24 with a quarter invalid: 3 groups)."""
    arrays = _synthetic(B, seed=2)
    n_valid = int(arrays["valid"].sum())
    total = n_valid // 6
    perm = np.random.default_rng(5).permutation(total)
    tr_sz = int(0.75 * total)
    ref = _host_float64(arrays, perm, 6, tr_sz, 0.5, nheads, label_keys)
    out = _prepare(_tensors(arrays, torch.float64),
                   torch.from_numpy(perm), n_cases=6, tr_sz=tr_sz, c=0.5,
                   nheads_pad=nheads, label_keys=label_keys)
    for k in ("X_tr", "X_va", "Y_tr", "Y_va", "Y_tr_raw", "Y_va_raw"):
        assert out[k].dtype == torch.float64
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    for name in FEATS:
        np.testing.assert_allclose(out["scalers"][name].scale.numpy(),
                                   ref["scalers"][name].scale, rtol=1e-12)
    np.testing.assert_allclose(out["scaler_Y"].mean.numpy(),
                               ref["scaler_Y"].mean, rtol=1e-12)
    if B == 24:
        assert out["X_tr"].shape[0] + out["X_va"].shape[0] == 3


def test_device_transform_matches_jax_prepare_dataset_float32():
    """The whole host pipeline (JAX ``prepare_dataset`` on the columnar
    dict) against the device transform in float32 on the same
    permutation."""
    arrays = _synthetic(120, seed=6)
    cols = _columnar(arrays)
    j = jpipe.prepare_dataset(cols, n_cases=6, train_split=0.8, c=0.5,
                              seed=7, nheads_pad=8)
    total = int(arrays["valid"].sum()) // 6
    perm = np.random.default_rng(7).permutation(total)
    out = _prepare(_tensors(arrays, torch.float32),
                   torch.from_numpy(perm), n_cases=6,
                   tr_sz=int(0.8 * total), c=0.5, nheads_pad=8)
    pairs = dict(X_tr=j.X_train, X_va=j.X_val, Y_tr=j.Y_train,
                 Y_va=j.Y_val)
    for k, ref in pairs.items():
        np.testing.assert_allclose(out[k].numpy(), ref, rtol=0, atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(out["Y_tr_raw"].numpy(), j.Y_train_raw,
                               rtol=1e-6)


def test_prepare_dataset_device_on_cpu():
    arrays = _tensors(_synthetic(200, seed=8), torch.float32)
    ds = prepare_dataset_device(arrays, n_cases=6, train_split=0.75, c=0.5,
                                seed=0, nheads_pad=8)
    total = int(arrays["valid"].sum()) // 6
    assert ds.feat_dim == 5 + 4 + 4 + 11    # already a multiple of 8
    assert ds.X_train.shape == (int(0.75 * total), 6, ds.feat_dim)
    assert ds.X_train.shape[0] + ds.X_val.shape[0] == total
    assert ds.max_lengths == {"roller_x": 5, "force_x": 4, "force_values": 4,
                              "node_positions": 11, "I_values": 10}
    # population statistics: standardized train labels have std 1, mean 0
    assert ds.Y_train.mean().abs().max() < 1e-5
    torch.testing.assert_close(ds.Y_train.std(0, correction=0),
                               torch.ones(10), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        ds.scaler_Y.inverse_transform(ds.Y_train), ds.Y_train_raw,
        rtol=1e-5, atol=1e-6)
    # the split is a function of the seed
    again = prepare_dataset_device(arrays, n_cases=6, train_split=0.75,
                                   c=0.5, seed=0, nheads_pad=8)
    assert torch.equal(again.X_train, ds.X_train)
