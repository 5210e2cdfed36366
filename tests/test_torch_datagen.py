"""Port: sampler laws, the sampler bitwise its two-argsort form, the batch
program on JAX-drawn scenarios, and the 13-key JSON read back by the JAX
package's reader."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import BeamConfig as JBeamConfig
from openpystruct_tpu.config import OptimizerConfig as JOptimizerConfig
from openpystruct_tpu.config import ScenarioConfig as JScenarioConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.datagen.io import (
    columnar_from_fields as j_columnar_from_fields,
)
from openpystruct_tpu.datagen.io import read_json_dataset as j_read_json
from openpystruct_tpu.fem import beam_min_pivot
from openpystruct_tpu.opt.beam_opt import optimize_beam_batched
from openpystruct_tpu_torch.config import (
    BeamConfig,
    OptimizerConfig,
    ScenarioConfig,
)
from openpystruct_tpu_torch.datagen import (
    SCHEMA_KEYS,
    batch_to_columnar,
    columnar_from_fields,
    read_json_dataset,
    run_batch,
    sample_scenarios,
    write_json_dataset,
    write_npz_shard,
)
from openpystruct_tpu_torch.datagen.sampler import _smallest
from openpystruct_tpu_torch.fem.beam import BeamScenario
from openpystruct_tpu_torch.interop import scenario_from_numpy, scenario_to_numpy

FAST = dict(max_epochs=30, tolerance=5e-3, patience=5)


def _torch_draws(B, cfg, seed):
    return scenario_to_numpy(sample_scenarios(
        torch.Generator().manual_seed(seed), B, cfg, device="cpu"))


def _jax_draws(B, cfg, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(lambda k: sample_scenario(k, cfg))(keys)
    return {k: np.asarray(getattr(scs, k)) for k in
            ("node_x", "roller_mask", "point_loads", "udl", "roller_order",
             "force_order")}


def test_sampler_fixed_bridge():
    d = _torch_draws(256, ScenarioConfig(), 0)
    expect = np.zeros(101, bool)
    expect[[9, 29, 69, 84, 99]] = True
    assert (d["roller_mask"] == expect[None, :]).all()
    loads = d["point_loads"]
    n_forces = (loads != 0).sum(axis=1)
    assert set(collections.Counter(n_forces).keys()) == {1, 2, 3, 4}
    vals = loads[loads != 0]
    assert vals.min() >= -355857.0 and vals.max() <= -35585.7
    assert (loads[:, 0] == 0).all() and (loads[:, -1] == 0).all()
    assert (loads[d["roller_mask"]] == 0).all()
    np.testing.assert_allclose(d["node_x"][:, -1], 200.0)
    # fixed rollers are stored in ascending-tag order
    ro = d["roller_order"]
    assert (ro[d["roller_mask"]].reshape(256, 5) == np.arange(5)).all()


def test_sampler_random_bridge():
    d = _torch_draws(256, ScenarioConfig(random_bridge=True), 1)
    L = d["node_x"][:, -1]
    assert L.min() >= 15.0 and L.max() <= 215.0
    assert len(np.unique(np.round(L, 6))) > 200
    n_rollers = d["roller_mask"].sum(axis=1)
    assert set(n_rollers.tolist()) == {1, 2, 3, 4}
    assert not d["roller_mask"][:, 0].any() and not d["roller_mask"][:, -1].any()
    assert (d["point_loads"][d["roller_mask"]] == 0).all()


def _rank(scores):
    """rank[..., i] = position of scores[..., i] in ascending order."""
    return torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1)


def _sample_by_rank(generator, batch_size, cfg, dtype):
    """The sampler as it was before the top-k selection, kept as the oracle:
    two stable argsorts rank every node, and the six (B, n) fields are
    built on the host (CPU only)."""
    n, B = cfg.num_nodes, batch_size
    idx = torch.arange(n)
    candidates = ((idx >= 1) & (idx <= n - 2)).expand(B, n)
    inf = torch.tensor(float("inf"), dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    if cfg.random_bridge:
        L = cfg.L_min + uniform(B) * cfg.L_max
        num_rollers = torch.randint(1, cfg.n_rollers_max + 1, (B, 1),
                                    generator=generator)
        r_rank = _rank(torch.where(candidates, uniform(B, n), inf))
        roller_mask = r_rank < num_rollers
        roller_order = torch.where(roller_mask, r_rank, n)
    else:
        L = torch.full((B,), float(cfg.L_max), dtype=torch.float64)
        roller_mask = torch.zeros((B, n), dtype=torch.bool)
        roller_mask[:, [t - 1 for t in cfg.fixed_roller_tags]] = True
        roller_order = torch.where(roller_mask, roller_mask.cumsum(-1) - 1,
                                   n)

    node_x = torch.linspace(0.0, 1.0, n, dtype=torch.float64) * L[:, None]
    available = candidates & ~roller_mask
    num_forces = torch.randint(1, cfg.m_forces_max + 1, (B, 1),
                               generator=generator)
    f_rank = _rank(torch.where(available, uniform(B, n), inf))
    force_sel = f_rank < num_forces
    force_order = torch.where(force_sel, f_rank, n)
    lo = min(cfg.max_force, cfg.min_force)
    hi = max(cfg.max_force, cfg.min_force)
    point_loads = torch.where(force_sel, lo + (hi - lo) * uniform(B, n), 0.0)
    return BeamScenario(
        node_x=node_x.to(dtype), roller_mask=roller_mask,
        point_loads=point_loads.to(dtype),
        udl=torch.full((B,), float(cfg.udl), dtype=torch.float64).to(dtype),
        roller_order=(roller_order.to(torch.int32)
                      if cfg.store_draw_order else None),
        force_order=(force_order.to(torch.int32)
                     if cfg.store_draw_order else None))


def _assert_bitwise(got, want):
    for name in ("node_x", "roller_mask", "point_loads", "udl",
                 "roller_order", "force_order"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert (a.dtype, a.shape, a.is_contiguous()) == (b.dtype, b.shape,
                                                          True), name
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)), \
            name


@pytest.mark.parametrize("B", [1, 7, 4096])
@pytest.mark.parametrize("store_draw_order", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("random_bridge", [False, True])
def test_sampler_bitwise_its_two_argsort_form(random_bridge, dtype,
                                              store_draw_order, B):
    """Three batches from one generator: every field bit for bit the
    two-argsort sampler's, and the generator left in the same state."""
    cfg = ScenarioConfig(random_bridge=random_bridge,
                         store_draw_order=store_draw_order)
    g_new = torch.Generator().manual_seed(2026)
    g_old = torch.Generator().manual_seed(2026)
    for _ in range(3):
        _assert_bitwise(
            sample_scenarios(g_new, B, cfg, device="cpu", dtype=dtype),
            _sample_by_rank(g_old, B, cfg, dtype))
    assert torch.equal(g_new.get_state(), g_old.get_state())


@pytest.mark.parametrize("k", [1, 4, 29])
def test_smallest_is_the_stable_sort_head(k):
    """``_smallest`` on scores with forced ties (eight levels, so most rows
    tie), unavailable entries (inf, tied with each other) and rows without
    a tie: the first k columns of the stable ascending argsort, at k = 1,
    4 and n - 2."""
    n = 31
    g = torch.Generator().manual_seed(k)
    tied = torch.randint(0, 8, (300, n), generator=g).double() / 8
    distinct = torch.rand((300, n), generator=g, dtype=torch.float64)
    scores = torch.cat([tied, distinct])
    masked = torch.rand(scores.shape, generator=g) < 0.3
    masked[:50] = True               # rows with every entry unavailable
    masked[50:100, :n - k] = True    # rows reaching into the unavailable
    for s in (scores, torch.where(masked, float("inf"), scores)):
        want = torch.argsort(s, dim=-1, stable=True)[:, :k]
        assert torch.equal(_smallest(s, k), want)
    assert torch.equal(_smallest(scores, n + 3),
                       torch.argsort(scores, dim=-1, stable=True))


@pytest.mark.parametrize("random_bridge", [False, True])
def test_sampler_follows_jax_laws(random_bridge):
    """The two samplers draw different numbers from the same laws: counts,
    values, positions and draw order agree in distribution (4096 draws;
    the bounds are ~5 standard errors)."""
    cfg_t = ScenarioConfig(random_bridge=random_bridge)
    cfg_j = JScenarioConfig(random_bridge=random_bridge)
    t, j = _torch_draws(4096, cfg_t, 7), _jax_draws(4096, cfg_j, 7)

    def stats(d):
        sel = d["point_loads"] != 0
        vals = d["point_loads"][sel]

        def first_is_min(mask, order):
            out = []
            for m, o in zip(mask, order):
                idx = np.nonzero(m)[0]
                if idx.size >= 2:
                    out.append(idx[np.argmin(o[idx])] == idx.min())
            return np.mean(out)

        return dict(
            n_forces=sel.sum(1).mean(),
            n_rollers=d["roller_mask"].sum(1).mean(),
            force_mean=vals.mean() / 1e5,
            force_node=np.nonzero(sel)[1].mean() / 100,
            L=d["node_x"][:, -1].mean() / 100,
            force_first_is_min=first_is_min(sel, d["force_order"]),
        )

    st, sj = stats(t), stats(j)
    for k in st:
        assert abs(st[k] - sj[k]) < 0.06, (k, st[k], sj[k])


def test_batch_program_on_jax_scenarios_matches_jax():
    """The port's batch program (fused plain path, float64) on scenarios
    drawn by the JAX sampler gives the JAX batch program's valid mask, I
    and fields (JAX: split path, float64)."""
    B = 6
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    scs = jax.vmap(sample_scenario)(keys)
    scs = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, scs)
    jbeam = JBeamConfig(udl=-1000.0)
    jres = jax.jit(lambda s: optimize_beam_batched(
        s, jbeam, JOptimizerConfig(**FAST), refine=1, use_pallas=False,
        I0=jnp.full((B, 100), 0.5)))(scs)
    jpiv = jax.vmap(lambda I, s: beam_min_pivot(I, s, jbeam.E, jbeam.A))(
        jres.I_solved, scs)
    jvalid = np.asarray(jpiv > 1e-9) & np.isfinite(np.asarray(jres.I)).all(1)

    arrays = {k: np.asarray(getattr(scs, k)) for k in
              ("node_x", "roller_mask", "point_loads", "udl", "roller_order",
               "force_order")}
    sc = scenario_from_numpy(arrays, device="cpu", dtype=torch.float64)
    batch = run_batch(sc, BeamConfig(udl=-1000.0), OptimizerConfig(**FAST),
                      refine=1, compact=False)
    np.testing.assert_array_equal(batch.valid.numpy(), jvalid)
    np.testing.assert_array_equal(batch.result.n_epochs.numpy(),
                                  np.asarray(jres.n_epochs))
    np.testing.assert_allclose(batch.result.I.numpy(), np.asarray(jres.I),
                               rtol=1e-6)
    # fused 3-DOF-equivalent pivot vs the split path's det3 diagnostic
    np.testing.assert_allclose(batch.residual.numpy(), np.asarray(jpiv),
                               rtol=1e-6)
    for t_name, j in (("deflections", jres.solution.deflections),
                      ("rotations", jres.solution.rotations),
                      ("shear_forces", jres.solution.shear_forces),
                      ("bending_moments", jres.solution.bending_moments)):
        j = np.asarray(j)
        np.testing.assert_allclose(
            getattr(batch.result.solution, t_name).numpy(), j, rtol=1e-6,
            atol=1e-6 * np.abs(j).max(), err_msg=t_name)


def test_json_schema_read_by_jax_reader(tmp_path):
    gen = torch.Generator().manual_seed(3)
    sc = sample_scenarios(gen, 5, device="cpu", dtype=torch.float64)
    batch = run_batch(sc, BeamConfig(udl=-1000.0),
                      OptimizerConfig(max_epochs=8), refine=1)
    cols = batch_to_columnar(batch)
    path = str(tmp_path / "d.json")
    write_json_dataset(cols, path)
    back = j_read_json(path, native=False)
    assert tuple(back) == SCHEMA_KEYS
    assert len(back["I_values"]) == int(batch.valid.sum()) > 0
    np.testing.assert_allclose(back["I_values"], batch.result.I.numpy())
    # draw order: force lists follow the stored draw positions
    f_idx = np.nonzero(sc.point_loads[0].numpy())[0]
    order = sc.force_order[0].numpy()[f_idx]
    assert back["force_nodes"][0] == (f_idx[np.argsort(order)] + 1).tolist()
    assert back["roller_nodes"][0] == [10, 30, 70, 85, 100]
    assert read_json_dataset(path, native=False) == back

    write_npz_shard(batch, str(tmp_path / "s.npz"))
    with np.load(tmp_path / "s.npz") as z:
        np.testing.assert_array_equal(z["valid"], batch.valid.numpy())
        assert z["I"].shape == (5, 100)


@pytest.mark.parametrize("draw_order", [True, False])
def test_columnar_from_fields_matches_jax(draw_order):
    """The port builds the ragged lists with one batched sort; the JAX
    package loops over rows.  Same lists, same Python values."""
    B, n = 64, 101
    d = _jax_draws(B, JScenarioConfig(random_bridge=True), 5)
    rng = np.random.default_rng(0)
    fields = dict(
        node_x=d["node_x"], roller=d["roller_mask"], loads=d["point_loads"],
        I=rng.random((B, n - 1), np.float32),
        shear=rng.random((B, n - 1), np.float32),
        moment=rng.random((B, n - 1), np.float32),
        defl=rng.random((B, n), np.float32),
        rot=rng.random((B, n), np.float32),
        valid=rng.random(B) > 0.3,
    )
    if draw_order:
        fields.update(roller_order=d["roller_order"],
                      force_order=d["force_order"])
    assert columnar_from_fields(fields) == j_columnar_from_fields(fields)
