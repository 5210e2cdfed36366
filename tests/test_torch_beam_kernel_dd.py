"""Port: the float64 rescue against the JAX package's double-double kernels
and rescue, on the CPU.

The port's rescue kernels compute in native float64; on the CPU their plain
versions stand in for them.  Each check runs the JAX side on the same
numpy-made inputs: the dd Pallas kernels in interpret mode (float32 hi/lo
pairs, ~48-bit mantissa) and the float64 split path.  Both rescues reach
float64-grade accuracy, so the bars are the JAX package's own for its dd
kernels (tests/test_beam_kernel_dd.py, tests/test_datagen.py): 1e-5 of the
lane's scale for the solve, a relative 1e-3 for the pivot and the optimized
I field.  The 20-lane batch holds the four quasi-cantilever lanes float32
cannot solve and 16 random-bridge lanes.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import BeamConfig as JBeamConfig
from openpystruct_tpu.config import OptimizerConfig as JOptimizerConfig
from openpystruct_tpu.config import ScenarioConfig as JScenarioConfig
from openpystruct_tpu.datagen import generate_batch as j_generate_batch
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.datagen.generate import _rescue_local as j_rescue_local
from openpystruct_tpu.fem.beam import BeamScenario as JBeamScenario
from openpystruct_tpu.fem.beam import beam_min_pivot as j_beam_min_pivot
from openpystruct_tpu.fem.beam import constraint_mask as j_constraint_mask
from openpystruct_tpu.fem.beam import solve_beam as j_solve_beam
from openpystruct_tpu.ops.beam_kernel_dd import (
    pallas_beam_analysis_dd,
    pallas_beam_opt_step_dd,
)
from openpystruct_tpu.opt.beam_opt import (
    optimize_beam_batched as j_optimize_beam_batched,
)
from openpystruct_tpu.opt.loss import structural_loss as j_structural_loss
from openpystruct_tpu_torch.config import (
    BeamConfig,
    OptimizerConfig,
    ScenarioConfig,
)
from openpystruct_tpu_torch.datagen import DatagenBatch, generate_batch
from openpystruct_tpu_torch.datagen import generate as tgen
from openpystruct_tpu_torch.fem.beam import BeamSolution
from openpystruct_tpu_torch.interop import scenario_from_numpy
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
from openpystruct_tpu_torch.opt import beam_opt as tbo
from openpystruct_tpu_torch.opt.loss import LossComponents

E, A = 200e9, 0.01
G = E / (2.0 * 1.3)
N = 101
N_QC = 4          # quasi-cantilever lanes at the head of the batch
FIELDS = ("node_x", "roller_mask", "point_loads", "udl")


def _quasi_cantilever(rng):
    """The four lanes of tests/test_beam_kernel_dd.py: one roller 1-5 nodes
    from the pin leaves a ~195 m overhang; float64 pivots ~2.6e-11 and up,
    and a float32 solve ~90-100% wrong.  I is a mild ripple around 0.05."""
    node_x = np.tile(np.linspace(0.0, 200.0, N), (N_QC, 1))
    mask = np.zeros((N_QC, N), bool)
    loads = np.zeros((N_QC, N))
    for b, roller in enumerate([1, 2, 3, 5]):
        mask[b, roller] = True
        loads[b, 60 + 5 * b] = -3.5e5
    I = 0.05 * rng.uniform(0.8, 1.2, (N_QC, N - 1))
    return dict(node_x=node_x, roller_mask=mask, point_loads=loads,
                udl=np.full(N_QC, -1000.0)), I


def _random_bridge(rng, B=16, seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(lambda k: sample_scenario(
        k, JScenarioConfig(random_bridge=True)))(keys)
    return ({k: np.asarray(getattr(scs, k), np.float64) if k != "roller_mask"
             else np.asarray(scs.roller_mask) for k in FIELDS},
            np.exp(rng.normal(size=(B, N - 1)) * 0.3) * 0.5)


@pytest.fixture(scope="module")
def batch():
    """20 lanes as float32 numpy arrays: scenario fields, I, the kernel
    inputs Le and free, and zero Adam moments."""
    rng = np.random.default_rng(0)
    (qc, I_qc), (rb, I_rb) = _quasi_cantilever(rng), _random_bridge(rng)
    sc = {k: np.concatenate([qc[k], rb[k]]) for k in FIELDS}
    sc = {k: v.astype(np.float32) if v.dtype == np.float64 else v
          for k, v in sc.items()}
    jsc = JBeamScenario(**{k: jnp.asarray(v) for k, v in sc.items()})
    free = np.asarray(~jax.vmap(j_constraint_mask)(jsc), np.float32)
    I = np.concatenate([I_qc, I_rb]).astype(np.float32)
    return dict(sc=sc, jsc=jsc, I=I, Le=np.diff(sc["node_x"], axis=-1),
                free=free, loads=sc["point_loads"], udl=sc["udl"],
                zeros=np.zeros_like(I))


def _t64(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _to64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def analysis(batch):
    """The port's plain float64 analysis, the JAX dd kernel, JAX float64
    solve_beam and JAX float64 beam_min_pivot on the same lanes."""
    b = batch
    port = tkd.beam_analysis_dd_reference(
        *(_t64(b[k]) for k in ("I", "Le", "free", "loads", "udl")), E, A)
    dd = pallas_beam_analysis_dd(
        *(jnp.asarray(b[k]) for k in ("I", "Le", "free", "loads", "udl")),
        E, A, interpret=True)
    I64, sc64 = jnp.asarray(b["I"], jnp.float64), _to64(b["jsc"])
    sol64 = jax.vmap(lambda I, s: j_solve_beam(I, s, E, A))(I64, sc64)
    piv64 = jax.vmap(lambda I, s: j_beam_min_pivot(I, s, E, A))(I64, sc64)
    return port, dd, sol64, np.asarray(piv64)


def _lane_err(a, b):
    """Per-lane max error relative to the lane's largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return np.abs(a - b).max(1) / np.abs(b).max(1)


def test_analysis_matches_jax_f64_solve(analysis):
    (u, V, M, _), _, sol64, _ = analysis
    assert u.dtype == torch.float64
    assert (u[..., 0] == 0).all()
    for name, a, b in (("deflections", u[..., 1], sol64.deflections),
                       ("rotations", u[..., 2], sol64.rotations),
                       ("V", V, sol64.shear_forces),
                       ("M", M, sol64.bending_moments)):
        err = _lane_err(a.numpy(), b)
        assert err.max() <= 1e-5, (name, err)


def test_analysis_matches_jax_dd_kernel(analysis):
    (u, V, M, piv), (du, dV, dM, dpiv), _, _ = analysis
    for name, a, b in (("u", u, du), ("V", V, dV), ("M", M, dM)):
        err = _lane_err(a.numpy(), b)
        assert err.max() <= 1e-5, (name, err)
    np.testing.assert_allclose(piv.numpy(), np.asarray(dpiv), rtol=1e-3)


def test_pivot_tracks_jax_f64_pivot(analysis):
    (_, _, _, piv), _, _, piv64 = analysis
    ratio = piv.numpy() / piv64
    assert ((ratio > 0.3) & (ratio < 3.0)).all(), ratio
    # the quasi-cantilever lanes sit above the rescue floor, far below the
    # float32 gate
    assert (piv.numpy()[:N_QC] > tgen.RESCUE_PIVOT_TOL).all()
    assert (piv.numpy()[:N_QC] < 1e-9).all()


def test_float32_kernel_fails_where_float64_holds(batch, analysis):
    """These are the lanes the rescue exists for: the float32 fused
    analysis's plain version in float32 is orders of magnitude off."""
    (u, _, _, _), _, _, _ = analysis
    b = batch
    u32 = tk.beam_analysis_reference(
        *(torch.from_numpy(b[k]) for k in ("I", "Le", "free", "loads",
                                           "udl")), E, A, refine=1)[0]
    err32 = _lane_err(u32[:N_QC, :, 1].numpy(), u[:N_QC, :, 1].numpy())
    assert err32.max() > 1e-2, err32


def test_opt_step_matches_jax_dd_kernel(batch, analysis):
    b = batch
    lr_t, bc1, bc2 = 0.009, 1.5, 400.0
    keys = ("I", "zeros", "zeros", "Le", "free", "loads", "udl")
    ref = pallas_beam_opt_step_dd(*(jnp.asarray(b[k]) for k in keys),
                                  lr_t, bc1, bc2, E, A, G, interpret=True)
    # float32 in, float64 inside, Adam in float32: the kernel's contract
    out = tkd.beam_opt_step_dd_reference(
        *(torch.from_numpy(b[k]) for k in keys), lr_t, bc1, bc2, E, A, G)
    assert all(t.dtype == torch.float32 for t in out)
    I_new, mu, nu, stats, piv = (t.numpy() for t in out)
    np.testing.assert_allclose(I_new, np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-10)
    np.testing.assert_allclose(stats, np.asarray(ref[3]), rtol=1e-5)
    # From zero moments mu = 0.1 g and nu = 0.001 g^2.  On the ill-conditioned
    # lanes the dd kernel's own gradient error is ~1e-6 of the lane's
    # largest |g|, up to 2e-4 relative on elements with a small gradient, so
    # against it the bar is 1e-4 relative or 1e-5 of the lane's scale; the
    # float64 semi-gradient (JAX split path in float64) holds the port to
    # 1e-4 relative on every element.
    for got, want in ((mu, ref[1]), (nu, ref[2])):
        want = np.asarray(want, np.float64)
        scale = np.abs(want).max(1, keepdims=True)
        assert (np.abs(got - want) <= 1e-4 * np.abs(want)
                + 1e-5 * scale).all()
    I64, sc64 = jnp.asarray(b["I"], jnp.float64), _to64(b["jsc"])

    def loss64(I, sc):
        sol = j_solve_beam(I, sc, E, A)
        return j_structural_loss(I, sol.bending_moments, sol.shear_forces, E,
                                 G, 1e-2, 1e-2, grad_mode="semi").total

    g64 = np.asarray(jax.vmap(jax.grad(loss64))(I64, sc64))
    np.testing.assert_allclose(mu, 0.1 * g64, rtol=1e-4)
    np.testing.assert_allclose(nu, 1e-3 * g64 * g64, rtol=1e-4)
    # the opt step's pivot is the analysis's, at the same I
    np.testing.assert_allclose(piv, analysis[0][3].numpy(), rtol=1e-6)


def test_wrappers_route_cpu_tensors_to_plain_versions(batch):
    b = batch
    args = [torch.from_numpy(b[k]) for k in ("I", "Le", "free", "loads",
                                            "udl")]
    tkd.reset_counts()
    out = tkd.beam_analysis_dd(*args, E, A)
    ref = tkd.beam_analysis_dd_reference(*args, E, A)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    zeros = torch.zeros_like(args[0])
    tkd.beam_opt_step_dd(args[0], zeros, zeros, *args[1:], 0.01, 10.0,
                         1000.0, E, A, G)
    assert tkd.LAUNCHES == {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}
    assert tkd.PLAIN_CALLS == {"beam_analysis_dd": 1, "beam_opt_step_dd": 1}
    tkd.reset_counts()


def test_optimizer_dd_matches_jax():
    """30 epochs of the rescue optimizer on the quasi-cantilever lanes: the
    JAX dd kernels (interpret mode) and the port's float64 plain versions
    stop at the same epochs and reach the same I."""
    sc, _ = _quasi_cantilever(np.random.default_rng(0))
    sc = {k: v.astype(np.float32) if v.dtype == np.float64 else v
          for k, v in sc.items()}
    jopt = JOptimizerConfig(max_epochs=30, tolerance=5e-3, patience=5)
    jres = j_optimize_beam_batched(
        JBeamScenario(**{k: jnp.asarray(v) for k, v in sc.items()}),
        JBeamConfig(udl=-1000.0), jopt, use_pallas=False, interpret=True,
        dd=True)
    tres = tbo.optimize_beam_batched(
        scenario_from_numpy(sc, device="cpu"), BeamConfig(udl=-1000.0),
        OptimizerConfig(max_epochs=30, tolerance=5e-3, patience=5), dd=True)
    np.testing.assert_array_equal(tres.n_epochs.numpy(),
                                  np.asarray(jres.n_epochs))
    I_j = np.asarray(jres.I, np.float64)
    rel = np.abs(tres.I.numpy() - I_j) / np.maximum(np.abs(I_j), 1e-6)
    assert rel.max() < 1e-3, rel.max()
    np.testing.assert_allclose(tres.pivot.numpy(), np.asarray(jres.pivot),
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# The rescue as a whole, on one first-pass batch of the JAX package
# ---------------------------------------------------------------------------

FAST = dict(max_epochs=60, tolerance=5e-3, patience=5)


def _port_batch(jb) -> DatagenBatch:
    """A JAX DatagenBatch as the port's, through numpy (float32 on the
    CPU)."""
    def t(x):
        return torch.from_numpy(np.array(x))

    scen = scenario_from_numpy(
        {k: np.asarray(getattr(jb.scenario, k)) for k in
         FIELDS + ("roller_order", "force_order")}, device="cpu")
    r, s = jb.result, jb.result.solution
    sol = BeamSolution(
        displacements=t(s.displacements), deflections=t(s.deflections),
        rotations=t(s.rotations), shear_forces=t(s.shear_forces),
        bending_moments=t(s.bending_moments))
    loss = LossComponents(total=t(r.loss.total), primary=t(r.loss.primary),
                          bending_energy=t(r.loss.bending_energy),
                          shear_energy=t(r.loss.shear_energy))
    res = tbo.BeamOptResult(
        I=t(r.I), I_solved=t(r.I_solved), solution=sol, loss=loss,
        n_epochs=t(r.n_epochs), converged=t(r.converged),
        pivot=None if r.pivot is None else t(r.pivot))
    return DatagenBatch(scenario=scen, result=res, valid=t(jb.valid),
                        residual=t(jb.residual))


def _first_pass(grad_mode):
    """64 random-bridge lanes of the JAX batch program, rescue off."""
    return j_generate_batch(
        jax.random.PRNGKey(11), 64,
        scen_cfg=JScenarioConfig(random_bridge=True),
        opt_cfg=JOptimizerConfig(**FAST, grad_mode=grad_mode), refine=0,
        use_pallas=False, rescue=False)


def _hold_rescue(tb, jb, v0, rtol, atol, d_tol):
    """The bar of tests/test_datagen.py::test_random_bridge_dd_rescue:
    the same valid lanes, the same epochs on the rescued lanes, I and the
    deflections close, rollers pinned exactly."""
    vt, vj = tb.valid.numpy(), np.asarray(jb.valid)
    np.testing.assert_array_equal(vt, vj)
    assert vt.mean() > 0.99
    resc = vt & ~v0
    assert resc.any()
    np.testing.assert_array_equal(tb.result.n_epochs.numpy()[resc],
                                  np.asarray(jb.result.n_epochs)[resc])
    np.testing.assert_allclose(tb.result.I.numpy()[resc],
                               np.asarray(jb.result.I)[resc], rtol=rtol,
                               atol=atol)
    d_t = tb.result.solution.deflections.numpy()[resc]
    d_j = np.asarray(jb.result.solution.deflections)[resc]
    scale = np.abs(d_j).max(axis=1, keepdims=True)
    assert (np.abs(d_t - d_j) / scale).max() < d_tol
    rollers = tb.scenario.roller_mask.numpy()[resc]
    assert np.abs(np.where(rollers, d_t, 0.0)).max() == 0.0
    assert (tb.residual.numpy()[resc] > tgen.RESCUE_PIVOT_TOL).all()


def test_rescue_dd_matches_jax_rescue():
    j0 = _first_pass("semi")
    v0 = np.asarray(j0.valid)
    assert v0.sum() < 64, "seed produced no float32 drops; test is vacuous"
    jb = j_rescue_local(j0, JBeamConfig(udl=-1000.0),
                        JOptimizerConfig(**FAST), "dd")
    t0 = _port_batch(j0)
    tkd.reset_counts()
    tb = tgen._rescue_local(t0, BeamConfig(udl=-1000.0),
                            OptimizerConfig(**FAST), "dd")
    assert tkd.PLAIN_CALLS["beam_analysis_dd"] == 1
    assert tkd.PLAIN_CALLS["beam_opt_step_dd"] > 0
    tkd.reset_counts()
    _hold_rescue(tb, jb, v0, rtol=1e-3, atol=1e-7, d_tol=1e-3)
    # lanes the float32 pass kept are merged through untouched
    kept = torch.from_numpy(v0.copy())
    for name in ("I", "n_epochs"):
        a, c = getattr(t0.result, name), getattr(tb.result, name)
        assert torch.equal(a[kept], c[kept])
    assert torch.equal(t0.result.solution.deflections[kept],
                       tb.result.solution.deflections[kept])


def test_rescue_adjoint_f64_matches_jax_rescue():
    """Adjoint mode rescues on the host in float64 in both packages: the
    same computation, so the bars are far tighter than the dd ones."""
    j0 = _first_pass("adjoint")
    v0 = np.asarray(j0.valid)
    assert v0.sum() < 64, "seed produced no float32 drops; test is vacuous"
    jopt = JOptimizerConfig(**FAST, grad_mode="adjoint")
    jb = j_rescue_local(j0, JBeamConfig(udl=-1000.0), jopt, "f64")
    tb = tgen._rescue_local(_port_batch(j0), BeamConfig(udl=-1000.0),
                            OptimizerConfig(**FAST, grad_mode="adjoint"),
                            "f64")
    _hold_rescue(tb, jb, v0, rtol=1e-5, atol=1e-9, d_tol=1e-5)


def test_adjoint_routes_the_rescue_to_f64(caplog):
    """On a CPU batch, generate_batch(rescue="dd") in adjoint mode warns and
    rescues on the host in float64 (the float64 kernels are semi-gradient
    only), keeping ~100% of the lanes, as the JAX package does.  A CUDA
    batch raises instead (tests/test_torch_slice.py)."""
    opt = OptimizerConfig(**FAST, grad_mode="adjoint")
    kw = dict(scen_cfg=ScenarioConfig(random_bridge=True), opt_cfg=opt,
              refine=0, device="cpu")
    b0 = generate_batch(torch.Generator().manual_seed(2), 16, rescue=False,
                        **kw)
    assert not b0.valid.all(), "seed produced no float32 drops"
    tkd.reset_counts()
    with caplog.at_level(logging.WARNING, logger=tgen.__name__):
        b1 = generate_batch(torch.Generator().manual_seed(2), 16,
                            rescue="dd", **kw)
    assert "semi-gradient only" in caplog.text
    assert tkd.PLAIN_CALLS == {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}
    assert b1.valid.all()
    resc = (b1.valid & ~b0.valid).numpy()
    I = b1.result.I.numpy()[resc]
    assert np.isfinite(I).all() and (I >= 1e-8).all()
    defl = b1.result.solution.deflections.numpy()[resc]
    rollers = b1.scenario.roller_mask.numpy()[resc]
    assert np.abs(np.where(rollers, defl, 0.0)).max() == 0.0
    # the optimizer itself refuses dd in adjoint mode
    with pytest.raises(NotImplementedError):
        tbo.optimize_beam_batched(b0.scenario, opt=opt, dd=True)
