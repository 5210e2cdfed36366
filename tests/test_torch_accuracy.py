"""Port: the accuracy autopilot (``fem/accuracy.py``) against the JAX
package's, on the CPU, with the JAX Pallas solves in interpret mode.

- float64 systems (n = 41): the "float32" stage runs in float64 on both
  sides, nothing escalates, and the deflections agree to 1e-10 of scale;
- float32 fixed-span meshes (n = 201, the tests/test_accuracy.py family,
  cond ~ n^4): both sides escalate the same lanes, and both land within
  1e-4 of the float64 solve.  The escalated lanes are the port's float64
  plain route for n = 201 (the streamed solve from ``DD_STREAM_FROM_N``,
  else the analysis) against the JAX double-double kernel, both rounded to
  float32: they agree to 1e-6 of scale, and their pivots to 5e-3 relative
  (the JAX kernel's axial chain is float32);
- a float32 batch of which only some lanes escalate (n = 101): the same
  lanes on both sides, against the JAX function as it runs, jitted;
- a structurally singular system: the same warning, and on_fail="raise".
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import ScenarioConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.fem import BeamScenario as JBeamScenario
from openpystruct_tpu.fem import auto_refine as j_auto_refine
from openpystruct_tpu.fem import solve_beam as j_solve_beam
from openpystruct_tpu.fem import solve_beam_checked as j_solve_beam_checked
from openpystruct_tpu_torch.fem import accuracy as tacc
from openpystruct_tpu_torch.fem import auto_refine, solve_beam_checked
from openpystruct_tpu_torch.interop import scenario_from_numpy
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
from openpystruct_tpu_torch.ops import block_stream_dd as tsd
from openpystruct_tpu_torch.ops import block_tridiag as tbt

E, A = 200e9, 0.01
FIELDS = ("node_x", "roller_mask", "point_loads", "udl")


def _torch_case(scs, I, dtype):
    sc = scenario_from_numpy({k: np.asarray(getattr(scs, k)) for k in FIELDS},
                             device="cpu", dtype=dtype)
    return torch.from_numpy(np.array(I)).to(dtype), sc


def _fixed_span(n, B=2, key=0):
    """tests/test_accuracy.py's fixed 200 m span at n nodes, float32."""
    node_x = jnp.linspace(0.0, 200.0, n, dtype=jnp.float32)
    tags = (jnp.array([9, 29, 69, 84, 99]) * (n - 1)) // 100
    mask = jnp.zeros(n, bool).at[tags].set(True)

    def mk(k):
        loads = jnp.zeros(n, jnp.float32).at[n // 2].set(
            -3.5e5 * (0.5 + jax.random.uniform(k, dtype=jnp.float32)))
        I = 0.05 * jax.random.uniform(k, (n - 1,), minval=0.2, maxval=2.0,
                                      dtype=jnp.float32)
        return JBeamScenario(node_x=node_x, roller_mask=mask,
                             point_loads=loads,
                             udl=jnp.asarray(-1000.0, jnp.float32)), I

    return jax.vmap(mk)(jax.random.split(jax.random.PRNGKey(key), B))


def _f64_deflections(scs, I):
    scs64 = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, scs)
    return np.asarray(jax.jit(jax.vmap(
        lambda i, s: j_solve_beam(i, s, E, A).deflections
    ))(jnp.asarray(I, jnp.float64), scs64))


def _rel(a, b):
    b = np.asarray(b, np.float64)
    scale = np.abs(b).max(axis=-1, keepdims=True)
    return (np.abs(np.asarray(a, np.float64) - b) / scale).max()


def test_auto_refine_matches_jax():
    for n in (2, 21, 101, 150, 151, 201, 400, 401, 501, 2000):
        assert auto_refine(n) == j_auto_refine(n)


def test_checked_float64_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    scs = jax.vmap(lambda k: sample_scenario(k, ScenarioConfig(num_nodes=41))
                   )(keys)
    scs = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, scs)
    I = np.exp(np.random.default_rng(0).normal(size=(4, 40)) * 0.3) * 0.5
    jsol, jinfo = j_solve_beam_checked(jnp.asarray(I), scs, E, A, tol=1e-4)
    It, sc = _torch_case(scs, I, torch.float64)
    tbt.reset_counts()
    tsol, tinfo = solve_beam_checked(It, sc, E, A, tol=1e-4)
    # one solve, refine_max = 4 correction solves and the float64-residual
    # correction
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 6
    tbt.reset_counts()
    assert not tinfo["used_dd"].any() and not jinfo["used_dd"].any()
    # float64 corrections are near round-off on both sides (the JAX
    # two_prod splits with float32's constant, so its float64 residual is
    # not error-free: ~1e-12 there, ~1e-16 here)
    assert (tinfo["est"] < 1e-10).all() and (jinfo["est"] < 1e-10).all()
    assert torch.isnan(tinfo["pivot"]).all()
    for name in ("displacements", "shear_forces", "bending_moments"):
        a, b = getattr(tsol, name).numpy(), np.asarray(getattr(jsol, name))
        np.testing.assert_allclose(a, b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max(), err_msg=name)


def test_checked_escalates_like_jax_at_n201():
    scs, I = _fixed_span(201, B=2, key=201)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        jsol, jinfo = j_solve_beam_checked(I, scs, E, A, tol=1e-4)
        It, sc = _torch_case(scs, I, torch.float32)
        tkd.reset_counts()
        tsd.reset_counts()
        tsol, tinfo = solve_beam_checked(It, sc, E, A, tol=1e-4)
    # the escalation ran the float64 route the threshold names for n = 201
    # (its plain version here): the streamed solve from DD_STREAM_FROM_N,
    # the float64 analysis below it
    streamed = 201 >= tacc.DD_STREAM_FROM_N
    assert tkd.PLAIN_CALLS["beam_analysis_dd"] == int(not streamed)
    assert tsd.PLAIN_CALLS["solve_beam_dd_streamed"] == int(streamed)
    tkd.reset_counts()
    tsd.reset_counts()
    np.testing.assert_array_equal(tinfo["used_dd"].numpy(), jinfo["used_dd"])
    assert tinfo["used_dd"].all()
    d64 = _f64_deflections(scs, I)
    assert _rel(tsol.deflections.numpy(), d64) < 1e-4
    assert _rel(jsol.deflections, d64) < 1e-4
    assert _rel(tsol.deflections.numpy(), jsol.deflections) < 1e-6
    # the JAX dd kernel runs the pivot's axial chain in float32, the port
    # in float64 (tests/test_torch_beam_kernel_dd.py): ~1e-3 apart
    np.testing.assert_allclose(tinfo["pivot"].numpy(), jinfo["pivot"],
                               rtol=5e-3)
    assert (tinfo["est"] <= 1e-4).all() and (jinfo["est"] <= 1e-4).all()


def _roller_spacing(n=101, seed=0):
    """Six float32 lanes on a fixed 200 m span: lanes 0-2 carry a roller
    every 2, 4 and 8 nodes (well conditioned), lanes 3-5 have two or one
    rollers far from the pin (long overhangs, float32 keeps ~2 digits)."""
    mask = np.zeros((6, n), bool)
    for b, k in enumerate((2, 4, 8)):
        mask[b, k::k] = True
    mask[3, [40, 80]] = True
    mask[4, n // 2] = True
    mask[5, n // 3] = True
    loads = np.zeros((6, n), np.float32)
    loads[:, n // 2 + 1] = -3e5
    rng = np.random.default_rng(seed)
    I = (0.05 * rng.uniform(0.2, 2.0, (6, n - 1))).astype(np.float32)
    scs = JBeamScenario(
        node_x=jnp.asarray(np.broadcast_to(np.linspace(0.0, 200.0, n),
                                           (6, n)), jnp.float32),
        roller_mask=jnp.asarray(mask), point_loads=jnp.asarray(loads),
        udl=jnp.full((6,), -1000.0, jnp.float32))
    return scs, I


def test_checked_escalates_some_lanes_like_jax():
    """A float32 batch where only some lanes escalate, against the JAX
    solve_beam_checked as it runs (its estimate jitted).  The two estimates
    are different measurements of the same error (JAX: the float32 noise
    of the jitted residual; the port: the float64-residual correction), so
    they agree in size, not in digits: within a factor of 20 (up to 5
    observed) on the certified lanes, each at least 4x below tol.  On the
    escalated lanes both take the pivot bound eps_dd/|pivot| and agree to
    the pivots' 5e-3."""
    scs, I = _roller_spacing()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        jsol, jinfo = j_solve_beam_checked(jnp.asarray(I), scs, E, A,
                                           tol=1e-4)
        It, sc = _torch_case(scs, I, torch.float32)
        tsol, tinfo = solve_beam_checked(It, sc, E, A, tol=1e-4)
    used = tinfo["used_dd"].numpy()
    np.testing.assert_array_equal(used, jinfo["used_dd"])
    np.testing.assert_array_equal(used, [False] * 3 + [True] * 3)
    est, jest = tinfo["est"].numpy().astype(np.float64), np.asarray(jinfo["est"])
    assert (est[:3] <= 2.5e-5).all() and (jest[:3] <= 2.5e-5).all(), (
        est, jest)
    assert (np.abs(np.log(est[:3] / jest[:3])) <= np.log(20.0)).all(), (
        est, jest)
    np.testing.assert_allclose(est[3:], jest[3:], rtol=1e-2)
    assert (est[3:] <= 1e-4).all()
    piv, jpiv = tinfo["pivot"].numpy(), np.asarray(jinfo["pivot"])
    assert np.isnan(piv[:3]).all() and np.isnan(jpiv[:3]).all()
    np.testing.assert_allclose(piv[3:], jpiv[3:], rtol=5e-3)
    d64 = _f64_deflections(scs, I)
    for b in range(6):
        assert _rel(tsol.deflections[b].numpy(), d64[b]) < 1e-4
        assert _rel(jsol.deflections[b], d64[b]) < 1e-4


def test_checked_singular_warns_and_raises_like_jax():
    """No rollers: rigid rotation about the pin, singular in any
    arithmetic; both sides escalate, warn, and raise on request."""
    n = 41
    scs = JBeamScenario(
        node_x=jnp.broadcast_to(jnp.linspace(0.0, 80.0, n), (2, n)),
        roller_mask=jnp.zeros((2, n), bool).at[1, 20].set(True),
        point_loads=jnp.zeros((2, n)).at[:, 30].set(-3e5),
        udl=jnp.full((2,), -1000.0))
    I = np.full((2, n - 1), 0.5)
    with pytest.warns(RuntimeWarning, match="cannot be certified"):
        _, jinfo = j_solve_beam_checked(jnp.asarray(I), scs, E, A, tol=1e-4)
    It, sc = _torch_case(scs, I, torch.float64)
    with pytest.warns(RuntimeWarning, match="1 of 2 systems cannot be "
                      "certified"):
        _, tinfo = solve_beam_checked(It, sc, E, A, tol=1e-4)
    np.testing.assert_array_equal(tinfo["used_dd"].numpy(), jinfo["used_dd"])
    assert tinfo["used_dd"][0] and not tinfo["used_dd"][1]
    assert tinfo["pivot"][0] < tacc._SINGULAR_PIVOT
    assert jinfo["pivot"][0] < tacc._SINGULAR_PIVOT
    with pytest.raises(ValueError, match="cannot be certified"):
        j_solve_beam_checked(jnp.asarray(I), scs, E, A, tol=1e-4,
                             on_fail="raise")
    with pytest.raises(ValueError, match="cannot be certified"):
        solve_beam_checked(It, sc, E, A, tol=1e-4, on_fail="raise")


def test_nan_lane_is_never_certified():
    """A zero-I lane makes K exactly singular and the float32 pipeline
    NaN: it must escalate and be reported, the healthy lanes not."""
    scs, I = _fixed_span(41, B=3)
    I = np.array(I)
    I[1] = 0.0
    It, sc = _torch_case(scs, I, torch.float32)
    with pytest.raises(ValueError, match="cannot be certified"):
        solve_beam_checked(It, sc, E, A, tol=1e-4, on_fail="raise")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, info = solve_beam_checked(It, sc, E, A, tol=1e-4)
    assert any("cannot be certified" in str(w.message) for w in rec)
    assert info["used_dd"][1]
    assert not torch.isfinite(info["est"][1]) or info["est"][1] > 1e-4
    assert info["est"][0] <= 1e-4 and info["est"][2] <= 1e-4


def test_estimate_sees_the_float32_assembly():
    """The JAX estimate, ported as is (``_scaled_solve_with_estimate``),
    measures convergence on the float32-assembled system: on a fixed 200 m
    span at n = 101 it reports ~1e-8 while the solution is ~1e-3 off the
    float64 one.  The port floors it with the float64-residual correction,
    which tracks the true error, so no lane is certified outside tol."""
    scs, I = _fixed_span(101, B=2, key=101)
    It, sc = _torch_case(scs, I, torch.float32)
    d64 = _f64_deflections(scs, I)
    diag, upper, f = tacc.assemble_beam_system(It, sc, E, A)
    x, s, est_jax = tacc._scaled_solve_with_estimate(diag, upper, f)
    true_err = np.array([_rel((x * s)[b, :, 1].numpy(), d64[b])
                         for b in range(2)])
    assert (est_jax.numpy() < 1e-2 * true_err).all(), (est_jax, true_err)
    est64 = tacc._float64_estimate(It, sc, E, A, diag, upper, s, x).numpy()
    assert (est64 > 0.5 * true_err).all() and (est64 < 2 * true_err).all()
    sol, info = solve_beam_checked(It, sc, E, A, tol=1e-4)
    certified = (info["est"] <= 1e-4).numpy()
    assert certified.all()
    for b in range(2):
        assert _rel(sol.deflections[b].numpy(), d64[b]) < 1e-4


def test_jax_jit_drops_the_compensation():
    """Why the JAX CPU tests escalate anyway: under jit, XLA simplifies the
    error-free transforms of ``block_tridiag_residual_compensated`` away,
    so its residual is float32 noise of the assembly's size; eager, and in
    the port, it is exact to ~1e-8 of scale."""
    from openpystruct_tpu.fem.beam import assemble_beam_system as j_assemble
    from openpystruct_tpu.fem.solve import (
        block_tridiag_matvec,
        block_tridiag_residual_compensated,
        block_tridiag_solve,
    )

    scs, I = _fixed_span(201, B=2, key=201)
    d, u, f = jax.vmap(lambda i, s: j_assemble(i, s, E, A))(I, scs)
    s = jax.lax.rsqrt(jnp.diagonal(d, axis1=-2, axis2=-1))
    d = d * s[..., :, None] * s[..., None, :]
    u = u * s[..., :-1, :, None] * s[..., 1:, None, :]
    f = f * s
    x = jax.vmap(block_tridiag_solve)(d, u, f)
    exact = np.asarray(f, np.float64) - np.asarray(jax.vmap(
        block_tridiag_matvec)(*(a.astype(jnp.float64) for a in (d, u, x))))
    res = jax.vmap(block_tridiag_residual_compensated)
    scale = np.abs(exact).max()
    err = {name: np.abs(np.asarray(r, np.float64) - exact).max() / scale
           for name, r in (("eager", res(d, u, f, x)),
                           ("jit", jax.jit(res)(d, u, f, x)))}
    port = tacc.block_tridiag_residual_compensated(
        *(torch.from_numpy(np.array(a)) for a in (d, u, f, x))).numpy()
    err["port"] = np.abs(port.astype(np.float64) - exact).max() / scale
    assert err["eager"] < 1e-6 and err["port"] < 1e-6, err
    assert err["jit"] > 1e3 * err["eager"], err
