"""Port: the streamed float64 beam solve (kernel #9 of PERF.md's table,
``ops/block_stream_dd.py``) against the JAX package's streamed
double-double solver, on the CPU.

The JAX side runs ``solve_beam_dd_streamed`` with its Pallas kernels in
interpret mode (float32 hi/lo pairs, ~48-bit mantissa); the port runs its
plain version (``thomas_dd_reference``, native float64), which the wrapper
takes for CPU tensors.  Both return float32 displacements.  The bars:

- the assembly: the port's float64 pipeline against JAX's hi + lo with JAX
  in float64 (double-double in float64 is exact to ~1e-30), within 1e-12 of
  each output's scale;
- the solve on tests/test_beam_kernel_dd.py's quasi-cantilever batch and a
  ragged B = 3: each side within 1e-6 of the lane's scale of the float64
  ``solve_beam``, within 2e-6 of each other; pivots within 1e-4 (the port)
  and 2e-3 (JAX's own gate) of the float64 ``beam_min_pivot``;
- a span-scaled n = 641 beam with a 256 m tail overhang (B = 2), where
  float32 is ~15% wrong: the port within 1e-6 of float64 on both lanes,
  JAX within its own test's 1e-5 (overhang) and 1e-6;
- ``solve_beam_checked`` with ``DD_STREAM_FROM_N`` lowered to 101: the
  same lanes escalate as in the JAX function (which takes its resident dd
  kernel at n = 101), and the escalated deflections agree to 1e-6 of scale.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_beam_kernel_dd import _ill_conditioned_batch, _to64
from test_block_stream_dd import _f64_reference, _run_streamed
from test_torch_accuracy import (
    _f64_deflections,
    _rel,
    _roller_spacing,
    _torch_case,
)
from openpystruct_tpu.fem import solve_beam_checked as j_solve_beam_checked
from openpystruct_tpu.fem.beam import BeamScenario as JBeamScenario
from openpystruct_tpu.fem.beam import beam_min_pivot as j_beam_min_pivot
from openpystruct_tpu.fem.beam import constraint_mask as j_constraint_mask
from openpystruct_tpu.ops.block_stream_dd import (
    assemble_beam_system_dd as j_assemble_dd,
)
from openpystruct_tpu_torch.fem import accuracy as tacc
from openpystruct_tpu_torch.fem import solve_beam_checked
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
from openpystruct_tpu_torch.ops import block_stream_dd as tsd

E, A = 200e9, 0.01


def _lane_rel(a, b):
    """Per-lane max |a - b| over the lane's max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    axes = tuple(range(1, b.ndim))
    return (np.abs(a - b).max(axis=axes) / np.abs(b).max(axis=axes))


def _port_inputs(scen, I):
    """The port's solve_beam_dd_streamed arguments from a JAX scenario."""
    free = np.array(~jax.vmap(j_constraint_mask)(scen))
    return (torch.from_numpy(np.array(I)),
            torch.from_numpy(np.diff(np.asarray(scen.node_x), axis=-1)),
            torch.from_numpy(free),
            torch.from_numpy(np.array(scen.point_loads)),
            torch.from_numpy(np.array(scen.udl)))


def _port_streamed(scen, I):
    tsd.reset_counts()
    u, piv = tsd.solve_beam_dd_streamed(*_port_inputs(scen, I), E, A)
    assert tsd.PLAIN_CALLS == {"solve_dd_streamed": 0,
                               "solve_beam_dd_streamed": 1}
    assert tsd.LAUNCHES == {"solve_dd_streamed": 0,
                            "solve_beam_dd_streamed": 0}
    tsd.reset_counts()
    assert u.dtype == torch.float32 and piv.dtype == torch.float32
    return u.numpy(), piv.numpy()


def test_assembly_matches_jax():
    """Quasi-cantilever lanes with a numpy-seeded I, float64 on both
    sides; the JAX function returns hi/lo pairs, compared as hi + lo."""
    scen, _ = _ill_conditioned_batch()
    scen = _to64(scen)
    I = 0.05 * np.random.default_rng(5).uniform(0.8, 1.2, (4, 100))
    Le = jnp.diff(scen.node_x, axis=-1)
    free = (~jax.vmap(j_constraint_mask)(scen)).astype(jnp.float64)
    jd, ju, jf, js = j_assemble_dd(jnp.asarray(I), Le, free,
                                   scen.point_loads, scen.udl, E, A)
    port = tsd.assemble_beam_system_dd(
        *(torch.from_numpy(np.array(a)) for a in (
            I, Le, free, scen.point_loads, scen.udl)), E, A)
    for name, p, j in zip(("diag", "upper", "f", "s"), port,
                          (jd, ju, jf, js)):
        j = (np.asarray(j.hi, np.float64) + np.asarray(j.lo, np.float64)
             if hasattr(j, "hi") else np.asarray(j, np.float64))
        assert p.dtype == torch.float64 and p.shape == j.shape, name
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-12,
                                   atol=1e-12 * np.abs(j).max(), err_msg=name)


def _ragged():
    """Three quasi-cantilever lanes (B = 3, not a power of two) with a
    numpy-seeded I ripple."""
    scen, _ = _ill_conditioned_batch()
    scen = jax.tree.map(lambda x: x[:3], scen)
    I = 0.05 * np.random.default_rng(3).uniform(0.8, 1.2, (3, 100))
    return scen, jnp.asarray(I, jnp.float32)


@pytest.mark.parametrize("case", ["quasi_cantilever", "ragged_b3"])
def test_streamed_matches_jax_and_f64(case):
    scen, I = _ill_conditioned_batch() if case == "quasi_cantilever" \
        else _ragged()
    u64, piv64 = _f64_reference(scen, I)
    ju, jpiv = _run_streamed(scen, I)
    u, piv = _port_streamed(scen, I)
    assert (_lane_rel(u, u64) < 1e-6).all(), _lane_rel(u, u64)
    assert (_lane_rel(ju, u64) < 1e-6).all(), _lane_rel(ju, u64)
    assert (_lane_rel(u, ju) < 2e-6).all(), _lane_rel(u, ju)
    np.testing.assert_allclose(piv, piv64, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jpiv, np.float64), piv64,
                               rtol=2e-3)
    # the pivots are the ones float32 cannot resolve (~2.6e-11 and up)
    assert (piv64 < 1e-9).all() and (piv64 > 1e-12).all()


def test_streamed_span_scaled_overhang_n641():
    """tests/test_block_stream_dd.py's n = 641 case: a span-scaled 1280 m
    beam (Le = 2 m), one lane with a 256 m tail overhang, one supported
    every 128 m."""
    n = 641
    node_x = np.linspace(0.0, 2.0 * (n - 1), n, dtype=np.float32)
    roller = np.zeros((2, n), bool)
    roller[0, np.arange(63, 513, 64)] = True
    roller[1, np.arange(63, n - 1, 64)] = True
    loads = np.zeros((2, n), np.float32)
    loads[0, 600], loads[1, n // 3] = -3.5e5, -2.5e5
    scen = JBeamScenario(node_x=jnp.asarray(np.tile(node_x, (2, 1))),
                         roller_mask=jnp.asarray(roller),
                         point_loads=jnp.asarray(loads),
                         udl=jnp.full((2,), -1000.0, jnp.float32))
    I = jnp.asarray(0.05 * np.random.default_rng(641).uniform(
        0.8, 1.2, (2, n - 1)), jnp.float32)
    u64, piv64 = _f64_reference(scen, I)
    ju, jpiv = _run_streamed(scen, I)
    u, piv = _port_streamed(scen, I)
    assert (_lane_rel(u, u64) < 1e-6).all(), _lane_rel(u, u64)
    jrel = _lane_rel(ju, u64)
    assert jrel[0] < 1e-5 and jrel[1] < 1e-6, jrel
    assert (_lane_rel(u, ju) <= jrel + 1e-6).all(), (_lane_rel(u, ju), jrel)
    np.testing.assert_allclose(piv, piv64, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jpiv, np.float64), piv64,
                               rtol=2e-3)


def test_checked_escalates_through_the_streamed_solve(monkeypatch):
    """solve_beam_checked on a float32 n = 101 batch of which three lanes
    escalate, with the streamed route forced from n = 101."""
    monkeypatch.setattr(tacc, "DD_STREAM_FROM_N", 101)
    scs, I = _roller_spacing()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        jsol, jinfo = j_solve_beam_checked(jnp.asarray(I), scs, E, A,
                                           tol=1e-4)
        It, sc = _torch_case(scs, I, torch.float32)
        tsd.reset_counts()
        tkd.reset_counts()
        tsol, tinfo = solve_beam_checked(It, sc, E, A, tol=1e-4)
    assert tsd.PLAIN_CALLS == {"solve_dd_streamed": 0,
                               "solve_beam_dd_streamed": 1}
    assert tkd.PLAIN_CALLS["beam_analysis_dd"] == 0
    tsd.reset_counts()
    used = tinfo["used_dd"].numpy()
    np.testing.assert_array_equal(used, jinfo["used_dd"])
    np.testing.assert_array_equal(used, [False] * 3 + [True] * 3)
    d64 = _f64_deflections(scs, I)
    for b in np.flatnonzero(used):
        assert _rel(tsol.deflections[b].numpy(), jsol.deflections[b]) < 1e-6
        assert _rel(tsol.deflections[b].numpy(), d64[b]) < 1e-4
    # #9's pivot is min |det S_i| of the full scaled system: float64
    # beam_min_pivot's, and JAX's a_axial |det2| to its 5e-3
    scs64 = _to64(scs)
    piv64 = np.asarray(jax.vmap(lambda i, s: j_beam_min_pivot(i, s, E, A))(
        jnp.asarray(I, jnp.float64), scs64))
    piv = tinfo["pivot"].numpy()
    np.testing.assert_allclose(piv[used], piv64[used], rtol=1e-4)
    np.testing.assert_allclose(piv[used], np.asarray(jinfo["pivot"])[used],
                               rtol=5e-3)
    assert (tinfo["est"][used] <= 1e-4).all()
