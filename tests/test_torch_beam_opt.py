"""Port: the I-field optimizers against ``openpystruct_tpu.opt`` in float64
on JAX-drawn scenarios, and compaction against the plain batched optimizer.

In float64 the port's fused path (the opt-step kernel's plain version on
the CPU) and its split path (plain solve + autograd) both follow the JAX
split path's trajectory to ~1e-7 over 25 epochs, as tests/test_batched_opt.py
holds the JAX optimizers to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import BeamConfig as JBeamConfig
from openpystruct_tpu.config import OptimizerConfig as JOptimizerConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.opt import optimize_beam as j_optimize_beam
from openpystruct_tpu.opt.beam_opt import (
    optimize_beam_batched as j_optimize_beam_batched,
)
from openpystruct_tpu_torch.config import BeamConfig, OptimizerConfig
from openpystruct_tpu_torch.datagen.sampler import sample_scenarios
from openpystruct_tpu_torch.interop import scenario_from_numpy
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
from openpystruct_tpu_torch.opt import beam_opt as tbo


def _scenarios(B, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(sample_scenario)(keys)
    scs = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, scs)
    arrays = {k: np.asarray(getattr(scs, k)) for k in
              ("node_x", "roller_mask", "point_loads", "udl")}
    return scs, scenario_from_numpy(arrays, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("mode", ["semi", "adjoint"])
def test_optimize_beam_batched_matches_jax(mode, fused):
    scs, sc = _scenarios(4)
    jopt = JOptimizerConfig(max_epochs=25, tolerance=5e-3, patience=5,
                            grad_mode=mode)
    topt = OptimizerConfig(max_epochs=25, tolerance=5e-3, patience=5,
                           grad_mode=mode)
    B, n = scs.node_x.shape
    I0 = np.full((B, n - 1), 0.5)
    jres = jax.jit(lambda s: j_optimize_beam_batched(
        s, JBeamConfig(udl=-1000.0), jopt, I0=jnp.asarray(I0),
        use_pallas=False))(scs)
    tres = tbo.optimize_beam_batched(sc, BeamConfig(udl=-1000.0), topt,
                                     I0=torch.from_numpy(I0), fused=fused)
    np.testing.assert_array_equal(tres.n_epochs.numpy(),
                                  np.asarray(jres.n_epochs))
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_allclose(tres.I.numpy(), np.asarray(jres.I), rtol=1e-6)
    np.testing.assert_allclose(tres.loss.total.numpy(),
                               np.asarray(jres.loss.total), rtol=1e-6)
    scale = np.abs(np.asarray(jres.solution.bending_moments)).max()
    np.testing.assert_allclose(tres.solution.bending_moments.numpy(),
                               np.asarray(jres.solution.bending_moments),
                               rtol=1e-6, atol=1e-6 * scale)
    assert (tres.pivot is not None) == fused


def test_optimize_beam_single_matches_jax():
    scs, sc = _scenarios(1, seed=2)
    one = jax.tree.map(lambda x: x[0], scs)
    jres = jax.jit(lambda s: j_optimize_beam(
        s, JBeamConfig(udl=-1000.0),
        JOptimizerConfig(max_epochs=15, tolerance=5e-3, patience=5),
        I0=jnp.full((100,), 0.5)))(one)
    tres = tbo.optimize_beam(
        sc.map(lambda x: x[0]), BeamConfig(udl=-1000.0),
        OptimizerConfig(max_epochs=15, tolerance=5e-3, patience=5),
        I0=torch.full((100,), 0.5, dtype=torch.float64),
        record_history=True)
    assert int(tres.n_epochs) == int(jres.n_epochs)
    np.testing.assert_allclose(tres.I.numpy(), np.asarray(jres.I), rtol=1e-6)
    assert torch.isfinite(tres.loss_history[: int(tres.n_epochs)]).all()


def _small_batch(B=16, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return sample_scenarios(gen, B, device="cpu", dtype=torch.float64)


def _assert_same(a, b):
    for name in ("I", "I_solved", "n_epochs", "converged", "pivot"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=0, msg=name)
    torch.testing.assert_close(a.loss.total, b.loss.total, rtol=0, atol=0)
    torch.testing.assert_close(a.solution.displacements,
                               b.solution.displacements, rtol=0, atol=0)


def test_compact_equals_batched_per_lane():
    sc = _small_batch()
    # a loose tolerance makes lanes stop at different epochs
    opt = OptimizerConfig(max_epochs=60, tolerance=1.0, patience=3)
    beam = BeamConfig(udl=-1000.0)
    plain = tbo.optimize_beam_batched(sc, beam, opt, refine=1)
    comp = tbo.optimize_beam_compact(sc, beam, opt, refine=1, min_bucket=2)
    # the cascade really compacted: lanes stopped at different epochs
    assert len(set(plain.n_epochs.tolist())) > 1
    assert tbo._compact_sizes(16, 2) == [16, 8, 4, 2]
    _assert_same(comp, plain)


def test_sync_interval_does_not_change_results(monkeypatch):
    sc = _small_batch(B=8, seed=6)
    opt = OptimizerConfig(max_epochs=40, tolerance=1.0, patience=3)
    beam = BeamConfig(udl=-1000.0)
    ref = tbo.optimize_beam_compact(sc, beam, opt, min_bucket=2)
    monkeypatch.setattr(tbo, "_SYNC_EVERY", 1)
    every = tbo.optimize_beam_compact(sc, beam, opt, min_bucket=2)
    _assert_same(every, ref)


def test_unported_paths_raise():
    """dd=True runs the float64 rescue path (semi-gradient only, as in the
    JAX package); with grad_mode="adjoint" it still raises."""
    sc = _small_batch(B=2)
    adjoint = OptimizerConfig(max_epochs=5, grad_mode="adjoint")
    with pytest.raises(NotImplementedError):
        tbo.optimize_beam_batched(sc, opt=adjoint, dd=True)
    with pytest.raises(NotImplementedError):
        tbo.optimize_beam_compact(sc, opt=adjoint, dd=True)
    semi = OptimizerConfig(max_epochs=5)
    tkd.reset_counts()
    batched = tbo.optimize_beam_batched(sc, opt=semi, dd=True)
    compact = tbo.optimize_beam_compact(sc, opt=semi, dd=True, min_bucket=1)
    assert tkd.PLAIN_CALLS == {"beam_analysis_dd": 2, "beam_opt_step_dd": 10}
    tkd.reset_counts()
    _assert_same(compact, batched)
    assert batched.pivot.dtype == torch.float64 and (batched.pivot > 0).all()
    # fused=False does not turn dd off, as in the JAX package
    split = tbo.optimize_beam_batched(sc, opt=semi, dd=True, fused=False)
    _assert_same(split, batched)
