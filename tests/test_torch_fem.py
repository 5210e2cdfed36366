"""Port: the beam FE model and the plain block-Thomas solve against
``openpystruct_tpu.fem`` in float64, at the 1e-8 gate of
tests/test_beam_fem.py, on JAX-drawn scenarios (B = 4, n in {21, 101})."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import ScenarioConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.fem import beam as jbeam
from openpystruct_tpu_torch.fem import beam as tbeam
from openpystruct_tpu_torch.interop import scenario_from_numpy

E, A = 200e9, 0.01
RTOL = 1e-8


def _case(n, B=4, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(lambda k: sample_scenario(k, ScenarioConfig(num_nodes=n))
                   )(keys)
    scs = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, scs)
    arrays = {k: np.asarray(getattr(scs, k)) for k in
              ("node_x", "roller_mask", "point_loads", "udl")}
    I = np.exp(np.random.default_rng(seed).normal(size=(B, n - 1)) * 0.3) * 0.5
    return scs, scenario_from_numpy(arrays, device="cpu",
                                    dtype=torch.float64), I


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("n", [21, 101])
def test_assemble_and_min_pivot(n):
    scs, sc, I = _case(n)
    jd, ju, jf = jax.vmap(
        lambda i, s: jbeam.assemble_beam_system(i, s, E, A))(jnp.asarray(I),
                                                             scs)
    td, tu, tf = tbeam.assemble_beam_system(torch.from_numpy(I), sc, E, A)
    _close(td, jd)
    _close(tu, ju)
    _close(tf, jf)
    jp = jax.vmap(lambda i, s: jbeam.beam_min_pivot(i, s, E, A))(
        jnp.asarray(I), scs)
    _close(tbeam.beam_min_pivot(torch.from_numpy(I), sc, E, A), jp)


@pytest.mark.parametrize("n", [21, 101])
@pytest.mark.parametrize("refine", [0, 1])
def test_solve_beam_and_batched(n, refine):
    scs, sc, I = _case(n)
    jsol = jax.jit(lambda i, s: jbeam.solve_beam_batched(
        i, s, E, A, refine=refine, use_pallas=False))(jnp.asarray(I), scs)
    for fn in (tbeam.solve_beam, tbeam.solve_beam_batched):
        tsol = fn(torch.from_numpy(I), sc, E, A, refine=refine)
        _close(tsol.displacements, jsol.displacements)
        _close(tsol.shear_forces, jsol.shear_forces)
        _close(tsol.bending_moments, jsol.bending_moments)
        _close(tsol.end_forces, jsol.end_forces)


def test_solve_adjoint_gradient_matches_jax_grad():
    scs, sc, I = _case(101, B=2, seed=1)

    def jloss(i):
        s = jbeam.solve_beam_batched(i, scs, E, A, use_pallas=False)
        return (jnp.sum(s.deflections**2) * 1e3
                + jnp.sum(s.bending_moments) * 1e-9)

    gj = jax.jit(jax.grad(jloss))(jnp.asarray(I))
    It = torch.from_numpy(I.copy()).requires_grad_(True)
    s = tbeam.solve_beam(It, sc, E, A)
    loss = (s.deflections**2).sum() * 1e3 + s.bending_moments.sum() * 1e-9
    (gt,) = torch.autograd.grad(loss, It)
    _close(gt, gj, rtol=1e-7)
