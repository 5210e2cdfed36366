"""Port: the explicit-RHS beam solve (kernel #3 of PERF.md's table), the
differentiable fused analysis and the split-path optimizer against the JAX
package, in float64 on the CPU with its Pallas kernels in interpret mode.

Tolerances: ``beam_solve`` repeats ``_beam_kernel``'s arithmetic, but these
beam systems are ill-conditioned enough (cond ~1e5 to 1e6 after scaling)
that a one-ulp difference in a scale or a pivot moves x by ~2e-11 of its
scale, so the gate is 1e-10.  The I gradient of the analysis adds
-lam^T (dK/dI) u and the direct dV/dI, dM/dI terms, which cancel to ~1e-4
of their size; the gate for it is 1e-7 (1.4e-9 observed), 1e-10 for the
load and UDL gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import BeamConfig as JBeamConfig
from openpystruct_tpu.config import OptimizerConfig as JOptimizerConfig
from openpystruct_tpu.config import ScenarioConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.fem.beam import constraint_mask
from openpystruct_tpu.fem.beam import solve_beam_batched as j_solve_batched
from openpystruct_tpu.ops.beam_kernel import (
    pallas_beam_analysis,
    pallas_beam_solve,
)
from openpystruct_tpu.opt.beam_opt import (
    optimize_beam_batched as j_optimize_beam_batched,
)
from openpystruct_tpu_torch.config import BeamConfig, OptimizerConfig
from openpystruct_tpu_torch.fem.beam import solve_beam_batched
from openpystruct_tpu_torch.interop import scenario_from_numpy
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.ops import block_tridiag as tbt
from openpystruct_tpu_torch.opt import beam_opt as tbo

E, A = 200e9, 0.01


def _scenarios(B, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(lambda k: sample_scenario(k, ScenarioConfig(num_nodes=n))
                   )(keys)
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, scs)


def _inputs(B=3, n=21, seed=0):
    scs = _scenarios(B, n, seed)
    rng = np.random.default_rng(seed)
    return dict(
        I=np.exp(rng.normal(size=(B, n - 1)) * 0.3) * 0.5,
        Le=np.diff(np.asarray(scs.node_x, np.float64), axis=-1),
        free=np.asarray(~jax.vmap(constraint_mask)(scs), np.float64),
        loads=np.asarray(scs.point_loads, np.float64),
        udl=np.asarray(scs.udl, np.float64),
        # an explicit RHS that loads every DOF, the axial chain included
        rhs=rng.normal(size=(B, n, 3)) * 1e4,
    )


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _close(a, b, what, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max(),
                               err_msg=what)


@pytest.mark.parametrize("refine", [0, 1])
def test_beam_solve_matches_pallas(refine):
    x = _inputs()
    args = [x[k] for k in ("I", "Le", "free", "rhs")]
    ref, piv = pallas_beam_solve(*(jnp.asarray(a) for a in args), E, A,
                                 refine=refine, interpret=True)
    tk.reset_counts()
    out, piv_t = tk.beam_solve(*(_t(a) for a in args), E, A, refine)
    assert tk.PLAIN_CALLS["beam_solve"] == 1 and tk.LAUNCHES["beam_solve"] == 0
    tk.reset_counts()
    _close(out, ref, "x", 1e-10)
    _close(piv_t, piv, "pivot", 1e-10)
    plain = tk.beam_solve_reference(*(_t(a) for a in args), E, A, refine)
    assert torch.equal(plain[0], out) and torch.equal(plain[1], piv_t)
    # constrained DOFs are projected out
    assert (out.numpy()[x["free"] == 0] == 0).all()


def _loss(u, V, M):
    """Touches every differentiable output head, as tests/test_fused_vjp.py
    does."""
    return (M**2).sum() * 1e-9 + (V**2).sum() * 1e-7 + (u[..., 1]**2).sum() * 1e3


@pytest.mark.parametrize("refine", [0, 1])
def test_beam_analysis_gradient_matches_jax_vjp(refine):
    x = _inputs(seed=3)
    Le, free = jnp.asarray(x["Le"]), jnp.asarray(x["free"])

    def jloss(I, loads, udl):
        u, V, M, _ = pallas_beam_analysis(I, Le, free, loads, udl, E, A,
                                          refine=refine, interpret=True)
        return _loss(u, V, M)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x["I"]), jnp.asarray(x["loads"]), jnp.asarray(x["udl"]))
    I, loads, udl = (_t(x[k]).requires_grad_(True)
                     for k in ("I", "loads", "udl"))
    tk.reset_counts()
    u, V, M, piv = tk.beam_analysis(I, _t(x["Le"]), _t(x["free"]), loads,
                                    udl, E, A, refine)
    assert not piv.requires_grad
    gI, gl, gw = torch.autograd.grad(_loss(u, V, M), (I, loads, udl))
    # one plain forward, one explicit-RHS solve in the backward pass
    assert tk.PLAIN_CALLS == {"beam_analysis": 1, "beam_opt_step": 0,
                              "beam_solve": 1}
    tk.reset_counts()
    _close(gI, gj[0], "gI", 1e-7)
    _close(gl, gj[1], "gloads", 1e-10)
    _close(gw, gj[2], "gudl", 1e-10)


def test_beam_analysis_gradient_matches_autograd_of_plain_version():
    """The analytic reverse pass against autograd through the plain
    forward version (float64, no refinement): the same derivative by
    another route."""
    x = _inputs(seed=4)
    I = _t(x["I"]).requires_grad_(True)
    args = (_t(x["Le"]), _t(x["free"]), _t(x["loads"]), _t(x["udl"]), E, A)
    (g_an,) = torch.autograd.grad(_loss(*tk.beam_analysis(I, *args, 0)[:3]),
                                  I)
    (g_ad,) = torch.autograd.grad(
        _loss(*tk.beam_analysis_reference(I, *args, 0)[:3]), I)
    _close(g_an, g_ad, "gI", 1e-7)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_solve_beam_batched_matches_jax(use_pallas):
    """The port's split-path solve (solve_sym, its plain version on the
    CPU) against both routes of the JAX one: the block-Thomas solve (its
    kernel in interpret mode) and the plain fem.solve solver."""
    scs = _scenarios(3, 21, 6)
    I = np.exp(np.random.default_rng(6).normal(size=(3, 20)) * 0.3) * 0.5
    jsol = j_solve_batched(jnp.asarray(I), scs, E, A, refine=1,
                           use_pallas=use_pallas, interpret=True)
    sc = scenario_from_numpy(
        {k: np.asarray(getattr(scs, k)) for k in
         ("node_x", "roller_mask", "point_loads", "udl")},
        device="cpu", dtype=torch.float64)
    tbt.reset_counts()
    tsol = solve_beam_batched(_t(I), sc, E, A, refine=1)
    # a refine-1 solve_sym is two block-Thomas solves
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 2
    tbt.reset_counts()
    for name in ("displacements", "shear_forces", "bending_moments"):
        _close(getattr(tsol, name), getattr(jsol, name), name, 1e-10)


@pytest.mark.parametrize("mode", ["semi", "adjoint"])
def test_split_optimizer_matches_jax_split_pallas(mode):
    """optimize_beam_batched(fused=False): plain assembly, solve_sym and
    autograd, against the JAX split path on its Pallas solve."""
    scs = _scenarios(3, 21, 5)
    kw = dict(max_epochs=12, tolerance=5e-3, patience=4, grad_mode=mode)
    B, n = scs.node_x.shape
    I0 = np.full((B, n - 1), 0.5)
    jres = j_optimize_beam_batched(
        scs, JBeamConfig(udl=-1000.0), JOptimizerConfig(**kw),
        I0=jnp.asarray(I0), refine=1, use_pallas=True, interpret=True,
        fused=False)
    sc = scenario_from_numpy(
        {k: np.asarray(getattr(scs, k)) for k in
         ("node_x", "roller_mask", "point_loads", "udl")},
        device="cpu", dtype=torch.float64)
    tbt.reset_counts()
    tres = tbo.optimize_beam_batched(sc, BeamConfig(udl=-1000.0),
                                     OptimizerConfig(**kw),
                                     I0=torch.from_numpy(I0), refine=1,
                                     fused=False)
    epochs = int(tres.n_epochs.max())
    # per epoch a refine-1 solve (2 solves), in adjoint mode 2 more in the
    # backward pass; then one solve of the final solution
    per_epoch = 2 if mode == "semi" else 4
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == per_epoch * epochs + 2
    tbt.reset_counts()
    np.testing.assert_array_equal(tres.n_epochs.numpy(),
                                  np.asarray(jres.n_epochs))
    _close(tres.I, jres.I, "I", 1e-9)
    _close(tres.loss.total, jres.loss.total, "loss", 1e-9)
    _close(tres.solution.bending_moments, jres.solution.bending_moments,
           "M", 1e-9)
    assert tres.pivot is None
