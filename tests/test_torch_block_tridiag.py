"""Port: the block-Thomas solves (kernels #4, #5 and #6 of PERF.md's table)
and the differentiable refined solve against the JAX Pallas kernels; the
launchers' checks and the #4/#6 dispatch.

Both sides run in float64 on the CPU on the same numpy-seeded systems:
``pallas_block_tridiag_solve`` (with and without ``bidi``),
``pallas_block_tridiag_solve_streamed`` and ``pallas_solve_sym`` in
interpret mode against the port's plain versions (``thomas_reference`` and
``thomas_bidi_reference``, which the wrappers run for CPU tensors).  They
repeat the same arithmetic in the same order, so they agree to a few ulps;
the gate is 1e-10 of each output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import ScenarioConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.fem.beam import assemble_beam_system
from openpystruct_tpu.ops.block_stream import (
    pallas_block_tridiag_solve_streamed,
)
from openpystruct_tpu.ops.block_tridiag import (
    pallas_block_tridiag_solve,
    pallas_solve_sym,
)
from openpystruct_tpu_torch.fem.beam import BeamScenario as TBeamScenario
from openpystruct_tpu_torch.fem.beam import assemble_beam_system as t_assemble
from openpystruct_tpu_torch.ops import block_stream as tbs
from openpystruct_tpu_torch.ops import block_tridiag as tbt

E, A = 200e9, 0.01
TOL = 1e-10


def _spd(B, n, seed):
    """Random symmetric positive definite block-tridiagonal systems."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, n, 3, 3))
    d = d @ d.transpose(0, 1, 3, 2) + 6.0 * np.eye(3)
    u = rng.normal(size=(B, n - 1, 3, 3)) * 0.3
    return d, u, rng.normal(size=(B, n, 3))


def _beam(B, n, seed):
    """Jacobi-scaled beam systems on JAX-drawn scenarios, as
    solve_beam_batched hands them to the solve."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(lambda k: sample_scenario(k, ScenarioConfig(num_nodes=n))
                   )(keys)
    I = np.exp(np.random.default_rng(seed).normal(size=(B, n - 1)) * 0.3) * 0.5
    d, u, f = jax.vmap(lambda i, s: assemble_beam_system(i, s, E, A))(
        jnp.asarray(I), scs)
    d, u, f = (np.asarray(a, np.float64) for a in (d, u, f))
    s = 1.0 / np.sqrt(np.diagonal(d, axis1=-2, axis2=-1))
    return (d * s[..., :, None] * s[..., None, :],
            u * s[:, :-1, :, None] * s[:, 1:, None, :], f * s)


def _span(B, n, seed):
    """Jacobi-scaled beam systems on a span-scaled mesh (Le = 2 m) pinned
    at node 0 with rollers at every third node and the last, numpy-seeded
    loads and I: well posed at any n >= 2, without sampling a scenario."""
    rng = np.random.default_rng(seed)
    roller = np.zeros((B, n), bool)
    roller[:, 3::3] = roller[:, -1] = True
    sc = TBeamScenario(
        node_x=torch.linspace(0.0, 2.0 * (n - 1), n,
                              dtype=torch.float64).repeat(B, 1),
        roller_mask=torch.from_numpy(roller),
        point_loads=torch.from_numpy(-3e5 * rng.uniform(size=(B, n))),
        udl=torch.full((B,), -1000.0, dtype=torch.float64))
    I = torch.from_numpy(np.exp(rng.normal(size=(B, n - 1)) * 0.3) * 0.5)
    d, u, f = t_assemble(I, sc, E, A)
    s = torch.rsqrt(torch.diagonal(d, dim1=-2, dim2=-1))
    return tuple(t.numpy() for t in (
        d * s[..., :, None] * s[..., None, :],
        u * s[:, :-1, :, None] * s[:, 1:, None, :], f * s))


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _close(a, b, what, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max(),
                               err_msg=what)


SYSTEMS = {"spd-n21": lambda: _spd(3, 21, 0),
           "beam-n41": lambda: _beam(4, 41, 1)}


@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_thomas_matches_pallas(case):
    d, u, b = SYSTEMS[case]()
    ref = pallas_block_tridiag_solve(jnp.asarray(d), jnp.asarray(u),
                                     jnp.asarray(b), interpret=True)
    _close(tbt.thomas_reference(_t(d), _t(u), _t(b)), ref, "thomas_reference")
    tbt.reset_counts()
    x = tbt.block_tridiag_solve(_t(d), _t(u), _t(b))
    assert tbt.PLAIN_CALLS == {"block_tridiag_solve": 1,
                               "block_tridiag_solve_bidi": 0}
    assert tbt.LAUNCHES == {"block_tridiag_solve": 0,
                            "block_tridiag_solve_bidi": 0}
    tbt.reset_counts()
    _close(x, ref, "block_tridiag_solve")


@pytest.mark.parametrize("n", [3, 4, 21, 23, 31, 32])
def test_bidi_matches_pallas(n):
    """The two-chain solve at both parities of n, n = 3 and 4 the smallest
    meshes the JAX kernel had to clamp its indices for, on three ``_spd``
    and two beam systems in one batch; the beam systems are ``_span``'s (a
    sampled scenario needs n >= 100 for its rollers).  Each kind is held
    at its own scale."""
    parts = [_spd(3, n, n), _span(2, n, n)]
    d, u, b = (np.concatenate(a) for a in zip(*parts))
    ref = np.asarray(pallas_block_tridiag_solve(
        jnp.asarray(d), jnp.asarray(u), jnp.asarray(b), interpret=True,
        bidi=True))
    tbt.reset_counts()
    x = tbt.block_tridiag_solve(_t(d), _t(u), _t(b), bidi=True)
    assert tbt.PLAIN_CALLS == {"block_tridiag_solve": 0,
                               "block_tridiag_solve_bidi": 1}
    tbt.reset_counts()
    # the same solution as the one-chain sweep
    x1 = tbt.thomas_reference(_t(d), _t(u), _t(b))
    for kind, lanes in (("spd", slice(0, 3)), ("beam", slice(3, 5))):
        _close(x[lanes], ref[lanes], f"bidi=True, {kind}")
        _close(x[lanes], x1[lanes].numpy(), f"bidi vs thomas, {kind}")


def test_bidi_needs_three_nodes():
    d, u, b = (_t(a) for a in _spd(2, 2, 0))
    with pytest.raises(ValueError, match="n >= 3"):
        tbt.block_tridiag_solve(d, u, b, bidi=True)
    with pytest.raises(ValueError, match="n >= 3"):
        tbt.thomas_bidi_reference(d, u, b)


def test_streamed_matches_pallas():
    """n = 70 is not a multiple of the TPU kernel's 64-node chunk: two
    chunks there, one sweep here."""
    d, u, b = _beam(3, 70, 2)
    ref = pallas_block_tridiag_solve_streamed(
        jnp.asarray(d), jnp.asarray(u), jnp.asarray(b), interpret=True)
    tbs.reset_counts()
    x = tbs.block_tridiag_solve_streamed(_t(d), _t(u), _t(b))
    assert tbs.PLAIN_CALLS == {"block_tridiag_solve_streamed": 1}
    tbs.reset_counts()
    _close(x, ref, "block_tridiag_solve_streamed")
    # the split at the forward/backward boundary is thomas_reference's
    c, y = tbt.thomas_forward_reference(_t(d), _t(u), _t(b))
    assert c.shape == (3, 70, 3, 3) and y.shape == (3, 70, 3)
    assert torch.equal(c[:, -1], torch.zeros_like(c[:, -1]))
    assert torch.equal(tbt.thomas_backward_reference(c, y), x)


def _launcher_inputs(case):
    """Float32 systems (B = 2, n = 5) made wrong in one way."""
    d, u, b = (torch.from_numpy(a).float()
               for a in _spd(2, 2 if case == "two nodes" else 5, 4))
    if case == "strided diag":
        d = d.movedim(0, 1).contiguous().movedim(1, 0)
    elif case == "float64 b":
        b = b.double()
    elif case == "wrong upper shape":
        u = u[:, 1:].contiguous()
    elif case == "two devices":
        b = torch.empty(b.shape, device="meta")
    return d, u, b


@pytest.mark.parametrize("case,error,match", [
    ("strided diag", ValueError, "contiguous"),
    ("float64 b", TypeError, "float32"),
    ("wrong upper shape", ValueError, "upper has shape"),
    ("two devices", ValueError, "b is on meta"),
    ("cpu tensors", ValueError, "CUDA"),
])
def test_streamed_launcher_checks_before_building(monkeypatch, case, error,
                                                  match):
    """``launch_thomas_streamed`` reads lanes-first systems as they lie: it
    raises on what the kernel does not take before it builds anything, and
    counts no launch."""
    def no_build():
        raise AssertionError("the launcher built the kernel library")

    monkeypatch.setattr(tbs, "_lib", no_build)
    tbs.reset_counts()
    with pytest.raises(error, match=match):
        tbs.launch_thomas_streamed(*_launcher_inputs(case))
    assert tbs.LAUNCHES == {"block_tridiag_solve_streamed": 0}


@pytest.mark.parametrize("case,error,match", [
    ("strided diag", ValueError, "contiguous"),
    ("float64 b", TypeError, "float32"),
    ("wrong upper shape", ValueError, "upper has shape"),
    ("two devices", ValueError, "b is on meta"),
    ("cpu tensors", ValueError, "CUDA"),
])
def test_resident_launcher_checks_before_building(monkeypatch, case, error,
                                                  match):
    """``launch_thomas`` (kernel #4) reads lanes-first systems as they lie:
    it raises on what the kernel does not take before it builds anything,
    and counts no launch."""
    def no_build(*_):
        raise AssertionError("the launcher built the kernel library")

    monkeypatch.setattr(tbt, "_resident_lib", no_build)
    monkeypatch.setattr(tbt._build, "load", no_build)
    tbt.reset_counts()
    with pytest.raises(error, match=match):
        tbt.launch_thomas(*_launcher_inputs(case))
    assert tbt.LAUNCHES == {"block_tridiag_solve": 0,
                            "block_tridiag_solve_bidi": 0}


@pytest.mark.parametrize("case,error,match", [
    ("strided diag", ValueError, "contiguous"),
    ("float64 b", TypeError, "float32"),
    ("wrong upper shape", ValueError, "upper has shape"),
    ("two devices", ValueError, "b is on meta"),
    ("cpu tensors", ValueError, "CUDA"),
    ("two nodes", ValueError, "n >= 3"),
])
def test_bidi_launcher_checks_before_building(monkeypatch, case, error,
                                              match):
    """``launch_thomas_bidi`` (kernel #5) reads lanes-first systems as they
    lie: it raises on what the kernel does not take, n < 3 included, before
    it builds anything, and counts no launch."""
    def no_build(*_):
        raise AssertionError("the launcher built the kernel library")

    monkeypatch.setattr(tbt, "_lib", no_build)
    monkeypatch.setattr(tbt._build, "load", no_build)
    tbt.reset_counts()
    with pytest.raises(error, match=match):
        tbt.launch_thomas_bidi(*_launcher_inputs(case))
    assert tbt.LAUNCHES == {"block_tridiag_solve": 0,
                            "block_tridiag_solve_bidi": 0}


# (n, B, kernel) where chip_smoke.py phase 6 timed #4 against #6 on an
# H100 (132 SMs; PERF.md, #4): #4 where every lane fits one round of its
# blocks up to n = 201
DISPATCH = [(51, 512, "#4"), (51, 2048, "#4"), (51, 4096, "#4"),
            (51, 8192, "#6"), (51, 16384, "#6"),
            (101, 512, "#4"), (101, 2048, "#4"), (101, 4096, "#4"),
            (101, 8192, "#6"), (101, 16384, "#6"),
            (201, 512, "#4"), (201, 2048, "#4"), (201, 4096, "#6"),
            (201, 8192, "#6"), (201, 16384, "#6"),
            (301, 512, "#6"), (301, 16384, "#6"), (1001, 512, "#6")]


@pytest.mark.parametrize("n,B,kernel", DISPATCH)
def test_dispatch_follows_the_measured_turns(n, B, kernel):
    assert tbt.uses_streamed(n, B, 132) == (kernel == "#6")


@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_solve_sym_forward_and_vjp_match_pallas(case, refine):
    d, u, b = SYSTEMS[case]()
    g = np.random.default_rng(9).normal(size=b.shape)
    x, vjp = jax.vjp(lambda d_, u_, b_: pallas_solve_sym(d_, u_, b_, refine,
                                                         True),
                     jnp.asarray(d), jnp.asarray(u), jnp.asarray(b))
    gd, gu, gb = vjp(jnp.asarray(g))
    dt, ut, bt = (_t(a).requires_grad_(True) for a in (d, u, b))
    xt = tbt.solve_sym(dt, ut, bt, refine)
    _close(xt, x, "x")
    gdt, gut, gbt = torch.autograd.grad(xt, (dt, ut, bt), _t(g))
    _close(gdt, gd, "diag_bar")
    _close(gbt, gb, "b_bar")
    _close(gut, gu, "upper_bar")
    # the stored upper block feeds both bands: the lower band's term
    # -x_i lam_{i+1}^T is a real part of upper_bar
    lam = gbt
    first = -lam[:, :-1, :, None] * xt.detach()[:, 1:, None, :]
    assert (gut - first).abs().max() > 1e-3 * gut.abs().max()


def test_solve_sym_refinement_solves_anew():
    """Each refinement sweep is one more whole solve: refine r costs 1 + r
    solves forward and as many backward."""
    d, u, b = (_t(a).requires_grad_(True) for a in _spd(2, 9, 3))
    tbt.reset_counts()
    x = tbt.solve_sym(d, u, b, 2)
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 3
    x.sum().backward()
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 6
    tbt.reset_counts()
