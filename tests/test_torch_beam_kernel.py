"""Port: the fused kernels' plain versions against the JAX Pallas kernels.

Both sides run in float64 on the CPU on the same numpy-seeded inputs (JAX
scenarios, lognormal I): ``pallas_beam_analysis`` / ``pallas_beam_opt_step``
in interpret mode against ``beam_analysis_reference`` /
``beam_opt_step_reference``.  The two repeat the same arithmetic in the
same order, so they agree to ~1e-12; the 1e-9 relative gate leaves room for
the sums the port takes in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import ScenarioConfig
from openpystruct_tpu.datagen import sample_scenario
from openpystruct_tpu.fem.beam import constraint_mask
from openpystruct_tpu.ops.beam_kernel import (
    pallas_beam_analysis,
    pallas_beam_opt_step,
)
from openpystruct_tpu_torch.interop import (
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from openpystruct_tpu_torch.ops import beam_kernel as tk

E, A = 200e9, 0.01
G = E / (2.0 * 1.3)
RTOL = 1e-9


def _inputs(B=3, seed=0, n=101):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    scs = jax.vmap(lambda k: sample_scenario(k, ScenarioConfig(num_nodes=n))
                   )(keys)
    rng = np.random.default_rng(seed)
    nelem = n - 1
    free = np.asarray(~jax.vmap(constraint_mask)(scs), np.float64)
    return dict(
        I=np.exp(rng.normal(size=(B, nelem)) * 0.3) * 0.5,
        mu=rng.normal(size=(B, nelem)) * 0.1,
        nu=rng.uniform(1e-4, 1e-2, size=(B, nelem)),
        Le=np.diff(np.asarray(scs.node_x, np.float64), axis=-1),
        free=free,
        loads=np.asarray(scs.point_loads, np.float64),
        udl=np.asarray(scs.udl, np.float64),
    )


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("refine", [0, 1])
def test_beam_analysis_reference_matches_pallas(refine):
    x = _inputs()
    ref = pallas_beam_analysis(
        jnp.asarray(x["I"]), jnp.asarray(x["Le"]), jnp.asarray(x["free"]),
        jnp.asarray(x["loads"]), jnp.asarray(x["udl"]), E, A, refine=refine,
        interpret=True,
    )
    out = tk.beam_analysis_reference(
        _t(x["I"]), _t(x["Le"]), _t(x["free"]), _t(x["loads"]), _t(x["udl"]),
        E, A, refine=refine,
    )
    for name, a, b in zip(("u", "V", "M", "pivot"), out, ref):
        assert a.dtype == torch.float64
        _close(a.numpy(), b, name)
    assert (out[0][..., 0] == 0).all()


@pytest.mark.parametrize("grad_semi", [True, False], ids=["semi", "adjoint"])
def test_beam_opt_step_reference_matches_pallas(grad_semi):
    x = _inputs(seed=1)
    lr_t, bc1, bc2 = 0.009, 1.5, 400.0
    ref = pallas_beam_opt_step(
        jnp.asarray(x["I"]), jnp.asarray(x["mu"]), jnp.asarray(x["nu"]),
        jnp.asarray(x["Le"]), jnp.asarray(x["free"]),
        jnp.asarray(x["loads"]), jnp.asarray(x["udl"]),
        lr_t, bc1, bc2, E, A, G, grad_semi=grad_semi, refine=1,
        interpret=True,
    )
    # the JAX optimizer state crosses over as numpy arrays
    state = opt_state_from_numpy(x["I"], x["mu"], x["nu"], device="cpu",
                                 dtype=torch.float64)
    out = tk.beam_opt_step_reference(
        *state, _t(x["Le"]), _t(x["free"]), _t(x["loads"]), _t(x["udl"]),
        lr_t, bc1, bc2, E, A, G, grad_semi=grad_semi, refine=1,
    )
    for name, a, b in zip(("I", "mu", "nu"), opt_state_to_numpy(*out[:3]),
                          ref):
        _close(a, b, name)
    _close(out[3].numpy(), ref[3], "stats")
    # the adjoint gradient differs from the semi-gradient
    other = tk.beam_opt_step_reference(
        _t(x["I"]), _t(x["mu"]), _t(x["nu"]), _t(x["Le"]), _t(x["free"]),
        _t(x["loads"]), _t(x["udl"]), lr_t, bc1, bc2, E, A, G,
        grad_semi=not grad_semi, refine=1,
    )
    assert not torch.allclose(other[1], out[1], rtol=1e-6)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    x = _inputs(B=2, n=21)
    tk.reset_counts()
    u, V, M, piv = tk.beam_analysis(
        _t(x["I"]), _t(x["Le"]), _t(x["free"]), _t(x["loads"]),
        _t(x["udl"]), E, A, refine=1,
    )
    ref = tk.beam_analysis_reference(
        _t(x["I"]), _t(x["Le"]), _t(x["free"]), _t(x["loads"]),
        _t(x["udl"]), E, A, refine=1,
    )
    assert all(torch.equal(a, b) for a, b in zip((u, V, M, piv), ref))
    tk.beam_opt_step(
        _t(x["I"]), _t(x["mu"]), _t(x["nu"]), _t(x["Le"]), _t(x["free"]),
        _t(x["loads"]), _t(x["udl"]), 0.01, 10.0, 1000.0, E, A, G,
    )
    assert tk.LAUNCHES == {"beam_analysis": 0, "beam_opt_step": 0,
                           "beam_solve": 0}
    assert tk.PLAIN_CALLS == {"beam_analysis": 1, "beam_opt_step": 1,
                              "beam_solve": 0}
    tk.reset_counts()


def _opt_args(B=4, n=9):
    """Lanes-first float32 opt-step inputs from numpy (values do not
    matter: nothing launches)."""
    rng = np.random.default_rng(n)
    shapes = ((B, n - 1),) * 4 + ((B, n, 3), (B, n), (B,))
    return [torch.from_numpy(rng.random(s, dtype=np.float32)) for s in shapes]


@pytest.mark.parametrize("case", ["strided I", "strided free", "float64",
                                  "short loads", "no element", "dd strided"])
def test_opt_step_launchers_check_inputs_before_building(case):
    """The opt-step kernels (#2, #8) read the optimizer's lanes-first
    tensors as they lie: the launchers refuse a strided view, another dtype
    or shape, or a beam without elements, before building or launching."""
    from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd

    args = _opt_args(B=1 if case == "no element" else 4,
                     n=1 if case == "no element" else 9)
    if case in ("strided I", "dd strided"):
        args[0] = args[0].t().contiguous().t()
    if case == "strided free":
        args[4] = args[4].movedim(0, -1).contiguous().movedim(-1, 0)
    if case == "float64":
        args[2] = args[2].double()
    if case == "short loads":
        args[5] = args[5][:, :-1]
    tail = (0.009, 1.5, 400.0, E, A, G)
    tk.reset_counts()
    tkd.reset_counts()
    with pytest.raises((ValueError, TypeError)) as err:
        if case == "dd strided":
            tkd.launch_beam_opt_step_dd(*args, *tail)
        else:
            tk.launch_beam_opt_step(*args, 0.009, 1.5, 400.0, E, G)
    if case.endswith("strided") or case.startswith("strided"):
        assert "contiguous" in str(err.value)
    assert tk.LAUNCHES["beam_opt_step"] == 0
    assert tkd.LAUNCHES["beam_opt_step_dd"] == 0


@pytest.mark.parametrize("dd", [False, True], ids=["analysis", "analysis_dd"])
@pytest.mark.parametrize("case", ["strided I", "strided free", "float64",
                                  "short loads", "no element", "cpu"])
def test_analysis_launchers_check_inputs_before_building(case, dd):
    """The analysis kernels (#1, #7) read the callers' lanes-first tensors
    as they lie: the launchers refuse a strided view, another dtype or
    shape, a beam without elements, or tensors off the card, before
    building or launching."""
    from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd

    args = _opt_args(B=1 if case == "no element" else 4,
                     n=1 if case == "no element" else 9)
    args = [args[i] for i in (0, 3, 4, 5, 6)]     # I, Le, free, loads, udl
    if case == "strided I":
        args[0] = args[0].t().contiguous().t()
    if case == "strided free":
        args[2] = args[2].movedim(0, -1).contiguous().movedim(-1, 0)
    if case == "float64":
        args[1] = args[1].double()
    if case == "short loads":
        args[3] = args[3][:, :-1]
    tk.reset_counts()
    tkd.reset_counts()
    launch = tkd.launch_beam_analysis_dd if dd else tk.launch_beam_analysis
    with pytest.raises((ValueError, TypeError)) as err:
        launch(*args, E, A)
    if case.startswith("strided"):
        assert "contiguous" in str(err.value)
    if case == "cpu":
        assert "CUDA" in str(err.value)
    assert tk.LAUNCHES["beam_analysis"] == 0
    assert tkd.LAUNCHES["beam_analysis_dd"] == 0


@pytest.mark.parametrize("case", ["strided I", "strided rhs", "float64",
                                  "short rhs", "no element", "cpu"])
def test_solve_launcher_checks_inputs_before_building(case):
    """The explicit-RHS solve (#3) reads the callers' lanes-first tensors
    as they lie: its launcher refuses a strided view, another dtype or
    shape, a beam without elements, or tensors off the card, before
    building or launching; the CPU wrapper runs the plain version."""
    B, n = (1, 1) if case == "no element" else (4, 9)
    rng = np.random.default_rng(n)
    args = [torch.from_numpy(rng.random(s, dtype=np.float32))
            for s in ((B, n - 1), (B, n - 1), (B, n, 3), (B, n, 3))]
    if case == "strided I":
        args[0] = args[0].t().contiguous().t()
    if case == "strided rhs":
        args[3] = args[3].movedim(0, -1).contiguous().movedim(-1, 0)
    if case == "float64":
        args[1] = args[1].double()
    if case == "short rhs":
        args[3] = args[3][:, :-1]
    tk.reset_counts()
    with pytest.raises((ValueError, TypeError)) as err:
        tk.launch_beam_solve(*args, E, A)
    if case.startswith("strided"):
        assert "contiguous" in str(err.value)
    if case == "cpu":
        assert "CUDA" in str(err.value)
        tk.beam_solve(*args, E, A)
        assert tk.PLAIN_CALLS["beam_solve"] == 1
    assert tk.LAUNCHES["beam_solve"] == 0
    tk.reset_counts()
