"""Port: the 2D frame FE model and its banded solver (``fem/frame.py``,
``fem/frame_banded.py``) against the JAX package's, in float64 on the same
numpy inputs.

- ``build_frame``: node coordinates, elements and masks equal.
- ``frame_system`` (dense K, f) and ``frame_blocks`` (D, U, f) within 1e-12
  of the largest entry.
- ``solve_frame`` dense and banded: displacements and end forces within
  1e-10 of the largest entry of JAX's, at 1x1, 3x3, 1x4 and 4x1, with
  per-lane loads; ``solve_frame_banded``'s pivots and ``frame_min_pivot``
  within 1e-10 relative.
- The level Cholesky against numpy at widths 3-63 within 1e-12, an
  all-NaN factor on a non-SPD block, the min pivot NaN for such a lane.
- ``block_thomas_solve``'s implicit adjoint: d/dI of a scalar of the
  solution against ``jax.grad`` of the same scalar within 1e-10 of the
  largest entry, d/d(loads) within 1e-10 relative, and ``gradcheck`` on a
  tiny system; at 20x2 (levels of width m = 63) the banded solve and its
  gradient equal the dense ones within 1e-10.
- ``solve_frame_checked``: flags and ``used_f64`` equal to JAX's on lanes
  clear of the thresholds, the escalated lane's float64 pivot within 1e-8
  relative (its condition is ~1e6), certified lanes within 5e-4 of the
  float64 dense solve, raise mode in both packages.
- TF32 off inside every solve, forward and backward, even when the caller
  asked for it, and the caller's setting restored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import FrameConfig as JFrameConfig
from openpystruct_tpu.fem import frame as jframe
from openpystruct_tpu.fem import frame_banded as jbanded
from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.fem import frame as tframe
from openpystruct_tpu_torch.fem import frame_banded as tbanded

CFG, JCFG = FrameConfig(), JFrameConfig()
TOPOLOGIES = [(1, 1), (3, 3), (1, 4), (4, 1)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small systems: one intra-op thread runs them faster than many,
    above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(nb, ns, B=3, seed=0):
    """I (B, E) around I0 and per-lane loads, float64 numpy."""
    rng = np.random.default_rng(seed + 13 * nb + ns)
    E = ns * (nb + 1) + ns * nb
    I = np.exp(rng.normal(size=(B, E)) * 0.5) * CFG.I0
    return I, rng.uniform(-2e4, -5e3, B), rng.uniform(5e3, 2e4, B)


def _rel(a, b):
    """max |a - b| relative to max |b| (tensors or arrays)."""
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _structures(nb, ns):
    return (jframe.build_frame(nb, ns, JCFG),
            tframe.build_frame(nb, ns, CFG, device="cpu"))


@pytest.mark.parametrize("nb,ns", TOPOLOGIES + [(10, 10), (2, 7)])
def test_build_frame_matches(nb, ns):
    js, ts = _structures(nb, ns)
    for name in ("node_xy", "elems", "is_beam", "fixed_mask",
                 "lateral_mask"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert (ts.num_bays, ts.num_stories) == (nb, ns)
    assert (ts.num_nodes, ts.num_elems) == (js.num_nodes, js.num_elems)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's frame_system, frame_blocks, both solves, the banded pivots and
    frame_min_pivot per topology, in float64: one jitted program each."""
    cache = {}

    def get(nb, ns):
        if (nb, ns) not in cache:
            js = jframe.build_frame(nb, ns, JCFG)

            def one(i, a, b):
                K, f, _ = jframe.frame_system(i, js, JCFG, jnp.float64, a, b)
                D, U, fb, _ = jbanded.frame_blocks(i, js, JCFG, jnp.float64,
                                                   a, b)
                dense = jframe.solve_frame(i, js, JCFG, jnp.float64, a, b,
                                           method="dense")
                banded, piv = jbanded.solve_frame_banded(
                    i, js, JCFG, jnp.float64, a, b)
                return dict(K=K, f=f, D=D, U=U, fb=fb, dense=dense,
                            banded=banded, piv=piv,
                            min_piv=jbanded.frame_min_pivot(
                                i, js, JCFG, jnp.float64))

            cache[nb, ns] = jax.jit(jax.vmap(one))(*_inputs(nb, ns))
        return cache[nb, ns]

    return get


@pytest.mark.parametrize("nb,ns", TOPOLOGIES)
def test_frame_system_and_blocks_match(nb, ns, jax_refs):
    ref = jax_refs(nb, ns)
    _, ts = _structures(nb, ns)
    I, w, p = map(torch.tensor, _inputs(nb, ns))
    K, f, _ = tframe.frame_system(I, ts, CFG, torch.float64, w, p)
    assert _rel(K, ref["K"]) <= 1e-12 and _rel(f, ref["f"]) <= 1e-12
    D, U, fb, _ = tbanded.frame_blocks(I, ts, CFG, torch.float64, w, p)
    assert D.shape == ref["D"].shape and U.shape == ref["U"].shape
    assert _rel(D, ref["D"]) <= 1e-12 and _rel(fb, ref["fb"]) <= 1e-12
    if ns > 1:
        assert _rel(U, ref["U"]) <= 1e-12
    else:   # one story: the base level is fixed, so U is all zeros
        assert not U.abs().max() and not np.abs(np.asarray(ref["U"])).max()


@pytest.mark.parametrize("method", ["dense", "banded"])
@pytest.mark.parametrize("nb,ns", TOPOLOGIES)
def test_solve_frame_matches(nb, ns, method, jax_refs):
    ref = jax_refs(nb, ns)
    _, ts = _structures(nb, ns)
    I, w, p = map(torch.tensor, _inputs(nb, ns))
    sol = tframe.solve_frame(I, ts, CFG, torch.float64, w, p, method=method)
    assert _rel(sol.displacements, ref[method].displacements) <= 1e-10
    assert _rel(sol.end_forces, ref[method].end_forces) <= 1e-10
    if method == "banded":
        _, piv = tbanded.solve_frame_banded(I, ts, CFG, torch.float64, w, p)
        np.testing.assert_allclose(piv.numpy(), np.asarray(ref["piv"]),
                                   rtol=1e-10)
        tmin = tbanded.frame_min_pivot(I, ts, CFG, torch.float64)
        np.testing.assert_allclose(tmin.numpy(), np.asarray(ref["min_piv"]),
                                   rtol=1e-10)
        assert (tmin.numpy() > tbanded.FRAME_VALID_PIVOT).all()


def test_wide_levels_banded_matches_dense():
    """20 bays: levels of width m = 63 (the JAX package switches to its
    panel-blocked factor from 49); the banded solve and its adjoint equal
    the dense ones within 1e-10."""
    _, ts = _structures(20, 2)
    I, w, p = map(torch.tensor, _inputs(20, 2, B=2, seed=7))
    grads = []
    for method in ("dense", "banded"):
        Iv = I.clone().requires_grad_(True)
        sol = tframe.solve_frame(Iv, ts, CFG, torch.float64, w, p,
                                 method=method)
        (sol.displacements ** 2).sum().backward()
        grads.append((sol, Iv.grad))
    (dense, gd), (banded, gb) = grads
    assert _rel(banded.displacements, dense.displacements) <= 1e-10
    assert _rel(banded.end_forces, dense.end_forces) <= 1e-10
    assert _rel(gb, gd) <= 1e-10


def test_unbatched_and_default_loads():
    """One lane without a batch axis and the config's loads equal the
    batched call's lane."""
    _, ts = _structures(2, 3)
    I, _, _ = _inputs(2, 3)
    one = tframe.solve_frame(torch.tensor(I[1]), ts, CFG, torch.float64)
    many = tframe.solve_frame(torch.tensor(I), ts, CFG, torch.float64)
    assert one.displacements.shape == (ts.num_nodes, 3)
    assert torch.equal(one.end_forces, many.end_forces[1])


def test_chol_matches_numpy_at_all_widths():
    rng = np.random.default_rng(1)
    for m in (3, 7, 16, 21, 33, 48, 49, 63):
        A = rng.standard_normal((2, m, m))
        A = A @ A.transpose(0, 2, 1) + m * np.eye(m)
        C = tbanded._chol(torch.tensor(A)).numpy()
        ref = np.linalg.cholesky(A)
        np.testing.assert_allclose(C, ref, atol=1e-12 * np.abs(ref).max())


def test_chol_non_spd_gives_nan():
    A = np.stack([np.eye(21), np.eye(21)])
    A[1, 17, 17] = -1.0
    C = tbanded._chol(torch.tensor(A))
    assert torch.equal(C[0], torch.eye(21, dtype=C.dtype))
    assert torch.isnan(C[1]).all()
    piv = tbanded._min_pivot([C])
    assert piv[0] == 1.0 and torch.isnan(piv[1])


def test_thomas_gradient_matches_jax():
    """d/dI of a scalar of the banded solution through the implicit
    adjoint, and d/d(udl, lateral_load)."""
    js, ts = _structures(3, 4)
    I = _inputs(3, 4, B=1, seed=11)[0][0]

    def jloss(i):
        sol, _ = jbanded.solve_frame_banded(i, js, JCFG, jnp.float64)
        return jnp.sum(sol.displacements ** 2) + jnp.sum(
            sol.end_forces[:, 1] ** 2) * 1e-12

    g_ref = np.asarray(jax.jit(jax.grad(jloss))(I))
    It = torch.tensor(I, requires_grad=True)
    sol, _ = tbanded.solve_frame_banded(It, ts, CFG, torch.float64)
    (torch.sum(sol.displacements ** 2)
     + torch.sum(sol.end_forces[:, 1] ** 2) * 1e-12).backward()
    assert _rel(It.grad, g_ref) <= 1e-10

    def jload(w, p):
        sol, _ = jbanded.solve_frame_banded(I, js, JCFG, jnp.float64, w, p)
        return jnp.sum(sol.displacements ** 2)

    gw, gp = jax.jit(jax.grad(jload, argnums=(0, 1)))(CFG.udl,
                                                     CFG.lateral_load)
    w, p = (torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for v in (CFG.udl, CFG.lateral_load))
    sol, _ = tbanded.solve_frame_banded(torch.tensor(I), ts, CFG,
                                        torch.float64, w, p)
    (sol.displacements ** 2).sum().backward()
    np.testing.assert_allclose([float(w.grad), float(p.grad)],
                               [float(gw), float(gp)], rtol=1e-10)


def test_thomas_gradcheck():
    """The implicit adjoint against finite differences on a tiny system
    (3 levels of width 2; D symmetric positive definite by construction,
    perturbed symmetrically)."""
    rng = np.random.default_rng(4)
    A = torch.tensor(0.3 * rng.normal(size=(2, 3, 2, 2)), requires_grad=True)
    U = torch.tensor(0.3 * rng.normal(size=(2, 2, 2, 2)),
                     requires_grad=True)
    f = torch.tensor(rng.normal(size=(2, 3, 2)), requires_grad=True)

    def solve(A, U, f):
        D = A + A.mT + 4.0 * torch.eye(2, dtype=A.dtype)
        return tbanded.block_thomas_solve(D, U, f)[0]

    assert torch.autograd.gradcheck(solve, (A, U, f))


def test_thomas_pivot_has_no_gradient():
    D = torch.eye(3, dtype=torch.float64).repeat(1, 2, 1, 1)
    U = torch.zeros(1, 1, 3, 3, dtype=torch.float64, requires_grad=True)
    f = torch.ones(1, 2, 3, dtype=torch.float64, requires_grad=True)
    x, piv = tbanded.block_thomas_solve(D, U, f)
    assert x.requires_grad and not piv.requires_grad


@pytest.fixture(scope="module")
def checked_case():
    """3x4 frame, four lanes: three healthy, lane 3 at the near-clamp
    float32-garbage regime (80% of members at 1e-8), and JAX's answer."""
    js, ts = _structures(3, 4)
    rng = np.random.default_rng(1)
    Ib = np.exp(rng.normal(size=(4, js.num_elems)) * 0.5) * CFG.I0
    Ib[3, rng.choice(js.num_elems, size=int(0.8 * js.num_elems),
                     replace=False)] = 1e-8
    ref = jbanded.solve_frame_checked(jnp.asarray(Ib, jnp.float32), js,
                                      JCFG, tol=1e-4)
    return js, ts, Ib, ref


def test_solve_frame_checked_matches_jax(checked_case):
    js, ts, Ib, (jsol, jinfo) = checked_case
    sol, info = tbanded.solve_frame_checked(
        torch.tensor(Ib, dtype=torch.float32), ts, CFG, tol=1e-4)
    np.testing.assert_array_equal(info["used_f64"], jinfo["used_f64"])
    np.testing.assert_array_equal(info["used_f64"], [0, 0, 0, 1])
    assert (info["est"] <= 1e-4).all() and (jinfo["est"] <= 1e-4).all()
    # the escalated lane is float64 in both packages; its pivot ~1.2e-6 is
    # the smallest Schur pivot of a system of condition ~1e6, whose
    # rounding is ~1e6 ulps of float64
    np.testing.assert_allclose(info["pivot"][3], jinfo["pivot"][3],
                               rtol=1e-8)
    assert sol.displacements.dtype == torch.float32
    for k in range(4):
        ref = jframe.solve_frame(jnp.asarray(Ib[k]), js, JCFG, jnp.float64,
                                 method="dense")
        assert _rel(sol.displacements[k].double(), ref.displacements) < 5e-4
        assert _rel(sol.displacements[k], jsol.displacements[k]) < 5e-4


def test_solve_frame_checked_raise_mode(checked_case):
    """A tolerance below the float64 bound eps64/pivot of lane 3 (~1.8e-10)
    cannot be certified: both packages raise, and warn by default."""
    js, ts, Ib, _ = checked_case
    for solve, st, cfg, arr in (
            (jbanded.solve_frame_checked, js, JCFG,
             jnp.asarray(Ib, jnp.float32)),
            (tbanded.solve_frame_checked, ts, CFG,
             torch.tensor(Ib, dtype=torch.float32))):
        with pytest.raises(ValueError, match="1 of 4 frame systems cannot"):
            solve(arr, st, cfg, tol=1e-11, on_fail="raise")
    with pytest.warns(RuntimeWarning, match="cannot be certified"):
        _, info = tbanded.solve_frame_checked(
            torch.tensor(Ib, dtype=torch.float32), ts, CFG, tol=1e-11)
    assert info["used_f64"].all()


@pytest.mark.parametrize("method", ["dense", "banded"])
def test_solves_run_without_tf32(monkeypatch, method):
    """With the caller's float32 matmul precision at "high", every
    factorization and solve of the frame path, forward and backward, runs at
    "highest", and the caller's setting is back afterwards."""
    seen = []
    for name in ("cholesky_ex", "solve_triangular", "solve"):
        real = getattr(torch.linalg, name)

        def spy(*a, _real=real, **k):
            seen.append(torch.get_float32_matmul_precision())
            return _real(*a, **k)

        monkeypatch.setattr(torch.linalg, name, spy)
    _, ts = _structures(2, 2)
    I = torch.tensor(_inputs(2, 2)[0], dtype=torch.float32,
                     requires_grad=True)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        sol = tframe.solve_frame(I, ts, CFG, method=method)
        n_forward = len(seen)
        sol.displacements.sum().backward()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert 0 < n_forward < len(seen)
    assert set(seen) == {"highest"}
