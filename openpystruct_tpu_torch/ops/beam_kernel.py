"""Fused beam FEA kernels: the whole linear-static analysis, and one whole
Adam iteration, per launch (port of the JAX package's
``ops/beam_kernel.py`` bending-only kernels).

Three public wrappers keep the JAX launchers' argument order and shapes:

- ``beam_analysis`` (``pallas_beam_analysis``, kernel ``_beam_kernel_b2``):
  element stiffness -> masked bending-only 2x2 block-tridiagonal assembly
  -> Jacobi scaling -> block-Thomas factorization (Schur inverses and
  back-substitution multipliers saved) fused with the forward sweep -> back
  sweep -> ``refine`` compensated-residual sweeps -> unscaling -> shear V
  and moment M recovery.  The min Schur pivot keeps its 3-DOF meaning:
  det3(S_i) = a_i * det2(S_i), with a_i the axial chain's scalar pivot.
- ``beam_opt_step`` (``pallas_beam_opt_step``, kernel
  ``_beam_opt_kernel_b2``): the same solve, the combined loss, its
  gradient (semi, or the exact adjoint: one more substitution pair and
  ``refine`` sweeps on the saved factors), and the Adam update with clamp.
  Given the epoch loop's ``LaneState``, the same launch also does the
  loop's freeze and early-stop bookkeeping (``freeze_lanes``), so that an
  epoch is one launch.
- ``beam_solve`` (``pallas_beam_solve``, kernel ``_beam_kernel`` with an
  explicit right-hand side): the 3-DOF assembly of K(I) (an arbitrary RHS
  may load the axial chain), masking, Jacobi scaling, block-Thomas with
  saved Sinv and C, ``refine`` compensated sweeps; the pivot is min_i
  |det3(S_i)|, without the axial-chain product.

The first two kernels live in ``csrc/beam_opt.cu``: one set of fused sweeps
per lane, with the analysis a last-sweep mode of the opt step's.  The
explicit-RHS solve's kernel (``csrc/beam_kernel.cu``) runs the same kind of
sweeps with one chain that carries the axial and the bending factorization
over the nonzeros of each 3x3 block.  All three read and write the callers'
lanes-first tensors directly: the wrappers copy no layout, and take only
contiguous tensors.

``beam_analysis`` is differentiable in I, the point loads and the UDL, as
``pallas_beam_analysis`` is through its ``custom_vjp``: the backward pass is
``_analysis_bwd`` line for line, one ``beam_solve`` of K lam = g_hat (K is
symmetric) and banded products.

The straight-beam system is block-diagonal per DOF class: the axial DOF
couples only to itself and has no load in the scenario schema, so u_x is
exactly 0 and the 2x2 bending chain carries the whole solution.

Each wrapper sends a CPU tensor to the plain PyTorch version beside it
(``beam_analysis_reference``, ``beam_opt_step_reference``,
``beam_solve_reference``), and launches the CUDA kernel
(``csrc/beam_opt.cu``, ``csrc/beam_kernel.cu``) on a CUDA tensor, or
raises.  There is no fallback from the kernel to the plain version.
``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the calls the
wrappers sent to the plain versions.  While a profiler records,
``beam_analysis`` and ``beam_opt_step`` also count each call, kernel or
plain, as ``utils.profiling.count("launch", 1, kind=, lanes=, n=,
refine=)``, and ``beam_opt_step`` given a lane state counts
``count("freeze_fused", 1, lanes=)`` too.

The plain versions repeat the kernels' arithmetic in the same order:
vectorised over the batch and, where no recurrence runs, over the nodes;
the recurrences are Python loops over nodes.  They are dtype-generic
(float64 on the CPU in the tests, float32 or float64 on the card in
``chip_smoke.py``) and use the kernels' analytic gradient formulas, not
autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from openpystruct_tpu_torch.fem.solve import two_prod, two_sum
from openpystruct_tpu_torch.ops import _build
from openpystruct_tpu_torch.ops.block_tridiag import (
    _inv3,
    _mm,
    _mtm,
    _mtv,
    _mv,
)
from openpystruct_tpu_torch.utils.profiling import count

LAUNCHES = {"beam_analysis": 0, "beam_opt_step": 0, "beam_solve": 0}
PLAIN_CALLS = {"beam_analysis": 0, "beam_opt_step": 0, "beam_solve": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  Per-node quantities are (B, n) tensors, one per
# component; recurrences walk lists of (B,) columns.
# ---------------------------------------------------------------------------


def _stiffness(I, Le, E, EA):
    """ks per element: EA/Le, 12EI/Le^3, 6EI/Le^2, 4EI/Le, 2EI/Le."""
    inv_le = 1.0 / Le
    eil = E * I * inv_le
    eil2 = eil * inv_le
    eil3 = eil2 * inv_le
    return (EA * inv_le, 12.0 * eil3, 6.0 * eil2, 4.0 * eil, 2.0 * eil)


def _assemble_b2(ks, Le, free, loads, udl):
    """Masked bending-only assembly: diag [d_ww, d_wt, d_tt], upper
    [u00, u01, u10, u11] (row i couples node i to i+1; the last row is 0),
    RHS [f_w, f_t], and the axial chain's unmasked-diagonal d00 and u00.
    Constrained rows/columns are zeroed and the original diagonal entry
    restored on the diagonal."""
    ea_p, k11_p, k12_p, k13_p, _ = (F.pad(k, (1, 0)) for k in ks)  # elem i-1
    ea_n, k11_n, k12_n, k13_n, k2_n = (F.pad(k, (0, 1)) for k in ks)  # elem i
    d11 = k11_p + k11_n
    d12 = -k12_p + k12_n
    d22 = k13_p + k13_n
    f0, f1, f2 = free.unbind(-1)
    fn0, fn1, fn2 = torch.cat([free[:, 1:], free[:, -1:]], dim=1).unbind(-1)
    diag = (d11 * (f1 * f1 + (1.0 - f1)), d12 * (f1 * f2),
            d22 * (f2 * f2 + (1.0 - f2)))
    upper = (-(k11_n * (f1 * fn1)), k12_n * (f1 * fn2),
             -(k12_n * (f2 * fn1)), k2_n * (f2 * fn2))
    # consistent UDL loads + nodal point loads (no axial load exists)
    Le_p, Le_n = F.pad(Le, (1, 0)), F.pad(Le, (0, 1))
    w = udl[:, None]
    fy = (Le_p + Le_n) * w * 0.5 + loads
    fm = (Le_n * Le_n - Le_p * Le_p) * w / 12.0
    rhs = (fy * f1, fm * f2)
    ax = ((ea_p + ea_n) * (f0 * f0 + (1.0 - f0)), -ea_n * (f0 * fn0))
    return diag, upper, rhs, ax


def _scale_b2(diag, upper, rhs):
    """Jacobi scaling s = rsqrt(diag) of the bending system."""
    s0, s1 = torch.rsqrt(diag[0]), torch.rsqrt(diag[2])
    diag = (diag[0] * s0 * s0, diag[1] * s0 * s1, diag[2] * s1 * s1)
    rhs = (rhs[0] * s0, rhs[1] * s1)
    one = torch.ones_like(s0[:, :1])
    n0, n1 = torch.cat([s0[:, 1:], one], 1), torch.cat([s1[:, 1:], one], 1)
    upper = (upper[0] * s0 * n0, upper[1] * s0 * n1,
             upper[2] * s1 * n0, upper[3] * s1 * n1)
    return diag, upper, rhs, (s0, s1)


def _inv2_sym(m0, m1, m2):
    """Inverse and determinant of the symmetric 2x2 [[m0, m1], [m1, m2]]."""
    det = m0 * m2 - m1 * m1
    inv_det = 1.0 / det
    return m2 * inv_det, -(m1 * inv_det), m0 * inv_det, det


def _cols(ts):
    return [list(t.unbind(1)) for t in ts]


def _stack(cols):
    return tuple(torch.stack(c, dim=1) for c in cols)


def _factor_b2(diag, upper, rhs, with_c, ax=None):
    """Block-Thomas factorization of the bending chain fused with the
    forward sweep.  Returns (sinv, c or None, y, pivot or None); the pivot
    is min_i a_i |det2(S_i)| when the axial chain ``ax`` is given."""
    d0, d1, d2 = _cols(diag)
    u00, u01, u10, u11 = _cols(upper)
    r0, r1 = _cols(rhs)
    n = len(d0)
    s00, s01, s11, det = _inv2_sym(d0[0], d1[0], d2[0])
    S = [[s00], [s01], [s11]]
    if with_c:
        C = [[s00 * u00[0] + s01 * u10[0]], [s00 * u01[0] + s01 * u11[0]],
             [s01 * u00[0] + s11 * u10[0]], [s01 * u01[0] + s11 * u11[0]]]
    Y = [[s00 * r0[0] + s01 * r1[0]], [s01 * r0[0] + s11 * r1[0]]]
    det = torch.abs(det)
    if ax is not None:
        a0, a1 = _cols(ax)
        r = torch.rsqrt(a0[0])
        a_prev = a0[0] * (r * r)
        piv = a_prev * det
    for i in range(1, n):
        p00, p01, p10, p11 = u00[i - 1], u01[i - 1], u10[i - 1], u11[i - 1]
        if with_c:
            w00, w01, w10, w11 = (C[k][i - 1] for k in range(4))
        else:
            q00, q01, q11 = S[0][i - 1], S[1][i - 1], S[2][i - 1]
            w00 = q00 * p00 + q01 * p10
            w01 = q00 * p01 + q01 * p11
            w10 = q01 * p00 + q11 * p10
            w11 = q01 * p01 + q11 * p11
        # S_i = D_i - U^T W (symmetric)
        s00, s01, s11, det = _inv2_sym(
            d0[i] - (p00 * w00 + p10 * w10),
            d1[i] - (p00 * w01 + p10 * w11),
            d2[i] - (p01 * w01 + p11 * w11),
        )
        S[0].append(s00)
        S[1].append(s01)
        S[2].append(s11)
        if with_c:
            C[0].append(s00 * u00[i] + s01 * u10[i])
            C[1].append(s00 * u01[i] + s01 * u11[i])
            C[2].append(s01 * u00[i] + s11 * u10[i])
            C[3].append(s01 * u01[i] + s11 * u11[i])
        # fused forward substitution y_i = Sinv_i (f_i - U^T y_{i-1})
        y0, y1 = Y[0][i - 1], Y[1][i - 1]
        q0 = r0[i] - (p00 * y0 + p10 * y1)
        q1 = r1[i] - (p01 * y0 + p11 * y1)
        Y[0].append(s00 * q0 + s01 * q1)
        Y[1].append(s01 * q0 + s11 * q1)
        if ax is not None:
            # axial Schur chain a_i = d00s_i - u00s_{i-1}^2 / a_{i-1}
            r_prev, r_cur = torch.rsqrt(a0[i - 1]), torch.rsqrt(a0[i])
            u00s = a1[i - 1] * r_prev * r_cur
            d00s = a0[i] * r_cur * r_cur
            a_prev = d00s - u00s * u00s / a_prev
            piv = torch.minimum(piv, a_prev * torch.abs(det))
    return (_stack(S), _stack(C) if with_c else None, Y,
            piv if ax is not None else None)


def _bsub_b2(X, upper, sinv, c=None):
    """x_i = y_i - C_i x_{i+1} in place on the column lists ``X`` (C from
    ``c`` when saved, else Sinv_i (U_i x_{i+1}))."""
    n = len(X[0])
    if c is not None:
        c00, c01, c10, c11 = _cols(c)
    else:
        u00, u01, u10, u11 = _cols(upper)
        s00, s01, s11 = _cols(sinv)
    for i in range(n - 2, -1, -1):
        x0, x1 = X[0][i + 1], X[1][i + 1]
        if c is not None:
            v0 = c00[i] * x0 + c01[i] * x1
            v1 = c10[i] * x0 + c11[i] * x1
        else:
            t0 = u00[i] * x0 + u01[i] * x1
            t1 = u10[i] * x0 + u11[i] * x1
            v0 = s00[i] * t0 + s01[i] * t1
            v1 = s01[i] * t0 + s11[i] * t1
        X[0][i] = X[0][i] - v0
        X[1][i] = X[1][i] - v1
    return X


def _subst_b2(rhs, upper, sinv, c=None):
    """Solve K_s x = rhs with the saved factors; returns (x0, x1)."""
    X = _cols(rhs)
    u00, u01, u10, u11 = _cols(upper)
    s00, s01, s11 = _cols(sinv)
    r0, r1 = X[0][0], X[1][0]
    X[0][0] = s00[0] * r0 + s01[0] * r1
    X[1][0] = s01[0] * r0 + s11[0] * r1
    for i in range(1, len(s00)):
        x0, x1 = X[0][i - 1], X[1][i - 1]
        r0 = X[0][i] - (u00[i - 1] * x0 + u10[i - 1] * x1)
        r1 = X[1][i] - (u01[i - 1] * x0 + u11[i - 1] * x1)
        X[0][i] = s00[i] * r0 + s01[i] * r1
        X[1][i] = s01[i] * r0 + s11[i] * r1
    return _stack(_bsub_b2(X, upper, sinv, c))


def _refine_b2(refine, diag, upper, sinv, rhs, x, c=None):
    """``refine`` sweeps: an error-free residual r = rhs - K_s x, one
    substitution against the saved factors, x += correction."""
    n = x[0].shape[1]
    ar = torch.arange(n, device=x[0].device)
    ip, iq = (ar - 1).clamp(min=0), ar.clamp(max=n - 2)
    d0, d1, d2 = diag
    lm = [[upper[0][:, ip], upper[2][:, ip]],
          [upper[1][:, ip], upper[3][:, ip]]]          # U_{i-1}^T
    um = [[upper[0][:, iq], upper[1][:, iq]],
          [upper[2][:, iq], upper[3][:, iq]]]          # U_i
    md = [[d0, d1], [d1, d2]]
    for _ in range(refine):
        x_p = [F.pad(v[:, :-1], (1, 0)) for v in x]
        x_n = [F.pad(v[:, 1:], (0, 1)) for v in x]
        work = []
        for a in range(2):
            acc_s = rhs[a]
            acc_c = torch.zeros_like(acc_s)
            for b in range(2):
                for mat, vec in ((md, x), (lm, x_p), (um, x_n)):
                    p, e = two_prod(-mat[a][b], vec[b])
                    acc_s, e2 = two_sum(acc_s, p)
                    acc_c = acc_c + e2 + e
            work.append(acc_s + acc_c)
        corr = _subst_b2(work, upper, sinv, c)
        x = (x[0] + corr[0], x[1] + corr[1])
    return x


def _forces(ks, Le, udl, uy, th):
    """Element end shear V and moment M: k_e [u_i; u_j] - f_eq."""
    _, k11, k12, k13, k2 = ks
    uy_i, th_i, uy_j, th_j = uy[:, :-1], th[:, :-1], uy[:, 1:], th[:, 1:]
    w = udl[:, None]
    V = k11 * uy_i + k12 * th_i - k11 * uy_j + k12 * th_j - w * Le * 0.5
    M = (k12 * uy_i + k13 * th_i - k12 * uy_j + k2 * th_j
         - w * Le * Le / 12.0)
    return V, M


def _solve_b2(I, Le, free, point_loads, udl, E, A, refine, analysis):
    ks = _stiffness(I, Le, E, E * A)
    diag, upper, rhs, ax = _assemble_b2(ks, Le, free, point_loads, udl)
    diag, upper, rhs, s = _scale_b2(diag, upper, rhs)
    # the analysis saves C and tracks the axial chain; the opt step
    # recomputes Sinv (U x) in the back sweep and reads no pivot
    sinv, c, Y, piv = _factor_b2(diag, upper, rhs, with_c=analysis,
                                 ax=ax if analysis else None)
    y = _stack(_bsub_b2(Y, upper, sinv, c))
    y = _refine_b2(refine, diag, upper, sinv, rhs, y, c)
    return ks, diag, upper, rhs, s, sinv, c, y, piv


def beam_analysis_reference(I, Le, free_mask, point_loads, udl, E, A,
                            refine=1):
    """Plain version of the fused analysis.  I, Le (B, nelem); free_mask
    (B, n, 3) 0/1; point_loads (B, n); udl (B,).  Returns u (B, n, 3), V,
    M (B, nelem), pivot (B,)."""
    ks, _, _, _, s, _, _, y, piv = _solve_b2(
        I, Le, free_mask, point_loads, udl, E, A, refine, analysis=True)
    uy, th = y[0] * s[0], y[1] * s[1]
    ux = (y[0][:, :1] * 0.0).expand_as(uy)      # u_x == 0 exactly
    V, M = _forces(ks, Le, udl, uy, th)
    return torch.stack([ux, uy, th], dim=-1), V, M, piv


def beam_opt_step_reference(I, mu, nu, Le, free_mask, point_loads, udl,
                            lr_t, bc1, bc2, E, A, G, alpha_m=1e-2,
                            alpha_s=1e-2, clamp_min=1e-8, grad_semi=True,
                            refine=1):
    """Plain version of one fused Adam iteration.  Returns I_new, mu_new,
    nu_new (B, nelem) and stats (B, 4): total, primary, bending, shear."""
    ks, diag, upper, _, s, sinv, _, y, _ = _solve_b2(
        I, Le, free_mask, point_loads, udl, E, A, refine, analysis=False)
    uy, th = y[0] * s[0], y[1] * s[1]
    V, M = _forces(ks, Le, udl, uy, th)

    den_b = 2.0 * E * I + 1e-6
    den_s = G * (0.03 * torch.sqrt(I))
    be = M * M / den_b
    se = V * V / den_s
    # explicit dL/dI with M, V held constant: the semi-gradient
    g = 1.0 - alpha_m * be * 2.0 * E / den_b - alpha_s * 0.5 * se / I
    if not grad_semi:
        # loss cotangents on the force fields
        gV = alpha_s * 2.0 * V / den_s
        gM = alpha_m * 2.0 * M / den_b
        # (dK_e/dI_e) u_e rows; also the direct dV/dI, dM/dI at fixed u
        uy_i, th_i, uy_j, th_j = uy[:, :-1], th[:, :-1], uy[:, 1:], th[:, 1:]
        c1 = E / (Le * Le * Le)
        r_uyi = c1 * (12.0 * (uy_i - uy_j) + 6.0 * Le * (th_i + th_j))
        r_thi = c1 * Le * (6.0 * (uy_i - uy_j)
                           + Le * (4.0 * th_i + 2.0 * th_j))
        r_thj = c1 * Le * (6.0 * (uy_i - uy_j)
                           + Le * (2.0 * th_i + 4.0 * th_j))
        g = g + gV * r_uyi + gM * r_thi
        # adjoint RHS g_hat = (dV/du)^T gV + (dM/du)^T gM, masked, scaled
        gV_p, gM_p = F.pad(gV, (1, 0)), F.pad(gM, (1, 0))
        gV_n, gM_n = F.pad(gV, (0, 1)), F.pad(gM, (0, 1))
        nelem = I.shape[1]
        ar = torch.arange(nelem + 1, device=I.device)
        jp, jn = (ar - 1).clamp(0, nelem - 1), ar.clamp(0, nelem - 1)
        k1, k2_, k3, k4 = ks[1], ks[2], ks[3], ks[4]
        gy = (gV_n * k1[:, jn] + gM_n * k2_[:, jn]
              - gV_p * k1[:, jp] - gM_p * k2_[:, jp])
        gt = (gV_n * k2_[:, jn] + gM_n * k3[:, jn]
              + gV_p * k2_[:, jp] + gM_p * k4[:, jp])
        ghat = (gy * free_mask[..., 1] * s[0], gt * free_mask[..., 2] * s[1])
        # K lam = g_hat with the saved factors (K is symmetric)
        lam = _subst_b2(ghat, upper, sinv)
        lam = _refine_b2(refine, diag, upper, sinv, ghat, lam)
        ly, lt = lam[0] * s[0], lam[1] * s[1]
        g = g - ((ly[:, :-1] - ly[:, 1:]) * r_uyi + lt[:, :-1] * r_thi
                 + lt[:, 1:] * r_thj)

    return (*_adam_step(I, mu, nu, g, lr_t, bc1, bc2, clamp_min),
            _loss_stats(I, be, se, alpha_m, alpha_s))


def _loss_stats(I, be, se, alpha_m, alpha_s):
    """(B, 4): total, primary, alpha_m * bending, alpha_s * shear."""
    return torch.stack([I.sum(1) + alpha_m * be.sum(1) + alpha_s * se.sum(1),
                        I.sum(1), alpha_m * be.sum(1), alpha_s * se.sum(1)],
                       dim=1)


def _adam_step(I, mu, nu, g, lr_t, bc1, bc2, clamp_min):
    """Adam, torch-identical: bias-corrected moments, post-step clamp on I
    (not on the moments).  Returns I_new, mu_new, nu_new."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu_new = b1 * mu + (1.0 - b1) * g
    nu_new = b2 * nu + (1.0 - b2) * g * g
    step = lr_t * (mu_new * bc1) / (torch.sqrt(nu_new * bc2) + eps)
    return torch.clamp_min(I - step, clamp_min), mu_new, nu_new


class LaneState(NamedTuple):
    """The epoch loop's per-lane early-stopping state at an epoch's start
    (``opt/beam_opt.py`` ``_lane_state_init``), for
    ``beam_opt_step(lane_state=)``, which updates the tensors in place."""

    done: torch.Tensor         # (B,) bool
    best: torch.Tensor         # (B,) the best total so far
    no_improve: torch.Tensor   # (B,) int32, epochs without improvement
    n_epochs: torch.Tensor     # (B,) int32, epochs run
    I_solved: torch.Tensor     # (B, nelem) the I the last step solved at
    stats: torch.Tensor        # (B, 4) the previous epoch's loss stats
    tolerance: float
    patience: int


#: the tensors of a ``LaneState`` that an epoch updates in place
_LANE_TENSORS = ("done", "best", "no_improve", "n_epochs", "I_solved")


def freeze_lanes(I, mu, nu, step, st: LaneState) -> dict:
    """One epoch's freeze and early-stop bookkeeping, out of place: the
    state after the step ``step = (I_new, mu_new, nu_new, stats)`` taken at
    ``I, mu, nu``.  A lane active on entry takes the step, saves I as its
    last solved I and compares the step's total with its best; a done lane
    keeps its state.  Returns the loop's state dict (``I``, ``I_solved``,
    ``mu``, ``nu``, ``n_epochs``, ``best``, ``no_improve``, ``done``,
    ``stats``)."""
    I_new, mu_new, nu_new, stats = step
    active = ~st.done
    am = active[:, None]
    total = stats[:, 0]
    improved = total < st.best - st.tolerance
    no_improve = torch.where(
        active,
        torch.where(improved, torch.zeros_like(st.no_improve),
                    st.no_improve + 1),
        st.no_improve,
    )
    return dict(
        I=torch.where(am, I_new, I),
        I_solved=torch.where(am, I, st.I_solved),
        mu=torch.where(am, mu_new, mu),
        nu=torch.where(am, nu_new, nu),
        n_epochs=st.n_epochs + active.to(torch.int32),
        best=torch.where(active & improved, total, st.best),
        no_improve=no_improve,
        done=st.done | (no_improve >= st.patience),
        stats=torch.where(am, stats, st.stats),
    )


# ---------------------------------------------------------------------------
# Plain version of the 3-DOF explicit-RHS solve: (B, n, 3, 3) blocks, the
# recurrences Python loops over nodes.
# ---------------------------------------------------------------------------


def _assemble3(ks, free, rhs):
    """Masked 3-DOF assembly with an explicit RHS: diag and upper (B, n, 3,
    3) (upper row i couples node i to i+1; the last row is 0), f (B, n, 3)."""
    ea_p, k11_p, k12_p, k13_p, _ = (F.pad(k, (1, 0)) for k in ks)  # elem i-1
    ea_n, k11_n, k12_n, k13_n, k2_n = (F.pad(k, (0, 1)) for k in ks)  # elem i
    d00 = ea_p + ea_n
    d11 = k11_p + k11_n
    d12 = -k12_p + k12_n
    d22 = k13_p + k13_n
    f0, f1, f2 = free.unbind(-1)
    fn0, fn1, fn2 = torch.cat([free[:, 1:], free[:, -1:]], dim=1).unbind(-1)
    z = torch.zeros_like(d00)

    def blocks(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    diag = blocks([[d00 * f0 * f0 + d00 * (1.0 - f0), z, z],
                   [z, d11 * f1 * f1 + d11 * (1.0 - f1), d12 * f1 * f2],
                   [z, d12 * f2 * f1, d22 * f2 * f2 + d22 * (1.0 - f2)]])
    upper = blocks([[-ea_n * f0 * fn0, z, z],
                    [z, -k11_n * f1 * fn1, k12_n * f1 * fn2],
                    [z, -k12_n * f2 * fn1, k2_n * f2 * fn2]])
    return diag, upper, rhs * free


def _scale3(diag, upper, f):
    """Jacobi scaling s = rsqrt(diag); the last upper row stays as is."""
    s = torch.rsqrt(torch.diagonal(diag, dim1=-2, dim2=-1))
    diag = diag * s[..., :, None] * s[..., None, :]
    upper = torch.cat([upper[:, :-1] * s[:, :-1, :, None] * s[:, 1:, None, :],
                       upper[:, -1:]], dim=1)
    return diag, upper, f * s, s


def _det3(m):
    """The TPU kernel's ``_det3`` expansion."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _factor3(diag, upper, f):
    """Factorization saving Sinv and C, fused with the forward sweep.
    Returns sinv, c (B, n, 3, 3), y (B, n, 3) and min_i |det3(S_i)|."""
    s = diag[:, 0]
    piv = torch.abs(_det3(s))
    sinv = [_inv3(s)]
    c = [_mm(sinv[0], upper[:, 0])]
    y = [_mv(sinv[0], f[:, 0])]
    for i in range(1, diag.shape[1]):
        u_prev = upper[:, i - 1]
        s = diag[:, i] - _mtm(u_prev, c[-1])
        sinv.append(_inv3(s))
        c.append(_mm(sinv[-1], upper[:, i]))
        y.append(_mv(sinv[-1], f[:, i] - _mtv(u_prev, y[-1])))
        piv = torch.minimum(piv, torch.abs(_det3(s)))
    return (torch.stack(sinv, 1), torch.stack(c, 1), torch.stack(y, 1), piv)


def _bsub3(y, c):
    """x_i = y_i - C_i x_{i+1} from x_{n-1} = y_{n-1}."""
    xs = [y[:, -1]]
    for i in range(y.shape[1] - 2, -1, -1):
        xs.append(y[:, i] - _mv(c[:, i], xs[-1]))
    return torch.stack(xs[::-1], 1)


def _subst3(r, upper, sinv, c):
    """Solve K_s x = r with the saved factors."""
    ys = [_mv(sinv[:, 0], r[:, 0])]
    for i in range(1, r.shape[1]):
        ys.append(_mv(sinv[:, i], r[:, i] - _mtv(upper[:, i - 1], ys[-1])))
    return _bsub3(torch.stack(ys, 1), c)


def _refine3(refine, diag, upper, sinv, c, f, x):
    """``refine`` sweeps: an error-free residual f - K_s x, one substitution
    with the saved factors, x += correction."""
    n = x.shape[1]
    ar = torch.arange(n, device=x.device)
    ip, iq = (ar - 1).clamp(min=0), ar.clamp(max=max(n - 2, 0))
    lm = upper[:, ip].transpose(-1, -2)     # U_{i-1}^T
    um = upper[:, iq]                       # U_i
    for _ in range(refine):
        x_p = F.pad(x[:, :-1], (0, 0, 1, 0))
        x_n = F.pad(x[:, 1:], (0, 0, 0, 1))
        work = []
        for a in range(3):
            acc_s = f[..., a]
            acc_c = torch.zeros_like(acc_s)
            for b in range(3):
                for mat, vec in ((diag, x), (lm, x_p), (um, x_n)):
                    p, e = two_prod(-mat[..., a, b], vec[..., b])
                    acc_s, e2 = two_sum(acc_s, p)
                    acc_c = acc_c + e2 + e
            work.append(acc_s + acc_c)
        x = x + _subst3(torch.stack(work, -1), upper, sinv, c)
    return x


def beam_solve_reference(I, Le, free_mask, rhs, E, A, refine=1):
    """Plain version of the explicit-RHS solve.  I, Le (B, nelem);
    free_mask (B, n, 3) 0/1; rhs (B, n, 3).  Returns x (B, n, 3) and the
    pivot min_i |det3(S_i)| (B,)."""
    ks = _stiffness(I, Le, E, E * A)
    diag, upper, f = _assemble3(ks, free_mask, rhs)
    diag, upper, f, s = _scale3(diag, upper, f)
    sinv, c, y, piv = _factor3(diag, upper, f)
    y = _refine3(refine, diag, upper, sinv, c, f, _bsub3(y, c))
    return y * s, piv


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The library of the explicit-RHS solve kernel
    (``csrc/beam_kernel.cu``), with the argument types of its C entry
    points."""
    lib = _build.load("beam_kernel")
    lib.beam_solve_f32.argtypes = [_P] * 7 + [_I] * 3 + [_F] * 2 + [_P]
    lib.beam_solve_scratch_per_node.argtypes = []
    for fn in (lib.beam_solve_f32, lib.beam_solve_scratch_per_node):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _opt_lib():
    """The library of the fused-sweep kernels, the opt step and the
    analysis (``csrc/beam_opt.cu``)."""
    lib = _build.load("beam_opt")
    lib.beam_opt_step_f32.argtypes = ([_P] * 18 + [_I] * 5 + [_F] * 9
                                      + [_P])
    lib.beam_opt_scratch_per_node.argtypes = [_I]
    lib.beam_analysis_f32.argtypes = [_P] * 10 + [_I] * 3 + [_F] * 2 + [_P]
    lib.beam_analysis_scratch_per_node.argtypes = []
    for fn in (lib.beam_opt_step_f32, lib.beam_opt_scratch_per_node,
               lib.beam_analysis_f32, lib.beam_analysis_scratch_per_node):
        fn.restype = _I
    return lib


def _check(device, **tensors):
    """Raise unless every tensor is float32 on ``device`` with the given
    shape (``name=(tensor, shape)``)."""
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernels take float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def _run(rc, name, launches=LAUNCHES):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1


def _check_lanes_first(name, I, Le, free_mask, point_loads=None, udl=None,
                       mu=None, nu=None, rhs=None):
    """Raise unless the inputs are the callers' lanes-first float32
    tensors, contiguous on one CUDA device: I, Le (and the opt step's mu,
    nu) (B, nelem), free_mask (and the solve's rhs) (B, n, 3), point_loads
    (B, n), udl (B,), nelem >= 1.  The fused-sweep kernels read them as they
    lie and copy none."""
    B, nelem = I.shape
    n = nelem + 1
    if nelem < 1:
        raise ValueError(f"{name} needs at least one element")
    ins = dict(I=I, mu=mu, nu=nu, Le=Le, free_mask=free_mask,
               point_loads=point_loads, udl=udl, rhs=rhs)
    ins = {k: t for k, t in ins.items() if t is not None}
    shapes = dict(I=(B, nelem), mu=(B, nelem), nu=(B, nelem),
                  Le=(B, nelem), free_mask=(B, n, 3), point_loads=(B, n),
                  udl=(B,), rhs=(B, n, 3))
    _check(I.device, **{k: (t, shapes[k]) for k, t in ins.items()})
    for k, t in ins.items():
        if not t.is_contiguous():
            raise ValueError(f"{k} is not contiguous: the kernel reads the "
                             "lanes-first layout as it lies and copies none")
    if not I.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{I.device}")


def _check_lane_state(st, I):
    """Raise unless the lane state's tensors are contiguous on I's device
    with the shapes and dtypes the opt-step kernel updates in place."""
    B, nelem = I.shape
    want = dict(done=((B,), torch.bool), best=((B,), torch.float32),
                no_improve=((B,), torch.int32),
                n_epochs=((B,), torch.int32),
                I_solved=((B, nelem), torch.float32),
                stats=((B, 4), torch.float32))
    for name, (shape, dtype) in want.items():
        t = getattr(st, name)
        if t.device != I.device:
            raise ValueError(f"lane state {name} is on {t.device}, "
                             f"expected {I.device}")
        if t.dtype != dtype:
            raise TypeError(f"lane state {name} is {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"lane state {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"lane state {name} is not contiguous: the "
                             "kernel updates it as it lies")


def _sweep_scratch(per_node, n, B, dev):
    """The fused sweeps' private scratch (n, per_node, lanes padded to
    whole 32-lane blocks): the kernels stage 128-byte rows."""
    return torch.empty((n, per_node, -(-B // 32) * 32), dtype=torch.float32,
                       device=dev)


def launch_beam_analysis(I, Le, free_mask, point_loads, udl, E, A,
                         refine=1):
    """Launch the analysis kernel on the callers' lanes-first float32
    tensors, as they are (``_check_lanes_first``, before any build).
    Returns u (B, n, 3), V, M (B, nelem) and the pivot (B,)."""
    _check_lanes_first("beam_analysis", I, Le, free_mask, point_loads, udl)
    B, nelem = I.shape
    n = nelem + 1
    dev = I.device
    lib = _opt_lib()
    u = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    V = torch.empty_like(I)
    M = torch.empty_like(I)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = _sweep_scratch(lib.beam_analysis_scratch_per_node(), n, B, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.beam_analysis_f32(
            I.data_ptr(), Le.data_ptr(), free_mask.data_ptr(),
            point_loads.data_ptr(), udl.data_ptr(), u.data_ptr(),
            V.data_ptr(), M.data_ptr(), piv.data_ptr(), scratch.data_ptr(),
            B, n, int(refine), float(E), float(E * A), stream)
    _run(rc, "beam_analysis")
    return u, V, M, piv


def launch_beam_opt_step(I, mu, nu, Le, free_mask, point_loads, udl,
                         lr_t, bc1, bc2, E, G, alpha_m=1e-2, alpha_s=1e-2,
                         clamp_min=1e-8, grad_semi=True, refine=1,
                         lane_state=None):
    """Launch the opt-step kernel on the optimizer's lanes-first float32
    tensors, as they are (``_check_lanes_first``; ``_check_lane_state``).
    Returns I_new, mu_new, nu_new (B, nelem) and stats (B, 4); with a
    ``lane_state``, the launch also runs ``freeze_lanes``' bookkeeping,
    updating the state in place."""
    _check_lanes_first("beam_opt_step", I, Le, free_mask, point_loads, udl,
                       mu, nu)
    if lane_state is not None:
        _check_lane_state(lane_state, I)
    B, nelem = I.shape
    dev = I.device
    lib = _opt_lib()
    I_o, mu_o, nu_o = (torch.empty_like(I) for _ in range(3))
    stats = torch.empty((B, 4), dtype=torch.float32, device=dev)
    scratch = _sweep_scratch(
        lib.beam_opt_scratch_per_node(int(bool(grad_semi))), nelem + 1, B,
        dev)
    st = lane_state
    if st is None:    # NULL pointers: no bookkeeping
        st_ptrs, patience, tolerance = (0,) * 6, 0, 0.0
    else:
        st_ptrs = tuple(getattr(st, k).data_ptr()
                        for k in _LANE_TENSORS + ("stats",))
        patience, tolerance = int(st.patience), float(st.tolerance)

    def launch():
        return lib.beam_opt_step_f32(
            I.data_ptr(), mu.data_ptr(), nu.data_ptr(), Le.data_ptr(),
            free_mask.data_ptr(), point_loads.data_ptr(), udl.data_ptr(),
            I_o.data_ptr(), mu_o.data_ptr(), nu_o.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), *st_ptrs, B, nelem + 1,
            int(refine), int(bool(grad_semi)), patience, float(E), float(G),
            float(alpha_m), float(alpha_s), float(clamp_min), float(lr_t),
            float(bc1), float(bc2), tolerance,
            torch.cuda.current_stream(dev).cuda_stream)

    _run(_on_device(dev, launch), "beam_opt_step")
    return I_o, mu_o, nu_o, stats


def _on_device(dev, fn):
    """``fn()`` with ``dev`` the current CUDA device, where the runtime
    launches; entering ``torch.cuda.device`` only when it is not already."""
    if dev.index == torch.cuda.current_device():
        return fn()
    with torch.cuda.device(dev):
        return fn()


def launch_beam_solve(I, Le, free_mask, rhs, E, A, refine=1):
    """Launch the explicit-RHS solve kernel on the callers' lanes-first
    float32 tensors, as they are (``_check_lanes_first``, before any
    build): I, Le (B, nelem), free_mask, rhs (B, n, 3).  Returns x (B, n, 3)
    and the pivot (B,)."""
    _check_lanes_first("beam_solve", I, Le, free_mask, rhs=rhs)
    B, nelem = I.shape
    n = nelem + 1
    dev = I.device
    lib = _lib()
    x = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = _sweep_scratch(lib.beam_solve_scratch_per_node(), n, B, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.beam_solve_f32(
            I.data_ptr(), Le.data_ptr(), free_mask.data_ptr(),
            rhs.data_ptr(), x.data_ptr(), piv.data_ptr(), scratch.data_ptr(),
            B, n, int(refine), float(E), float(E * A), stream)
    _run(rc, "beam_solve")
    return x, piv


def beam_solve(I, Le, free_mask, rhs, E, A, refine=1):
    """Fused assembly and solve of K(I) x = rhs for an explicit (B, n, 3)
    right-hand side, constrained DOFs projected out (``pallas_beam_solve``).
    Returns x (B, n, 3) and the pivot (B,).  CPU tensors run the plain
    version; CUDA tensors (float32, contiguous) launch the kernel, with no
    layout copy."""
    if not I.is_cuda:
        PLAIN_CALLS["beam_solve"] += 1
        return beam_solve_reference(I, Le, free_mask, rhs, E, A, refine)
    return launch_beam_solve(I, Le, free_mask, rhs, E, A, refine)


def _analysis_forward(I, Le, free_mask, point_loads, udl, E, A, refine):
    if not I.is_cuda:
        PLAIN_CALLS["beam_analysis"] += 1
        return beam_analysis_reference(I, Le, free_mask, point_loads, udl,
                                       E, A, refine)
    return launch_beam_analysis(I, Le, free_mask, point_loads, udl, E, A,
                                refine)


class _BeamAnalysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, I, Le, free_mask, point_loads, udl, E, A, refine):
        u, V, M, piv = _analysis_forward(I, Le, free_mask, point_loads, udl,
                                         E, A, refine)
        ctx.save_for_backward(I, Le, free_mask, u)
        ctx.consts = (E, A, refine)
        ctx.mark_non_differentiable(piv)
        return u, V, M, piv

    @staticmethod
    def backward(ctx, gu, gV, gM, _gpiv):
        """``_analysis_bwd``: with K(I) u = f(loads, udl) and V, M linear in
        the element displacements with I-linear coefficients,
        g_hat = gu + (dV/du)^T gV + (dM/du)^T gM, lam = K^-1 g_hat (one
        explicit-RHS solve), gI_e = -lam_e^T (dK_e/dI_e) u_e + gV dV/dI +
        gM dM/dI, gloads = lam_y, gudl = lam . df/dw + the -w Le/2,
        -w Le^2/12 recovery terms.  Le and the mask get no gradient."""
        I, Le, free_mask, u = ctx.saved_tensors
        E, A, refine = ctx.consts
        k11 = 12.0 * E * I / Le**3
        k12 = 6.0 * E * I / Le**2
        k13 = 4.0 * E * I / Le
        k2 = 2.0 * E * I / Le

        # (dV/du)^T gV + (dM/du)^T gM scattered onto the nodal cotangent
        g_hat = gu.clone(memory_format=torch.contiguous_format)
        g_hat[:, :-1, 1] += gV * k11 + gM * k12
        g_hat[:, :-1, 2] += gV * k12 + gM * k13
        g_hat[:, 1:, 1] += -gV * k11 - gM * k12
        g_hat[:, 1:, 2] += gV * k12 + gM * k2
        g_hat = g_hat * free_mask
        if I.is_cuda:
            # the forward pass took contiguous tensors: the solve reads
            # them, and g_hat, as they lie
            assert all(t.is_contiguous() for t in (g_hat, I, Le, free_mask))

        lam, _ = beam_solve(I, Le, free_mask, g_hat, E, A, refine)

        uy_i, th_i = u[:, :-1, 1], u[:, :-1, 2]
        uy_j, th_j = u[:, 1:, 1], u[:, 1:, 2]
        ly_i, lt_i = lam[:, :-1, 1], lam[:, :-1, 2]
        ly_j, lt_j = lam[:, 1:, 1], lam[:, 1:, 2]
        # (dK_e/dI_e) u_e rows (bending block per unit I)
        c1 = E / Le**3
        r_uyi = c1 * (12.0 * (uy_i - uy_j) + 6.0 * Le * (th_i + th_j))
        r_thi = c1 * Le * (6.0 * (uy_i - uy_j)
                           + Le * (4.0 * th_i + 2.0 * th_j))
        r_thj = c1 * Le * (6.0 * (uy_i - uy_j)
                           + Le * (2.0 * th_i + 4.0 * th_j))
        gI_K = -(ly_i * r_uyi - ly_j * r_uyi + lt_i * r_thi + lt_j * r_thj)
        # direct dV/dI, dM/dI of the force recovery at fixed u
        gI = gI_K + gV * r_uyi + gM * r_thi
        # lam is zero at constrained DOFs: no masking needed
        gloads = lam[..., 1]
        Le_p, Le_n = F.pad(Le, (1, 0)), F.pad(Le, (0, 1))
        gudl = (torch.sum(lam[..., 1] * (Le_p + Le_n) * 0.5, dim=-1)
                + torch.sum(lam[..., 2] * (Le_n**2 - Le_p**2) / 12.0, dim=-1)
                - torch.sum(gV * Le * 0.5 + gM * Le**2 / 12.0, dim=-1))
        return gI, None, None, gloads, gudl, None, None, None


def beam_analysis(I, Le, free_mask, point_loads, udl, E, A, refine=1):
    """Fused batched beam FEA (``pallas_beam_analysis``), differentiable in
    I, point_loads and udl.

    I, Le (B, nelem); free_mask (B, n, 3) float 0/1, 1 where the DOF is
    free; point_loads (B, n) nodal Fy; udl (B,).  Returns u (B, n, 3),
    V (B, nelem), M (B, nelem) and the min Schur pivot (B,).  CPU tensors
    run the plain version; CUDA tensors (float32, contiguous) launch the
    kernel, with no layout copy.  The backward pass runs ``beam_solve``
    (kernel or plain version, by device).
    """
    count("launch", 1, kind="analysis", lanes=I.shape[0], n=I.shape[1] + 1,
          refine=refine)
    return _BeamAnalysis.apply(I, Le, free_mask, point_loads, udl, E, A,
                               refine)


def beam_opt_step(I, mu, nu, Le, free_mask, point_loads, udl, lr_t, bc1,
                  bc2, E, A, G, alpha_m=1e-2, alpha_s=1e-2, clamp_min=1e-8,
                  grad_semi=True, refine=1, lane_state=None):
    """One fused optimizer iteration for the whole batch
    (``pallas_beam_opt_step``): solve, combined loss, its gradient (semi or
    exact adjoint), Adam update and clamp.  ``lr_t``, ``bc1``, ``bc2`` are
    the epoch's learning rate and bias corrections 1/(1-b1^t), 1/(1-b2^t).
    Returns I_new, mu_new, nu_new (B, nelem) and stats (B, 4): total,
    primary, bending energy, shear energy.  CPU tensors run the plain
    version; CUDA tensors (float32, contiguous) launch the kernel, with no
    layout copy.

    ``lane_state`` (a ``LaneState``) makes this the epoch loop's whole
    epoch: the returned I, mu, nu and stats are ``freeze_lanes``' (a lane
    done on entry returns its inputs and previous stats) and the state's
    tensors are updated in place.  It is counted as
    ``count("freeze_fused", 1, lanes=B)``.
    """
    count("launch", 1, kind="semi" if grad_semi else "adjoint",
          lanes=I.shape[0], n=I.shape[1] + 1, refine=refine)
    if lane_state is not None:
        count("freeze_fused", 1, lanes=I.shape[0])
    if I.is_cuda:
        return launch_beam_opt_step(I, mu, nu, Le, free_mask, point_loads,
                                    udl, lr_t, bc1, bc2, E, G, alpha_m,
                                    alpha_s, clamp_min, grad_semi, refine,
                                    lane_state)
    PLAIN_CALLS["beam_opt_step"] += 1
    step = beam_opt_step_reference(
        I, mu, nu, Le, free_mask, point_loads, udl, lr_t, bc1, bc2, E, A, G,
        alpha_m, alpha_s, clamp_min, grad_semi, refine)
    if lane_state is None:
        return step
    new = freeze_lanes(I, mu, nu, step, lane_state)
    for k in _LANE_TENSORS:
        getattr(lane_state, k).copy_(new[k])
    return new["I"], new["mu"], new["nu"], new["stats"]
