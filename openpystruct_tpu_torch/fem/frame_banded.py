"""Story-level block-tridiagonal frame solver + accuracy autopilot (port of
``fem/frame_banded.py``).

The reference solves its frames with OpenSees' BandGeneral system
(OpenPyStruct_FrameOpt_Discrete_Beta.py:134-139), a float64 banded LU that
exploits the grid's structure implicitly.  Node numbering is story-major
(fem/frame.py:build_frame), so grouping each story level's ``m =
3·(bays+1)`` DOFs into one super-node makes K(I) block-tridiagonal over
levels: only column elements couple adjacent levels.  A block-Thomas
factorization (a loop over levels, one m×m Cholesky of the Schur complement
per level, batched over lanes; K is SPD) costs O(levels·m³), and its
Cholesky diagonals are the Schur pivots of the Jacobi-scaled system, the
frame path's singularity/conditioning diagnostic.

Each level's factor is one batched ``torch.linalg.cholesky_ex``; the JAX
package's unrolled rank-1 form and its panel-blocked form above level width
49 answer XLA compile-time and TPU costs, not numerics.  What they define is
kept: a non-positive pivot makes the lane's factor NaN (the ``rsqrt`` of
``_chol_unrolled``), and the min pivot is ``min(diag C)²`` over all levels,
NaN-propagating.

``solve_frame_checked`` mirrors ``fem.accuracy.solve_beam_checked``: float32
with factor-once refinement and a measured error estimate; lanes it cannot
certify are re-solved in float64 on the same device (the JAX package goes
to the host CPU; the H100 has native FP64).

Every matmul, triangular solve and factorization here runs inside
``full_float32`` (TF32 off, the caller's setting restored), the backward of
``block_thomas_solve`` included.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.fem.frame import (
    FrameSolution,
    FrameStructure,
    _matvec,
    as_lanes,
    assemble,
    frame_element_data,
    full_float32,
    recover_end_forces,
)

# float32 / float64 unit roundoffs (escalation bookkeeping)
_EPS32 = 2.0 ** -24
_EPS64 = 2.0 ** -53

# Scaled-pivot floor below which a float32 frame factorization is treated as
# numerically SINGULAR in solve_frame_checked (a NaN Cholesky factor
# sanitizes to 0 and trips this).  Accuracy flagging is the refinement
# estimate's job, so this floor only needs to sit below every
# merely-ill-conditioned regime.
FRAME_PIVOT_TOL32 = 1e-9
# float64 floor (mirrors datagen.generate.RESCUE_PIVOT_TOL's rationale).
FRAME_PIVOT_TOL64 = 1e-12
# Datagen VALIDITY threshold (accuracy-grade, not just singularity): the JAX
# package's calibration puts healthy frames at scaled pivots >= ~2e-3 with
# float32 error <= ~1e-4 and garbage float32 regimes at <= ~1.4e-5 pivots
# with >= 12% error (or NaN); 1e-3 splits them with a decade of margin on
# each side, and optimized lanes sit two decades above it.
FRAME_VALID_PIVOT = 1e-3


def frame_blocks(I, structure: FrameStructure, cfg: FrameConfig = FrameConfig(),
                 dtype=torch.float32, udl=None, lateral_load=None):
    """Assemble the constrained system as story-level blocks.

    Returns ``(D, U, f, aux)`` over the flattened lanes B: (B, L, m, m)
    level-diagonal blocks, (B, L-1, m, m) super-diagonal blocks (level i ->
    i+1 coupling; the sub-diagonal is ``U_iᵀ`` by symmetry), (B, L, m) RHS,
    and the force-recovery tuple, where ``L = stories+1`` and ``m =
    3·(bays+1)``."""
    cols = structure.num_bays + 1
    Lv = structure.num_stories + 1
    m = 3 * cols
    I, w, p, _ = as_lanes(I, structure, dtype, udl, lateral_load, cfg)
    B = I.shape[0]
    k_global, f_nodal, con, aux = frame_element_data(I, structure, cfg, w, p)
    blocks = assemble(k_global.flatten(1), structure.block_plan)
    D = blocks[:, :Lv * m * m].reshape(B, Lv, m, m)
    U = blocks[:, Lv * m * m:].reshape(B, Lv - 1, m, m)

    # fixed-base constraints: zero rows/cols, original diagonal back on
    # constrained DOFs (the dense path's convention)
    conL = con.reshape(Lv, m)
    freeL = (~conL).to(dtype)
    dD = torch.diagonal(D, dim1=-2, dim2=-1)
    D = D * freeL[:, :, None] * freeL[:, None, :]
    D = D + torch.diag_embed(torch.where(conL, dD, 0.0))
    U = U * freeL[:-1, :, None] * freeL[1:, None, :]
    f = f_nodal.reshape(B, Lv, m) * freeL
    return D, U, f, aux


def _chol(A):
    """Lower Cholesky factor of each (m, m) block; a lane whose block is not
    positive definite gets an all-NaN factor."""
    C, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, C)


def _tri(C, r):
    return torch.linalg.solve_triangular(C, r, upper=False)


def _triT(C, r):
    return torch.linalg.solve_triangular(C.mT, r, upper=True)


def _chol_vec_solve(C, r):
    """S⁻¹ r from the Cholesky factor C of S (two triangular sweeps)."""
    return _triT(C, _tri(C, r[..., None]))[..., 0]


def _min_pivot(Cs):
    """min over levels of the squared Cholesky diagonal, per lane (NaN if
    any factor is NaN)."""
    diag = torch.stack([torch.diagonal(C, dim1=-2, dim2=-1) for C in Cs], 1)
    return torch.amin(diag, dim=(1, 2)) ** 2


def _thomas_impl(D, U, f):
    """Block-Thomas factor-and-solve of (B, L, ...) systems; returns ``(x,
    min_pivot, Cs)``, ``Cs`` the L per-level (B, m, m) Schur Cholesky
    factors, kept so the implicit adjoint and refinement substitute without
    re-factoring."""
    Lv, m = f.shape[1], f.shape[2]
    Cs, ys = [_chol(D[:, 0])], [f[:, 0]]
    for i in range(1, Lv):
        # one triangular solve against [U_prev | y_prev] gives both the
        # Schur update (S = D - GᵀG, G = C⁻¹U) and the forward RHS
        X = _tri(Cs[-1], torch.cat([U[:, i - 1], ys[-1][..., None]], -1))
        G, h = X[..., :m], X[..., m]
        S = D[:, i] - G.mT @ G
        ys.append(f[:, i] - _matvec(G.mT, h))
        Cs.append(_chol(S))
    x = [_chol_vec_solve(Cs[-1], ys[-1])]
    for i in range(Lv - 2, -1, -1):
        x.append(_chol_vec_solve(Cs[i], ys[i] - _matvec(U[:, i], x[-1])))
    return torch.stack(x[::-1], 1), _min_pivot(Cs), Cs


def _substitute(Cs, U, b):
    """Solve K x = b from saved factors (substitution only, O(L·m²)):
    forward Schur RHS sweep ``y_i = b_i - U_{i-1}ᵀ S_{i-1}⁻¹ y_{i-1}``,
    then the backward sweep."""
    Lv = b.shape[1]
    ys = [b[:, 0]]
    for i in range(1, Lv):
        ys.append(b[:, i] - _matvec(U[:, i - 1].mT,
                                _chol_vec_solve(Cs[i - 1], ys[-1])))
    x = [_chol_vec_solve(Cs[-1], ys[-1])]
    for i in range(Lv - 2, -1, -1):
        x.append(_chol_vec_solve(Cs[i], ys[i] - _matvec(U[:, i], x[-1])))
    return torch.stack(x[::-1], 1)


def thomas_substitute(Cs, U, b):
    """``K x = b`` from saved factors ``Cs`` (B, L, m, m), ``U`` (B, L-1, m,
    m), ``b`` (B, L, m)."""
    with full_float32():
        return _substitute(Cs.unbind(1), U, b)


class _BlockThomas(torch.autograd.Function):
    """(x, min_pivot) of the block-tridiagonal system; the backward is the
    implicit adjoint: K is symmetric, so K λ = x̄ reuses the forward factors
    and the backward pass is substitution only."""

    @staticmethod
    def forward(ctx, D, U, f):
        with full_float32():
            x, piv, Cs = _thomas_impl(D, U, f)
        ctx.save_for_backward(U, x, *Cs)
        ctx.mark_non_differentiable(piv)
        return x, piv

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, x_bar, _piv_bar):
        U, x, *Cs = ctx.saved_tensors
        with full_float32():
            lam = _substitute(Cs, U, x_bar)
        # dL/dK = -λ xᵀ restricted to the (D, U) block sparsity; the
        # sub-diagonal Uᵀ usage folds into the symmetrized Ū term
        D_bar = -lam[..., :, None] * x[..., None, :]
        U_bar = -(lam[:, :-1, :, None] * x[:, 1:, None, :]
                  + x[:, :-1, :, None] * lam[:, 1:, None, :])
        return D_bar, U_bar, lam


def block_thomas_solve(D, U, f):
    """Solve the block-tridiagonal systems (D (B, L, m, m), U (B, L-1, m, m)
    in the symmetric layout, f (B, L, m)) by block-Thomas with Cholesky
    level factors: forward Schur elimination over levels, backward sweep.

    Cholesky, not pivoted LU, because K is SPD by construction (fixed-base
    frames are never mechanisms and I >= clamp > 0).  A NaN factor (float32
    near-singularity) is the failure signal: it propagates into
    ``min_pivot`` and the solution, where the validity/escalation layers
    catch it.

    Returns ``(x, min_pivot)``, ``min_pivot`` (B,) the smallest squared
    Cholesky diagonal over every level: the Schur pivots, on a
    Jacobi-scaled system the conditioning diagnostic.

    Gradient: the implicit adjoint (λ = K⁻¹ x̄ from the saved factors, D̄ =
    -λ xᵀ, Ū = -(λ_i x_{i+1}ᵀ + x_i λ_{i+1}ᵀ), f̄ = λ), never AD through the
    factorization; ``min_pivot`` carries no gradient."""
    return _BlockThomas.apply(D, U, f)


def _scale_blocks(D, U, f):
    """Jacobi scaling (the beam solver's convention): solve the scaled
    system, pivots become dimensionless conditioning measures."""
    s = torch.rsqrt(torch.diagonal(D, dim1=-2, dim2=-1))
    D_s = D * s[..., :, None] * s[..., None, :]
    U_s = U * s[:, :-1, :, None] * s[:, 1:, None, :]
    return D_s, U_s, f * s, s


def block_matvec(D, U, x):
    """y = K x through the block structure (residual computation), as
    elementwise products and sums."""
    y = _matvec(D, x)
    up = _matvec(U, x[:, 1:])
    down = _matvec(U.mT, x[:, :-1])
    zero = torch.zeros_like(x[:, :1])
    return y + torch.cat([up, zero], 1) + torch.cat([zero, down], 1)


def solve_frame_banded(I, structure: FrameStructure,
                       cfg: FrameConfig = FrameConfig(),
                       dtype=torch.float32, udl=None, lateral_load=None):
    """Banded linear static solve + end-force recovery for I (..., E).

    Returns ``(FrameSolution, min_pivot)``: the scaled-system Schur pivot
    (...,) is free here, unlike the dense path."""
    I, w, p, lead = as_lanes(I, structure, dtype, udl, lateral_load, cfg)
    D, U, f, aux = frame_blocks(I, structure, cfg, dtype, udl=w,
                                lateral_load=p)
    D_s, U_s, f_s, s = _scale_blocks(D, U, f)
    x, piv = block_thomas_solve(D_s, U_s, f_s)
    u_nodes = (x * s).reshape(-1, structure.num_nodes, 3)
    ef = recover_end_forces(u_nodes, structure, aux)
    return FrameSolution(
        displacements=u_nodes.reshape(*lead, structure.num_nodes, 3),
        end_forces=ef.reshape(*lead, structure.num_elems, 6),
    ), piv.reshape(lead)


def frame_min_pivot(I, structure: FrameStructure,
                    cfg: FrameConfig = FrameConfig(), dtype=torch.float32):
    """Min Schur pivot of the Jacobi-scaled frame system for I (..., E): the
    validity signal the beam path gets from ``beam_min_pivot``.
    Load-independent (pivots come from the factorization alone)."""
    I, _, _, lead = as_lanes(I, structure, dtype, None, None, cfg)
    with torch.no_grad(), full_float32():
        D, U, f, _ = frame_blocks(I, structure, cfg, dtype)
        D_s, U_s, f_s, _ = _scale_blocks(D, U, f)
        _, piv, _ = _thomas_impl(D_s, U_s, torch.zeros_like(f_s))
    return piv.reshape(lead)


def solve_frame_checked(
    I,
    structure: FrameStructure,
    cfg: FrameConfig = FrameConfig(),
    udl=None,
    lateral_load=None,
    tol: float = 1e-4,
    refine_max: int = 2,
    on_fail: str = "warn",   # "warn" | "raise"
):
    """Batched frame solve of I (B, E) with a certified-accuracy contract,
    the frame counterpart of ``fem.accuracy.solve_beam_checked`` (the
    reference's implicit guarantee is float64 BandGeneral,
    OpenPyStruct_FrameOpt_Discrete_Beta.py:134-139).

    float32 banded solve + refinement from the saved factors first (a
    correction that does not shrink the estimate is not taken); lanes whose
    measured relative-error estimate exceeds ``tol``, or whose scaled Schur
    pivot signals a near-singular float32 factorization, are re-solved in
    float64 on the structure's device.  Returns ``(FrameSolution, info)``
    with per-lane numpy ``est``, ``used_f64`` and ``pivot``.  An eager
    diagnostic API, not a hot loop."""
    I32, w, p, _ = as_lanes(I, structure, torch.float32, udl, lateral_load,
                            cfg)
    B = I32.shape[0]
    with torch.no_grad(), full_float32():
        D, U, f, aux = frame_blocks(I32, structure, cfg, torch.float32,
                                    udl=w, lateral_load=p)
        D_s, U_s, f_s, s = _scale_blocks(D, U, f)
        # factor ONCE; refinement sweeps substitute from the saved factors
        x, piv32, Cs = _thomas_impl(D_s, U_s, f_s)
        xnorm = torch.amax(torch.abs(x), dim=(1, 2)) + 1e-30
        est = torch.full((B,), float("inf"), device=x.device)
        for _ in range(refine_max):
            r = f_s - block_matvec(D_s, U_s, x)
            e = _substitute(Cs, U_s, r)
            e_new = torch.amax(torch.abs(e), dim=(1, 2)) / xnorm
            # freeze on divergence, like the beam autopilot
            x = torch.where((e_new < est)[:, None, None], x + e, x)
            est = torch.minimum(est, e_new)
        u = (x * s).reshape(B, structure.num_nodes, 3)
        ef = recover_end_forces(u, structure, aux)

    est = est.cpu().numpy()
    est = np.where(np.isfinite(est), est, np.inf)
    piv32 = piv32.cpu().numpy()
    piv32 = np.where(np.isfinite(piv32), piv32, 0.0)
    # the refinement estimate certifies accuracy but cannot see singularity
    # (self-consistent garbage has small corrections); the pivot covers that
    # axis, as in the beam autopilot
    flagged = np.flatnonzero((est > tol) | (piv32 < FRAME_PIVOT_TOL32))
    used_f64 = np.zeros(B, bool)
    pivot = piv32.astype(np.float64)

    if flagged.size:
        gidx = torch.as_tensor(flagged, device=I32.device)
        with torch.no_grad():
            sol64, piv64 = solve_frame_banded(
                I32[gidx].double(), structure, cfg, torch.float64,
                udl=w[gidx].double(), lateral_load=p[gidx].double())
        u[gidx] = sol64.displacements.float()
        ef[gidx] = sol64.end_forces.float()
        piv64 = piv64.cpu().numpy()
        used_f64[flagged] = True
        pivot[flagged] = piv64
        # float64 certification: scaled float32 estimate + pivot-based
        # normwise bound (amplification ~ 1/min scaled pivot), whichever is
        # larger
        with np.errstate(divide="ignore", invalid="ignore"):
            est64 = np.maximum(
                np.where(np.isfinite(est[flagged]),
                         est[flagged] * (_EPS64 / _EPS32), 0.0),
                _EPS64 / np.abs(piv64),
            )
        est[flagged] = est64
        bad = ~(est64 <= tol) | ~(piv64 > FRAME_PIVOT_TOL64)
        if bad.any():
            msg = (
                f"{int(bad.sum())} of {B} frame systems cannot be "
                f"certified at tol={tol:g} even in float64 (min pivot "
                f"{piv64.min():.3e}); results for those lanes may be "
                "inaccurate"
            )
            if on_fail == "raise":
                raise ValueError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)

    return (FrameSolution(displacements=u, end_forces=ef),
            dict(est=est, used_f64=used_f64, pivot=pivot))
