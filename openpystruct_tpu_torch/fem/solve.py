"""Block-tridiagonal direct solver with an implicit-differentiation adjoint
(port of ``fem/solve.py``).

The chain beam mesh assembles into a block-tridiagonal stiffness with 3x3
nodal blocks.  ``block_tridiag_solve`` factors it with an O(n) block-Thomas
sweep (a Python loop over nodes; every step is batched tensor work over the
leading dimensions) and carries a ``torch.autograd.Function`` implementing
the adjoint of a linear solve,

    x = K^-1 b,   dL/db = K^-T g,   dL/dK = -(K^-T g) x^T  (on the sparsity),

so reverse mode costs one more solve instead of replaying the factorization
graph.  This is the plain split path: the CPU tests hold it against the JAX
package, and the fused kernels' plain versions are tested against it.

The 3x3 products are written as elementwise products and sums, never as a
matmul, so no float32 product on the card can run in TF32.
"""

from __future__ import annotations

import torch


def _inv_small(m):
    """Inverse of (..., k, k) blocks: the cofactor closed form for the beam's
    3x3 blocks (elementwise work, no LU), ``torch.linalg.inv`` otherwise."""
    if m.shape[-1] != 3:
        return torch.linalg.inv(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, D, G], dim=-1),
            torch.stack([B, E, H], dim=-1),
            torch.stack([C, F, I], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _det_small(m):
    """Determinant of (..., k, k) blocks (closed form for 3x3)."""
    if m.shape[-1] != 3:
        return torch.linalg.det(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _mv(m, v):
    return (m * v[..., None, :]).sum(-1)


def _mm(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _factor(diag, upper, lower):
    """Block-Thomas factorization.

    diag (..., n, k, k), upper/lower (..., n-1, k, k).  Returns (Sinv, C):
    the inverted Schur complements and the back-substitution multipliers
    C_i = Sinv_i U_i, both (..., n, k, k) (the last C block is zero).
    """
    n = diag.shape[-3]
    upper_p = torch.cat([upper, torch.zeros_like(diag[..., :1, :, :])], dim=-3)
    sinv = [_inv_small(diag[..., 0, :, :])]
    c = [_mm(sinv[0], upper_p[..., 0, :, :])]
    for i in range(1, n):
        s = diag[..., i, :, :] - _mm(lower[..., i - 1, :, :], c[-1])
        sinv.append(_inv_small(s))
        c.append(_mm(sinv[-1], upper_p[..., i, :, :]))
    return torch.stack(sinv, dim=-3), torch.stack(c, dim=-3)


def _solve_factored(sinv, c, lower, b):
    """Forward/back substitution with block-Thomas factors."""
    n = b.shape[-2]
    y = [_mv(sinv[..., 0, :, :], b[..., 0, :])]
    for i in range(1, n):
        y.append(_mv(sinv[..., i, :, :],
                     b[..., i, :] - _mv(lower[..., i - 1, :, :], y[-1])))
    x = [y[-1]]
    for i in range(n - 2, -1, -1):
        x.append(y[i] - _mv(c[..., i, :, :], x[-1]))
    return torch.stack(x[::-1], dim=-2)


def _solve_impl(diag, upper, lower, b, refine):
    """Factor once; each refinement sweep is one compensated residual plus
    one substitution against the same factors."""
    sinv, c = _factor(diag, upper, lower)
    x = _solve_factored(sinv, c, lower, b)
    for _ in range(refine):
        r = block_tridiag_residual_compensated(diag, upper, b, x, lower)
        x = x + _solve_factored(sinv, c, lower, r)
    return x


class _BlockTridiagSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, diag, upper, lower, b, refine):
        x = _solve_impl(diag, upper, lower, b, refine)
        ctx.refine = refine
        ctx.save_for_backward(diag, upper, lower, x)
        return x

    @staticmethod
    def backward(ctx, g):
        diag, upper, lower, x = ctx.saved_tensors
        # adjoint system K^T lam = g: transpose every block, swap the bands;
        # it refines to the same accuracy as the primal
        lam = _solve_impl(diag.transpose(-1, -2), lower.transpose(-1, -2),
                          upper.transpose(-1, -2), g, ctx.refine)
        # dL/dK = -lam x^T restricted to the block-tridiagonal sparsity
        diag_bar = -lam[..., :, :, None] * x[..., :, None, :]
        upper_bar = -lam[..., :-1, :, None] * x[..., 1:, None, :]
        lower_bar = -lam[..., 1:, :, None] * x[..., :-1, None, :]
        return diag_bar, upper_bar, lower_bar, lam, None


def block_tridiag_solve(diag, upper, b, lower=None, refine=0):
    """Solve the block-tridiagonal system K x = b.

    diag (..., n, k, k), upper (..., n-1, k, k), b (..., n, k); ``lower``
    defaults to ``upper^T`` (symmetric K, the BandSPD case of
    OpenPyStruct_BeamOpt.py:122).  ``refine`` compensated-residual
    refinement sweeps recover near-full float32 accuracy on stiff systems.
    Differentiable in all operands through the implicit adjoint.
    """
    if lower is None:
        lower = upper.transpose(-1, -2)
    return _BlockTridiagSolve.apply(diag, upper, lower, b, refine)


def block_tridiag_min_pivot(diag, upper, lower=None):
    """min_i |det(S_i)| over the block-Thomas Schur pivots of the
    Jacobi-scaled system: a singularity detector.  A structurally singular
    beam (no roller) collapses to round-off level while valid systems stay
    orders of magnitude above (OpenSees' analyze-failure analog,
    OpenPyStruct_BeamOpt_training_MultiCore.py:184-186)."""
    d = torch.diagonal(diag, dim1=-2, dim2=-1)
    s = torch.rsqrt(d)
    diag_s = diag * s[..., :, :, None] * s[..., :, None, :]
    upper_s = upper * s[..., :-1, :, None] * s[..., 1:, None, :]
    if lower is None:
        lower_s = upper_s.transpose(-1, -2)
    else:
        lower_s = lower * s[..., 1:, :, None] * s[..., :-1, None, :]
    n = diag.shape[-3]
    upper_p = torch.cat([upper_s, torch.zeros_like(diag_s[..., :1, :, :])],
                        dim=-3)
    d0 = diag_s[..., 0, :, :]
    min_det = torch.abs(_det_small(d0))
    c = _mm(_inv_small(d0), upper_p[..., 0, :, :])
    for i in range(1, n):
        sblk = diag_s[..., i, :, :] - _mm(lower_s[..., i - 1, :, :], c)
        min_det = torch.minimum(min_det, torch.abs(_det_small(sblk)))
        c = _mm(_inv_small(sblk), upper_p[..., i, :, :])
    return min_det


# ---------------------------------------------------------------------------
# Compensated (double-float) residual for iterative refinement.  A plain
# residual b - K x is dominated by rounding when ||K|| ||x|| >> ||b||, so
# refinement stalls; error-free transforms (Dekker two-product, Knuth
# two-sum) give it to ~2^-45 relative in float32.
# ---------------------------------------------------------------------------


def _split_const(x):
    """Dekker split constant 2^ceil(p/2) + 1 for the operand's dtype."""
    return 134217729.0 if x.dtype == torch.float64 else 4097.0


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth).  Every step is its own PyTorch
    operation, so nothing is contracted or reassociated."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker split)."""
    split = _split_const(a)
    p = a * b
    ca = split * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = split * b
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def block_tridiag_matvec(diag, upper, b, lower=None):
    """K @ b for a block-tridiagonal K (symmetric if ``lower`` is None)."""
    if lower is None:
        lower = upper.transpose(-1, -2)
    r = _mv(diag, b)
    r = r + torch.cat([_mv(upper, b[..., 1:, :]),
                       torch.zeros_like(b[..., :1, :])], dim=-2)
    return r + torch.cat([torch.zeros_like(b[..., :1, :]),
                          _mv(lower, b[..., :-1, :])], dim=-2)


def block_tridiag_residual_compensated(diag, upper, b, x, lower=None):
    """b - K x in compensated arithmetic (shapes of ``block_tridiag_solve``)."""
    if lower is None:
        lower = upper.transpose(-1, -2)
    k = diag.shape[-1]
    zpad = torch.zeros_like(diag[..., :1, :, :])
    up = torch.cat([upper, zpad], dim=-3)      # row i couples x[i+1]
    lo = torch.cat([zpad, lower], dim=-3)      # row i couples x[i-1]
    xz = torch.zeros_like(x[..., :1, :])
    x_next = torch.cat([x[..., 1:, :], xz], dim=-2)
    x_prev = torch.cat([xz, x[..., :-1, :]], dim=-2)

    terms = [two_prod(-m, v[..., None, :])
             for m, v in ((diag, x), (up, x_next), (lo, x_prev))]
    # Neumaier accumulation of 3k products + b per output component
    s = b
    comp = torch.zeros_like(b)
    for p, e in terms:
        for j in range(k):
            s, c = two_sum(s, p[..., j])
            comp = comp + c + e[..., j]
    return s + comp
