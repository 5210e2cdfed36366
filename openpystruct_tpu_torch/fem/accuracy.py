"""Accuracy autopilot (port of ``fem/accuracy.py``): a refine count from
the mesh size, a computable error estimate, and automatic escalation of the
lanes float32 cannot certify to the float64 analysis.

On float32 the attainable accuracy of one solve call spans three regimes:
benign meshes reach ~1e-6 with compensated refinement, fixed-span refined
meshes (cond ~ n^4) stall near n = 200 and diverge near n = 500, and the
random-bridge tail keeps no digits.  ``solve_beam_checked`` solves in
float32 with adaptive compensated refinement, estimates each lane's error
from its last refinement correction, and re-solves the lanes that miss
``tol`` (or whose float32 Schur pivot looks singular) in float64: with
``beam_analysis_dd`` (the fused float64 analysis) below ``DD_STREAM_FROM_N``
nodes and with ``solve_beam_dd_streamed`` (the streamed float64 solve) from
there.  The JAX package takes its streamed dd solve only past its resident
dd kernel's range, from 788 nodes; the port's threshold is measured on the
card (below).
Each runs its kernel on the card and its plain float64 version for a CPU
batch; neither leaves the batch's device.  It warns, or raises, for lanes
not even float64 can certify.

One departure from the JAX package's code: the estimate is floored by one
more correction, from the float64 residual of the system assembled in
float64 (``_float64_estimate``).  The compensated residual is exact for the
float32-assembled system, so the estimate run eagerly cannot see the
rounding of the assembly itself and would certify lanes far outside
``tol``.  The JAX package jits it, and there (on the CPU) XLA reduces that
residual to plain float32 arithmetic, whose noise is of the assembly's
size: the reference as it runs does see that error, and escalates the
lanes the port escalates.  The port runs eagerly and measures the error
directly.

The float64 stage is certified with the JAX package's double-double unit
roundoff ``_EPS_DD`` = 2^-48, so the port certifies the same lanes; native
float64 is at least that accurate.
"""

from __future__ import annotations

import warnings

import torch

from openpystruct_tpu_torch.fem.beam import (
    BeamScenario,
    BeamSolution,
    assemble_beam_system,
    constraint_mask,
)
from openpystruct_tpu_torch.fem.elements import element_end_forces
from openpystruct_tpu_torch.fem.solve import (
    block_tridiag_matvec,
    block_tridiag_min_pivot,
    block_tridiag_residual_compensated,
)

# float32 / double-double unit roundoffs
_EPS32 = 2.0 ** -24
_EPS_DD = 2.0 ** -48

# float64 pivot floor below which a system is treated as structurally
# singular rather than merely ill-conditioned (datagen.generate's
# RESCUE_PIVOT_TOL rationale)
_SINGULAR_PIVOT = 1e-12

# Meshes of this many nodes or more escalate through the streamed float64
# solve (kernel #9 in its beam mode: the assembly fused into its sweeps),
# smaller ones through the fused float64 analysis (#7).  Set as
# block_tridiag.uses_streamed is, by measured turns: the smallest of n =
# 201, 501, 1001, 2001 at which #9's whole route is no slower than #7's on
# 16384 fixed-span lanes in two runs on the card (chip_smoke.py phase 6,
# PERF.md; NVIDIA H100 80GB HBM3, 700.00 W), else the JAX package's own
# point, 788 (pick_sub(n, 52) is None from there).  Route ms, #7 / #9, in
# the two runs:
#   n = 201:   0.576 / 0.438,  0.547 / 0.404
#   n = 501:   1.291 / 0.991,  1.287 / 0.934
#   n = 1001:  2.431 / 1.843,  2.411 / 1.827
#   n = 2001:  4.715 / 3.655,  4.753 / 3.620
# #9's route takes 0.72-0.78x #7's at every n.
DD_STREAM_FROM_N = 201


def auto_refine(n_nodes: int) -> int:
    """Refine-sweep count from mesh size alone, calibrated against float64
    on span-scaled meshes (benign conditioning); ill-conditioned systems
    need :func:`solve_beam_checked`'s escalation instead."""
    if n_nodes <= 150:
        return 1
    if n_nodes <= 400:
        return 2
    return 3


def _scaled_solve_with_estimate(diag, upper, f, refine_max: int = 4):
    """Jacobi-scaled solve with up to ``refine_max`` compensated refinement
    sweeps, each freezing the lanes whose correction stopped shrinking.
    Returns (x_scaled, s, est): ``est`` is the per-lane size of the last
    kept correction relative to max |x|, which bounds the remaining forward
    error after convergence and saturates near or above 1 under
    divergence, the escalation signal."""
    from openpystruct_tpu_torch.ops.block_tridiag import solve_sym

    s = torch.rsqrt(torch.diagonal(diag, dim1=-2, dim2=-1))
    diag_s = diag * s[..., :, None] * s[..., None, :]
    upper_s = upper * s[..., :-1, :, None] * s[..., 1:, None, :]
    f_s = f * s

    x = solve_sym(diag_s, upper_s, f_s, 0)
    xnorm = torch.amax(torch.abs(x), dim=(-2, -1)) + 1e-30
    est = torch.full_like(xnorm, float("inf"))
    for _ in range(refine_max):
        r = block_tridiag_residual_compensated(diag_s, upper_s, f_s, x)
        e = solve_sym(diag_s, upper_s, r, 0)
        est_new = torch.amax(torch.abs(e), dim=(-2, -1)) / xnorm
        improved = est_new < est
        x = torch.where(improved[:, None, None], x + e, x)
        est = torch.minimum(est, est_new)
    return x, s, est


def _float64_estimate(I, scenario, E, A, diag32, upper32, s, x):
    """Relative size of one correction of the scaled float32 solution ``x``
    computed from the float64 residual of the system assembled in float64
    from the same inputs, solved with the float32 factorization.

    The compensated residual above is exact for the float32-assembled
    system, so its corrections, run eagerly, converge to that system's
    solution and cannot see the assembly's own rounding (~eps32 |K|,
    amplified by the conditioning): on a fixed 200 m span at n = 101 they
    shrink to ~4e-8 while the solution is 6e-3 off the float64 one.  This
    correction sees that error."""
    from openpystruct_tpu_torch.ops.block_tridiag import solve_sym

    f64 = torch.float64
    sc64 = scenario.map(lambda t: t.to(f64) if t.is_floating_point() else t)
    diag, upper, f = assemble_beam_system(I.to(f64), sc64, E, A)
    r = f - block_tridiag_matvec(diag, upper, (x * s).to(f64))
    diag_s = diag32 * s[..., :, None] * s[..., None, :]
    upper_s = upper32 * s[..., :-1, :, None] * s[..., 1:, None, :]
    e = solve_sym(diag_s, upper_s, (r * s.to(f64)).to(x.dtype), 0)
    return (torch.amax(torch.abs(e), dim=(-2, -1))
            / (torch.amax(torch.abs(x), dim=(-2, -1)) + 1e-30))


def solve_beam_checked(I, scenario: BeamScenario, E, A, tol: float = 1e-4,
                       refine_max: int = 4, on_fail: str = "warn"):
    """Batched linear-static solve with a certified-accuracy contract.

    Float32 (the batch's dtype) with adaptive compensated refinement first;
    lanes whose error estimate exceeds ``tol``, or whose Schur pivot falls
    below 1e-9, are re-solved in float64 on the batch's device, by
    ``beam_analysis_dd`` below ``DD_STREAM_FROM_N`` nodes and by
    ``solve_beam_dd_streamed`` from there.  Returns ``(BeamSolution,
    info)``; ``info`` holds per-lane tensors ``est`` (relative error
    estimate), ``used_dd`` (the escalated lanes) and ``pivot`` (float64
    Schur pivots of escalated lanes, NaN elsewhere: #7's a_axial |det2|, or
    #9's min |det S_i| of the full scaled system, equal in exact
    arithmetic).  ``on_fail`` says what happens when a lane cannot be
    certified at ``tol`` even in float64 or is structurally singular:
    "warn" emits a RuntimeWarning, "raise" raises ValueError.

    Eager and not differentiable: a diagnostic API, not a hot loop.
    """
    from openpystruct_tpu_torch.ops.beam_kernel_dd import beam_analysis_dd
    from openpystruct_tpu_torch.ops.block_stream_dd import (
        solve_beam_dd_streamed,
    )

    B = I.shape[0]
    diag, upper, f = assemble_beam_system(I, scenario, E, A)
    x, s, est = _scaled_solve_with_estimate(diag, upper, f, refine_max)
    est = torch.maximum(est, _float64_estimate(I, scenario, E, A, diag, upper,
                                               s, x))
    u = x * s
    # a non-finite estimate means the float32 factorization itself blew up;
    # NaN compares False against every threshold, so such lanes are set to
    # inf here, or they would be certified
    est = torch.where(torch.isfinite(est), est, torch.inf)

    # the correction estimate cannot see singularity (a singular
    # factorization gives self-consistent garbage with small corrections):
    # the Schur-pivot detector covers that, as in the datagen gate
    piv32 = block_tridiag_min_pivot(diag, upper)
    piv32 = torch.where(torch.isfinite(piv32), piv32, 0.0)
    flagged = torch.nonzero((est > tol) | (piv32 < 1e-9)).flatten()
    used_dd = torch.zeros(B, dtype=torch.bool, device=I.device)
    pivot = torch.full((B,), float("nan"), dtype=torch.float32,
                       device=I.device)
    Le = torch.diff(scenario.node_x, dim=-1)

    if flagged.numel():
        free = (~constraint_mask(scenario)).to(I.dtype)
        args = (I[flagged], Le.to(I.dtype)[flagged], free[flagged],
                scenario.point_loads.to(I.dtype)[flagged],
                scenario.udl.to(I.dtype)[flagged], float(E), float(A))
        if scenario.node_x.shape[-1] >= DD_STREAM_FROM_N:
            u_hi, piv_hi = solve_beam_dd_streamed(*args)
        else:
            u_hi, _, _, piv_hi = beam_analysis_dd(*args)
        u = u.clone()
        u[flagged] = u_hi.to(u.dtype)
        used_dd[flagged] = True
        pivot[flagged] = piv_hi.to(torch.float32)

        # float64 certification: the measured float32 amplification scaled
        # by eps_dd / eps32, floored by the pivot-based normwise bound
        # eps_dd / |min pivot|, for every escalated lane (a diverged float32
        # estimate saturates near 1 and alone would certify lanes whose
        # conditioning is too large).  A NaN pivot fails both tests below.
        est_f32 = est[flagged]
        est_dd = torch.maximum(
            torch.where(torch.isfinite(est_f32), est_f32 * (_EPS_DD / _EPS32),
                        torch.zeros_like(est_f32)),
            _EPS_DD / torch.abs(piv_hi.to(est.dtype)))
        est[flagged] = est_dd
        bad = ~(est_dd <= tol) | ~(piv_hi > _SINGULAR_PIVOT)
        n_bad = int(bad.sum())
        if n_bad:
            msg = (f"{n_bad} of {B} systems cannot be certified at "
                   f"tol={tol:g} even in float64 arithmetic (min float64 "
                   f"pivot {piv_hi.min().item():.3e}); results for those "
                   "lanes may be inaccurate")
            if on_fail == "raise":
                raise ValueError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)

    u_e = torch.cat([u[..., :-1, :], u[..., 1:, :]], dim=-1)
    end_forces = element_end_forces(u_e, E, A, I, Le.to(u.dtype),
                                    scenario.udl[..., None].to(u.dtype))
    sol = BeamSolution(
        displacements=u,
        deflections=u[..., 1],
        rotations=u[..., 2],
        shear_forces=end_forces[..., 1],
        bending_moments=end_forces[..., 2],
        end_forces=end_forces,
    )
    return sol, dict(est=est, used_dd=used_dd, pivot=pivot)
