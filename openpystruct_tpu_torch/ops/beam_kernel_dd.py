"""The rescue's fused beam kernels in float64 (port of the JAX package's
``ops/beam_kernel_dd.py``).

The JAX package re-optimizes the lanes the float32 validity gate rejects
(random-bridge scenarios, meshes finer than 101 nodes) in double-double
arithmetic, float32 hi/lo pairs emulating a ~48-bit mantissa on the TPU.
The H100 has native FP64, so "dd" here means float64, with float32 inputs
and outputs.  The kernels take any mesh (n >= 2): their scratch lives in
device memory the wrapper sizes to the batch, so the TPU kernel's VMEM
ceiling (the JAX module's ``fits_dd``) has no counterpart here.

- ``beam_analysis_dd`` (``pallas_beam_analysis_dd``, kernel
  ``_beam_dd_kernel``): ``beam_analysis``'s contract without the refinement
  stage (float64 forward error is already below float32's resolution):
  stiffness -> masked bending-only 2x2 assembly (u_x exactly 0) -> Jacobi
  scaling -> factorization fused with the forward sweep -> back sweep ->
  u, V, M.  The 3-DOF min Schur pivot a_i |det2(S_i)|, with the axial
  chain's a_i, is computed in float64 and returned in float32.
- ``beam_opt_step_dd`` (``pallas_beam_opt_step_dd``, kernel
  ``_beam_dd_opt_kernel``): the same solve, the loss and its semi-gradient
  in float64; Adam in float32 on the gradient cast to float32, with the
  same lr_t, bc1, bc2 scalars; the pivot as a fifth output.  There is no
  adjoint mode, as in the JAX package.

Both kernels live in ``csrc/beam_opt_dd.cu``: two fused sweeps per lane,
the forward one shared (so the two pivots agree bit for bit), the backward
one writing u, V, M or the Adam step.  They read and write the callers'
lanes-first tensors directly: the wrappers copy no layout, and take only
contiguous tensors.

Each wrapper sends a CPU tensor to the plain PyTorch version beside it
(``beam_analysis_dd_reference``, ``beam_opt_step_dd_reference``), which takes
float32 or float64 inputs, computes in float64 and returns the input dtype,
and launches the CUDA kernel on a CUDA float32 tensor, or raises.  There is
no fallback from the kernel to the plain version.  ``LAUNCHES`` counts kernel
launches and ``PLAIN_CALLS`` the calls sent to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openpystruct_tpu_torch.ops import _build
from openpystruct_tpu_torch.ops.beam_kernel import (
    _adam_step,
    _assemble_b2,
    _bsub_b2,
    _check_lanes_first,
    _factor_b2,
    _forces,
    _loss_stats,
    _run,
    _scale_b2,
    _stack,
    _stiffness,
)

LAUNCHES = {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}
PLAIN_CALLS = {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the float32 kernels' stages in float64, without C
# and without refinement, as the kernels run them.
# ---------------------------------------------------------------------------


def _solve_dd(I, Le, free, point_loads, udl, E, A):
    ks = _stiffness(I, Le, E, E * A)
    diag, upper, rhs, ax = _assemble_b2(ks, Le, free, point_loads, udl)
    diag, upper, rhs, s = _scale_b2(diag, upper, rhs)
    sinv, _, Y, piv = _factor_b2(diag, upper, rhs, with_c=False, ax=ax)
    y = _stack(_bsub_b2(Y, upper, sinv))
    return ks, y[0] * s[0], y[1] * s[1], piv


def beam_analysis_dd_reference(I, Le, free_mask, point_loads, udl, E, A):
    """Plain version of the float64 analysis.  I, Le (B, nelem); free_mask
    (B, n, 3) 0/1; point_loads (B, n); udl (B,).  Returns u (B, n, 3), V, M
    (B, nelem), pivot (B,) in I's dtype."""
    io = I.dtype
    I, Le, free_mask, point_loads, udl = (
        t.to(torch.float64) for t in (I, Le, free_mask, point_loads, udl))
    ks, uy, th, piv = _solve_dd(I, Le, free_mask, point_loads, udl, E, A)
    ux = (uy[:, :1] * 0.0).expand_as(uy)        # u_x == 0 exactly
    V, M = _forces(ks, Le, udl, uy, th)
    return tuple(t.to(io) for t in (torch.stack([ux, uy, th], dim=-1), V, M,
                                    piv))


def beam_opt_step_dd_reference(I, mu, nu, Le, free_mask, point_loads, udl,
                               lr_t, bc1, bc2, E, A, G, alpha_m=1e-2,
                               alpha_s=1e-2, clamp_min=1e-8):
    """Plain version of one float64 semi-gradient Adam iteration.  Returns
    I_new, mu_new, nu_new (B, nelem), stats (B, 4) and pivot (B,) in I's
    dtype; Adam runs in I's dtype on the gradient cast to it."""
    io = I.dtype
    I64, Le, free_mask, point_loads, udl = (
        t.to(torch.float64) for t in (I, Le, free_mask, point_loads, udl))
    ks, uy, th, piv = _solve_dd(I64, Le, free_mask, point_loads, udl, E, A)
    V, M = _forces(ks, Le, udl, uy, th)
    den_b = 2.0 * E * I64 + 1e-6
    den_s = G * (0.03 * torch.sqrt(I64))
    be = M * M / den_b
    se = V * V / den_s
    # explicit dL/dI with M, V held constant: the semi-gradient
    g = 1.0 - alpha_m * be * 2.0 * E / den_b - alpha_s * 0.5 * se / I64
    stats = _loss_stats(I64, be, se, alpha_m, alpha_s)
    return (*_adam_step(I, mu, nu, g.to(io), lr_t, bc1, bc2, clamp_min),
            stats.to(io), piv.to(io))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    """The library of the float64 kernels, the analysis and the opt step
    (``csrc/beam_opt_dd.cu``)."""
    lib = _build.load("beam_opt_dd")
    P, I_, D, F_ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                    ctypes.c_float)
    lib.beam_opt_step_dd_f32io.argtypes = ([P] * 13 + [I_] * 2 + [D] * 5
                                           + [F_] * 4 + [P])
    lib.beam_analysis_dd_f32io.argtypes = [P] * 10 + [I_] * 2 + [D] * 2 + [P]
    lib.beam_opt_dd_scratch_per_node.argtypes = []
    for fn in (lib.beam_opt_step_dd_f32io, lib.beam_analysis_dd_f32io,
               lib.beam_opt_dd_scratch_per_node):
        fn.restype = I_
    return lib


def _scratch(lib, n, B, dev):
    """The sweeps' private float64 scratch (n, 7, B), written once."""
    return torch.empty((n, lib.beam_opt_dd_scratch_per_node(), B),
                       dtype=torch.float64, device=dev)


def launch_beam_analysis_dd(I, Le, free_mask, point_loads, udl, E, A):
    """Launch the float64 analysis kernel on the callers' lanes-first
    float32 tensors, as they are (``beam_kernel._check_lanes_first``, before
    any build).  Returns u (B, n, 3), V, M (B, nelem) and the pivot (B,),
    float32."""
    _check_lanes_first("beam_analysis_dd", I, Le, free_mask, point_loads,
                       udl)
    B, nelem = I.shape
    n = nelem + 1
    dev = I.device
    lib = _lib()
    u = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    V = torch.empty_like(I)
    M = torch.empty_like(I)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, n, B, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.beam_analysis_dd_f32io(
            I.data_ptr(), Le.data_ptr(), free_mask.data_ptr(),
            point_loads.data_ptr(), udl.data_ptr(), u.data_ptr(),
            V.data_ptr(), M.data_ptr(), piv.data_ptr(), scratch.data_ptr(),
            B, n, float(E), float(E * A), stream)
    _run(rc, "beam_analysis_dd", LAUNCHES)
    return u, V, M, piv


def launch_beam_opt_step_dd(I, mu, nu, Le, free_mask, point_loads, udl,
                            lr_t, bc1, bc2, E, A, G, alpha_m=1e-2,
                            alpha_s=1e-2, clamp_min=1e-8):
    """Launch the float64 opt-step kernel on the optimizer's lanes-first
    float32 tensors, as they are (``beam_kernel._check_lanes_first``).
    Returns I_new, mu_new, nu_new (B, nelem), stats (B, 4) and the pivot
    (B,)."""
    _check_lanes_first("beam_opt_step_dd", I, Le, free_mask, point_loads,
                       udl, mu, nu)
    B, nelem = I.shape
    n = nelem + 1
    dev = I.device
    lib = _lib()
    I_o, mu_o, nu_o = (torch.empty_like(I) for _ in range(3))
    stats = torch.empty((B, 4), dtype=torch.float32, device=dev)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, n, B, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.beam_opt_step_dd_f32io(
            I.data_ptr(), mu.data_ptr(), nu.data_ptr(), Le.data_ptr(),
            free_mask.data_ptr(), point_loads.data_ptr(), udl.data_ptr(),
            I_o.data_ptr(), mu_o.data_ptr(), nu_o.data_ptr(),
            stats.data_ptr(), piv.data_ptr(), scratch.data_ptr(), B, n,
            float(E), float(E * A), float(G), float(alpha_m), float(alpha_s),
            float(clamp_min), float(lr_t), float(bc1), float(bc2), stream)
    _run(rc, "beam_opt_step_dd", LAUNCHES)
    return I_o, mu_o, nu_o, stats, piv


def beam_analysis_dd(I, Le, free_mask, point_loads, udl, E, A):
    """Fused batched beam FEA in float64 (``pallas_beam_analysis_dd``).

    Shapes of ``beam_analysis``; returns u (B, n, 3), V, M (B, nelem) and
    the float64 min Schur pivot (B,), in the inputs' dtype.  CPU tensors
    run the plain version; CUDA tensors (float32, contiguous) launch the
    kernel, with no layout copy.
    """
    if not I.is_cuda:
        PLAIN_CALLS["beam_analysis_dd"] += 1
        return beam_analysis_dd_reference(I, Le, free_mask, point_loads, udl,
                                          E, A)
    return launch_beam_analysis_dd(I, Le, free_mask, point_loads, udl, E, A)


def beam_opt_step_dd(I, mu, nu, Le, free_mask, point_loads, udl, lr_t, bc1,
                     bc2, E, A, G, alpha_m=1e-2, alpha_s=1e-2,
                     clamp_min=1e-8):
    """One fused semi-gradient Adam iteration with the solve, loss and
    gradient in float64 (``pallas_beam_opt_step_dd``).  Returns I_new,
    mu_new, nu_new (B, nelem), stats (B, 4) and the pivot (B,).  CPU tensors
    run the plain version; CUDA tensors (float32, contiguous) launch the
    kernel, with no layout copy.
    """
    if not I.is_cuda:
        PLAIN_CALLS["beam_opt_step_dd"] += 1
        return beam_opt_step_dd_reference(
            I, mu, nu, Le, free_mask, point_loads, udl, lr_t, bc1, bc2, E, A,
            G, alpha_m, alpha_s, clamp_min)
    return launch_beam_opt_step_dd(I, mu, nu, Le, free_mask, point_loads, udl,
                                   lr_t, bc1, bc2, E, A, G, alpha_m, alpha_s,
                                   clamp_min)
