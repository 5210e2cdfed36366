"""Streamed float64 beam solve without a mesh ceiling (port of the JAX
package's ``ops/block_stream_dd.py``).

The JAX package reaches double-double accuracy past its resident dd
kernel's VMEM range with the streamed block-Thomas solve of
``ops/block_stream.py`` carried in float32 hi/lo pairs.  The H100 has
native FP64, so here the same two sweeps run in float64:

- ``assemble_beam_system_dd`` (the JAX module's XLA pipeline, not a kernel):
  the full 3x3 beam assembly with the axial DOF, row and column masking
  with the original diagonal entry put back, and the Jacobi scale, in plain
  float64 PyTorch.  The scale ``s`` stays float64.
- ``solve_dd_streamed`` (``pallas_solve_dd_streamed``, kernels
  ``_fwd_kernel_dd`` and ``_bwd_kernel_dd``): a forward sweep writing the
  float64 multipliers C and forward solution y of every lane to device
  memory and keeping the lane's min |det S_i| (the Schur-pivot
  diagnostic), and a backward sweep carrying x in float64 and writing it
  as float32.  float32 out, float64 inside: the JAX contract.
- ``solve_beam_dd_streamed``: the two together, ``(u, pivot)``, the role
  ``fem.accuracy.solve_beam_checked`` escalates large meshes to.

``solve_dd_streamed`` sends a CPU tensor to the plain version
(``thomas_dd_reference``, the block-Thomas recurrence of
``ops/block_tridiag.py`` in float64 with the pivot) and launches the CUDA
kernels (``csrc/block_tridiag.cu``) on CUDA float64 systems, or raises.
``LAUNCHES`` counts solves (one forward and one backward launch each) and
``PLAIN_CALLS`` the calls sent to the plain version.  The TPU kernels' node
chunks and identity-padded rows and lanes existed for VMEM and have no
counterpart: one thread walks all rows of its lane.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openpystruct_tpu_torch.ops.block_tridiag import (
    _lib,
    check_system,
    lanes_first,
    lanes_last,
    thomas_backward_reference,
    thomas_forward_reference,
)

LAUNCHES = {"solve_dd_streamed": 0}
PLAIN_CALLS = {"solve_dd_streamed": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def assemble_beam_system_dd(I, Le, free, point_loads, udl, E: float,
                            A: float):
    """Batched float64 assembly, masking and Jacobi scaling: I, Le (B,
    nelem); free (B, n, 3) 0/1 free-DOF mask; point_loads (B, n); udl (B,).

    Returns ``(diag, upper, f, s)``: the scaled system (B, n, 3, 3), (B,
    n-1, 3, 3), (B, n, 3) and the scale s (B, n, 3), all float64; u = x s
    for the solution x of the scaled system."""
    I, Le, free, point_loads, udl = (
        t.to(torch.float64) for t in (I, Le, free, point_loads, udl))
    inv_le = 1.0 / Le
    ea = float(E * A) * inv_le
    eil = float(E) * I * inv_le
    eil2 = eil * inv_le
    eil3 = eil2 * inv_le
    k11 = 12.0 * eil3
    k12 = 6.0 * eil2
    k13 = 4.0 * eil
    k2 = 2.0 * eil

    def node(left, right):
        """Element quantities (B, nelem) -> nodal sum (B, n): the left
        element's end plus the right element's start."""
        return F.pad(left, (1, 0)) + F.pad(right, (0, 1))

    zn = torch.zeros_like(point_loads)
    ze = torch.zeros_like(I)
    # unmasked diagonal entries per node (left element + right element)
    d00, d11 = node(ea, ea), node(k11, k11)
    d12, d22 = node(-k12, k12), node(k13, k13)

    fr = [free[..., a] for a in range(3)]
    diag = [[zn] * 3 for _ in range(3)]
    for a, d_aa in zip(range(3), (d00, d11, d22)):
        # masked rows/cols, original diagonal entry back on the diagonal
        diag[a][a] = d_aa * fr[a] * fr[a] + d_aa * (1.0 - fr[a])
    diag[1][2] = d12 * fr[1] * fr[2]
    diag[2][1] = d12 * fr[2] * fr[1]

    frn = [free[:, :-1, a] for a in range(3)]   # node i of element i
    frx = [free[:, 1:, a] for a in range(3)]    # node i+1
    upper = [[ze] * 3 for _ in range(3)]
    upper[0][0] = -ea * frn[0] * frx[0]
    upper[1][1] = -k11 * frn[1] * frx[1]
    upper[1][2] = k12 * frn[1] * frx[2]
    upper[2][1] = -k12 * frn[2] * frx[1]
    upper[2][2] = k2 * frn[2] * frx[2]

    w = udl[:, None]
    half = w * Le * 0.5
    fm_e = w * Le * Le / 12.0
    fy = node(half, half) + point_loads
    fm = F.pad(fm_e, (0, 1)) - F.pad(fm_e, (1, 0))
    f = [zn, fy * fr[1], fm * fr[2]]

    s = [torch.rsqrt(diag[a][a]) for a in range(3)]
    for a in range(3):
        for b in range(3):
            diag[a][b] = diag[a][b] * s[a] * s[b]
            upper[a][b] = upper[a][b] * s[a][:, :-1] * s[b][:, 1:]
        f[a] = f[a] * s[a]

    def stack_33(m):
        return torch.stack([torch.stack(row, -1) for row in m], -2)

    return (stack_33(diag), stack_33(upper), torch.stack(f, -1),
            torch.stack(s, -1))


def thomas_dd_reference(diag, upper, b):
    """Plain version of the streamed float64 solve: the block-Thomas
    recurrence (``thomas_forward_reference``, ``thomas_backward_reference``)
    in float64 with the min |det S_i| pivot.  Returns x (..., n, 3) and the
    pivot (...,) in float32, the kernel's outputs."""
    diag, upper, b = (t.to(torch.float64) for t in (diag, upper, b))
    c, y, piv = thomas_forward_reference(diag, upper, b, pivot=True)
    return thomas_backward_reference(c, y).float(), piv.float()


def launch_thomas_streamed_dd(diag_t, upper_t, b_t):
    """Launch the float64 forward and backward sweeps (kernel #9) on
    lane-innermost float64 systems, contiguous on one card: diag_t (n, 3,
    3, B), upper_t (n-1, 3, 3, B), b_t (n, 3, B).  Returns x_t (n, 3, B) and
    the pivot (B,), float32."""
    n, B = b_t.shape[0], b_t.shape[-1]
    dev = b_t.device
    c = torch.empty((n, 3, 3, B), dtype=torch.float64, device=dev)
    y = torch.empty((n, 3, B), dtype=torch.float64, device=dev)
    x = torch.empty((n, 3, B), dtype=torch.float32, device=dev)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().thomas_streamed_dd_f64(
            diag_t.data_ptr(), upper_t.data_ptr(), b_t.data_ptr(),
            c.data_ptr(), y.data_ptr(), x.data_ptr(), piv.data_ptr(), B, n,
            stream)
    if rc != 0:
        raise RuntimeError(f"solve_dd_streamed launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["solve_dd_streamed"] += 1
    return x, piv


def solve_dd_streamed(diag, upper, b):
    """Solve K x = b in float64 for a batch of symmetric block-tridiagonal
    systems of any length (``pallas_solve_dd_streamed``): diag (B, n, 3,
    3), upper (B, n-1, 3, 3), b (B, n, 3), float64.  Returns ``(x,
    pivot)``: x (B, n, 3) and min |det S_i| (B,), float32.  CPU tensors run
    the plain version; CUDA tensors (float64) launch the kernels."""
    if not diag.is_cuda:
        PLAIN_CALLS["solve_dd_streamed"] += 1
        return thomas_dd_reference(diag, upper, b)
    check_system(diag, upper, b, dtype=torch.float64)
    x, piv = launch_thomas_streamed_dd(lanes_last(diag), lanes_last(upper),
                                       lanes_last(b))
    return lanes_first(x), piv


def solve_beam_dd_streamed(I, Le, free_mask, point_loads, udl, E: float,
                           A: float):
    """Batched beam FEA in float64 with no mesh ceiling: the float64
    assembly, then the streamed float64 solve.  ``free_mask`` is the (B, n,
    3) free-DOF mask (True or 1 = free), ``~constraint_mask(scenario)``.
    Returns ``(u, pivot)``: displacements (B, n, 3) and the float64 min
    Schur pivot of the scaled system (B,), in I's dtype."""
    diag, upper, f, s = assemble_beam_system_dd(I, Le, free_mask,
                                                point_loads, udl, E, A)
    x, piv = solve_dd_streamed(diag, upper, f)
    return (x.to(s.dtype) * s).to(I.dtype), piv.to(I.dtype)
