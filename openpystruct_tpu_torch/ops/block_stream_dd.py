"""Streamed float64 beam solve without a mesh ceiling (port of the JAX
package's ``ops/block_stream_dd.py``).

The JAX package reaches double-double accuracy past its resident dd
kernel's VMEM range with the streamed block-Thomas solve of
``ops/block_stream.py`` carried in float32 hi/lo pairs.  The H100 has
native FP64, so here the same two sweeps run in float64 (kernel #9,
``csrc/block_stream_dd.cu``, the design of #6's ``csrc/block_stream.cu``:
per block of 4-32 lanes one chain warp runs the recurrence while other
warps stage each lane's rows a tile ahead in shared memory, C and y go
through a private lanes-innermost workspace, and the I/O is lanes-first
with no layout copy):

- ``assemble_beam_system_dd`` (the JAX module's XLA pipeline, not a kernel):
  the full 3x3 beam assembly with the axial DOF, row and column masking
  with the original diagonal entry put back, and the Jacobi scale, in plain
  float64 PyTorch.  The scale ``s`` stays float64.
- ``solve_dd_streamed`` (``pallas_solve_dd_streamed``, kernels
  ``_fwd_kernel_dd`` and ``_bwd_kernel_dd``): a forward sweep writing the
  float64 multipliers C and forward solution y of every lane to the
  workspace and keeping the lane's min |det S_i| (the Schur-pivot
  diagnostic), and a backward sweep carrying x in float64 and writing it
  as float32.  float32 out, float64 inside: the JAX contract.
- ``solve_beam_dd_streamed``: the assembly and the solve, ``(u, pivot)``,
  the role ``fem.accuracy.solve_beam_checked`` escalates large meshes to.
  On the card it is one forward and one backward launch of the same pair
  in its beam mode: helper warps assemble each row in float64 from the
  callers' float32 inputs, one rounding per op of
  ``assemble_beam_system_dd``, and the backward sweep writes u = x s.

A CPU tensor runs the plain version (``assemble_beam_system_dd`` and
``thomas_dd_reference``, the block-Thomas recurrence of
``ops/block_tridiag.py`` in float64 with the pivot); a CUDA tensor launches
the kernels, which take contiguous tensors as they lie, or raises: there is
no fallback.  ``LAUNCHES`` counts solves (one forward and one backward
launch each) by route, ``solve_dd_streamed`` the direct system solves and
``solve_beam_dd_streamed`` the beam solves; ``PLAIN_CALLS`` the calls sent
to the plain version.  The TPU kernels' node chunks and identity-padded
rows and lanes existed for VMEM and have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from openpystruct_tpu_torch.ops import _build
from openpystruct_tpu_torch.ops.beam_kernel import _check_lanes_first
from openpystruct_tpu_torch.ops.block_tridiag import (
    check_lanes_first,
    thomas_backward_reference,
    thomas_forward_reference,
)

LAUNCHES = {"solve_dd_streamed": 0, "solve_beam_dd_streamed": 0}
PLAIN_CALLS = {"solve_dd_streamed": 0, "solve_beam_dd_streamed": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The library of kernel #9 (``csrc/block_stream_dd.cu``)."""
    lib = _build.load("block_stream_dd")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.thomas_streamed_dd_f64.argtypes = [P] * 6 + [I] * 2 + [P]
    lib.beam_streamed_dd_f64.argtypes = ([P] * 5 + [D] * 2 + [P] * 3
                                         + [I] * 2 + [P])
    lib.stream_dd_ws_per_row.argtypes = [I]
    for fn in (lib.thomas_streamed_dd_f64, lib.beam_streamed_dd_f64,
               lib.stream_dd_ws_per_row):
        fn.restype = I
    return lib


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


def _workspace(lib, beam, B, n, dev):
    """The sweeps' private float64 workspace: C and y (and in the beam mode
    s) of every row, for lanes padded to whole 32-lane blocks."""
    per_row = lib.stream_dd_ws_per_row(int(beam))
    return torch.empty(-(-B // 32) * 32 * n * per_row, dtype=torch.float64,
                       device=dev)


def _run(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def launch_thomas_streamed_dd(diag, upper, b):
    """Launch the float64 forward and backward sweeps (kernel #9) on
    lanes-first float64 systems as they lie: diag (B, n, 3, 3), upper (B,
    n-1, 3, 3), b (B, n, 3), contiguous on one card
    (``block_tridiag.check_lanes_first``, before any build).  Returns x (B,
    n, 3) and the pivot (B,), float32."""
    B, n = check_lanes_first(diag, upper, b, dtype=torch.float64)
    dev = b.device
    lib = _lib()
    ws = _workspace(lib, False, B, n, dev)
    x = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.thomas_streamed_dd_f64(
            diag.data_ptr(), upper.data_ptr(), b.data_ptr(), ws.data_ptr(),
            x.data_ptr(), piv.data_ptr(), B, n, stream)
    _run(rc, "solve_dd_streamed")
    return x, piv


def launch_beam_streamed_dd(I, Le, free_mask, point_loads, udl, E, A):
    """Launch kernel #9's sweeps in their beam mode on the callers'
    lanes-first float32 inputs as they lie (``beam_kernel._check_lanes_first``,
    before any build): I, Le (B, n-1), free_mask (B, n, 3), point_loads (B,
    n), udl (B,).  Returns u (B, n, 3) and the pivot (B,), float32."""
    _check_lanes_first("solve_beam_dd_streamed", I, Le, free_mask,
                       point_loads, udl)
    B, nelem = I.shape
    n = nelem + 1
    dev = I.device
    lib = _lib()
    ws = _workspace(lib, True, B, n, dev)
    u = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    piv = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.beam_streamed_dd_f64(
            I.data_ptr(), Le.data_ptr(), free_mask.data_ptr(),
            point_loads.data_ptr(), udl.data_ptr(), float(E), float(E * A),
            ws.data_ptr(), u.data_ptr(), piv.data_ptr(), B, n, stream)
    _run(rc, "solve_beam_dd_streamed")
    return u, piv


def solve_dd_streamed(diag, upper, b):
    """Solve K x = b in float64 for a batch of symmetric block-tridiagonal
    systems of any length (``pallas_solve_dd_streamed``): diag (B, n, 3,
    3), upper (B, n-1, 3, 3), b (B, n, 3), float64.  Returns ``(x,
    pivot)``: x (B, n, 3) and min |det S_i| (B,), float32.  CPU tensors run
    the plain version; CUDA tensors (float64, contiguous) launch the
    kernels, with no layout copy."""
    if not diag.is_cuda:
        PLAIN_CALLS["solve_dd_streamed"] += 1
        return thomas_dd_reference(diag, upper, b)
    return launch_thomas_streamed_dd(diag, upper, b)


def solve_beam_dd_streamed(I, Le, free_mask, point_loads, udl, E: float,
                           A: float):
    """Batched beam FEA in float64 with no mesh ceiling: the float64
    assembly, then the streamed float64 solve.  ``free_mask`` is the (B, n,
    3) free-DOF mask (True or 1 = free), ``~constraint_mask(scenario)``.
    Returns ``(u, pivot)``: displacements (B, n, 3) and the float64 min
    Schur pivot of the scaled system (B,), in I's dtype.  CPU tensors run
    the plain version; CUDA tensors (float32, contiguous) launch the fused
    route, two launches and no assembled system in device memory."""
    if I.is_cuda:
        return launch_beam_streamed_dd(I, Le, free_mask, point_loads, udl,
                                       E, A)
    PLAIN_CALLS["solve_beam_dd_streamed"] += 1
    diag, upper, f, s = assemble_beam_system_dd(I, Le, free_mask,
                                                point_loads, udl, E, A)
    x, piv = thomas_dd_reference(diag, upper, f)
    return (x.to(s.dtype) * s).to(I.dtype), piv.to(I.dtype)
