"""Batched symmetric 3x3 block-tridiagonal solve (port of the JAX package's
``ops/block_tridiag.py``).

- ``block_tridiag_solve`` (``pallas_block_tridiag_solve``, kernel
  ``_thomas_kernel``): block-Thomas factorization fused with the forward
  sweep, then the back sweep, one launch per solve, C and y resident in the
  block's shared memory as the TPU kernel kept them in VMEM.  Where
  ``uses_streamed`` says so, the solve goes to the two-launch streamed
  kernel of ``ops/block_stream.py`` instead, the port's own dispatch; both
  give bitwise equal x.
- ``block_tridiag_solve(..., bidi=True)`` (kernel ``_thomas_kernel_bidi``):
  the bidirectional experiment, two elimination chains from the ends that
  meet at row n // 2, at every n >= 3 (the kernel has no mesh ceiling).
  The default route does not take it.
- ``solve_sym`` (``pallas_solve_sym``): the differentiable solve with
  ``refine`` compensated refinement sweeps, each a whole new solve of the
  compensated residual; its backward pass is one more refined solve.

``block_tridiag_solve`` sends a CPU tensor to the plain version
(``thomas_reference``, or ``thomas_bidi_reference`` with ``bidi``) and
launches a CUDA kernel on a CUDA float32 tensor, or raises; there is no
fallback.  The one-launch kernel (``csrc/block_resident.cu``) and the
bidirectional one (``csrc/block_tridiag.cu``) read the lanes-first systems
as they lie and write x lanes-first: no layout copy.  ``LAUNCHES``
counts kernel launches and ``PLAIN_CALLS`` the calls sent to the plain
version.  The plain versions repeat the kernels' arithmetic in their order
(the cofactor inverse times 1/det, 3x3 products summed over k = 0, 1, 2)
and take any leading batch dimensions; the kernels take (B, n, 3, 3)
systems.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openpystruct_tpu_torch.fem.solve import (
    block_tridiag_residual_compensated,
)
from openpystruct_tpu_torch.ops import _build

LAUNCHES = {"block_tridiag_solve": 0, "block_tridiag_solve_bidi": 0}
PLAIN_CALLS = {"block_tridiag_solve": 0, "block_tridiag_solve_bidi": 0}


def uses_streamed(n: int, B: int, sm_count: int) -> bool:
    """Whether ``block_tridiag_solve`` sends B lanes of n rows to the
    streamed kernel #6 rather than the one-launch kernel #4 on a card of
    ``sm_count`` SMs: #4 wherever it was no slower (chip_smoke.py phase 6,
    PERF.md, #4).  That is where every lane fits the card in one round of
    #4's blocks, 32 lanes an SM up to n = 101 and 16 up to n = 201: there
    both run the same chain in about the same device time, and #4 saves a
    launch and the workspace, host time that the compaction's small buckets
    pay.  Past one round, and from n = 301 on, #6 keeps more lanes in flight
    than #4's shared memory holds and takes less device time, which the
    device-bound full batch pays."""
    per_sm = 32 if n <= 101 else 16 if n <= 201 else 0
    return B > per_sm * sm_count


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version.  Blocks are (..., 3, 3) tensors; the recurrence is
# a Python loop over rows.
# ---------------------------------------------------------------------------


def _inv3_det(m):
    """Cofactor inverse of (..., 3, 3) blocks times 1/det, and det (the TPU
    kernel's ``_inv3_det``)."""
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
    inv_det = 1.0 / det
    cof = torch.stack([torch.stack([A, D, G], -1), torch.stack([B, E, H], -1),
                       torch.stack([C, F, I], -1)], -2)
    return cof * inv_det[..., None, None], det


def _inv3(m):
    return _inv3_det(m)[0]


def _mm(p, q):
    """p q, summed over k in order."""
    return (p[..., :, 0, None] * q[..., None, 0, :]
            + p[..., :, 1, None] * q[..., None, 1, :]
            + p[..., :, 2, None] * q[..., None, 2, :])


def _mtm(p, q):
    """p^T q."""
    return (p[..., 0, :, None] * q[..., None, 0, :]
            + p[..., 1, :, None] * q[..., None, 1, :]
            + p[..., 2, :, None] * q[..., None, 2, :])


def _mmt(p, q):
    """p q^T."""
    return (p[..., :, 0, None] * q[..., None, :, 0]
            + p[..., :, 1, None] * q[..., None, :, 1]
            + p[..., :, 2, None] * q[..., None, :, 2])


def _mv(p, v):
    return (p[..., :, 0] * v[..., 0, None] + p[..., :, 1] * v[..., 1, None]
            + p[..., :, 2] * v[..., 2, None])


def _mtv(p, v):
    return (p[..., 0, :] * v[..., 0, None] + p[..., 1, :] * v[..., 1, None]
            + p[..., 2, :] * v[..., 2, None])


def thomas_forward_reference(diag, upper, b, pivot=False):
    """Factorization fused with the forward sweep, from zero carries:
    S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i (U_{n-1} = 0),
    y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}).  Returns C (..., n, 3, 3) and
    y (..., n, 3), what the streamed forward kernel writes, and with
    ``pivot`` also min_i |det S_i| (...,), NaN if any det is."""
    n = diag.shape[-3]
    u_prev = torch.zeros_like(diag[..., 0, :, :])
    c_prev = torch.zeros_like(u_prev)
    y_prev = torch.zeros_like(b[..., 0, :])
    piv = torch.full_like(diag[..., 0, 0, 0], float("inf"))
    cs, ys = [], []
    for i in range(n):
        sinv, det = _inv3_det(diag[..., i, :, :] - _mtm(u_prev, c_prev))
        piv = torch.minimum(piv, det.abs())
        u = upper[..., i, :, :] if i < n - 1 else torch.zeros_like(u_prev)
        y_prev = _mv(sinv, b[..., i, :] - _mtv(u_prev, y_prev))
        c_prev = _mm(sinv, u)
        u_prev = u
        cs.append(c_prev)
        ys.append(y_prev)
    out = torch.stack(cs, -3), torch.stack(ys, -2)
    return (*out, piv) if pivot else out


def thomas_backward_reference(c, y):
    """Back sweep x_i = y_i - C_i x_{i+1} from a zero carry."""
    x = torch.zeros_like(y[..., 0, :])
    xs = []
    for i in range(y.shape[-2] - 1, -1, -1):
        x = y[..., i, :] - _mv(c[..., i, :, :], x)
        xs.append(x)
    return torch.stack(xs[::-1], -2)


def thomas_reference(diag, upper, b):
    """Plain version of the block-Thomas solve: diag (..., n, 3, 3), upper
    (..., n-1, 3, 3) (lower = upper^T), b (..., n, 3) -> x (..., n, 3)."""
    return thomas_backward_reference(*thomas_forward_reference(diag, upper, b))


def thomas_bidi_reference(diag, upper, b):
    """Plain version of the bidirectional solve (n >= 3), in its order:
    the left chain over rows [0, m) and the right chain over rows (m, n),
    m = n // 2, each from zero carries; the meeting row m; then the back
    sweeps outward.  Right chain: S'_k = D_k - U_k C'_{k+1}, C'_k =
    S'_k^-1 U_{k-1}^T, y'_k = S'_k^-1 (b_k - U_k y'_{k+1}).  Meeting row:
    S_m = D_m - U_{m-1}^T C_{m-1} - (U_m S'_{m+1}^-1) U_m^T."""
    n = diag.shape[-3]
    if n < 3:
        raise ValueError(f"the bidirectional solve needs n >= 3, got {n}")
    m = n // 2
    c, y, x = [None] * n, [None] * n, [None] * n
    zero = torch.zeros_like(diag[..., 0, :, :])
    u_l, c_l, y_l = zero, zero, torch.zeros_like(b[..., 0, :])
    for i in range(m):
        sinv = _inv3(diag[..., i, :, :] - _mtm(u_l, c_l))
        u = upper[..., i, :, :]
        y[i] = y_l = _mv(sinv, b[..., i, :] - _mtv(u_l, y_l))
        c[i] = c_l = _mm(sinv, u)
        u_l = u
    u_r, c_r, y_r = zero, zero, torch.zeros_like(b[..., 0, :])
    for k in range(n - 1, m, -1):
        sinv_r = _inv3(diag[..., k, :, :] - _mm(u_r, c_r))
        u = upper[..., k - 1, :, :]
        y[k] = y_r = _mv(sinv_r, b[..., k, :] - _mv(u_r, y_r))
        c[k] = c_r = _mmt(sinv_r, u)
        u_r = u
    s_m = (diag[..., m, :, :] - _mtm(u_l, c_l)) - _mmt(_mm(u_r, sinv_r), u_r)
    q = (b[..., m, :] - _mtv(u_l, y_l)) - _mv(u_r, y_r)
    x[m] = _mv(_inv3(s_m), q)
    for i in range(m - 1, -1, -1):
        x[i] = y[i] - _mv(c[i], x[i + 1])
    for k in range(m + 1, n):
        x[k] = y[k] - _mv(c[k], x[k - 1])
    return torch.stack(x, -2)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The library of kernel #5 (``csrc/block_tridiag.cu``)."""
    lib = _build.load("block_tridiag")
    lib.thomas_bidi_f32.argtypes = [_P] * 5 + [_I] * 2 + [_P]
    lib.thomas_bidi_f32.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _resident_lib():
    """The library of kernel #4 (``csrc/block_resident.cu``)."""
    lib = _build.load("block_resident")
    lib.thomas_resident_f32.argtypes = [_P] * 4 + [_I] * 2 + [_P]
    lib.thomas_resident_lanes.argtypes = [_I] * 2
    for fn in (lib.thomas_resident_f32, lib.thomas_resident_lanes):
        fn.restype = _I
    return lib


def check_system(diag, upper, b, dtype=torch.float32):
    """Raise unless (diag, upper, b) are ``dtype`` (B, n, 3, 3), (B, n-1, 3,
    3), (B, n, 3) on one device.  Returns (B, n)."""
    if diag.dim() != 4 or diag.shape[-2:] != (3, 3):
        raise ValueError(f"diag has shape {tuple(diag.shape)}, expected "
                         "(B, n, 3, 3)")
    B, n = diag.shape[:2]
    for name, t, shape in (("diag", diag, (B, n, 3, 3)),
                           ("upper", upper, (B, n - 1, 3, 3)),
                           ("b", b, (B, n, 3))):
        if t.device != diag.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{diag.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    return B, n


def check_lanes_first(diag, upper, b, dtype=torch.float32, min_n=1):
    """Raise unless (diag, upper, b) are contiguous ``dtype`` (B, n, 3, 3),
    (B, n-1, 3, 3), (B, n, 3) on one CUDA device with n >= ``min_n``:
    kernels #4, #5 and #6 (float32) and #9 (float64) read them as they lie
    and copy none.  Returns (B, n)."""
    B, n = check_system(diag, upper, b, dtype)
    if n < min_n:
        raise ValueError(f"the kernel needs n >= {min_n} nodes, got {n}")
    for name, t in (("diag", diag), ("upper", upper), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: the kernel reads the "
                             "lanes-first layout as it lies and copies none")
    if not diag.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {diag.device}")
    return B, n


def resident_lanes(B: int, n: int, device=None) -> int:
    """Lanes per block kernel #4 takes for B lanes of n rows on ``device``
    (the current CUDA device by default); 0 where one lane's C and y do not
    fit a block's shared memory, and the launch would raise."""
    with torch.cuda.device(device):
        lanes = _resident_lib().thomas_resident_lanes(B, n)
    if lanes < 0:
        raise RuntimeError(f"thomas_resident_lanes failed: CUDA error "
                           f"{-lanes}")
    return lanes


def launch_thomas(diag, upper, b):
    """Launch kernel #4 on lanes-first float32 systems as they lie: diag
    (B, n, 3, 3), upper (B, n-1, 3, 3), b (B, n, 3), contiguous on one card
    (``check_lanes_first``, before any build).  The kernel picks its lanes
    per block from B, n and the card, and raises where one lane does not
    fit a block (``resident_lanes``).  Returns x (B, n, 3)."""
    B, n = check_lanes_first(diag, upper, b)
    dev = b.device
    lib = _resident_lib()
    x = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.thomas_resident_f32(diag.data_ptr(), upper.data_ptr(),
                                     b.data_ptr(), x.data_ptr(), B, n, stream)
    if rc != 0:
        raise RuntimeError(f"block_tridiag_solve launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["block_tridiag_solve"] += 1
    return x


def launch_thomas_bidi(diag, upper, b):
    """Launch kernel #5 on lanes-first float32 systems as they lie: diag
    (B, n, 3, 3), upper (B, n-1, 3, 3), b (B, n, 3), contiguous on one card,
    n >= 3 (``check_lanes_first``, before any build).  The kernel picks its
    lanes per block from B and the card.  Returns x (B, n, 3)."""
    B, n = check_lanes_first(diag, upper, b, min_n=3)
    dev = b.device
    lib = _lib()
    # C and y, (blocks, n, 12, lanes per block): lanes per block divide 32
    ws = torch.empty(-(-B // 32) * 32 * n * 12, dtype=torch.float32,
                     device=dev)
    x = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.thomas_bidi_f32(diag.data_ptr(), upper.data_ptr(),
                                 b.data_ptr(), ws.data_ptr(), x.data_ptr(),
                                 B, n, stream)
    if rc != 0:
        raise RuntimeError(f"block_tridiag_solve(bidi=True) launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["block_tridiag_solve_bidi"] += 1
    return x


def block_tridiag_solve(diag, upper, b, bidi=False):
    """Solve K x = b for a batch of symmetric block-tridiagonal systems
    (``pallas_block_tridiag_solve``): diag (B, n, 3, 3), upper (B, n-1, 3,
    3) with lower = upper^T, b (B, n, 3) -> x (B, n, 3).  CPU tensors run
    the plain version; CUDA tensors (float32) launch the one-launch kernel
    #4, or the streamed #6 where ``uses_streamed`` says so.  ``bidi=True``
    takes the bidirectional kernel at every n >= 3 and raises
    ``ValueError`` below."""
    if bidi:
        n = diag.shape[-3]
        if n < 3:
            raise ValueError(f"bidi=True needs n >= 3 nodes, got {n}")
        if not diag.is_cuda:
            PLAIN_CALLS["block_tridiag_solve_bidi"] += 1
            return thomas_bidi_reference(diag, upper, b)
        return launch_thomas_bidi(diag.contiguous(), upper.contiguous(),
                                  b.contiguous())
    if not diag.is_cuda:
        PLAIN_CALLS["block_tridiag_solve"] += 1
        return thomas_reference(diag, upper, b)
    B, n = check_system(diag, upper, b)
    sms = torch.cuda.get_device_properties(diag.device).multi_processor_count
    if uses_streamed(n, B, sms):
        from openpystruct_tpu_torch.ops.block_stream import (
            block_tridiag_solve_streamed,
        )

        return block_tridiag_solve_streamed(diag, upper, b)
    return launch_thomas(diag.contiguous(), upper.contiguous(),
                         b.contiguous())


# ---------------------------------------------------------------------------
# Differentiable refined solve
# ---------------------------------------------------------------------------


def _refined(diag, upper, b, refine):
    """A solve, then ``refine`` sweeps: each solves the compensated residual
    anew and adds the correction (``_pallas_refined``)."""
    x = block_tridiag_solve(diag, upper, b)
    for _ in range(refine):
        r = block_tridiag_residual_compensated(diag, upper, b, x)
        x = x + block_tridiag_solve(diag, upper, r)
    return x


class _SolveSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, diag, upper, b, refine):
        x = _refined(diag, upper, b, refine)
        ctx.refine = refine
        ctx.save_for_backward(diag, upper, x)
        return x

    @staticmethod
    def backward(ctx, g):
        diag, upper, x = ctx.saved_tensors
        # K is symmetric: the adjoint system is K itself
        lam = _refined(diag, upper, g.contiguous(), ctx.refine)
        diag_bar = -lam[..., :, :, None] * x[..., :, None, :]
        # the stored upper block feeds both bands of K:
        # upper_bar_i = -lam_i x_{i+1}^T - x_i lam_{i+1}^T
        upper_bar = (-lam[..., :-1, :, None] * x[..., 1:, None, :]
                     - x[..., :-1, :, None] * lam[..., 1:, None, :])
        return diag_bar, upper_bar, lam, None


def solve_sym(diag, upper, b, refine=0):
    """Differentiable batched symmetric solve with ``refine`` compensated
    refinement sweeps (``pallas_solve_sym``).  Shapes of
    ``block_tridiag_solve``; the backward pass is one more refined solve."""
    return _SolveSym.apply(diag, upper, b, refine)
