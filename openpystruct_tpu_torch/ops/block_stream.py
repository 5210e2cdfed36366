"""Streamed block-tridiagonal solve (port of the JAX package's
``ops/block_stream.py``).

``block_tridiag_solve_streamed`` (``pallas_block_tridiag_solve_streamed``,
kernels ``_fwd_kernel`` and ``_bwd_kernel``): the block-Thomas solve of
``ops/block_tridiag.py`` as two launches, a forward sweep that writes the
back-substitution multipliers C (n, 3, 3) and the forward solution y (n, 3)
of every lane to a workspace in device memory, and a backward sweep that
reads them back in reverse.  On the TPU this was the mesh-size regime past
VMEM, streamed in 64-node chunks; on the card each lane's thread walks all
rows, and ``block_tridiag_solve`` sends systems here by its own dispatch
(``block_tridiag.uses_streamed``).

A CPU tensor runs the plain version, ``thomas_reference`` split at the same
point (``thomas_forward_reference`` then ``thomas_backward_reference``); a
CUDA float32 tensor launches the kernels (``csrc/block_stream.cu``), which
read the lanes-first systems as they lie and write x lanes-first: no layout
copy.  There is no fallback: a failed build or launch raises.
``LAUNCHES`` counts solves (one forward and one backward launch each) and
``PLAIN_CALLS`` the calls sent to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openpystruct_tpu_torch.ops import _build
from openpystruct_tpu_torch.ops.block_tridiag import (
    check_lanes_first,
    thomas_backward_reference,
    thomas_forward_reference,
)

LAUNCHES = {"block_tridiag_solve_streamed": 0}
PLAIN_CALLS = {"block_tridiag_solve_streamed": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The library of kernel #6 (``csrc/block_stream.cu``)."""
    lib = _build.load("block_stream")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.thomas_streamed_f32.argtypes = [P] * 5 + [I] * 2 + [P]
    lib.thomas_streamed_f32.restype = I
    return lib


def launch_thomas_streamed(diag, upper, b):
    """Launch the forward and backward sweeps (kernel #6) on lanes-first
    float32 systems as they lie: diag (B, n, 3, 3), upper (B, n-1, 3, 3),
    b (B, n, 3), contiguous on one card (``block_tridiag.check_lanes_first``,
    before any build).  The kernel picks its lanes per block from B and the
    card.  Returns x (B, n, 3)."""
    B, n = check_lanes_first(diag, upper, b)
    dev = b.device
    lib = _lib()
    # C and y, (blocks, n, 12, lanes per block): lanes per block divide 32
    ws = torch.empty(-(-B // 32) * 32 * n * 12, dtype=torch.float32,
                     device=dev)
    x = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.thomas_streamed_f32(
            diag.data_ptr(), upper.data_ptr(), b.data_ptr(), ws.data_ptr(),
            x.data_ptr(), B, n, stream)
    if rc != 0:
        raise RuntimeError(f"block_tridiag_solve_streamed launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["block_tridiag_solve_streamed"] += 1
    return x


def block_tridiag_solve_streamed(diag, upper, b):
    """Solve K x = b for a batch of symmetric block-tridiagonal systems in
    two sweeps through device memory.  Contract of
    ``block_tridiag.block_tridiag_solve``: diag (B, n, 3, 3), upper (B,
    n-1, 3, 3), b (B, n, 3) -> x (B, n, 3)."""
    if not diag.is_cuda:
        PLAIN_CALLS["block_tridiag_solve_streamed"] += 1
        return thomas_backward_reference(
            *thomas_forward_reference(diag, upper, b))
    return launch_thomas_streamed(diag.contiguous(), upper.contiguous(),
                                  b.contiguous())
