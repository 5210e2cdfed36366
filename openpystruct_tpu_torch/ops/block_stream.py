"""Streamed block-tridiagonal solve (port of the JAX package's
``ops/block_stream.py``).

``block_tridiag_solve_streamed`` (``pallas_block_tridiag_solve_streamed``,
kernels ``_fwd_kernel`` and ``_bwd_kernel``): the block-Thomas solve of
``ops/block_tridiag.py`` as two launches, a forward sweep that writes the
back-substitution multipliers C (n, 3, 3) and the forward solution y (n, 3)
of every lane to device memory, and a backward sweep that reads them back
in reverse.  On the TPU this was the mesh-size regime past VMEM, streamed in
64-node chunks; on the card each thread walks all rows, so the chunks have
no counterpart, and ``block_tridiag_solve`` sends meshes here from its own
threshold (``block_tridiag.STREAM_FROM_N``).

A CPU tensor runs the plain version, ``thomas_reference`` split at the same
point (``thomas_forward_reference`` then ``thomas_backward_reference``); a
CUDA float32 tensor launches the kernels (``csrc/block_tridiag.cu``), or
raises.  ``LAUNCHES`` counts solves (one forward and one backward launch
each) and ``PLAIN_CALLS`` the calls sent to the plain version.
"""

from __future__ import annotations

import torch

from openpystruct_tpu_torch.ops.block_tridiag import (
    _lib,
    check_system,
    lanes_first,
    lanes_last,
    thomas_backward_reference,
    thomas_forward_reference,
)

LAUNCHES = {"block_tridiag_solve_streamed": 0}
PLAIN_CALLS = {"block_tridiag_solve_streamed": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def launch_thomas_streamed(diag_t, upper_t, b_t):
    """Launch the forward and backward sweeps (kernel #6) on lane-innermost
    float32 systems (layouts of ``block_tridiag.launch_thomas``).  Returns
    x_t (n, 3, B)."""
    n, B = b_t.shape[0], b_t.shape[-1]
    dev = b_t.device
    c = torch.empty((n, 3, 3, B), dtype=torch.float32, device=dev)
    y = torch.empty((n, 3, B), dtype=torch.float32, device=dev)
    x = torch.empty_like(y)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().thomas_streamed_f32(
            diag_t.data_ptr(), upper_t.data_ptr(), b_t.data_ptr(),
            c.data_ptr(), y.data_ptr(), x.data_ptr(), B, n, stream)
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
    check_system(diag, upper, b)
    return lanes_first(launch_thomas_streamed(
        lanes_last(diag), lanes_last(upper), lanes_last(b)))
