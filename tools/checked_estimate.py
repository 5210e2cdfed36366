#!/usr/bin/env python3
"""The accuracy autopilot's error estimates against the true error, in
float32 on the CPU, on the fixed 200 m span of tests/test_accuracy.py.

    python3 tools/checked_estimate.py

For each mesh and lane it prints the last compensated-refinement
correction (``_scaled_solve_with_estimate``, the JAX package's estimate
computed eagerly, with the compensation intact), the port's correction from
the float64 residual (``_float64_estimate``), and the true relative
deflection error of the float32 solution against the plain float64 solve of
the same float32 inputs.  The compensated residual is exact for the
float32-assembled system, so the first estimate cannot see the assembly's
rounding; the second can.  The JAX package jits its estimate, and XLA's
CPU jit drops the compensation, which makes it see that rounding as noise;
this script does not run JAX.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from openpystruct_tpu_torch.fem import accuracy  # noqa: E402
from openpystruct_tpu_torch.fem.beam import (  # noqa: E402
    BeamScenario,
    assemble_beam_system,
)
from openpystruct_tpu_torch.ops.block_tridiag import thomas_reference  # noqa: E402

E, A, B, SEED = 200e9, 0.01, 4, 0


def fixed_span(n, gen):
    """Rollers at tags 10/30/70/85/100 of the 101-node mesh scaled to n,
    one mid-span load, I = 0.05 U(0.2, 2), float32."""
    roller = torch.zeros((B, n), dtype=torch.bool)
    roller[:, [t * (n - 1) // 100 for t in (9, 29, 69, 84, 99)]] = True
    loads = torch.zeros((B, n))
    loads[:, n // 2] = -3.5e5 * (0.5 + torch.rand(B, generator=gen))
    I = 0.05 * (0.2 + 1.8 * torch.rand((B, n - 1), generator=gen))
    return I, BeamScenario(node_x=torch.linspace(0.0, 200.0, n).repeat(B, 1),
                           roller_mask=roller, point_loads=loads,
                           udl=torch.full((B,), -1000.0))


def main():
    gen = torch.Generator().manual_seed(SEED)
    print("n, lane: eager compensated estimate | float64-residual estimate "
          "| true error")
    for n in (101, 201, 301, 501):
        I, sc = fixed_span(n, gen)
        diag, upper, f = assemble_beam_system(I, sc, E, A)
        x, s, est = accuracy._scaled_solve_with_estimate(diag, upper, f)
        est64 = accuracy._float64_estimate(I, sc, E, A, diag, upper, s, x)
        sc64 = sc.map(lambda t: t.double() if t.is_floating_point() else t)
        d, u, f64 = assemble_beam_system(I.double(), sc64, E, A)
        s64 = torch.rsqrt(torch.diagonal(d, dim1=-2, dim2=-1))
        truth = thomas_reference(
            d * s64[..., :, None] * s64[..., None, :],
            u * s64[..., :-1, :, None] * s64[..., 1:, None, :],
            f64 * s64) * s64
        err = (((x * s).double() - truth)[..., 1].abs().amax(-1)
               / truth[..., 1].abs().amax(-1))
        for b in range(B):
            print(f"{n:4d}, {b}: {est[b].item():.3e} | {est64[b].item():.3e} "
                  f"| {err[b].item():.3e}")


if __name__ == "__main__":
    main()
