"""Combined structural loss (port of ``opt/loss.py``).

Reference ``compute_combined_loss`` (OpenPyStruct_BeamOpt.py:128-168):

    total = sum(I) + alpha_m * sum(M^2 / (2 E I + 1e-6))
                   + alpha_s * sum(V^2 / (G * 0.03 * sqrt(I)))

The reference wraps the fetched moments/shears in fresh leaf tensors
(OpenPyStruct_BeamOpt.py:150-151), so its gradient treats M and V as
constants: ``grad_mode="semi"`` detaches them; ``"adjoint"`` keeps the exact
gradient through the FE solve.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LossComponents:
    total: torch.Tensor
    primary: torch.Tensor         # sum(I)
    bending_energy: torch.Tensor  # already scaled by alpha_moment
    shear_energy: torch.Tensor    # already scaled by alpha_shear


def structural_loss(I, bending_moments, shear_forces, E, G,
                    alpha_moment=1e-2, alpha_shear=1e-2,
                    grad_mode: str = "semi") -> LossComponents:
    """Sum-of-inertia + bending-energy + shear-energy loss, summed over the
    last (element) dimension.  Constants match the reference: the +1e-6
    bending guard (OpenPyStruct_BeamOpt.py:154) and the proportional shear
    area A = 0.03 sqrt(I) (:157-160)."""
    if grad_mode == "semi":
        bending_moments = bending_moments.detach()
        shear_forces = shear_forces.detach()
    elif grad_mode != "adjoint":
        raise ValueError(f"unknown grad_mode: {grad_mode!r}")

    bending = torch.sum(bending_moments**2 / (2.0 * E * I + 1e-6), dim=-1)
    A_approx = 0.03 * torch.sqrt(I)
    shear = torch.sum(shear_forces**2 / (G * A_approx), dim=-1)
    primary = torch.sum(I, dim=-1)
    b = alpha_moment * bending
    s = alpha_shear * shear
    return LossComponents(total=primary + b + s, primary=primary,
                          bending_energy=b, shear_energy=s)
