"""Batched beam model (port of ``fem/beam.py``).

Nodes on a line, a pin at node 0 (``fix(1,1,1,0)``), rollers as
y-constraints at arbitrary nodes (``fix(n,0,1,0)``), ``elasticBeamColumn``
elements with per-element moments of inertia, nodal point loads and a
uniform UDL on every element (OpenPyStruct_BeamOpt.py:91-144).  Scenarios
are fixed-shape and masked; every function takes leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from openpystruct_tpu_torch.fem.elements import (
    beam_element_stiffness,
    element_end_forces,
    udl_equivalent_loads,
)
from openpystruct_tpu_torch.fem.solve import (
    block_tridiag_min_pivot,
    block_tridiag_solve,
)


@dataclasses.dataclass
class BeamScenario:
    """Load/support configurations, batched over leading dimensions.

    node_x (..., n) node positions (m); roller_mask (..., n) bool, True where
    a roller constrains uy (node 0 is always pinned); point_loads (..., n)
    nodal Fy (N), 0 where no load; udl (...) uniform load on every element
    (N/m).  roller_order/force_order (..., n) int32: the node's draw
    position among the selected rollers/forces (>= n where unselected), which
    the JSON writer honours; None means ascending node order.
    """

    node_x: torch.Tensor
    roller_mask: torch.Tensor
    point_loads: torch.Tensor
    udl: torch.Tensor
    roller_order: Optional[torch.Tensor] = None
    force_order: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.node_x.shape[-1]

    def map(self, fn) -> "BeamScenario":
        """Apply ``fn`` to every tensor field (None stays None)."""
        return BeamScenario(**{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class BeamSolution:
    """FE solution fields (names follow the reference's dataset schema,
    OpenPyStruct_BeamOpt_training_SingleCore.py:73-87)."""

    displacements: torch.Tensor  # (..., n, 3) (ux, uy, rz)
    deflections: torch.Tensor    # (..., n)
    rotations: torch.Tensor      # (..., n)
    shear_forces: torch.Tensor   # (..., nelem)
    bending_moments: torch.Tensor  # (..., nelem)
    # (..., nelem, 6) end forces; None on the fused path, which recovers
    # only the V/M components the losses and datasets use
    end_forces: Optional[torch.Tensor] = None


def constraint_mask(scenario: BeamScenario) -> torch.Tensor:
    """(..., n, 3) bool mask of constrained DOFs: pin (ux, uy) at node 0
    plus roller uy constraints."""
    rm = scenario.roller_mask
    con = torch.zeros(rm.shape + (3,), dtype=torch.bool, device=rm.device)
    con[..., 0, 0] = True
    con[..., 0, 1] = True
    con[..., :, 1] |= rm
    return con


def assemble_beam_system(I, scenario: BeamScenario, E, A):
    """Assemble the constrained block-tridiagonal system K(I) u = f.

    Returns (diag (..., n, 3, 3), upper (..., n-1, 3, 3), rhs (..., n, 3)).
    Constraints mask rows/columns and keep the original diagonal entry,
    which preserves symmetry, bandedness and differentiability.
    """
    Le = torch.diff(scenario.node_x, dim=-1)
    k_all = beam_element_stiffness(E, A, I, Le)   # (..., nelem, 6, 6)
    dtype = k_all.dtype
    # node i collects k_i's top-left block, then k_{i-1}'s bottom-right
    diag = (F.pad(k_all[..., :3, :3], (0, 0, 0, 0, 0, 1))
            + F.pad(k_all[..., 3:, 3:], (0, 0, 0, 0, 1, 0)))
    upper = k_all[..., :3, 3:]

    zero = torch.zeros_like(scenario.point_loads, dtype=dtype)
    f = torch.stack([zero, scenario.point_loads.to(dtype), zero], dim=-1)
    feq = udl_equivalent_loads(scenario.udl[..., None].to(dtype), Le)
    f = f + F.pad(feq[..., :3], (0, 0, 0, 1))
    f = f + F.pad(feq[..., 3:], (0, 0, 1, 0))

    con = constraint_mask(scenario)
    free = (~con).to(dtype)
    orig_dd = torch.diagonal(diag, dim1=-2, dim2=-1)
    diag = diag * free[..., :, :, None] * free[..., :, None, :]
    # re-install the original (positive) diagonal entry on constrained
    # DOFs to keep the system well-scaled and SPD
    eye = torch.eye(3, dtype=dtype, device=diag.device)
    diag = diag + eye * (con.to(dtype) * orig_dd)[..., :, None, :]
    upper = upper * free[..., :-1, :, None] * free[..., 1:, None, :]
    f = f * free
    return diag, upper, f


def beam_min_pivot(I, scenario: BeamScenario, E, A):
    """Min Schur-pivot determinant of the scaled system (the singularity
    diagnostic, see :func:`block_tridiag_min_pivot`)."""
    diag, upper, _ = assemble_beam_system(I, scenario, E, A)
    return block_tridiag_min_pivot(diag, upper)


def solve_beam(I, scenario: BeamScenario, E, A, refine: int = 0,
               jacobi_scale: bool = True) -> BeamSolution:
    """Linear static solve (one ``ops.analyze(1)`` + response sweep,
    OpenPyStruct_BeamOpt.py:206-210), differentiable in ``I`` through the
    solver's implicit adjoint.  ``jacobi_scale`` symmetrically pre-scales
    the system, equilibrating the translation-vs-rotation scale disparity
    before a float32 factorization."""
    diag, upper, f = assemble_beam_system(I, scenario, E, A)
    if jacobi_scale:
        s = torch.rsqrt(torch.diagonal(diag, dim1=-2, dim2=-1))
        diag_s = diag * s[..., :, :, None] * s[..., :, None, :]
        upper_s = upper * s[..., :-1, :, None] * s[..., 1:, None, :]
        u = block_tridiag_solve(diag_s, upper_s, f * s, refine=refine) * s
    else:
        u = block_tridiag_solve(diag, upper, f, refine=refine)
    return _solution(u, I, scenario, E, A)


def _solution(u, I, scenario: BeamScenario, E, A) -> BeamSolution:
    """The solution fields of displacements u (..., n, 3), with the element
    end forces recovered from them."""
    u_e = torch.cat([u[..., :-1, :], u[..., 1:, :]], dim=-1)  # (..., nelem, 6)
    Le = torch.diff(scenario.node_x, dim=-1)
    end_forces = element_end_forces(u_e, E, A, I, Le,
                                    scenario.udl[..., None].to(u.dtype))
    return BeamSolution(
        displacements=u,
        deflections=u[..., 1],
        rotations=u[..., 2],
        shear_forces=end_forces[..., 1],
        bending_moments=end_forces[..., 2],
        end_forces=end_forces,
    )


def solve_beam_batched(I, scenario: BeamScenario, E, A,
                       refine: int = 0) -> BeamSolution:
    """Batched solve on the split path: ``I`` is (B, nelem), every scenario
    field has a leading batch dim.  Assembly, Jacobi scaling and force
    recovery are plain tensor code; the solve is ``ops.block_tridiag.
    solve_sym`` with ``refine`` refinement sweeps, which launches the
    block-Thomas kernel on a CUDA float32 batch (or raises) and runs its
    plain version on a CPU one.  Differentiable in ``I``."""
    from openpystruct_tpu_torch.ops.block_tridiag import solve_sym

    diag, upper, f = assemble_beam_system(I, scenario, E, A)
    s = torch.rsqrt(torch.diagonal(diag, dim1=-2, dim2=-1))   # (B, n, 3)
    diag_s = diag * s[..., :, None] * s[..., None, :]
    upper_s = upper * s[..., :-1, :, None] * s[..., 1:, None, :]
    return _solution(solve_sym(diag_s, upper_s, f * s, refine) * s, I,
                     scenario, E, A)
