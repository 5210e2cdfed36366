"""2D Euler-Bernoulli beam-column element (port of ``fem/elements.py``).

The element OpenSees builds for ``elasticBeamColumn`` with a ``Linear``
transform on a horizontal member (OpenPyStruct_BeamOpt.py:107-109).  DOF
order per node: (ux, uy, rz); element vector (ux_i, uy_i, rz_i, ux_j, uy_j,
rz_j).  All arguments broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def beam_element_stiffness(E, A, I, Le):
    """6x6 element stiffness, shape ``broadcast(I, Le) + (6, 6)``."""
    ea = E * A / Le
    eil = E * I / Le
    eil2 = eil / Le          # E I / Le^2
    eil3 = eil2 / Le         # E I / Le^3
    ea, eil, eil2, eil3 = torch.broadcast_tensors(ea, eil, eil2, eil3)
    z = torch.zeros_like(eil)

    k11, k12, k13 = 12.0 * eil3, 6.0 * eil2, 4.0 * eil
    k2 = 2.0 * eil

    rows = [
        [ea,   z,     z,    -ea,  z,     z],
        [z,    k11,   k12,  z,    -k11,  k12],
        [z,    k12,   k13,  z,    -k12,  k2],
        [-ea,  z,     z,    ea,   z,     z],
        [z,    -k11,  -k12, z,    k11,   -k12],
        [z,    k12,   k2,   z,    -k12,  k13],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def udl_equivalent_loads(w, Le):
    """Consistent nodal loads of a uniform transverse load ``w`` (N/m, +y):
    half the load to each node plus the +/- w Le^2/12 fixed-end moments
    (OpenSees ``eleLoad '-beamUniform'``, OpenPyStruct_BeamOpt.py:117-119).
    Shape ``broadcast(w, Le) + (6,)``."""
    w, Le = torch.broadcast_tensors(torch.as_tensor(w, dtype=Le.dtype,
                                                    device=Le.device), Le)
    z = torch.zeros_like(Le)
    half = w * Le / 2.0
    m = w * Le * Le / 12.0
    return torch.stack([z, half, m, z, half, -m], dim=-1)


def element_end_forces(u_e, E, A, I, Le, w=0.0):
    """Element end forces ``k_e @ u_e - f_eq(w)`` (OpenSees
    ``eleResponse(e, 'forces')``, OpenPyStruct_BeamOpt.py:136-138).
    Returns ``(..., 6)``: (N_i, V_i, M_i, N_j, V_j, M_j)."""
    k = beam_element_stiffness(E, A, I, Le)
    # an elementwise product and sum, not a matmul: no TF32 path exists
    f = (k * u_e[..., None, :]).sum(-1)
    return f - udl_equivalent_loads(w, Le)
