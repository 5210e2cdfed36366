"""2D frame finite elements (port of ``fem/frame.py``).

The reference's ``setup_frame_model``
(OpenPyStruct_FrameOpt_Discrete_Beta.py:75-139): a (stories+1) x (bays+1)
node grid, fixed base (``fix(tag,1,1,1)`` at y=0), column elements then beam
elements, lateral nodal loads on the x=0 nodes above ground, and a uniform
load on beam elements only.

Faithful-parity notes (as in the JAX package):
- the reference's ``eleLoad '-beamUniform' w, w`` passes TWO arguments: in
  OpenSees 2D these are (Wy, Wx), transverse AND axial distributed load,
  both equal to ``vertical_load``.  Both components are applied here.
- ``end_forces`` are element resisting forces in GLOBAL coordinates (what
  ``eleResponse(e,'forces')`` returns), so for a vertical column index 1 is
  the global-Y force, the member's AXIAL force.  The reference's frame loss
  reads exactly that index (FrameOpt_Discrete_Beta.py:151-153).
- the problem is linear, so the reference's Newton iteration (FrameOpt:138)
  converges in one step; a direct linear solve is exactly equivalent.

Every function takes I with leading batch dimensions, ``(..., E)``, and
per-lane ``udl``/``lateral_load`` that broadcast to them; the structure
fixes the device.  Assembly is deterministic: each entry of K, of the
story-level blocks and of f sums a fixed list of element contributions in a
fixed order (gather tables built once per topology), never an atomic
scatter, so a call gives the same bits every time on the card.

Precision: float32 frame math never runs in TF32.  The small per-element
contractions are elementwise products and sums (no matmul, so no TF32
path), and the solves, forward and backward, run their matmuls, triangular
solves and factorizations inside :func:`full_float32`, which turns TF32 off
for the call and restores the caller's setting after it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.elements import beam_element_stiffness


@contextlib.contextmanager
def full_float32():
    """float32 matmuls in full float32 (no TF32) inside the block, whatever
    the caller set; the caller's setting is restored on exit.  A caller that
    set TF32 through the newer ``fp32_precision`` flags is answered in the
    same flags (torch refuses a mix of the two)."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:
        matmul = torch.backends.cuda.matmul
        prev = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = prev
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@dataclasses.dataclass
class FramePlan:
    """A deterministic scatter-add of n sources into ``size`` targets:
    source i goes to target ``inv[i]`` (``size``: nowhere), and target
    ``pos[p]`` sums the sources ``table[p]`` in that order (index n: a zero
    pad)."""

    pos: torch.Tensor     # (P,) targets that receive a source
    table: torch.Tensor   # (P, c) their sources, padded with n
    inv: torch.Tensor     # (n,) the target of each source
    size: int


def _plan(tgt: np.ndarray, size: int, device) -> FramePlan:
    """The plan that sums source i into target ``tgt[i]`` (< 0: dropped),
    the sources of one target in ascending order."""
    live = np.flatnonzero(tgt >= 0)
    order = live[np.argsort(tgt[live], kind="stable")]
    pos, start, counts = np.unique(tgt[order], return_index=True,
                                   return_counts=True)
    group = np.repeat(np.arange(len(pos)), counts)
    table = np.full((len(pos), int(counts.max())), len(tgt), np.int64)
    table[group, np.arange(len(order)) - start[group]] = order
    inv = np.where(tgt >= 0, tgt, size)

    def put(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return FramePlan(pos=put(pos), table=put(table), inv=put(inv),
                     size=size)


def _pad(x):
    return torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)


def _sum_into(vals, plan: FramePlan):
    out = vals.new_zeros(vals.shape[0], plan.size)
    out[:, plan.pos] = _pad(vals)[:, plan.table].sum(-1)
    return out


def _take(x, plan: FramePlan):
    return _pad(x)[:, plan.inv]


class _Assemble(torch.autograd.Function):
    """(B, n) -> (B, size) through a plan; the backward is a gather."""

    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan = plan
        return _sum_into(vals, plan)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _take(g, ctx.plan), None


class _Take(torch.autograd.Function):
    """(B, size) -> (B, n), ``x[:, inv]``; the backward sums the
    repeated targets through the plan, never with atomics."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _take(x, plan)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _sum_into(g, ctx.plan), None


def assemble(vals, plan: FramePlan):
    """Deterministic scatter-add of (B, n) contributions through
    ``plan``, differentiable."""
    return _Assemble.apply(vals, plan)


def take(x, plan: FramePlan):
    """``x[:, plan.inv]`` with a deterministic backward."""
    return _Take.apply(x, plan)


@dataclasses.dataclass
class FrameStructure:
    """Static frame topology on one device, with its assembly tables."""

    node_xy: torch.Tensor       # (N, 2) float64 coordinates
    elems: torch.Tensor         # (E, 2) node indices (0-based)
    is_beam: torch.Tensor       # (E,) True for horizontal beam members
    fixed_mask: torch.Tensor    # (N,) True where the base is fully fixed
    lateral_mask: torch.Tensor  # (N,) True where the lateral load applies
    num_bays: int = 0
    num_stories: int = 0
    # deterministic assembly: dense K (3N x 3N) and the story blocks D and U
    # (one plan, D's entries first) from the (E, 6, 6) element matrices;
    # f (3N) from the (E, 6) element loads and the N lateral loads; the
    # element ends' DOFs (E x 6) from the 3N nodal DOFs (its transpose)
    k_plan: FramePlan = dataclasses.field(default=None, repr=False)
    block_plan: FramePlan = dataclasses.field(default=None, repr=False)
    f_plan: FramePlan = dataclasses.field(default=None, repr=False)
    dof_plan: FramePlan = dataclasses.field(default=None, repr=False)

    @property
    def num_nodes(self) -> int:
        return self.node_xy.shape[0]

    @property
    def num_elems(self) -> int:
        return self.elems.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_xy.device


@dataclasses.dataclass
class FrameSolution:
    displacements: torch.Tensor  # (..., N, 3)
    end_forces: torch.Tensor     # (..., E, 6) global-coordinate resisting forces


def _element_dofs(elems: np.ndarray) -> np.ndarray:
    """(E, 6) global DOF numbers of each element's two nodes."""
    r3 = np.arange(3)
    return np.concatenate([3 * elems[:, 0:1] + r3, 3 * elems[:, 1:2] + r3],
                          axis=1)


def build_frame(num_bays: int, num_stories: int,
                cfg: FrameConfig = FrameConfig(),
                device="cuda") -> FrameStructure:
    """Node grid + column/beam element lists on ``device``, ordered exactly
    as the reference builds them: all columns story by story, then all beams
    (FrameOpt_Discrete_Beta.py:97-114); the I vector indexes elements in
    this order."""
    device = resolve_device(device)
    nb, ns = num_bays, num_stories
    cols = nb + 1
    xy = np.zeros(((ns + 1) * cols, 2), np.float64)
    for i in range(ns + 1):
        for j in range(cols):
            xy[i * cols + j] = (j * cfg.bay_width, i * cfg.story_height)

    elems, is_beam = [], []
    for i in range(ns):            # columns
        for j in range(cols):
            elems.append((i * cols + j, (i + 1) * cols + j))
            is_beam.append(False)
    for i in range(1, ns + 1):     # beams
        for j in range(nb):
            elems.append((i * cols + j, i * cols + j + 1))
            is_beam.append(True)
    elems = np.asarray(elems, np.int64)
    fixed = xy[:, 1] == 0.0
    lateral = (xy[:, 0] == 0.0) & (xy[:, 1] > 0.0)

    N, E = len(xy), len(elems)
    dof = _element_dofs(elems)                           # (E, 6)
    rows = np.broadcast_to(dof[:, :, None], (E, 6, 6)).reshape(-1)
    cols_ = np.broadcast_to(dof[:, None, :], (E, 6, 6)).reshape(-1)
    k_plan = _plan(rows * 3 * N + cols_, 9 * N * N, device)

    # story blocks: level = dof // m, in-level index = dof % m, m = 3 cols;
    # the same-level quadrants go to D[level], the upward ones to U[level]
    # and the downward ones (U's transpose, implicit in the solve) nowhere
    Lv, m = ns + 1, 3 * cols
    lev_r, lev_c = rows // m, cols_ // m
    inner = (rows % m) * m + cols_ % m
    d_size = Lv * m * m
    tgt = np.where(lev_r == lev_c, lev_r * m * m + inner,
                   np.where(lev_c == lev_r + 1,
                            d_size + lev_r * m * m + inner, -1))
    block_plan = _plan(tgt, d_size + (Lv - 1) * m * m, device)
    f_plan = _plan(np.concatenate([dof.reshape(-1), 3 * np.arange(N)]),
                   3 * N, device)
    dof_plan = _plan(dof.reshape(-1), 3 * N, device)

    def put(a):
        return torch.as_tensor(a, device=device)

    return FrameStructure(
        node_xy=put(xy), elems=put(elems), is_beam=put(np.asarray(is_beam)),
        fixed_mask=put(fixed), lateral_mask=put(lateral),
        num_bays=nb, num_stories=ns,
        k_plan=k_plan, block_plan=block_plan, f_plan=f_plan,
        dof_plan=dof_plan,
    )


def _element_transform(dx, dy, L):
    """(..., 6, 6) local->global rotation for a 2D frame element."""
    c, s = dx / L, dy / L
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [
        [c, s, z, z, z, z],
        [-s, c, z, z, z, z],
        [z, z, o, z, z, z],
        [z, z, z, c, s, z],
        [z, z, z, -s, c, z],
        [z, z, z, z, z, o],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _matvec(a, v):
    """a @ v over the last axes as an elementwise product and sum."""
    return (a * v[..., None, :]).sum(-1)


def _matmul(a, b):
    """a @ b over the last two axes as an elementwise product and sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def as_lanes(I, structure: FrameStructure, dtype, udl, lateral_load,
             cfg: FrameConfig):
    """I as (B, E) in ``dtype`` on the structure's device and the per-lane
    loads as (B,), with the leading shape of I to restore."""
    I = torch.as_tensor(I, dtype=dtype, device=structure.device)
    lead = I.shape[:-1]
    I = I.reshape(-1, I.shape[-1])

    def lane(v, default):
        v = torch.as_tensor(default if v is None else v, dtype=dtype,
                            device=structure.device)
        return torch.broadcast_to(v, lead).reshape(-1)

    return (I, lane(udl, cfg.udl), lane(lateral_load, cfg.lateral_load),
            lead)


def frame_element_data(I, structure: FrameStructure, cfg: FrameConfig,
                       udl, lateral_load):
    """Per-element stiffness/load data + the unconstrained global RHS, for
    lanes ``I`` (B, E) and loads (B,), shared by the dense assembly below
    and the story-block assembly in fem/frame_banded.py.

    Returns ``(k_global, f_nodal, con, (k_local, T, f_local, L))``:
    (B, E, 6, 6) global element stiffness, (B, 3N) nodal force vector
    (element equivalents + lateral loads, unconstrained), (3N,)
    constrained-DOF mask, and the local-frame recovery tuple."""
    dtype = I.dtype
    xy = structure.node_xy.to(dtype)
    e = structure.elems
    d = xy[e[:, 1]] - xy[e[:, 0]]
    L = torch.sqrt(torch.sum(d**2, dim=-1))
    T = _element_transform(d[:, 0], d[:, 1], L)           # (E, 6, 6)

    k_local = beam_element_stiffness(cfg.E, cfg.A, I, L)  # (B, E, 6, 6)
    k_global = _matmul(T.mT, _matmul(k_local, T))

    # uniform load on beams only: local (Wy, Wx) both = udl (the
    # reference's two-argument eleLoad, FrameOpt:131)
    w = torch.where(structure.is_beam, udl[:, None], 0.0)
    half = w * L / 2.0
    m = w * L * L / 12.0
    f_local = torch.stack([half, half, m, half, half, -m], dim=-1)
    f_global_e = _matvec(T.mT, f_local)                    # (B, E, 6)

    lat = torch.where(structure.lateral_mask, lateral_load[:, None], 0.0)
    f = assemble(torch.cat([f_global_e.flatten(1), lat], dim=1),
                 structure.f_plan)
    con = structure.fixed_mask.repeat_interleave(3)
    return k_global, f, con, (k_local, T, f_local, L)


def frame_system(I, structure: FrameStructure, cfg: FrameConfig = FrameConfig(),
                 dtype=torch.float32, udl=None, lateral_load=None):
    """Assemble the constrained dense system K(I) u = f: returns ``(K, f,
    aux)`` with K (..., 3N, 3N), f (..., 3N) and the per-element recovery
    tuple (over the flattened lanes).  ``udl``/``lateral_load`` override
    the config scalars per lane (the reference only ever solves one frame at
    a time, FrameOpt_Discrete_Beta.py:166-206)."""
    I, w, p, lead = as_lanes(I, structure, dtype, udl, lateral_load, cfg)
    k_global, f, con, aux = frame_element_data(I, structure, cfg, w, p)
    n = 3 * structure.num_nodes
    K = assemble(k_global.flatten(1), structure.k_plan).reshape(-1, n, n)
    # fixed base: zero rows/cols, original diagonal back on constrained DOFs
    free = (~con).to(dtype)
    dK = torch.diagonal(K, dim1=-2, dim2=-1)
    K = K * free[:, None] * free[None, :]
    K = K + torch.diag_embed(torch.where(con, dK, 0.0))
    f = f * free
    return K.reshape(*lead, n, n), f.reshape(*lead, n), aux


def recover_end_forces(u_nodes, structure: FrameStructure, aux):
    """Global end forces (B, E, 6) from nodal displacements (B, N, 3) (the
    ``eleResponse`` recovery shared by every frame solve path)."""
    k_local, T, f_local, _L = aux
    u_e = take(u_nodes.flatten(1), structure.dof_plan).reshape(
        -1, structure.num_elems, 6)
    u_local = _matvec(T, u_e)
    p_local = _matvec(k_local, u_local) - f_local
    return _matvec(T.mT, p_local)


class _DenseSolve(torch.autograd.Function):
    """u = K⁻¹ f with ``torch.linalg.solve``, both directions in full
    float32; the backward is the implicit adjoint (λ = K⁻ᵀ ū, K̄ = -λ uᵀ,
    f̄ = λ), as ``torch.linalg.solve``'s own."""

    @staticmethod
    def forward(ctx, K, f):
        with full_float32():
            u = torch.linalg.solve(K, f)
        ctx.save_for_backward(K, u)
        return u

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u_bar):
        K, u = ctx.saved_tensors
        with full_float32():
            lam = torch.linalg.solve(K.mT, u_bar)
        return -lam[..., :, None] * u[..., None, :], lam


def solve_frame(I, structure: FrameStructure,
                cfg: FrameConfig = FrameConfig(),
                dtype=torch.float32, udl=None,
                lateral_load=None, method: str = "auto") -> FrameSolution:
    """Linear static solve + global end-force recovery for I (..., E).

    Matches ``ops.analyze(1)`` + ``eleResponse(e,'forces')``
    (FrameOpt_Discrete_Beta.py:139,149-153).

    ``method``: ``"dense"`` = batched ``torch.linalg.solve`` of the
    (3N, 3N) system, ``"banded"`` = story-level block-tridiagonal
    Cholesky-Thomas factorization (fem/frame_banded.py, O(stories·m³)
    instead of O((stories·m)³), the structure OpenSees' BandGeneral
    exploits, FrameOpt_Discrete_Beta.py:134).  ``"auto"`` = banded, the JAX
    package's choice; PERF.md times both on the card."""
    if method == "auto":
        method = "banded"
    if method == "banded":
        from openpystruct_tpu_torch.fem.frame_banded import solve_frame_banded

        sol, _piv = solve_frame_banded(I, structure, cfg, dtype, udl=udl,
                                       lateral_load=lateral_load)
        return sol
    if method != "dense":
        raise ValueError(f"unknown method: {method!r}")
    I, w, p, lead = as_lanes(I, structure, dtype, udl, lateral_load, cfg)
    K, f, aux = frame_system(I, structure, cfg, dtype, udl=w,
                             lateral_load=p)
    u_nodes = _DenseSolve.apply(K, f).reshape(-1, structure.num_nodes, 3)
    ef = recover_end_forces(u_nodes, structure, aux)
    return FrameSolution(
        displacements=u_nodes.reshape(*lead, structure.num_nodes, 3),
        end_forces=ef.reshape(*lead, structure.num_elems, 6),
    )
