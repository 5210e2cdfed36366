"""Plain reference of the datagen's beam analysis and I-field optimizer.

A straight Euler-Bernoulli beam of n nodes (DOFs ux, uy, rz a node), a pin
at node 0 and rollers on uy, the element OpenSees builds for
``elasticBeamColumn`` with a linear transform, nodal point loads and a
uniform load on every element, as the upstream scripts build it
(OpenPyStruct_BeamOpt.py:91-144).  The 3-DOF system is assembled as 3x3
blocks, constrained rows and columns are zeroed with the original diagonal
entry kept, the system is Jacobi scaled, and a block-Thomas sweep solves it.
The validity pivot is min_i |det S_i| over the scaled 3x3 Schur
complements; OpenSees' failed ``analyze`` is its singular limit.

The optimizer is the upstream loop (OpenPyStruct_BeamOpt.py:179-244, the
datagen budget of OpenPyStruct_BeamOpt_training_MultiCore.py:36-44): each
epoch solves at the current I, evaluates

    total = sum(I) + a_m sum(M^2 / (2 E I + 1e-6)) + a_s sum(V^2 / (G 0.03 sqrt(I)))

takes torch's Adam step at lr * gamma^epoch, clamps I at ``clamp_min`` and
stops a lane once ``patience`` epochs in a row improved on its best by no
more than ``tolerance``.  The semi gradient holds M and V constant (the
upstream's fresh leaf tensors); the adjoint gradient is exact, through one
more solve with the same factors.  The result holds the analysis at the
last solved I and the I after the last step.

Every function works on any device.  ``precision`` is "f64" (float64 on
float64 inputs) or "tf32": float32, with every product of the solve and of
the force recovery taken on operands rounded to TF32's 10-bit mantissa, as
a tensor-core matrix product takes them.  The second is the control of the
benchmark's comparison, never the reference.
"""

from __future__ import annotations

import dataclasses

import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _tf32(x):
    """Round float32 ``x`` to TF32 (10 mantissa bits, to nearest)."""
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Arith:
    """The arithmetic of one precision: its dtype and its matrix product."""

    def __init__(self, precision: str):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            return torch.matmul(_tf32(a.contiguous()), _tf32(b.contiguous()))
        return torch.matmul(a, b)


@dataclasses.dataclass
class Beams:
    """R lanes' scenarios in one dtype, with what every solve reuses."""

    Le: torch.Tensor        # (R, ne) element lengths
    free: torch.Tensor      # (R, n, 3) 1.0 where the DOF is free
    f: torch.Tensor         # (R, n, 3) masked load vector
    feq: torch.Tensor       # (R, ne, 6) element fixed-end loads
    E: float
    A: float
    G: float


def make_beams(sc: dict, beam: dict, dtype, device) -> Beams:
    """``sc``: the sampler's arrays (float32 values: what the program is
    given); ``beam``: a configuration's ``beam`` group (E, A, nu)."""
    def t(name):
        return torch.as_tensor(sc[name]).to(device=device)

    node_x = t("node_x").to(dtype)
    roller = t("roller_mask").to(torch.bool)
    loads = t("point_loads").to(dtype)
    w = t("udl").to(dtype)[:, None]
    R, n = node_x.shape
    Le = node_x[:, 1:] - node_x[:, :-1]
    con = torch.zeros((R, n, 3), dtype=torch.bool, device=device)
    con[:, 0, 0] = True
    con[:, 0, 1] = True
    con[:, :, 1] |= roller
    free = (~con).to(dtype)
    z = torch.zeros_like(Le)
    feq = torch.stack([z, w * Le / 2, w * Le * Le / 12,
                       z, w * Le / 2, -w * Le * Le / 12], dim=-1)
    f = torch.zeros((R, n, 3), dtype=dtype, device=device)
    f[:, :, 1] = loads
    f[:, :-1] += feq[:, :, :3]
    f[:, 1:] += feq[:, :, 3:]
    E, A, nu = float(beam["E"]), float(beam["A"]), float(beam["nu"])
    return Beams(Le=Le, free=free, f=f * free, feq=feq, E=E, A=A,
                 G=E / (2.0 * (1.0 + nu)))


def element_stiffness(I, bm: Beams, bending_only=False):
    """(R, ne, 6, 6) element stiffness; ``bending_only`` leaves out the
    axial terms, which leaves the part proportional to I."""
    L = bm.Le
    ea = torch.zeros_like(L) if bending_only else bm.E * bm.A / L
    eil = bm.E * I / L
    k11, k12 = 12.0 * eil / (L * L), 6.0 * eil / L
    k13, k2 = 4.0 * eil, 2.0 * eil
    z = torch.zeros_like(L)
    rows = [[ea, z, z, -ea, z, z],
            [z, k11, k12, z, -k11, k12],
            [z, k12, k13, z, -k12, k2],
            [-ea, z, z, ea, z, z],
            [z, -k11, -k12, z, k11, -k12],
            [z, k12, k2, z, -k12, k13]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@dataclasses.dataclass
class Factors:
    s: torch.Tensor         # (R, n, 3) Jacobi scales
    sinv: list              # n x (R, 3, 3) inverted Schur complements
    c: list                 # n-1 x (R, 3, 3) back-substitution multipliers
    up: torch.Tensor        # (R, n-1, 3, 3) scaled upper blocks
    dets: list              # n x (R,) det S_i (when asked for)


def factor(ke, bm: Beams, ar: Arith, with_dets=False) -> Factors:
    """Assemble K from the element matrices, mask, scale, and factor."""
    R, ne = ke.shape[:2]
    n = ne + 1
    D = torch.zeros((R, n, 3, 3), dtype=ke.dtype, device=ke.device)
    D[:, :-1] += ke[:, :, :3, :3]
    D[:, 1:] += ke[:, :, 3:, 3:]
    U = ke[:, :, :3, 3:]
    fr = bm.free
    orig = torch.diagonal(D, dim1=-2, dim2=-1)
    D = D * fr[..., :, None] * fr[..., None, :]
    D = D + torch.diag_embed((1.0 - fr) * orig)
    U = U * fr[:, :-1, :, None] * fr[:, 1:, None, :]
    s = torch.rsqrt(torch.diagonal(D, dim1=-2, dim2=-1))
    Ds = D * s[..., :, None] * s[..., None, :]
    Us = U * s[:, :-1, :, None] * s[:, 1:, None, :]
    UsT = Us.transpose(-1, -2)
    sinv, c, dets = [], [], []
    S = Ds[:, 0]
    for i in range(n):
        if i > 0:
            S = Ds[:, i] - ar.mm(UsT[:, i - 1], c[-1])
        if with_dets:
            dets.append(torch.linalg.det(S))
        sinv.append(torch.linalg.inv_ex(S)[0])
        if i < n - 1:
            c.append(ar.mm(sinv[-1], Us[:, i]))
    return Factors(s=s, sinv=sinv, c=c, up=Us, dets=dets)


def substitute(fac: Factors, rhs, ar: Arith):
    """Solve K x = rhs (unscaled, masked rhs (R, n, 3)) with the factors."""
    b = (rhs * fac.s)[..., None]
    UsT = fac.up.transpose(-1, -2)
    n = b.shape[1]
    y = [ar.mm(fac.sinv[0], b[:, 0])]
    for i in range(1, n):
        y.append(ar.mm(fac.sinv[i], b[:, i] - ar.mm(UsT[:, i - 1], y[-1])))
    x = [y[-1]]
    for i in range(n - 2, -1, -1):
        x.append(y[i] - ar.mm(fac.c[i], x[-1]))
    return torch.stack(x[::-1], dim=1)[..., 0] * fac.s


def end_forces(ke, u, bm: Beams, ar: Arith):
    """(R, ne, 6) element end forces k_e u_e - f_eq."""
    ue = torch.cat([u[:, :-1], u[:, 1:]], dim=-1)[..., None]
    return ar.mm(ke, ue)[..., 0] - bm.feq


def analysis(I, bm: Beams, ar: Arith, with_pivot=True):
    """u (R, n, 3), V, M (R, ne) and the pivot (R,) at I."""
    ke = element_stiffness(I, bm)
    fac = factor(ke, bm, ar, with_dets=with_pivot)
    u = substitute(fac, bm.f, ar)
    fe = end_forces(ke, u, bm, ar)
    piv = (torch.stack(fac.dets, -1).abs().amin(-1) if with_pivot else None)
    return u, fe[..., 1], fe[..., 2], piv


def loss_terms(I, V, M, bm: Beams, opt: dict):
    """(total, be, se, den_b, den_s): the loss and its parts."""
    den_b = 2.0 * bm.E * I + 1e-6
    den_s = bm.G * (0.03 * torch.sqrt(I))
    be, se = M * M / den_b, V * V / den_s
    total = (I.sum(-1) + opt["alpha_moment"] * be.sum(-1)
             + opt["alpha_shear"] * se.sum(-1))
    return total, be, se, den_b, den_s


def gradient(I, bm: Beams, opt: dict, ar: Arith):
    """The loss at I and its gradient, semi or exact by
    ``opt["grad_mode"]``."""
    ke = element_stiffness(I, bm)
    fac = factor(ke, bm, ar)
    u = substitute(fac, bm.f, ar)
    fe = end_forces(ke, u, bm, ar)
    V, M = fe[..., 1], fe[..., 2]
    am, as_ = opt["alpha_moment"], opt["alpha_shear"]
    total, be, se, den_b, den_s = loss_terms(I, V, M, bm, opt)
    g = 1.0 - am * be * 2.0 * bm.E / den_b - as_ * 0.5 * se / I
    if opt["grad_mode"] == "semi":
        return total, g
    if opt["grad_mode"] != "adjoint":
        raise ValueError(f"unknown grad_mode {opt['grad_mode']!r}")
    gV, gM = as_ * 2.0 * V / den_s, am * 2.0 * M / den_b
    # the I-proportional rows of the element matrices times u_e: dV/dI,
    # dM/dI at fixed u, and the element's part of (dK/dI_e) u
    ue = torch.cat([u[:, :-1], u[:, 1:]], dim=-1)
    dke_u = (element_stiffness(I, bm, bending_only=True)
             * ue[:, :, None, :]).sum(-1) / I[..., None]
    g = g + gV * dke_u[..., 1] + gM * dke_u[..., 2]
    # the load of the adjoint system: dL/du through V and M
    ge = gV[..., None] * ke[:, :, 1, :] + gM[..., None] * ke[:, :, 2, :]
    ghat = torch.zeros_like(u)
    ghat[:, :-1] += ge[..., :3]
    ghat[:, 1:] += ge[..., 3:]
    lam = substitute(fac, ghat * bm.free, ar)
    le = torch.cat([lam[:, :-1], lam[:, 1:]], dim=-1)
    return total, g - (le * dke_u).sum(-1)


@dataclasses.dataclass
class Result:
    I: torch.Tensor          # (R, ne) after the last step
    I_solved: torch.Tensor   # (R, ne) the I the last evaluation solved at
    loss: torch.Tensor       # (R,) total loss of the last evaluation
    n_epochs: torch.Tensor   # (R,) int
    converged: torch.Tensor  # (R,) bool


def optimize(bm: Beams, opt: dict, I0: float, ar: Arith) -> Result:
    """The upstream Adam loop over every lane, each with its own early
    stopping; a stopped lane keeps its state."""
    R, ne = bm.Le.shape
    dev, dt = bm.Le.device, bm.Le.dtype
    I = torch.full((R, ne), float(I0), dtype=dt, device=dev)
    I_solved = I.clone()
    mu, nu = torch.zeros_like(I), torch.zeros_like(I)
    best = torch.full((R,), float("inf"), dtype=dt, device=dev)
    last = torch.full((R,), float("nan"), dtype=dt, device=dev)
    no_improve = torch.zeros((R,), dtype=torch.int64, device=dev)
    n_epochs = torch.zeros((R,), dtype=torch.int64, device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    lr, gamma = float(opt["lr"]), float(opt["lr_gamma"])
    for epoch in range(int(opt["max_epochs"])):
        if epoch % 8 == 0 and bool(done.all()):
            break
        total, g = gradient(I, bm, opt, ar)
        # torch.optim.Adam with ExponentialLR, then the clamp
        t = epoch + 1
        m_new = _B1 * mu + (1 - _B1) * g
        v_new = _B2 * nu + (1 - _B2) * g * g
        denom = v_new.sqrt() / (1 - _B2 ** t) ** 0.5 + _EPS
        step = lr * gamma ** epoch / (1 - _B1 ** t) * m_new / denom
        I_new = torch.clamp_min(I - step, float(opt["clamp_min"]))
        act = ~done
        a2 = act[:, None]
        improved = total < best - float(opt["tolerance"])
        no_improve = torch.where(act, torch.where(improved, 0, no_improve + 1),
                                 no_improve)
        best = torch.where(act & improved, total, best)
        last = torch.where(act, total, last)
        I_solved = torch.where(a2, I, I_solved)
        I = torch.where(a2, I_new, I)
        mu = torch.where(a2, m_new, mu)
        nu = torch.where(a2, v_new, nu)
        n_epochs = n_epochs + act.to(torch.int64)
        done = done | (no_improve >= int(opt["patience"]))
    return Result(I=I, I_solved=I_solved, loss=last, n_epochs=n_epochs,
                  converged=done)
