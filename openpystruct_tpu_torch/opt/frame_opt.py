"""Frame I-field optimization (port of ``opt/frame_opt.py``).

Reference loop (OpenPyStruct_FrameOpt_Discrete_Beta.py:166-206): Adam with
lr=0.005 and NO learning-rate scheduler, loss

  sum(I) + alpha_m * sum(M^2 / (2 E I + 1e-8))
         + alpha_s * sum(F_y^2 / (G * 0.03 * sqrt(I)))

where F_y is the element's global-Y end force (``response[1]``, the axial
force for vertical columns; see fem/frame.py), post-step clamp I >= 1e-8,
and early stop at tolerance 1e-3 / patience 10 over <= 5000 epochs.
Semi-gradient like the beam: the force fields are constants per iteration
(the reference accumulates Python floats, FrameOpt:149-158).

The JAX package runs one lane as a ``lax.while_loop`` and B lanes as its
``vmap``; here B lanes run in one batched Python loop with vmap's
semantics: a lane that is done freezes (its I, Adam moments, epoch count,
best loss and history stay as they were) while the others run on.  The
host reads the done flags every ``_SYNC_EVERY`` epochs; frozen lanes do not
change, so the results are the same as with a read every epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.fem.frame import (
    FrameSolution,
    FrameStructure,
    as_lanes,
    full_float32,
    solve_frame,
)
from openpystruct_tpu_torch.opt.loss import LossComponents

_SYNC_EVERY = 4
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_CLAMP = 1e-8


@dataclasses.dataclass
class FrameOptResult:
    I: torch.Tensor
    solution: FrameSolution
    loss: LossComponents
    n_epochs: torch.Tensor
    converged: torch.Tensor
    loss_history: Optional[torch.Tensor] = None


def frame_loss(I, solution: FrameSolution, cfg: FrameConfig,
               alpha_moment: float = 1e-2, alpha_shear: float = 1e-2,
               grad_mode: str = "semi") -> LossComponents:
    """The reference's frame loss per lane, summed over the elements of I
    (..., E); ``"semi"`` detaches the end forces."""
    fy = solution.end_forces[..., 1]
    mz = solution.end_forces[..., 2]
    if grad_mode == "semi":
        fy, mz = fy.detach(), mz.detach()
    elif grad_mode != "adjoint":
        raise ValueError(f"unknown grad_mode: {grad_mode!r}")
    bending = torch.sum(mz**2 / (2.0 * cfg.E * I + 1e-8), dim=-1)
    shear = torch.sum(fy**2 / (cfg.G * (0.03 * torch.sqrt(I))), dim=-1)
    primary = torch.sum(I, dim=-1)
    b, s = alpha_moment * bending, alpha_shear * shear
    return LossComponents(total=primary + b + s, primary=primary,
                          bending_energy=b, shear_energy=s)


def _map_result(fn, res: FrameOptResult) -> FrameOptResult:
    """``fn`` applied to every tensor of a result."""
    def go(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: go(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return None if x is None else fn(x)

    return go(res)


def _optimize(structure, cfg, I0, udl, lateral_load, lr, alpha_moment,
              alpha_shear, grad_mode, record_history, method):
    """The batched loop over lanes I0 (B, E) with loads (B,)."""
    B = I0.shape[0]
    dtype, dev = I0.dtype, I0.device

    def solve(I):
        return solve_frame(I, structure, cfg, dtype, udl=udl,
                           lateral_load=lateral_load, method=method)

    I = I0.clone()
    mu, nu = torch.zeros_like(I), torch.zeros_like(I)
    n_epochs = torch.zeros(B, dtype=torch.int32, device=dev)
    best = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    no_improve = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    hist = (torch.full((B, cfg.max_epochs), float("nan"), dtype=dtype,
                       device=dev) if record_history else None)

    epoch = 0
    while epoch < cfg.max_epochs:
        for _ in range(min(_SYNC_EVERY, cfg.max_epochs - epoch)):
            I_var = I.detach().requires_grad_(True)
            if grad_mode == "semi":
                # the force fields are per-iteration constants: no graph
                # through the solve, the gradient detached at its input
                with torch.no_grad():
                    sol = solve(I)
            else:
                sol = solve(I_var)
            total = frame_loss(I_var, sol, cfg, alpha_moment, alpha_shear,
                               grad_mode).total
            g, = torch.autograd.grad(total.sum(), I_var)
            total = total.detach()
            # optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8), then the clamp
            t = torch.tensor(epoch + 1, dtype=dtype)
            bc1, bc2 = float(1 - _B1 ** t), float(1 - _B2 ** t)
            mu_n = (1 - _B1) * g + _B1 * mu
            nu_n = (1 - _B2) * (g * g) + _B2 * nu
            step = (-lr) * ((mu_n / bc1) / (torch.sqrt(nu_n / bc2) + _EPS))
            I_n = torch.clamp_min(I + step, _CLAMP)
            improved = total < best - cfg.tolerance
            no_improve_n = torch.where(improved, 0, no_improve + 1)

            active = ~done
            a2 = active[:, None]
            I = torch.where(a2, I_n, I)
            mu = torch.where(a2, mu_n, mu)
            nu = torch.where(a2, nu_n, nu)
            best = torch.where(active & improved, total, best)
            no_improve = torch.where(active, no_improve_n, no_improve)
            done = done | (active & (no_improve_n >= cfg.patience))
            n_epochs = n_epochs + active.to(torch.int32)
            if hist is not None:
                hist[:, epoch] = torch.where(active, total, hist[:, epoch])
            epoch += 1
        if bool(done.all()):
            break

    # re-run the analysis at the converged I before reporting, as the
    # reference does (FrameOpt_Discrete_Beta.py:217-219): the in-loop
    # solution trails the final clamp/step by one iteration
    with torch.no_grad():
        sol_f = solve(I)
        comps_f = frame_loss(I, sol_f, cfg, alpha_moment, alpha_shear,
                             grad_mode)
    return FrameOptResult(I=I, solution=sol_f, loss=comps_f,
                          n_epochs=n_epochs, converged=done,
                          loss_history=hist)


def optimize_frame(
    structure: FrameStructure,
    cfg: FrameConfig = FrameConfig(),
    I0=None,
    lr: Optional[float] = None,
    alpha_moment: float = 1e-2,
    alpha_shear: float = 1e-2,
    grad_mode: str = "semi",
    record_history: bool = False,
    dtype=torch.float32,
    udl=None,
    lateral_load=None,
    method: str = "auto",
) -> FrameOptResult:
    """Optimize one frame's I field (E,) under one load scenario (``udl``/
    ``lateral_load`` override the config's scalars); the result's tensors
    have no lane axis.

    ``method`` selects the linear solver (see ``fem.frame.solve_frame``):
    dense ``torch.linalg.solve`` or the story-level block-Cholesky Thomas
    factorization; "auto" = banded."""
    if I0 is None:
        I0 = torch.full((structure.num_elems,), cfg.I0, dtype=dtype)
    I0, w, p, _ = as_lanes(I0, structure, dtype, udl, lateral_load, cfg)
    with full_float32():
        res = _optimize(structure, cfg, I0[:1], w[:1], p[:1],
                        cfg.lr if lr is None else lr, alpha_moment,
                        alpha_shear, grad_mode, record_history, method)
    return _map_result(lambda x: x[0], res)


def optimize_frame_batched(
    structure: FrameStructure,
    udl,
    lateral_load,
    cfg: FrameConfig = FrameConfig(),
    I0=None,
    lr: Optional[float] = None,
    alpha_moment: float = 1e-2,
    alpha_shear: float = 1e-2,
    grad_mode: str = "semi",
    dtype=torch.float32,
    method: str = "auto",
    chunk_size: Optional[int] = None,
) -> FrameOptResult:
    """Batched frame optimization: one topology, ``B`` load scenarios
    (``udl``, ``lateral_load``: (B,)), each lane with its own early
    stopping; a lane that stops freezes while the others run on (vmap's
    semantics of the JAX package's loop).

    ``chunk_size`` bounds peak memory at large topology x batch products:
    lanes run in sequential chunks of that size, the last padded with
    copies of lane 0 (sliced off), so every chunk has one shape.  ``None``
    (default) runs the whole batch at once."""
    udl = torch.as_tensor(udl, dtype=dtype, device=structure.device)
    B = udl.shape[0]
    if I0 is None:
        I0 = torch.full((B, structure.num_elems), cfg.I0, dtype=dtype)
    I0, w, p, _ = as_lanes(I0, structure, dtype, udl, lateral_load, cfg)
    lr = cfg.lr if lr is None else lr

    def run(I0_, w_, p_):
        return _optimize(structure, cfg, I0_, w_, p_, lr, alpha_moment,
                         alpha_shear, grad_mode, False, method)

    with full_float32():
        if chunk_size is None or chunk_size >= B:
            return run(I0, w, p)
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        pad = (-B) % chunk_size

        def edge(a):
            return torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) if pad \
                else a

        I0, w, p = edge(I0), edge(w), edge(p)
        parts = [run(I0[i:i + chunk_size], w[i:i + chunk_size],
                     p[i:i + chunk_size])
                 for i in range(0, B + pad, chunk_size)]
    return _cat_results(parts, B)


def _cat_results(results, B: int) -> FrameOptResult:
    """The chunks' results concatenated along the lanes, cut to B."""
    def go(xs):
        x0 = xs[0]
        if dataclasses.is_dataclass(x0):
            return type(x0)(**{f.name: go([getattr(x, f.name) for x in xs])
                               for f in dataclasses.fields(x0)})
        return None if x0 is None else torch.cat(xs)[:B]

    return go(results)
