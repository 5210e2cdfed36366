"""Adam optimization of the per-element moment-of-inertia field (port of
``opt/beam_opt.py``).

Reference semantics (OpenPyStruct_BeamOpt.py:179-244, the datagen loop at
OpenPyStruct_BeamOpt_training_MultiCore.py:164-219): each epoch solves at
the current I, evaluates the combined loss, takes an Adam step with
ExponentialLR decay, clamps I >= clamp_min, and stops early when the loss
fails to improve by ``tolerance`` for ``patience`` consecutive epochs.  The
returned ``solution`` holds at the last SOLVED I while ``I`` has the final
step applied, the reference's own off-by-one.

The JAX package runs the loop as a ``lax.while_loop``; here it is a Python
loop around one fused kernel launch per epoch, which on the fused path
(not the float64 rescue's) also does the per-lane freeze and early-stop
bookkeeping, so that the host issues nothing else.  Its exit test needs the
per-lane ``done`` flags on the host, a device sync.  The sync is taken every
``_SYNC_EVERY`` epochs: a frozen lane does not change, and entering the next
compaction stage later changes no lane, so the results are the same as with
a sync every epoch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from openpystruct_tpu_torch.config import BeamConfig, OptimizerConfig
from openpystruct_tpu_torch.fem.beam import (
    BeamScenario,
    BeamSolution,
    constraint_mask,
    solve_beam,
    solve_beam_batched,
)
from openpystruct_tpu_torch.opt.loss import LossComponents, structural_loss
from openpystruct_tpu_torch.ops.beam_kernel import (
    LaneState,
    beam_analysis,
    beam_opt_step,
    freeze_lanes,
)
from openpystruct_tpu_torch.ops.beam_kernel_dd import (
    beam_analysis_dd,
    beam_opt_step_dd,
)
from openpystruct_tpu_torch.utils.profiling import span

# Epochs between host reads of the done flags.  An epoch at B = 16384 is a
# launch of a few milliseconds, so a sync every epoch would idle the card
# for one host round trip per epoch; a stage switch taken up to 3 epochs
# late wastes at most 3 epochs on the larger bucket, and there are at most
# six switches per batch.  4 keeps both costs small.
_SYNC_EVERY = 4

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class BeamOptResult:
    I: torch.Tensor                # (..., nelem) optimized moments of inertia
    I_solved: torch.Tensor         # (..., nelem) the I ``solution`` holds at
    solution: BeamSolution         # FE fields at the last solved I
    loss: LossComponents           # loss components at the last evaluation
    n_epochs: torch.Tensor         # epochs actually run
    converged: torch.Tensor        # True if early-stopped before max_epochs
    loss_history: Optional[torch.Tensor] = None   # (max_epochs, 4) or None
    # min Schur pivot of the last solved system (fused path only)
    pivot: Optional[torch.Tensor] = None


def _adam_scalars(opt: OptimizerConfig, epoch: int, dtype):
    """lr_t = lr * gamma^epoch and the bias corrections 1/(1 - b^t), t =
    epoch + 1, computed in the working dtype as the JAX package does
    (opt/beam_opt.py:318-322), returned as Python floats; computed once a
    process for each (lr, lr_gamma, dtype, epoch)."""
    return _adam_scalars_at(opt.lr, opt.lr_gamma, dtype, epoch)


@functools.lru_cache(maxsize=None)
def _adam_scalars_at(lr, lr_gamma, dtype, epoch):
    t = torch.tensor(epoch + 1, dtype=dtype)
    lr_t = lr * lr_gamma ** torch.tensor(epoch, dtype=dtype)
    bc1 = 1.0 / (1.0 - _B1 ** t)
    bc2 = 1.0 / (1.0 - _B2 ** t)
    return float(lr_t), float(bc1), float(bc2)


def _adam(I, mu, nu, g, epoch, opt: OptimizerConfig):
    """One Adam step with torch's math (bias-corrected moments, lr_t =
    lr * gamma^epoch) and the post-step clamp on I, for the autograd paths;
    the fused path does the same inside the kernel."""
    dtype = I.dtype
    t = torch.tensor(epoch + 1, dtype=dtype)
    lr_t = opt.lr * opt.lr_gamma ** torch.tensor(epoch, dtype=dtype)
    mu = _B1 * mu + (1 - _B1) * g
    nu = _B2 * nu + (1 - _B2) * g * g
    mu_hat = mu / (1 - _B1 ** t)
    nu_hat = nu / (1 - _B2 ** t)
    I_new = torch.clamp_min(I - lr_t * mu_hat / (torch.sqrt(nu_hat) + _EPS),
                            opt.clamp_min)
    return I_new, mu, nu


def _default_I0(scenario, beam, shape):
    """I0 everywhere, in the scenario's floating dtype: float32 on the card
    (the JAX package's datagen dtype), float64 where the caller drew the
    scenarios in float64."""
    x = scenario.node_x
    return torch.full(shape, beam.I0, dtype=x.dtype, device=x.device)


def _detached(obj):
    """A copy of a dataclass of tensors with every tensor detached."""
    return type(obj)(**{
        f.name: (None if getattr(obj, f.name) is None
                 else getattr(obj, f.name).detach())
        for f in dataclasses.fields(obj)
    })


def optimize_beam(scenario: BeamScenario, beam: BeamConfig = BeamConfig(),
                  opt: OptimizerConfig = OptimizerConfig(),
                  I0: Optional[torch.Tensor] = None, refine: int = 0,
                  record_history: bool = False) -> BeamOptResult:
    """Optimize the I field of one (unbatched) scenario with autograd
    through the plain solve; a sync every epoch.  The reference loop,
    used by the tests; the batched optimizers are the production path."""
    nelem = scenario.num_nodes - 1
    if I0 is None:
        I0 = _default_I0(scenario, beam, (nelem,))
    dtype = I0.dtype
    E, G, A = beam.E, beam.G, beam.A

    I = I0.clone()
    mu = torch.zeros_like(I)
    nu = torch.zeros_like(I)
    best = float("inf")
    no_improve, epoch, done = 0, 0, False
    hist = (torch.full((opt.max_epochs, 4), float("nan"), dtype=dtype)
            if record_history else None)
    I_solved, sol, comps = I, None, None
    while not done and epoch < opt.max_epochs:
        Ig = I.detach().requires_grad_(True)
        with torch.enable_grad():
            # semi mode: the solve is a constant (reference fresh leaf
            # tensors, OpenPyStruct_BeamOpt.py:150-151)
            I_solve = Ig.detach() if opt.grad_mode == "semi" else Ig
            sol = solve_beam(I_solve, scenario, E, A, refine=refine)
            comps = structural_loss(Ig, sol.bending_moments,
                                    sol.shear_forces, E, G,
                                    opt.alpha_moment, opt.alpha_shear,
                                    grad_mode=opt.grad_mode)
            (g,) = torch.autograd.grad(comps.total, Ig)
        sol = _detached(sol)
        comps = _detached(comps)
        I_new, mu, nu = _adam(I, mu, nu, g, epoch, opt)
        total = float(comps.total)
        if total < best - opt.tolerance:
            best, no_improve = total, 0
        else:
            no_improve += 1
        done = no_improve >= opt.patience
        if hist is not None:
            hist[epoch] = torch.stack([comps.total, comps.primary,
                                       comps.bending_energy,
                                       comps.shear_energy])
        I_solved, I = I, I_new
        epoch += 1
    return BeamOptResult(
        I=I, I_solved=I_solved, solution=sol, loss=comps,
        n_epochs=torch.tensor(epoch), converged=torch.tensor(done),
        loss_history=hist,
    )


def _make_kernel_step(scenario, beam, opt, refine, fused, dtype, dd=False,
                      solve=solve_beam_batched):
    """One optimizer iteration for the whole batch:
    ``step(I, mu, nu, epoch) -> (I_new, mu, nu, stats (B, 4))``; the split
    path solves with ``solve``.  The fused float32 step also takes
    ``lane_state=`` (``beam_opt_step``'s)."""
    E, G, A = beam.E, beam.G, beam.A

    if dd and opt.grad_mode != "semi":
        raise NotImplementedError(
            "the float64 rescue kernels implement the reference's "
            "semi-gradient mode only (OpenPyStruct_BeamOpt.py:150-151)"
        )
    if dd or fused:
        # contiguous once here, as the float64 kernel needs them
        Le = torch.diff(scenario.node_x, dim=-1).to(dtype).contiguous()
        free = (~constraint_mask(scenario)).to(dtype).contiguous()
        loads = scenario.point_loads.to(dtype).contiguous()
        udl = scenario.udl.to(dtype).contiguous()

        kw = dict(alpha_m=opt.alpha_moment, alpha_s=opt.alpha_shear,
                  clamp_min=opt.clamp_min)
        semi = opt.grad_mode == "semi"

        def kernel_step(I, mu, nu, epoch, lane_state=None):
            lr_t, bc1, bc2 = _adam_scalars(opt, epoch, dtype)
            args = (I, mu, nu, Le, free, loads, udl, lr_t, bc1, bc2, E, A, G)
            if dd:
                return beam_opt_step_dd(*args, **kw)[:4]   # drop the pivot
            # the module global, looked up each call
            return beam_opt_step(*args, grad_semi=semi, refine=refine,
                                 lane_state=lane_state, **kw)

        return kernel_step

    def kernel_step(I, mu, nu, epoch):
        Ig = I.detach().requires_grad_(True)
        with torch.enable_grad():
            # semi mode treats the whole FE solve as a constant per epoch
            I_solve = Ig.detach() if opt.grad_mode == "semi" else Ig
            sol = solve(I_solve, scenario, E, A, refine=refine)
            comps = structural_loss(Ig, sol.bending_moments,
                                    sol.shear_forces, E, G,
                                    opt.alpha_moment, opt.alpha_shear,
                                    grad_mode=opt.grad_mode)
            # independent lanes: summing gives each lane its own gradient
            (g,) = torch.autograd.grad(comps.total.sum(), Ig)
        I_new, mu, nu = _adam(I, mu, nu, g, epoch, opt)
        stats = torch.stack([comps.total, comps.primary, comps.bending_energy,
                             comps.shear_energy], dim=-1).detach()
        return I_new, mu, nu, stats

    return kernel_step


def _lane_state_init(I0):
    """Per-lane optimizer and early-stopping state."""
    I0 = I0.contiguous()    # the float64 kernel reads the state as it lies
    B = I0.shape[0]
    dev = I0.device
    return dict(
        # copies: the compaction scatter writes into the state in place
        I=I0.clone(),
        I_solved=I0.clone(),
        mu=torch.zeros_like(I0),
        nu=torch.zeros_like(I0),
        n_epochs=torch.zeros((B,), dtype=torch.int32, device=dev),
        best=torch.full((B,), float("inf"), dtype=I0.dtype, device=dev),
        no_improve=torch.zeros((B,), dtype=torch.int32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        # NaN, not zero: a lane that runs zero epochs reports "never
        # evaluated"; any lane that takes a step overwrites these
        stats=torch.full((B, 4), float("nan"), dtype=I0.dtype, device=dev),
    )


def _lane_state(c, opt):
    return LaneState(c["done"], c["best"], c["no_improve"], c["n_epochs"],
                     c["I_solved"], c["stats"], opt.tolerance, opt.patience)


def _make_freeze_body(kernel_step, opt):
    """One epoch: a step for the batch, then per-lane freeze/early-stop
    bookkeeping (``freeze_lanes``) in torch ops; frozen lanes keep their
    state.  The float64 rescue's step and the split path's."""

    def body(c, epoch):
        step = kernel_step(c["I"], c["mu"], c["nu"], epoch)
        return freeze_lanes(c["I"], c["mu"], c["nu"], step,
                            _lane_state(c, opt))

    return body


def _make_fused_body(kernel_step, opt):
    """One epoch of the fused step: one ``beam_opt_step`` call that also
    does the bookkeeping, updating the lane state in place."""

    def body(c, epoch):
        I, mu, nu, stats = kernel_step(c["I"], c["mu"], c["nu"], epoch,
                                       lane_state=_lane_state(c, opt))
        return dict(c, I=I, mu=mu, nu=nu, stats=stats)

    return body


def _make_body(scenario, beam, opt, refine, fused, dtype, dd,
               solve=solve_beam_batched):
    """The epoch body of a stage: the fused step's own (``fused`` and not
    ``dd``), or the step and ``_make_freeze_body``'s bookkeeping."""
    step = _make_kernel_step(scenario, beam, opt, refine, fused, dtype, dd,
                             solve)
    make = _make_fused_body if fused and not dd else _make_freeze_body
    return make(step, opt)


def _run_epochs(body, state, epoch, max_epochs, keep_going):
    """Run epochs until ``keep_going(state)`` (read on the host every
    ``_SYNC_EVERY`` epochs, an ``opt.sync`` span) is False or
    ``max_epochs`` is reached."""
    while epoch < max_epochs:
        with span("opt.sync"):
            go = keep_going(state)
        if not go:
            break
        for _ in range(min(_SYNC_EVERY, max_epochs - epoch)):
            state = body(state, epoch)
            epoch += 1
    return state, epoch


def _final_solution(scenario, I_solved, beam, refine, fused, dd=False,
                    solve=solve_beam_batched):
    """One analysis at the last-solved I, the solve the loop's last
    evaluation saw.  Returns ``(BeamSolution, pivot or None)``."""
    I_solved = I_solved.detach()
    if dd or fused:
        dtype = I_solved.dtype
        args = (I_solved, torch.diff(scenario.node_x, dim=-1).to(dtype),
                (~constraint_mask(scenario)).to(dtype),
                scenario.point_loads.to(dtype), scenario.udl.to(dtype),
                beam.E, beam.A)
        if dd:
            u, V, M, piv = beam_analysis_dd(*args)
        else:
            u, V, M, piv = beam_analysis(*args, refine=refine)
        sol = BeamSolution(displacements=u, deflections=u[..., 1],
                           rotations=u[..., 2], shear_forces=V,
                           bending_moments=M)
        return sol, piv
    return solve(I_solved, scenario, beam.E, beam.A, refine=refine), None


def _result(scenario, state, beam, refine, fused, dd,
            solve=solve_beam_batched):
    sol, piv = _final_solution(scenario, state["I_solved"], beam, refine,
                               fused, dd, solve)
    st = state["stats"]
    return BeamOptResult(
        I=state["I"], I_solved=state["I_solved"], solution=sol,
        loss=LossComponents(total=st[:, 0], primary=st[:, 1],
                            bending_energy=st[:, 2], shear_energy=st[:, 3]),
        n_epochs=state["n_epochs"], converged=state["done"], pivot=piv,
    )


def optimize_beam_batched(scenario: BeamScenario,
                          beam: BeamConfig = BeamConfig(),
                          opt: OptimizerConfig = OptimizerConfig(),
                          I0: Optional[torch.Tensor] = None, refine: int = 0,
                          fused: Optional[bool] = None,
                          dd: bool = False) -> BeamOptResult:
    """Explicitly batched optimizer: every scenario field has a leading
    batch dim, each lane carries its own early-stopping state (converged
    lanes freeze), and the loop runs until every lane is done or
    ``max_epochs``.

    ``fused`` (default True) runs one ``beam_opt_step`` per epoch: solve,
    loss, gradient (semi or adjoint) and Adam in one kernel launch on the
    card, or its plain version for CPU tensors.  ``fused=False`` is the
    split path: plain assembly, the block-Thomas solve (``solve_sym``: the
    kernel on a CUDA float32 batch, its plain version on a CPU one), the
    loss and autograd; semi mode detaches I at the solve input, adjoint
    mode backpropagates through one more solve.  ``dd=True``
    (the rescue's arithmetic) runs ``beam_opt_step_dd`` and a final
    ``beam_analysis_dd`` instead, whatever ``fused`` says: solve, loss and
    semi-gradient in float64, Adam in I0's dtype, the pivot in
    ``result.pivot``; ``refine`` is not used and adjoint mode raises.
    """
    B, nelem = scenario.node_x.shape[0], scenario.node_x.shape[-1] - 1
    if I0 is None:
        I0 = _default_I0(scenario, beam, (B, nelem))
    fused = True if fused is None else fused
    with span("opt.stage", lanes=B) as sp:
        body = _make_body(scenario, beam, opt, refine, fused, I0.dtype, dd)
        state, epochs = _run_epochs(body, _lane_state_init(I0), 0,
                                    opt.max_epochs,
                                    lambda st: bool((~st["done"]).any()))
        sp.set(epochs=epochs)
    return _result(scenario, state, beam, refine, fused, dd)


def _bucket_size(n_active: int, min_bucket: int, cap: int) -> int:
    """Smallest power-of-two working-set size covering the active lanes,
    floored at ``min_bucket`` and capped at the full batch."""
    size = max(n_active, min_bucket, 1)
    return min(cap, 1 << (size - 1).bit_length())


def _compact_sizes(B: int, min_bucket: int) -> list:
    """Halving schedule of working-set sizes, e.g. 8192 -> [8192, 4096,
    2048, 1024, 512] at the default 512 floor."""
    sizes = [B]
    min_b = min(min_bucket, B)
    while True:
        nxt = _bucket_size(max(sizes[-1] // 2, 1), min_b, B)
        if nxt >= sizes[-1]:
            return sizes
        sizes.append(nxt)


def optimize_beam_compact(scenario: BeamScenario,
                          beam: BeamConfig = BeamConfig(),
                          opt: OptimizerConfig = OptimizerConfig(),
                          I0: Optional[torch.Tensor] = None, refine: int = 0,
                          fused: Optional[bool] = None, min_bucket: int = 512,
                          dd: bool = False) -> BeamOptResult:
    """``optimize_beam_batched`` with converged-lane compaction.

    The loop runs as a cascade of halving working sets (B, B/2, ...,
    ``min_bucket``): a stage ends once its active lanes fit the next
    bucket, the active lanes are gathered into it, and the results are
    scattered back.  Lanes are independent and the global epoch (which
    drives the lr schedule) threads through the stages, so per-lane
    results equal ``optimize_beam_batched``'s; only the epochs frozen lanes
    would spend are skipped.
    """
    return _optimize_compact(scenario, beam, opt, I0, refine,
                             True if fused is None else fused, min_bucket, dd,
                             solve_beam_batched)


def _optimize_compact(scenario, beam, opt, I0, refine, fused, min_bucket, dd,
                      solve):
    """``optimize_beam_compact`` whose split path solves with ``solve``:
    ``solve_beam_batched``, or for the host float64 rescue the plain
    ``fem.solve`` solver of ``solve_beam``, the JAX rescue's arithmetic."""
    B, nelem = scenario.node_x.shape[0], scenario.node_x.shape[-1] - 1
    if I0 is None:
        I0 = _default_I0(scenario, beam, (B, nelem))
    sizes = _compact_sizes(B, min_bucket)

    def run_stage(scen, st, epoch, next_size):
        with span("opt.stage", lanes=scen.node_x.shape[0]) as sp:
            body = _make_body(scen, beam, opt, refine, fused, I0.dtype, dd,
                              solve)
            st, end = _run_epochs(
                body, st, epoch, opt.max_epochs,
                lambda s: int((~s["done"]).sum()) > next_size)
            sp.set(epochs=end - epoch)
        return st, end

    state, epoch = run_stage(scenario, _lane_state_init(I0), 0,
                             sizes[1] if len(sizes) > 1 else 0)
    for i, s in enumerate(sizes[1:], start=1):
        nxt = sizes[i + 1] if i + 1 < len(sizes) else 0
        # active lanes first, in original order: the sort must be stable
        # (jnp.argsort is; torch.argsort only with stable=True), or the
        # trailing converged lanes picked to fill the bucket would change
        gidx = torch.argsort(state["done"].to(torch.uint8), stable=True)[:s]
        ws = {k: v[gidx] for k, v in state.items()}
        ws, epoch = run_stage(scenario.map(lambda x: x[gidx]), ws, epoch, nxt)
        # gidx is part of a permutation: a conflict-free scatter
        for k, v in ws.items():
            state[k][gidx] = v
    return _result(scenario, state, beam, refine, fused, dd, solve)
