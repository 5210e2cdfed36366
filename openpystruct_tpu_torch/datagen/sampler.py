"""Random load/support scenario sampler (port of ``datagen/sampler.py``).

Draws a whole batch at once from a ``torch.Generator`` on the CPU, then
moves it to the target device, so one seed gives the same scenarios on every
device.  The laws are the reference's
(OpenPyStruct_BeamOpt_training_MultiCore.py:58-70,136-162); the draws
cannot match ``jax.random`` bit for bit, so the tests hold the two samplers
on distribution statistics:

- fixed-bridge mode (default): L = L_max, rollers at the fixed 1-based node
  tags (10, 30, 70, 85, 100), stored in that order;
- random-bridge mode: L = L_min + U(0, 1) L_max; 1..n_rollers_max rollers
  uniformly without replacement from node tags 2..n-1, in draw order;
- 1..m_forces_max point forces at non-roller tags 2..n-1, values
  ~ U(max_force, max_force/10), in draw order in both modes.

A uniform k-subset is drawn by ranking i.i.d. uniform scores over the
candidates and keeping the k smallest; conditional on the subset, the score
order is a uniform permutation, the law of the reference's sequential draws.
"""

from __future__ import annotations

import torch

from openpystruct_tpu_torch.config import ScenarioConfig
from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.beam import BeamScenario


def _rank(scores):
    """rank[..., i] = position of scores[..., i] in ascending order."""
    return torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1)


def sample_scenarios(generator: torch.Generator, batch_size: int,
                     cfg: ScenarioConfig = ScenarioConfig(), device="cuda",
                     dtype=torch.float32) -> BeamScenario:
    """Draw ``batch_size`` random scenarios (a CPU ``generator``)."""
    device = resolve_device(device)
    n, B = cfg.num_nodes, batch_size
    idx = torch.arange(n)
    # candidate node tags 2..n-1, i.e. 0-based 1..n-2 (MultiCore.py:62)
    candidates = ((idx >= 1) & (idx <= n - 2)).expand(B, n)
    inf = torch.tensor(float("inf"), dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    if cfg.random_bridge:
        L = cfg.L_min + uniform(B) * cfg.L_max
        num_rollers = torch.randint(1, cfg.n_rollers_max + 1, (B, 1),
                                    generator=generator)
        r_rank = _rank(torch.where(candidates, uniform(B, n), inf))
        roller_mask = r_rank < num_rollers
        roller_order = torch.where(roller_mask, r_rank, n)
    else:
        L = torch.full((B,), float(cfg.L_max), dtype=torch.float64)
        roller_mask = torch.zeros((B, n), dtype=torch.bool)
        roller_mask[:, [t - 1 for t in cfg.fixed_roller_tags]] = True
        # fixed rollers are stored in the given (ascending-tag) list order
        roller_order = torch.where(roller_mask, roller_mask.cumsum(-1) - 1, n)

    node_x = torch.linspace(0.0, 1.0, n, dtype=torch.float64) * L[:, None]

    available = candidates & ~roller_mask
    num_forces = torch.randint(1, cfg.m_forces_max + 1, (B, 1),
                               generator=generator)
    f_rank = _rank(torch.where(available, uniform(B, n), inf))
    force_sel = f_rank < num_forces
    force_order = torch.where(force_sel, f_rank, n)

    lo = min(cfg.max_force, cfg.min_force)
    hi = max(cfg.max_force, cfg.min_force)
    point_loads = torch.where(force_sel, lo + (hi - lo) * uniform(B, n), 0.0)

    def put(x):
        x = x.to(dtype) if x.is_floating_point() else x
        return x.to(device)

    return BeamScenario(
        node_x=put(node_x),
        roller_mask=put(roller_mask),
        point_loads=put(point_loads),
        udl=put(torch.full((B,), float(cfg.udl), dtype=torch.float64)),
        roller_order=(put(roller_order.to(torch.int32))
                      if cfg.store_draw_order else None),
        force_order=(put(force_order.to(torch.int32))
                     if cfg.store_draw_order else None),
    )
