"""Frozen copy of the datagen's scenario sampler.

The laws are the upstream datagen script's
(OpenPyStruct_BeamOpt_training_MultiCore.py:58-70,136-162): a fixed bridge
(L = L_max, rollers at the 1-based tags in ``fixed_roller_tags``) or a
random bridge (L = L_min + U(0, 1) L_max, 1..n_rollers_max rollers drawn
without replacement from tags 2..n-1), and 1..m_forces_max point loads of
U(max_force, max_force / 10) at the remaining tags 2..n-1.

The draws are made in the order, shapes and dtypes the program's sampler
makes them from one CPU ``torch.Generator``, so one generator state gives
the same scenarios on both sides.  ``rows`` keeps the derived quantities of
the listed lanes only: every random number of the batch is still drawn, so
the generator advances exactly as a whole batch advances it.

Everything is returned as float64 numpy arrays and int masks; the program
receives these values cast to float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _rank(scores):
    """rank[..., i] = position of scores[..., i] in ascending order."""
    return torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1)


def draw(generator: torch.Generator, batch: int, cfg: dict, rows=None):
    """One batch of ``batch`` scenarios from ``generator``; the lanes in
    ``rows`` (all when None).  ``cfg`` is a configuration file's
    ``scenario`` group.  Returns a dict of numpy arrays: node_x (R, n)
    float64, roller_mask (R, n) bool, point_loads (R, n) float64, udl (R,)
    float64, roller_order and force_order (R, n) int32 (n where unselected).
    """
    n, B = int(cfg["num_nodes"]), int(batch)
    rows = torch.arange(B) if rows is None else torch.as_tensor(rows)
    R = rows.numel()
    idx = torch.arange(n)
    candidates = ((idx >= 1) & (idx <= n - 2)).expand(R, n)
    inf = torch.tensor(float("inf"), dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    if cfg["random_bridge"]:
        L = (cfg["L_min"] + uniform(B) * cfg["L_max"])[rows]
        num_rollers = torch.randint(1, int(cfg["n_rollers_max"]) + 1, (B, 1),
                                    generator=generator)[rows]
        r_rank = _rank(torch.where(candidates, uniform(B, n)[rows], inf))
        roller_mask = r_rank < num_rollers
        roller_order = torch.where(roller_mask, r_rank, n)
    else:
        L = torch.full((R,), float(cfg["L_max"]), dtype=torch.float64)
        roller_mask = torch.zeros((R, n), dtype=torch.bool)
        roller_mask[:, [int(t) - 1 for t in cfg["fixed_roller_tags"]]] = True
        roller_order = torch.where(roller_mask, roller_mask.cumsum(-1) - 1, n)

    node_x = torch.linspace(0.0, 1.0, n, dtype=torch.float64) * L[:, None]
    available = candidates & ~roller_mask
    num_forces = torch.randint(1, int(cfg["m_forces_max"]) + 1, (B, 1),
                               generator=generator)[rows]
    f_rank = _rank(torch.where(available, uniform(B, n)[rows], inf))
    force_sel = f_rank < num_forces
    force_order = torch.where(force_sel, f_rank, n)
    max_f = float(cfg["max_force"])
    lo, hi = min(max_f, max_f / 10.0), max(max_f, max_f / 10.0)
    point_loads = torch.where(force_sel, lo + (hi - lo) * uniform(B, n)[rows],
                              0.0)
    return dict(
        node_x=node_x.numpy(), roller_mask=roller_mask.numpy(),
        point_loads=point_loads.numpy(),
        udl=np.full((R,), float(cfg["udl"])),
        roller_order=roller_order.to(torch.int32).numpy(),
        force_order=force_order.to(torch.int32).numpy(),
    )
