"""Random load/support scenario sampler (port of ``datagen/sampler.py``).

Draws a whole batch at once from a ``torch.Generator`` on the CPU, so one
seed gives the same scenarios on every device.  The laws are the
reference's (OpenPyStruct_BeamOpt_training_MultiCore.py:58-70,136-162); the
draws cannot match ``jax.random`` bit for bit, so the tests hold the two
samplers on distribution statistics:

- fixed-bridge mode (default): L = L_max, rollers at the fixed 1-based node
  tags (10, 30, 70, 85, 100), stored in that order;
- random-bridge mode: L = L_min + U(0, 1) L_max; 1..n_rollers_max rollers
  uniformly without replacement from node tags 2..n-1, in draw order;
- 1..m_forces_max point forces at non-roller tags 2..n-1, values
  ~ U(max_force, max_force/10), in draw order in both modes.

A uniform k-subset is drawn by keeping the k smallest of i.i.d. uniform
scores over the candidates; conditional on the subset, the score order is a
uniform permutation, the law of the reference's sequential draws.  The kept
nodes are the k smallest by (score, node index), found by a top-k
selection: the first k of a stable ascending sort of the scores, in law and
in bits.

Only the kept nodes leave the host: L and, for k = n_rollers_max and
m_forces_max, each lane's (B, k) kept node indices, their draw positions
and load values.  The (B, n) fields are scattered from them on the target
device.
"""

from __future__ import annotations

import torch

from openpystruct_tpu_torch.config import ScenarioConfig
from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.beam import BeamScenario
from openpystruct_tpu_torch.utils.profiling import count


def _smallest(scores, k):
    """(B, min(k, n)) column indices of the smallest entries of each row of
    ``scores`` (B, n), ascending by (score, column): the first columns of a
    stable ascending argsort."""
    n = scores.shape[-1]
    top = min(k + 1, n)
    vals, idx = torch.topk(scores, top, dim=-1, largest=False, sorted=True)
    # strictly ascending top values fix the first k columns and their order;
    # topk orders equal scores as it likes, so a row with a tie among them
    # takes the stable sort
    tied = (vals[:, 1:] == vals[:, :-1]).any(-1).nonzero()[:, 0]
    if len(tied):
        idx[tied] = torch.argsort(scores[tied], dim=-1, stable=True)[:, :top]
    return idx[:, :k]


def sample_scenarios(generator: torch.Generator, batch_size: int,
                     cfg: ScenarioConfig = ScenarioConfig(), device="cuda",
                     dtype=torch.float32) -> BeamScenario:
    """Draw ``batch_size`` random scenarios (a CPU ``generator``)."""
    device = resolve_device(device)
    n, B = cfg.num_nodes, batch_size
    idx = torch.arange(n)
    # candidate node tags 2..n-1, i.e. 0-based 1..n-2 (MultiCore.py:62)
    candidates = (idx >= 1) & (idx <= n - 2)
    inf = torch.tensor(float("inf"), dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    def kept(k, num):
        """(B, k) True at the first ``num`` (B, 1) positions."""
        return torch.arange(k) < num

    if cfg.random_bridge:
        L = cfg.L_min + uniform(B) * cfg.L_max
        num_rollers = torch.randint(1, cfg.n_rollers_max + 1, (B, 1),
                                    generator=generator)
        r_idx = _smallest(torch.where(candidates, uniform(B, n), inf),
                          cfg.n_rollers_max)
        r_kept = kept(r_idx.shape[1], num_rollers)
        roller_mask = torch.zeros((B, n), dtype=torch.bool).scatter_(
            1, r_idx, r_kept)
    else:
        L = torch.full((B,), float(cfg.L_max), dtype=torch.float64)
        roller_mask = torch.zeros(n, dtype=torch.bool)
        roller_mask[[t - 1 for t in cfg.fixed_roller_tags]] = True
        # fixed rollers are stored in ascending-tag order
        r_idx = roller_mask.nonzero().T
        r_kept = torch.ones_like(r_idx, dtype=torch.bool)

    num_forces = torch.randint(1, cfg.m_forces_max + 1, (B, 1),
                               generator=generator)
    f_idx = _smallest(
        torch.where(candidates & ~roller_mask, uniform(B, n), inf),
        cfg.m_forces_max)
    f_kept = kept(f_idx.shape[1], num_forces)

    lo = min(cfg.max_force, cfg.min_force)
    hi = max(cfg.max_force, cfg.min_force)
    u = uniform(B, n).gather(1, f_idx)
    loads = torch.where(f_kept, lo + (hi - lo) * u, 0.0).to(dtype)

    def order(kept_):
        """A kept node's draw position, n where unkept."""
        pos = torch.arange(kept_.shape[1], dtype=torch.int32)
        return torch.where(kept_, pos, n)

    # indices travel as int32 (n < 2**31) and widen on the device
    host = dict(L=L, lin=torch.linspace(0.0, 1.0, n, dtype=torch.float64),
                r_idx=r_idx.int(), r_kept=r_kept, f_idx=f_idx.int(),
                loads=loads)
    if cfg.store_draw_order:
        host.update(r_order=order(r_kept), f_order=order(f_kept))
    count("h2d_bytes", sum(x.nbytes for x in host.values()), stage="sample")
    dev = {k: x.to(device) for k, x in host.items()}

    def scatter(fill, index, src):
        """(B, n) of ``fill`` with ``src`` (B or 1, k) at ``index``."""
        out = torch.full((B, n), fill, dtype=src.dtype, device=device)
        return out.scatter_(1, index.expand(B, -1), src.expand(B, -1))

    r_idx, f_idx = dev["r_idx"].long(), dev["f_idx"].long()
    return BeamScenario(
        node_x=(dev["lin"] * dev["L"][:, None]).to(dtype),
        roller_mask=scatter(False, r_idx, dev["r_kept"]),
        point_loads=scatter(0.0, f_idx, dev["loads"]),
        udl=torch.full((B,), float(cfg.udl), dtype=dtype, device=device),
        roller_order=(scatter(n, r_idx, dev["r_order"])
                      if cfg.store_draw_order else None),
        force_order=(scatter(n, f_idx, dev["f_order"])
                     if cfg.store_draw_order else None),
    )
