"""State carried between the JAX package and the port as numpy arrays.

This slice has no network weights: what crosses over is scenarios and
optimizer state.  The tests draw scenarios with the JAX sampler (torch
draws cannot match ``jax.random``), pass them through here, and hold the
port's results against the JAX package's on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.beam import BeamScenario

_SCENARIO_FIELDS = ("node_x", "roller_mask", "point_loads", "udl",
                    "roller_order", "force_order")


def scenario_from_numpy(arrays: dict, device="cuda",
                        dtype=torch.float32) -> BeamScenario:
    """``{"node_x", "roller_mask", "point_loads", "udl"[, "roller_order",
    "force_order"]}`` numpy arrays -> BeamScenario on ``device``; floating
    fields are cast to ``dtype``."""
    device = resolve_device(device)

    def put(x):
        if x is None:
            return None
        t = torch.from_numpy(np.array(x))
        return (t.to(dtype) if t.is_floating_point() else t).to(device)

    return BeamScenario(**{k: put(arrays.get(k)) for k in _SCENARIO_FIELDS})


def scenario_to_numpy(scenario: BeamScenario) -> dict:
    return {k: getattr(scenario, k).detach().cpu().numpy()
            for k in _SCENARIO_FIELDS if getattr(scenario, k) is not None}


def opt_state_from_numpy(I, mu, nu, device="cuda", dtype=torch.float32):
    """Optimizer state (I, mu, nu), each (B, nelem), as tensors."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.array(x)).to(dtype).to(device)
                 for x in (I, mu, nu))


def opt_state_to_numpy(I, mu, nu):
    return tuple(x.detach().cpu().numpy() for x in (I, mu, nu))
