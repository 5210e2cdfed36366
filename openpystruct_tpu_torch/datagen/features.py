"""On-device feature extraction: DatagenBatch -> training arrays (port of
``datagen/features.py``).

A generated batch becomes the padded feature layout of the reference
pipeline without the ragged-JSON round trip, on the batch's device.  Per
case: [roller_x (max_rollers), force_x (max_forces), force_values
(max_forces), node_positions (n)], zero-padded exactly like
``pad_sequences`` + ``merge_sub_features``
(OpenPyStruct_FNN_MultiCase.py:205-294).

Ordering: with the sampler's draw-order ranks (``roller_order`` /
``force_order``, ``ScenarioConfig.store_draw_order``) roller and force
features come out in the reference's random draw order
(OpenPyStruct_BeamOpt_training_MultiCore.py:137-162), as a JSON round trip
would give them; without them, in ascending node order.
"""

from __future__ import annotations

import torch


def extract_padded(values, mask, size: int, order=None):
    """Per row of (B, n) ``values``: the entries at True positions of
    ``mask``, zero-padded to ``size``, ordered ascending (``order`` None) or
    by the draw-order ranks in ``order`` ((B, n) int, >= n where
    unselected)."""
    n = mask.shape[-1]
    if order is None:
        order = torch.arange(n, device=mask.device).expand(mask.shape)
    # ranks of selected nodes are 0..k-1, unselected >= n: the first k slots
    # of a stable argsort are exactly the ordered selection
    key = torch.where(mask, order, torch.full_like(order, n))
    idx = torch.argsort(key, dim=-1, stable=True)[..., :size]
    present = mask.gather(-1, idx)
    picked = values.gather(-1, idx)
    return torch.where(present, picked, torch.zeros_like(picked))


def batch_feature_arrays(batch, max_rollers: int = 5, max_forces: int = 4,
                         include_solution: bool = False) -> dict:
    """DatagenBatch -> dict of dense per-sample feature and label tensors on
    the batch's device.  Keys: roller_x, force_x, force_values,
    node_positions, I, valid; with ``include_solution`` also deflections
    and rotations (the PINN's auxiliary targets,
    OpenPyStruct_PINN_MultiCase.py:35-56)."""
    sc = batch.scenario
    force_mask = sc.point_loads != 0.0
    out = dict(
        roller_x=extract_padded(sc.node_x, sc.roller_mask, max_rollers,
                                sc.roller_order),
        force_x=extract_padded(sc.node_x, force_mask, max_forces,
                               sc.force_order),
        force_values=extract_padded(sc.point_loads, force_mask, max_forces,
                                    sc.force_order),
        node_positions=sc.node_x,
        I=batch.result.I,
        valid=batch.valid,
    )
    if include_solution:
        sol = batch.result.solution
        out["deflections"] = sol.deflections
        out["rotations"] = sol.rotations
    return out
