"""Surrogate training losses (port of ``models/losses.py``).

``trainable_l1l2_loss`` is the reference's ``TrainableL1L2Loss``
(OpenPyStruct_FNN_MultiCase.py:386-438): an alpha-blended L1/L2 loss plus
ReLU box-constraint penalties against the training-label min/max.  The
external mild regularizer ``(alpha_0 - alpha)^2``
(OpenPyStruct_FNN_MultiCase.py:546-547) is applied by the train harness.

The reference never updates alpha (its optimizers see only the model's
parameters, OpenPyStruct_FNN_MultiCase.py:481); the harness trains it by
default and offers ``train_alpha=False`` for the reference's behaviour.
"""

from __future__ import annotations

import torch


def trainable_l1l2_loss(
    alpha,
    preds,
    targets,
    min_constraint=None,
    max_constraint=None,
    penalty_weight: float = 5e-1,
):
    """alpha * L1 + (1 - alpha) * L2 + penalty_weight * box_penalty.

    ``alpha`` is the raw (unclamped) parameter; the blend uses the clamped
    value, as the reference clamps inside ``forward``
    (OpenPyStruct_FNN_MultiCase.py:419).  The box bounds are scalars.
    """
    a = torch.clamp(alpha, 1e-6, 1.0)
    diff = preds - targets
    l1 = diff.abs().mean()
    l2 = (diff ** 2).mean()
    penalty = 0.0
    if min_constraint is not None:
        penalty = penalty + torch.relu(min_constraint - preds).sum()
    if max_constraint is not None:
        penalty = penalty + torch.relu(preds - max_constraint).sum()
    return a * l1 + (1.0 - a) * l2 + penalty_weight * penalty
