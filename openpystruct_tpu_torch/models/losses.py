"""Surrogate training losses (port of ``models/losses.py``, and of
``models/pinn.py``'s ``composite_pinn_loss``).

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


def composite_pinn_loss(alpha, preds, targets, nelem: int = 100,
                        min_constraint=None, max_constraint=None,
                        box_constraint_coeff: float = 1e-1,
                        penalty_pinn: float = 1.5e-6):
    """TrainableL1L2 on the I slice + penalty_pinn * (relative L1 on the
    deflections + rotations) (OpenPyStruct_PINN_MultiCase.py:603-653).  The
    deflection and rotation widths are each (output_dim - nelem) / 2."""
    aux_dim = (preds.shape[-1] - nelem) // 2
    I_pred, I_true = preds[:, :nelem], targets[:, :nelem]
    d_pred = preds[:, nelem:nelem + aux_dim]
    d_true = targets[:, nelem:nelem + aux_dim]
    r_pred, r_true = preds[:, nelem + aux_dim:], targets[:, nelem + aux_dim:]

    loss_I = trainable_l1l2_loss(alpha, I_pred, I_true, min_constraint,
                                 max_constraint, box_constraint_coeff)
    eps = 1e-8
    loss_d = ((d_pred - d_true).abs() / (d_true.abs() + eps)).mean()
    loss_r = ((r_pred - r_true).abs() / (r_true.abs() + eps)).mean()
    return loss_I + penalty_pinn * (loss_d + loss_r)
