"""On-device preprocessing: feature arrays -> standardized training splits
(port of ``data/device_pipeline.py``).

The torch mirror of ``data.pipeline.prepare_dataset`` for device-resident
feature arrays (``datagen.features.batch_feature_arrays``): case grouping,
permuted train/val split, per-column standardization fitted on train only,
label aggregation (mean + c*std), label standardization, all on the arrays'
device with one host sync (the valid count).  Every standard deviation is the
population one (``correction=0``), as numpy's and sklearn's: torch's default
sample std would shift every standardized input.  The permutation is drawn
from ``torch.Generator(device).manual_seed(seed)``, so the split differs from
the host pipeline's ``np.random.default_rng(seed)`` one; given the same
permutation the two agree (``tests/test_torch_features.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from openpystruct_tpu_torch.data.pipeline import DatasetSplits, Scaler

_FEATS = ("roller_x", "force_x", "force_values", "node_positions")


def _fit_scaler(flat2d):
    mean = flat2d.mean(dim=0)
    scale = flat2d.std(dim=0, correction=0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return mean, scale


def _aggregate(l3, c):
    """(G, n_cases, m) -> (G, m): mean + c * std over the case axis."""
    return l3.mean(dim=1) + c * l3.std(dim=1, correction=0)


def _prepare(arrays: dict, perm, *, n_cases: int, tr_sz: int, c: float,
             nheads_pad: Optional[int], label_keys=("I",)) -> dict:
    """The device transform for a given permutation ``perm`` of the
    ``perm.numel()`` case groups; the first ``tr_sz`` of it are the train
    groups."""
    # one wide (B, ~114) array instead of four narrow ones: standardization
    # is per column either way
    X_all = torch.cat([arrays[k] for k in _FEATS], dim=-1)
    total = perm.numel()
    # valid rows first, in their order (stable), then trimmed to whole groups
    order = torch.argsort((~arrays["valid"]).to(torch.int8), stable=True)
    rows = order[: total * n_cases]

    def group(x):
        return x[rows].reshape(total, n_cases, -1)

    X3 = group(X_all)
    labels3 = [group(arrays[k]) for k in label_keys]
    tr, va = perm[:tr_sz], perm[tr_sz:]

    x_tr, x_va = X3[tr], X3[va]
    mean, scale = _fit_scaler(x_tr.reshape(-1, x_tr.shape[-1]))
    X_tr = (x_tr - mean) / scale
    X_va = (x_va - mean) / scale

    # per-feature scaler views (column slices of the joint scaler)
    scalers, off = {}, 0
    for name in _FEATS:
        w = arrays[name].shape[-1]
        scalers[name] = Scaler(mean=mean[off:off + w], scale=scale[off:off + w])
        off += w

    if nheads_pad:
        pad = -X_tr.shape[-1] % nheads_pad
        X_tr = F.pad(X_tr, (0, pad))
        X_va = F.pad(X_va, (0, pad))

    # per-key mean + c*std over the case axis, concatenated: the host
    # pipeline's unify_label + concat for extra_label_keys
    Y_tr_raw = torch.cat([_aggregate(l3[tr], c) for l3 in labels3], dim=1)
    Y_va_raw = torch.cat([_aggregate(l3[va], c) for l3 in labels3], dim=1)
    y_mean, y_scale = _fit_scaler(Y_tr_raw)
    return dict(
        X_tr=X_tr, X_va=X_va,
        Y_tr=(Y_tr_raw - y_mean) / y_scale,
        Y_va=(Y_va_raw - y_mean) / y_scale,
        Y_tr_raw=Y_tr_raw, Y_va_raw=Y_va_raw,
        scalers=scalers, scaler_Y=Scaler(mean=y_mean, scale=y_scale),
    )


def prepare_dataset_device(
    arrays: dict,
    n_cases: int = 6,
    train_split: float = 0.8,
    c: float = 1.0,
    seed: int = 0,
    nheads_pad: Optional[int] = None,
    extra_label_keys: tuple = (),
) -> DatasetSplits:
    """Device-side ``prepare_dataset``.

    ``arrays``: dict with roller_x, force_x, force_values, node_positions,
    I, valid, all (B, ...) tensors on one device.  Invalid samples are
    dropped before grouping (like the reference's None-filter).
    ``extra_label_keys`` appends more aggregated targets after I (the PINN's
    deflections + rotations, OpenPyStruct_PINN_MultiCase.py:35-56): pass
    ``batch_feature_arrays(..., include_solution=True)`` output.  Returns a
    DatasetSplits whose arrays and scalers hold tensors on that device.
    """
    valid = arrays["valid"]
    n_valid = int(valid.sum())  # the one host sync
    total = n_valid // n_cases
    if total == 0:
        raise ValueError(f"n_cases={n_cases} > total samples={n_valid}.")
    gen = torch.Generator(device=valid.device).manual_seed(seed)
    perm = torch.randperm(total, generator=gen, device=valid.device)
    label_keys = ("I",) + tuple(extra_label_keys)
    out = _prepare(arrays, perm, n_cases=n_cases,
                   tr_sz=int(train_split * total), c=float(c),
                   nheads_pad=nheads_pad, label_keys=label_keys)
    max_lengths = {k: arrays[k].shape[-1] for k in _FEATS}
    max_lengths["I_values"] = arrays["I"].shape[-1]
    return DatasetSplits(
        X_train=out["X_tr"],
        X_val=out["X_va"],
        Y_train=out["Y_tr"],
        Y_val=out["Y_va"],
        scalers=out["scalers"],
        scaler_Y=out["scaler_Y"],
        max_lengths=max_lengths,
        n_cases=n_cases,
        feat_dim=out["X_tr"].shape[-1],
        label_dim=out["Y_tr"].shape[-1],
        Y_train_raw=out["Y_tr_raw"],
        Y_val_raw=out["Y_va_raw"],
    )
