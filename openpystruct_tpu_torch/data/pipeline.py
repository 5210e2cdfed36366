"""Preprocessing: padding, case grouping, standardization, label aggregation
(a copy of ``openpystruct_tpu.data.pipeline``).

Plain NumPy, as in the JAX package; the port keeps its own copy because
importing ``openpystruct_tpu.data`` imports JAX.  For the same columnar dict
and seed its output is bitwise the JAX package's
(``tests/test_torch_features.py``).

The suite every reference surrogate script duplicates
(OpenPyStruct_FNN_MultiCase.py:61-183): ``pad_sequences``,
``unify_label_with_c`` (mean + c*std, plus the median+MAD and mode variants
kept as comments in OpenPyStruct_TransformerDiffusionModule_MultiCase.py:
100-140), ``fit_transform_3d``/``transform_3d``, ``merge_sub_features``,
``pad_feat_dim_to_multiple_of_nheads`` and the user-input builder.

Deliberately NOT reproduced: the TFD/GNN scripts re-fit their scalers on
validation data (train/val leakage,
OpenPyStruct_TransformerDiffusionModule_MultiCase.py:324-328); here
validation is always transformed with train-fitted scalers, matching the
corrected FNN/PINN/FNO behavior (OpenPyStruct_FNN_MultiCase.py:271-275).
The device-resident path is ``data.device_pipeline.prepare_dataset_device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Scalers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scaler:
    """StandardScaler as a plain (mean, scale) pair.

    Matches sklearn semantics: population std (ddof=0), zero-variance
    features get scale 1.
    """

    mean: np.ndarray
    scale: np.ndarray

    @classmethod
    def fit(cls, X2d: np.ndarray) -> "Scaler":
        mean = X2d.mean(axis=0)
        scale = X2d.std(axis=0)
        scale = np.where(scale == 0.0, 1.0, scale)
        return cls(mean=mean.astype(X2d.dtype), scale=scale.astype(X2d.dtype))

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.scale

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return X * self.scale + self.mean


def fit_transform_3d(arr_3d: np.ndarray, scaler: Optional[Scaler] = None):
    """Fit on (B*NC, M) and transform, like the reference's
    ``fit_transform_3d`` (OpenPyStruct_FNN_MultiCase.py:89-103).
    Returns (scaled (B, NC, M), fitted Scaler)."""
    B, NC, M = arr_3d.shape
    flat = arr_3d.reshape(B * NC, M)
    sc = Scaler.fit(flat)
    return sc.transform(flat).reshape(B, NC, M), sc


def transform_3d(arr_3d: np.ndarray, scaler: Scaler) -> np.ndarray:
    B, NC, M = arr_3d.shape
    return scaler.transform(arr_3d.reshape(B * NC, M)).reshape(B, NC, M)


# ---------------------------------------------------------------------------
# Padding / grouping / aggregation
# ---------------------------------------------------------------------------

def pad_sequences(data_list, max_length: int, pad_val: float = 0.0):
    """Pad ragged 1D lists to (num_samples, max_length); rows longer than
    ``max_length`` are truncated (same contract as the reference's helper,
    OpenPyStruct_FNN_MultiCase.py:61-71).  Vectorized: one boolean-mask
    scatter of the concatenated (truncated) rows instead of a per-row loop.
    """
    out = np.full((len(data_list), max_length), pad_val, dtype=np.float32)
    if not len(data_list):
        return out
    rows = [np.asarray(r, dtype=np.float32).ravel()[:max_length]
            for r in data_list]
    lengths = np.array([r.size for r in rows])
    valid = np.arange(max_length) < lengths[:, None]
    out[valid] = np.concatenate(rows) if lengths.sum() else []
    return out


def unify_label(I_3d: np.ndarray, c: float = 1.0, agg: str = "mean_std"):
    """Aggregate per-case labels (B, n_cases, n_elem) -> (B, n_elem).

    - "mean_std": mean + c*std — the active reference variant
      (OpenPyStruct_FNN_MultiCase.py:74-87);
    - "median_mad": median + c*MAD (commented variant, TFD:102-121);
    - "mode_mad": mode + c*MAD-from-mode (commented variant, TFD:123-140).
    """
    if agg == "mean_std":
        return I_3d.mean(axis=1) + c * I_3d.std(axis=1)
    if agg == "median_mad":
        med = np.median(I_3d, axis=1)
        mad = np.median(np.abs(I_3d - med[:, None, :]), axis=1)
        return med + c * mad
    if agg == "mode_mad":
        try:
            from scipy.stats import mode as _mode

            m = _mode(I_3d, axis=1, keepdims=False).mode
        except ImportError:  # mode of continuous data ~ first value fallback
            m = I_3d[:, 0, :]
        mad = np.median(np.abs(I_3d - m[:, None, :]), axis=1)
        return m + c * mad
    raise ValueError(f"unknown aggregation: {agg!r}")


def merge_sub_features(*arrays):
    """Concatenate along the feature axis (OpenPyStruct_FNN_MultiCase.py:105-115)."""
    return np.concatenate(arrays, axis=2)


def pad_feat_dim_to_multiple_of_nheads(X_3d: np.ndarray, nheads: int):
    """Zero-pad the feature axis up to a multiple of ``nheads`` so the
    transformer's head split divides evenly (the role of the reference's
    helper at OpenPyStruct_FNN_MultiCase.py:117-136).
    Returns (padded, padded feature width)."""
    pad = -X_3d.shape[2] % nheads
    if pad:
        X_3d = np.pad(X_3d, ((0, 0), (0, 0), (0, pad)))
    return X_3d, X_3d.shape[2]


# ---------------------------------------------------------------------------
# End-to-end dataset preparation
# ---------------------------------------------------------------------------

FEATURE_KEYS = ("roller_x_locations", "force_x_locations", "force_values",
                "node_positions")
FEATURE_NAMES = ("roller_x", "force_x", "force_values", "node_positions")


@dataclasses.dataclass
class DatasetSplits:
    """Prepared arrays + fitted scalers for one surrogate-training run."""

    X_train: np.ndarray          # (B_tr, n_cases, feat_dim), standardized
    X_val: np.ndarray            # (B_va, n_cases, feat_dim)
    Y_train: np.ndarray          # (B_tr, label_dim), standardized
    Y_val: np.ndarray            # (B_va, label_dim)
    scalers: Dict[str, Scaler]   # per-feature input scalers
    scaler_Y: Scaler
    max_lengths: Dict[str, int]
    n_cases: int
    feat_dim: int
    label_dim: int
    # un-standardized aggregated labels (for box constraints / diagnostics)
    Y_train_raw: np.ndarray
    Y_val_raw: np.ndarray


def prepare_dataset(
    data: dict,
    n_cases: int = 6,
    train_split: float = 0.8,
    c: float = 1.0,
    agg: str = "mean_std",
    seed: int = 0,
    nheads_pad: Optional[int] = None,
    extra_label_keys: Sequence[str] = (),
) -> DatasetSplits:
    """JSON-schema dict -> standardized (B, n_cases, feat) inputs and
    aggregated (B, label_dim) labels, following the reference pipeline
    (OpenPyStruct_FNN_MultiCase.py:185-305):

      pad -> group consecutive samples into n_cases load cases -> permuted
      train/val split -> fit scalers on train only -> merge features ->
      aggregate labels (mean + c*std) -> standardize labels.

    ``extra_label_keys`` appends additional aggregated targets (e.g.
    deflections + rotations for the PINN's 302-dim label,
    OpenPyStruct_PINN_MultiCase.py:35-56).
    """
    num_samples = len(data["I_values"])
    for k in FEATURE_KEYS:
        if len(data.get(k, [])) != num_samples:
            raise ValueError(
                "Mismatch in sample counts among roller_x, force_x, "
                "force_values, node_positions."
            )

    max_lengths = {
        name: max((len(r) for r in data[key]), default=0)
        for name, key in zip(FEATURE_NAMES, FEATURE_KEYS)
    }
    max_lengths["I_values"] = max(len(r) for r in data["I_values"])

    feats = {
        name: pad_sequences(data[key], max_lengths[name])
        for name, key in zip(FEATURE_NAMES, FEATURE_KEYS)
    }
    labels = [pad_sequences(data["I_values"], max_lengths["I_values"])]
    for k in extra_label_keys:
        labels.append(
            pad_sequences(data[k], max(len(r) for r in data[k]))
        )

    total_grouped = num_samples // n_cases
    if total_grouped == 0:
        raise ValueError(f"n_cases={n_cases} > total samples={num_samples}.")
    trim = total_grouped * n_cases

    def group(x):
        return x[:trim].reshape(total_grouped, n_cases, -1)

    feats = {k: group(v) for k, v in feats.items()}
    labels = [group(v) for v in labels]

    rng = np.random.default_rng(seed)
    indices = rng.permutation(total_grouped)
    train_sz = int(train_split * total_grouped)
    tr, va = indices[:train_sz], indices[train_sz:]

    scalers = {}
    Xtr_parts, Xva_parts = [], []
    for name in FEATURE_NAMES:
        tr_std, sc = fit_transform_3d(feats[name][tr])
        scalers[name] = sc
        Xtr_parts.append(tr_std)
        Xva_parts.append(transform_3d(feats[name][va], sc))

    X_train = merge_sub_features(*Xtr_parts)
    X_val = merge_sub_features(*Xva_parts)
    if nheads_pad:
        X_train, _ = pad_feat_dim_to_multiple_of_nheads(X_train, nheads_pad)
        X_val, _ = pad_feat_dim_to_multiple_of_nheads(X_val, nheads_pad)

    Y_tr_raw = np.concatenate(
        [unify_label(lab[tr], c=c, agg=agg) for lab in labels], axis=1
    )
    Y_va_raw = np.concatenate(
        [unify_label(lab[va], c=c, agg=agg) for lab in labels], axis=1
    )
    scaler_Y = Scaler.fit(Y_tr_raw)
    return DatasetSplits(
        X_train=X_train,
        X_val=X_val,
        Y_train=scaler_Y.transform(Y_tr_raw),
        Y_val=scaler_Y.transform(Y_va_raw),
        scalers=scalers,
        scaler_Y=scaler_Y,
        max_lengths=max_lengths,
        n_cases=n_cases,
        feat_dim=X_train.shape[-1],
        label_dim=Y_tr_raw.shape[-1],
        Y_train_raw=Y_tr_raw,
        Y_val_raw=Y_va_raw,
    )


def build_user_input(
    roller_list,
    force_x_list,
    force_val_list,
    node_pos_list,
    scalers: Dict[str, Scaler],
    n_cases: int,
    max_lengths: Dict[str, int],
) -> np.ndarray:
    """Scale per-case user inputs with the fitted scalers ->
    (1, n_cases, feat_dim) (the reference's ``scale_user_inputs`` +
    ``build_user_input_no_agg``, OpenPyStruct_FNN_MultiCase.py:138-183,
    647-657)."""

    def pad_to(seq, req_len):
        arr = np.zeros((req_len,), dtype=np.float32)
        ln = min(len(seq), req_len)
        arr[:ln] = np.asarray(seq, dtype=np.float32)[:ln]
        return arr

    rows = []
    lists = {
        "roller_x": roller_list,
        "force_x": force_x_list,
        "force_values": force_val_list,
        "node_positions": node_pos_list,
    }
    for i in range(n_cases):
        parts = []
        for name in FEATURE_NAMES:
            padded = pad_to(lists[name][i], max_lengths[name])
            parts.append(
                scalers[name].transform(padded[None, :]).ravel()
            )
        rows.append(np.concatenate(parts))
    return np.stack(rows, axis=0)[None, ...]
