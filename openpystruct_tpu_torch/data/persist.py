"""Persist preprocessing state: the fitted scalers and the shape metadata
(port of ``data/persist.py``).

The reference never persists its fitted StandardScalers, so inference works
only inside the script run that trained the model.  Here the (mean, scale)
pairs and the padding metadata round-trip through one ``.npz`` in the JAX
package's layout (``<feature>__mean``, ``<feature>__scale``, ``Y__mean``,
``Y__scale`` and a JSON ``__meta__``), so a file written by either package
loads in the other.  Plain NumPy.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from openpystruct_tpu_torch.data.pipeline import (
    FEATURE_NAMES,
    DatasetSplits,
    Scaler,
)


def _host(a) -> np.ndarray:
    """A scaler array as numpy (the device pipeline's scalers hold
    tensors)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_preprocessing(ds: DatasetSplits, path: str,
                       nelem: Optional[int] = None) -> None:
    """Save the fitted scalers and metadata of a prepared dataset.

    ``nelem``: the element count of the training dataset's mesh (the
    label's I-slice width), so that a later process rebuilds the model and
    the user-input node grid at that mesh size."""
    arrays = {}
    for name in FEATURE_NAMES:
        arrays[f"{name}__mean"] = _host(ds.scalers[name].mean)
        arrays[f"{name}__scale"] = _host(ds.scalers[name].scale)
    arrays["Y__mean"] = _host(ds.scaler_Y.mean)
    arrays["Y__scale"] = _host(ds.scaler_Y.scale)
    meta = dict(
        max_lengths=ds.max_lengths,
        n_cases=ds.n_cases,
        feat_dim=ds.feat_dim,
        label_dim=ds.label_dim,
    )
    if nelem is not None:
        meta["nelem"] = int(nelem)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_preprocessing(path: str) -> Dict:
    """Load scalers and metadata: a dict with 'scalers', 'scaler_Y',
    'max_lengths', 'n_cases', 'feat_dim', 'label_dim' and 'nelem' (None in a
    file saved without it)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        scalers = {
            name: Scaler(mean=z[f"{name}__mean"], scale=z[f"{name}__scale"])
            for name in FEATURE_NAMES
        }
        scaler_Y = Scaler(mean=z["Y__mean"], scale=z["Y__scale"])
    return dict(
        scalers=scalers,
        scaler_Y=scaler_Y,
        max_lengths=meta["max_lengths"],
        n_cases=meta["n_cases"],
        feat_dim=meta["feat_dim"],
        label_dim=meta["label_dim"],
        nelem=meta.get("nelem"),
    )
