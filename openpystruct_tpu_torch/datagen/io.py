"""Dataset serialization (port of ``datagen/io.py``).

- the reference's 13-key columnar JSON schema (the contract between its
  datagen and surrogate layers,
  OpenPyStruct_BeamOpt_training_SingleCore.py:73-87): ragged per-sample
  lists, 1-based node tags;
- array-native ``.npz`` shards of the masked fixed-size representation.

``write_json_dataset`` dumps a columnar dict with ``json.dump``;
``read_json_dataset`` parses with the native C++ reader by default and
falls back to ``json.load`` (``datagen/native.py``).  The streamed writer
that serializes straight from the arrays is ``native.JsonStreamWriter``
(``generate.generate_dataset_json``, ``generate.shards_to_json``).
"""

from __future__ import annotations

import json
from typing import Iterable, List

import numpy as np

SCHEMA_KEYS = (
    "roller_x_locations",
    "force_x_locations",
    "force_values",
    "I_values",
    "shear_forces",
    "bending_moments",
    "node_positions",
    "roller_nodes",
    "force_nodes",
    "num_nodes",
    "L",
    "rotations",
    "deflections",
)


def _np(t):
    return t.detach().cpu().numpy()


def _json_fields(batch) -> dict:
    """The arrays of a DatagenBatch that the 13-key schema needs, on the
    host as numpy: one ``.cpu()`` per field and nothing else (the batch
    carries ~4x more: displacements, the optimizer state)."""
    sc, res = batch.scenario, batch.result
    fields = dict(
        node_x=_np(sc.node_x), roller=_np(sc.roller_mask),
        loads=_np(sc.point_loads), I=_np(res.I),
        shear=_np(res.solution.shear_forces),
        moment=_np(res.solution.bending_moments),
        defl=_np(res.solution.deflections), rot=_np(res.solution.rotations),
        valid=_np(batch.valid),
    )
    if sc.roller_order is not None:
        fields["roller_order"] = _np(sc.roller_order)
    if sc.force_order is not None:
        fields["force_order"] = _np(sc.force_order)
    return fields


def batch_to_columnar(batch) -> dict:
    """One DatagenBatch -> the 13-key columnar schema on the host, dropping
    invalid samples (the reference's None-filtering,
    OpenPyStruct_BeamOpt_training_MultiCore.py:264-265).  Only the fields
    the schema needs leave the device."""
    return columnar_from_fields(_json_fields(batch))


def columnar_from_fields(fields: dict) -> dict:
    """Fields dict (node_x, roller, loads, I, shear, moment, defl, rot,
    valid: (B, ...) numpy arrays) -> 13-key columnar schema.  Optional
    ``roller_order``/``force_order`` put each sample's roller/force lists in
    the reference's draw order (MultiCore.py:137-162,227-240); without them
    the lists are in ascending node order."""
    valid = np.asarray(fields["valid"])
    node_x = np.asarray(fields["node_x"])
    roller_mask = np.asarray(fields["roller"])
    loads = np.asarray(fields["loads"])
    I = np.asarray(fields["I"])
    shear = np.asarray(fields["shear"])
    moment = np.asarray(fields["moment"])
    rot = np.asarray(fields["rot"])
    defl = np.asarray(fields["defl"])
    r_order = fields.get("roller_order")
    f_order = fields.get("force_order")

    out = {k: [] for k in SCHEMA_KEYS}
    for b in np.nonzero(valid)[0]:
        r_idx = np.nonzero(roller_mask[b])[0]
        f_idx = np.nonzero(loads[b] != 0.0)[0]
        if r_order is not None:
            r_idx = r_idx[np.argsort(r_order[b][r_idx], kind="stable")]
        if f_order is not None:
            f_idx = f_idx[np.argsort(f_order[b][f_idx], kind="stable")]
        out["roller_x_locations"].append(node_x[b, r_idx].tolist())
        out["force_x_locations"].append(node_x[b, f_idx].tolist())
        out["force_values"].append(loads[b, f_idx].tolist())
        out["I_values"].append(I[b].tolist())
        out["shear_forces"].append(shear[b].tolist())
        out["bending_moments"].append(moment[b].tolist())
        out["node_positions"].append(node_x[b].tolist())
        # 1-based OpenSees node tags, as the reference stores them
        out["roller_nodes"].append((r_idx + 1).tolist())
        out["force_nodes"].append((f_idx + 1).tolist())
        out["num_nodes"].append(int(node_x.shape[1]))
        out["L"].append(float(node_x[b, -1]))
        out["rotations"].append(rot[b].tolist())
        out["deflections"].append(defl[b].tolist())
    return out


def merge_columnar(chunks: Iterable[dict]) -> dict:
    out = {k: [] for k in SCHEMA_KEYS}
    for c in chunks:
        for k in SCHEMA_KEYS:
            out[k].extend(c[k])
    return out


def write_json_dataset(columnar: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(columnar, f)


def read_json_dataset(path: str, native: bool = True) -> dict:
    """Load a 13-key schema dataset.

    With ``native=True`` (the default) the C++ single-pass reader parses the
    file when it can be built: columns come back as numpy arrays, (rows,
    width) float32 where the rows are uniform, a list of float32 row arrays
    where they are ragged, and (rows,) float64 for the scalar columns
    (num_nodes, L).  ``prepare_dataset`` takes either form.  Without the
    reader, or on a file it does not parse, ``json.load`` reads it (nested
    Python lists, ints where the file has ints).
    """
    data = None
    if native:
        from openpystruct_tpu_torch.datagen.native import (
            read_json_dataset_native,
        )

        data = read_json_dataset_native(path, SCHEMA_KEYS)
    if data is None:
        with open(path, "r") as f:
            data = json.load(f)
    missing = [k for k in SCHEMA_KEYS if k not in data]
    if missing:
        raise ValueError(f"dataset at {path} missing keys: {missing}")
    return data


def write_npz_shard(batch, path: str) -> None:
    """Array-native shard: masked fixed-size arrays, no ragged lists."""
    sc, res = batch.scenario, batch.result
    extra = {}
    if sc.roller_order is not None:
        extra["roller_order"] = _np(sc.roller_order)
    if sc.force_order is not None:
        extra["force_order"] = _np(sc.force_order)
    np.savez_compressed(
        path,
        **extra,
        node_x=_np(sc.node_x),
        roller_mask=_np(sc.roller_mask),
        point_loads=_np(sc.point_loads),
        udl=_np(sc.udl),
        I=_np(res.I),
        shear_forces=_np(res.solution.shear_forces),
        bending_moments=_np(res.solution.bending_moments),
        deflections=_np(res.solution.deflections),
        rotations=_np(res.solution.rotations),
        n_epochs=_np(res.n_epochs),
        valid=_np(batch.valid),
        residual=_np(batch.residual),
    )


def read_npz_shards(paths: List[str]) -> dict:
    """Concatenate ``.npz`` shards (``write_npz_shard``) field by field along
    the lane axis."""
    arrays = {}
    for p in paths:
        with np.load(p) as z:
            for k in z.files:
                arrays.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v, axis=0) for k, v in arrays.items()}
