"""The comparison that decides ``correct`` for datagen rows.

Each sampled lane's row, as the program returned it, is held against the
plain float64 reference on the same scenario:

- ``scenario_mismatch``: entries of the row's scenario (node positions,
  roller mask, point loads, UDL, draw orders) that differ from the
  reference sampler's draw cast to float32.  Exact: limit 0.
- ``singular_rows``: rows the program returned valid whose system the
  float64 reference finds singular at the row's own last-solved I (pivot
  at most ``SINGULAR_PIVOT``, or a field not finite).  Exact: limit 0.
- ``analysis_gap_max`` and ``analysis_gap_p50``: over the valid rows, the
  largest and the median of a row's gap between its fields u, V, M and the
  float64 analysis at the row's own last-solved I, each field's largest
  absolute difference over the reference field's largest magnitude, the
  worst of the three.  This judges the final analysis (#1, or #7 for a
  rescued lane) by what it says about the I it was given.
- ``loss_gap_max`` and ``loss_gap_p50``: over the rows valid on both sides,
  the gap between the float64 loss of the row's design (its final I) and
  the float64 loss of the reference's own design, found by the upstream
  Adam loop in float64 from I0, over the latter.  This judges the epoch
  loop, the opt step (#2, or #8 for a rescued lane) and early stopping.

The reference reads the program's I only to judge the row made from it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import beam as rb
from portbench.reference import sampler

#: a float64 pivot at or below this is singular: the program's own floor for
#: rescued lanes, a decade above the float64 round-off floor
SINGULAR_PIVOT = 1e-12

NUMBERS = ("scenario_mismatch", "singular_rows", "analysis_gap_max",
           "analysis_gap_p50", "loss_gap_max", "loss_gap_p50")

SCENARIO_FIELDS = ("node_x", "roller_mask", "point_loads", "udl",
                   "roller_order", "force_order")


def replay(seed: int, cfg: dict, lanes: int, rows_by_batch: list) -> dict:
    """The reference's scenarios of the sampled rows: every batch drawn in
    order from one generator seeded with ``seed``, batch i keeping the
    lanes ``rows_by_batch[i]`` (empty for a batch not sampled).  Returns
    the rows of all batches concatenated, float32 values in float64
    arrays as the program receives them."""
    gen = torch.Generator().manual_seed(seed)
    parts = [sampler.draw(gen, lanes, cfg["scenario"], rows=rows)
             for rows in rows_by_batch]
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    for k in ("node_x", "point_loads", "udl"):
        out[k] = out[k].astype(np.float32).astype(np.float64)
    return out


def _rel(a, b, dims):
    return (a - b).abs().amax(dims) / b.abs().amax(dims)


def _loss_at(I, bm, opt, ar):
    _, V, M, _ = rb.analysis(I, bm, ar, with_pivot=False)
    return rb.loss_terms(I, V, M, bm, opt)[0]


def reference_rows(ref_sc: dict, cfg: dict, opt: dict, device) -> dict:
    """The reference's own rows: its design by the float64 Adam loop from
    I0, the loss of that design and its validity."""
    bm = rb.make_beams(ref_sc, cfg["beam"], torch.float64, device)
    ar = rb.Arith("f64")
    res = rb.optimize(bm, opt, cfg["beam"]["I0"], ar)
    _, _, _, piv = rb.analysis(res.I_solved, bm, ar)
    valid = torch.isfinite(res.I).all(-1) & (piv > SINGULAR_PIVOT)
    return dict(bm=bm, I=res.I, loss=_loss_at(res.I, bm, opt, ar),
                valid=valid, n_epochs=res.n_epochs)


def judge(rows: dict, ref_sc: dict, ref: dict, opt: dict) -> dict:
    """The numbers of ``NUMBERS`` for the program's ``rows`` (tensors on
    the reference's device: the scenario fields, I, I_solved, u, V, M,
    valid) against the reference's scenarios and ``reference_rows``."""
    bm, ar = ref["bm"], rb.Arith("f64")
    dev = bm.Le.device
    mismatch = 0
    for k in SCENARIO_FIELDS:
        mine = torch.as_tensor(ref_sc[k]).to(dev)
        theirs = rows[k].to(dev)
        if k in ("node_x", "point_loads", "udl"):
            theirs = theirs.to(torch.float32).to(torch.float64)
        mismatch += int((mine.to(theirs.dtype) != theirs).sum())
    f64 = {k: rows[k].to(dev, torch.float64)
           for k in ("I", "I_solved", "u", "V", "M")}
    valid = rows["valid"].to(dev).bool()
    u, V, M, piv = rb.analysis(f64["I_solved"], bm, ar)
    finite = (torch.isfinite(f64["I"]).all(-1)
              & torch.isfinite(f64["u"]).all(-1).all(-1)
              & torch.isfinite(f64["M"]).all(-1)
              & torch.isfinite(f64["V"]).all(-1))
    singular = valid & ~(finite & (piv > SINGULAR_PIVOT))
    gap = torch.maximum(torch.maximum(_rel(f64["u"], u, (-1, -2)),
                                      _rel(f64["V"], V, -1)),
                        _rel(f64["M"], M, -1))
    gap = torch.nan_to_num(gap, nan=float("inf"))
    ok = valid & ~singular
    both = ok & ref["valid"]
    loss = _loss_at(torch.where(both[:, None], f64["I"], ref["I"]), bm, opt,
                    ar)
    lgap = torch.nan_to_num((loss - ref["loss"]).abs() / ref["loss"].abs(),
                            nan=float("inf"))

    def stats(x, mask):
        x = x[mask]
        if x.numel() == 0:
            return float("inf"), float("inf")
        return float(x.max()), float(x.median())

    a_max, a_p50 = stats(gap, ok)
    l_max, l_p50 = stats(lgap, both)
    return dict(
        numbers=dict(scenario_mismatch=mismatch,
                     singular_rows=int(singular.sum()),
                     analysis_gap_max=a_max, analysis_gap_p50=a_p50,
                     loss_gap_max=l_max, loss_gap_p50=l_p50),
        info=dict(rows=int(valid.numel()), rows_valid=int(valid.sum()),
                  rows_valid_in_reference=int(ref["valid"].sum()),
                  rows_compared_for_loss=int(both.sum()),
                  reference_epochs_max=int(ref["n_epochs"].max())
                  if ref["n_epochs"].numel() else 0),
    )
