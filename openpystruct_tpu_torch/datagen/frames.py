"""Batched frame scenario generation (port of ``datagen/frames.py``), the
frame analog of the beam datagen pipeline.

The reference's frame script optimizes exactly ONE random frame per run
(random 1-10 bays x 1-10 stories, fixed loads,
OpenPyStruct_FrameOpt_Discrete_Beta.py:50-52,166-206) and has no dataset
story at all.  Here a whole batch of load scenarios of one topology is
optimized at once (batched story-level block-Cholesky factorizations,
fem/frame_banded.py), with columnar output in the beam schema's spirit.

Draws come from ``torch.Generator``s, as in the beam datagen, so samples
differ from the JAX package's for the same seed: the topologies from
``torch.Generator(seed)``, the loads of topology (b, s) from
``np.random.SeedSequence([seed, b*64 + s])`` (the JAX package folds
``b*64 + s`` into its load key).  Lanes float32 cannot solve are dropped
by the pivot gate, not rescued.

With a ``mesh`` (``parallel.default_mesh``, one process per device) every
rank draws the whole batch's loads, optimizes its contiguous rows on its
device, gates them, and the ranks gather the results: every rank returns
the global batch, whose rows are the one-rank batch's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.datagen.generate import shard_generator
from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.frame import FrameStructure, build_frame
from openpystruct_tpu_torch.fem.frame_banded import (
    FRAME_VALID_PIVOT,
    frame_min_pivot,
)
from openpystruct_tpu_torch.opt.frame_opt import (
    FrameOptResult,
    optimize_frame_batched,
)
from openpystruct_tpu_torch.parallel import batch_sharding
from openpystruct_tpu_torch.parallel import collectives as coll


@dataclasses.dataclass
class FrameBatch:
    udl: torch.Tensor            # (B,) per-scenario beam UDL
    lateral_load: torch.Tensor   # (B,) per-scenario lateral load
    result: FrameOptResult       # batched
    valid: torch.Tensor          # (B,) finite AND accuracy-grade pivot:
                                 # fixed-base frames are never mechanisms,
                                 # but float32 near-clamp lanes lose every
                                 # digit; the scaled Schur pivot flags them
    pivot: Optional[torch.Tensor] = None  # (B,) min scaled Schur pivot


def sample_frame_loads(generator: torch.Generator, batch: int,
                       cfg: FrameConfig = FrameConfig(), scale=(0.5, 1.5),
                       device="cuda"):
    """(B,) float32 load scenarios from a CPU ``generator``: the reference's
    fixed loads scaled by a uniform factor per lane (the reference
    randomizes only geometry, FrameOpt_Discrete_Beta.py:50-52; load
    variation is the natural dataset axis once topology is batched)."""
    device = resolve_device(device)
    lo, hi = scale
    su = lo + (hi - lo) * torch.rand(batch, generator=generator)
    sp = lo + (hi - lo) * torch.rand(batch, generator=generator)
    return (cfg.udl * su).to(device), (cfg.lateral_load * sp).to(device)


@functools.lru_cache(maxsize=32)
def _structure(num_bays: int, num_stories: int, cfg: FrameConfig,
               device: torch.device) -> FrameStructure:
    """One structure (and its assembly tables) per topology and device."""
    return build_frame(num_bays, num_stories, cfg, device)


def generate_frame_batch(
    generator: torch.Generator,
    batch_size: int,
    num_bays: int,
    num_stories: int,
    cfg: FrameConfig = FrameConfig(),
    load_scale=(0.5, 1.5),
    chunk_size: Optional[int] = None,
    grad_mode: str = "semi",
    device="cuda",
    mesh=None,
    data_axis: str = "data",
):
    """Optimize ``batch_size`` load scenarios of one frame topology at once,
    in float32.  Returns (FrameStructure, FrameBatch).

    ``chunk_size`` (per rank under a mesh) runs lanes in fixed-size
    sequential chunks to bound peak memory (see ``optimize_frame_batched``);
    the pivot pass runs in the same chunks.  ``grad_mode="adjoint"``
    differentiates the loss THROUGH the solve (one extra substitution-only
    adjoint solve through ``block_thomas_solve``'s implicit adjoint) instead
    of the reference's semi-gradient (FrameOpt_Discrete_Beta.py:197-199).
    ``mesh``: shard the lanes over its ``data_axis`` (module docstring); the
    batch must split evenly and the rank's device is the mesh's."""
    device = resolve_device(device) if mesh is None else mesh.device
    structure = _structure(num_bays, num_stories, cfg, device)
    udl, lateral = sample_frame_loads(generator, batch_size, cfg,
                                      load_scale, device)
    mine_udl, mine_lat = udl, lateral
    if mesh is not None:
        rows = batch_sharding(mesh, data_axis).rows(udl.shape[0])
        mine_udl, mine_lat = udl[rows], lateral[rows]
    res = optimize_frame_batched(structure, mine_udl, mine_lat, cfg,
                                 chunk_size=chunk_size, grad_mode=grad_mode)
    finite = (torch.isfinite(res.I).all(-1)
              & torch.isfinite(res.solution.displacements).all(-1).all(-1))
    # accuracy-grade validity: the scaled Schur pivot of the FINAL system
    # (one extra factorization per lane; a NaN pivot compares False and
    # drops the lane)
    B = res.I.shape[0]
    step = B if chunk_size is None or chunk_size >= B else chunk_size
    pad = (-B) % step
    I_p = torch.cat([res.I, res.I[:1].expand(pad, -1)]) if pad else res.I
    pivot = torch.cat([frame_min_pivot(I_p[i:i + step], structure, cfg)
                       for i in range(0, B + pad, step)])[:B]
    valid = finite & (pivot > FRAME_VALID_PIVOT)
    out = FrameBatch(udl=None, lateral_load=None, result=res, valid=valid,
                     pivot=pivot)
    if mesh is not None:
        out = coll.gather_rows(out, mesh.group)
    return structure, dataclasses.replace(out, udl=udl, lateral_load=lateral)


def sample_topologies(generator: torch.Generator, num_samples: int,
                      bays_range=(1, 10), stories_range=(1, 10)):
    """Per-sample random (bays, stories) as numpy arrays: the reference's
    per-run draw (random.randint(1,10) twice,
    OpenPyStruct_FrameOpt_Discrete_Beta.py:50-52) applied per dataset
    row."""
    bays = torch.randint(bays_range[0], bays_range[1] + 1, (num_samples,),
                         generator=generator)
    stories = torch.randint(stories_range[0], stories_range[1] + 1,
                            (num_samples,), generator=generator)
    return bays.numpy(), stories.numpy()


def generate_frame_dataset(
    seed: int,
    num_samples: int,
    cfg: FrameConfig = FrameConfig(),
    bays_range=(1, 10),
    stories_range=(1, 10),
    load_scale=(0.5, 1.5),
    min_bucket: int = 8,
    verbose: bool = False,
    chunk_size: Optional[int] = None,
    grad_mode: str = "semi",
    device="cuda",
    mesh=None,
    data_axis: str = "data",
) -> dict:
    """Mixed-topology frame dataset in ONE call: topology is drawn per
    sample from the reference's 1-10 x 1-10 distribution
    (OpenPyStruct_FrameOpt_Discrete_Beta.py:50-52), then lanes are
    BUCKETED by (bays, stories), each distinct topology one batched run,
    with bucket sizes padded to powers of two (at least ``min_bucket``, and
    to a multiple of the shard count under a ``mesh``, whose ranks share
    each bucket) to bound the number of batch shapes; the padding lanes are
    dropped.

    Returns a columnar dict with PER-ROW ``num_bays``/``num_stories``
    columns plus the frame result schema of :func:`frame_batch_to_columnar`
    (ragged across topologies: lists)."""
    bays, stories = sample_topologies(torch.Generator().manual_seed(seed),
                                      num_samples, bays_range, stories_range)
    keys = ("I_values", "axial_forces", "bending_moments",
            "displacements", "udl", "lateral_load", "n_epochs")
    data = {"num_bays": [], "num_stories": []}
    data.update({k: [] for k in keys})
    shards = 1 if mesh is None else mesh.shards(data_axis)
    for b, s in sorted({(int(x), int(y)) for x, y in zip(bays, stories)}):
        n = int(((bays == b) & (stories == s)).sum())
        bucket = max(1 << max(n - 1, 0).bit_length(), min_bucket, shards)
        bucket = -(-bucket // shards) * shards
        st, batch = generate_frame_batch(
            shard_generator(seed, b * 64 + s), bucket, b, s, cfg,
            load_scale, chunk_size=chunk_size, grad_mode=grad_mode,
            device=device, mesh=mesh, data_axis=data_axis)
        # padding lanes (drawn only to keep bucket shapes) are dropped via
        # the valid mask the columnar writer honours
        keep = batch.valid.clone()
        keep[n:] = False
        cols = frame_batch_to_columnar(st, dataclasses.replace(batch,
                                                               valid=keep))
        rows = len(cols["I_values"])
        data["num_bays"] += [b] * rows
        data["num_stories"] += [s] * rows
        for k in keys:
            data[k] += list(cols[k])
        if verbose:
            print(f"  topology {b}x{s}: {rows}/{n} valid "
                  f"(bucket {bucket})", flush=True)
    return data


def frame_batch_to_columnar(structure: FrameStructure,
                            batch: FrameBatch) -> dict:
    """Columnar host dict (valid rows only), beam-schema spirit: one row
    per scenario with the optimized I field, the global end-force
    components the loss reads, and nodal displacements."""
    valid = batch.valid.cpu().numpy()
    ef = batch.result.solution.end_forces.cpu().numpy()[valid]

    def rows(x):
        return x.cpu().numpy()[valid].tolist()

    return {
        "num_bays": structure.num_bays,
        "num_stories": structure.num_stories,
        "I_values": rows(batch.result.I),
        "axial_forces": ef[:, :, 1].tolist(),
        "bending_moments": ef[:, :, 2].tolist(),
        "displacements": rows(batch.result.solution.displacements),
        "udl": rows(batch.udl),
        "lateral_load": rows(batch.lateral_load),
        "n_epochs": rows(batch.result.n_epochs),
    }
