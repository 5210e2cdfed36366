"""Batched training-data generation (port of ``datagen/generate.py``).

One batch: draw scenarios, optimize every lane's I field (one fused kernel
launch per epoch, with lane compaction for large batches), and keep the
lanes that pass the validity gate: finite values and a min Schur pivot
above ``pivot_tol``, the on-device analog of the reference dropping a sample
when ``ops.analyze`` fails (MultiCore.py:184-186).

Random-bridge scenarios (one roller near the pin plus the 1e-8 I clamp) and
fixed-span meshes finer than 101 nodes (cond ~ n^4) are valid but
ill-conditioned: the float32 gate rejects about a third of a random-bridge
batch and every lane at n = 201, where float64 OpenSees keeps them.  The
**rescue**, on by default in those two regimes, re-optimizes the rejected
lanes from I0 with the full epoch budget in float64-grade arithmetic and
merges them back:

- ``rescue="dd"`` (the default on the card): the float64 fused kernels
  (``ops/beam_kernel_dd.py``), on the device, with lane compaction;
- ``rescue="f64"`` (the default for CPU batches): the plain split path on
  the CPU in float64, the arithmetic the reference runs for every sample.
  A CUDA batch rescues on the host only when the caller asks for it.

The float64 kernels are semi-gradient only.  In adjoint mode a CPU batch
rescues with ``"f64"``, as the JAX package routes it; a CUDA batch raises
``NotImplementedError`` unless ``rescue="f64"`` (or False) is passed, since
there is no float64 adjoint kernel to keep the rescue on the card.

Rescued lanes are valid when finite with a pivot above ``RESCUE_PIVOT_TOL``.

With a ``mesh`` (``parallel.default_mesh``, one process per device) every
rank draws the whole batch's scenarios from the same generator, keeps its
contiguous rows, runs the batch program and the rescue of its own rejected
lanes on its device, and the ranks gather the results: every rank returns
the global batch.  Lanes are independent, so its rows are the one-rank
batch's, bitwise.  The file writers write on rank 0 only.

Three routes write a dataset to disk: ``generate_dataset`` returns the
columnar lists (``io.write_json_dataset`` dumps them);
``generate_dataset_json`` streams each batch's arrays through the native
writer (``native.JsonStreamWriter``), peak host memory one batch; and
``generate_to_shards`` writes one crash-safe ``.npz`` shard a batch, which
``shards_to_json`` turns into the same JSON.

While a profiler records (``utils/profiling.py``), each batch is a
``datagen.batch`` span holding ``datagen.sample``, ``datagen.run_batch``
(its ``opt.stage`` and ``opt.sync`` spans inside) and ``datagen.rescue``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from openpystruct_tpu_torch.config import (
    DATAGEN_OPT,
    BeamConfig,
    OptimizerConfig,
    ScenarioConfig,
)
from openpystruct_tpu_torch.datagen.io import (
    _json_fields,
    batch_to_columnar,
    merge_columnar,
    write_npz_shard,
)
from openpystruct_tpu_torch.datagen.sampler import sample_scenarios
from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.beam import (
    BeamScenario,
    beam_min_pivot,
    solve_beam,
)
from openpystruct_tpu_torch.opt.beam_opt import (
    BeamOptResult,
    _optimize_compact,
    optimize_beam_batched,
    optimize_beam_compact,
)
from openpystruct_tpu_torch.opt.loss import LossComponents
from openpystruct_tpu_torch.parallel import batch_sharding
from openpystruct_tpu_torch.parallel import collectives as coll
from openpystruct_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class DatagenBatch:
    scenario: BeamScenario   # batched (B, ...)
    result: BeamOptResult    # batched
    valid: torch.Tensor      # (B,) bool
    residual: torch.Tensor   # (B,) min Schur pivot of the final system


def run_batch(scenario: BeamScenario, beam_cfg: BeamConfig,
              opt_cfg: OptimizerConfig = DATAGEN_OPT, refine: int = 1,
              pivot_tol: float = 1e-9,
              compact: Optional[bool] = None) -> DatagenBatch:
    """The batch program on given scenarios: optimize, then gate.

    ``compact`` defaults to on for batches of 2048 lanes or more.  The
    scenarios' device and dtype choose the path: CUDA float32 launches the
    kernels, CPU tensors run their plain versions.
    """
    if compact is None:
        compact = scenario.node_x.shape[0] >= 2048
    optimize = optimize_beam_compact if compact else optimize_beam_batched
    with span("datagen.run_batch"):
        res = optimize(scenario, beam_cfg, opt_cfg, refine=refine)
        if res.pivot is not None:
            pivot = res.pivot   # the fused analysis measured it
        else:
            pivot = beam_min_pivot(res.I_solved, scenario, beam_cfg.E,
                                   beam_cfg.A)
        valid = _finite(res) & (pivot > pivot_tol)
    return DatagenBatch(scenario=scenario, result=res, valid=valid,
                        residual=pivot)


def _finite(res: BeamOptResult):
    """(B,) True where I and the displacements are finite."""
    return (torch.isfinite(res.I).all(-1)
            & torch.isfinite(res.solution.displacements).all(-1).all(-1))


# Validity floor for rescued lanes (the JAX package's value and reasoning):
# rescued random-bridge lanes' float64 pivots sit in [7.5e-10, 1.3e-5], pure
# conditioning spread, while a singular system collapses to the round-off
# floor (~1e-16-scale in float64); 1e-12 splits the two with a decade of
# margin on each side.
RESCUE_PIVOT_TOL = 1e-12


def _gather_scenario(scenario: BeamScenario, gidx) -> BeamScenario:
    return scenario.map(lambda x: x[gidx])


def _rescued(res: BeamOptResult, pivot) -> dict:
    """The fields the merge writes back, with the rescue's validity."""
    sol = res.solution
    return dict(
        I=res.I, I_solved=res.I_solved, displacements=sol.displacements,
        deflections=sol.deflections, rotations=sol.rotations,
        shear=sol.shear_forces, moment=sol.bending_moments,
        loss=torch.stack([res.loss.total, res.loss.primary,
                          res.loss.bending_energy, res.loss.shear_energy]),
        n_epochs=res.n_epochs, converged=res.converged, pivot=pivot,
        valid=_finite(res) & (pivot > RESCUE_PIVOT_TOL),
    )


def _dd_rescue(scenario: BeamScenario, beam_cfg: BeamConfig,
               opt_cfg: OptimizerConfig) -> dict:
    """Float64 re-optimization of rejected lanes with the fused float64
    kernels, on the scenarios' device: a cold start from I0 in float32 with
    the full epoch budget, the trajectory the host float64 rescue computes."""
    B, nelem = scenario.node_x.shape[0], scenario.num_nodes - 1
    I0 = torch.full((B, nelem), beam_cfg.I0, dtype=torch.float32,
                    device=scenario.node_x.device)
    res = optimize_beam_compact(scenario, beam_cfg, opt_cfg, I0=I0, dd=True,
                                min_bucket=256)
    return _rescued(res, res.pivot)   # the float64 pivot of the final solve


def _f64_rescue(scenario: BeamScenario, beam_cfg: BeamConfig,
                opt_cfg: OptimizerConfig) -> dict:
    """Float64 re-optimization of rejected lanes on the host CPU with the
    plain split path (any grad_mode) on the plain ``fem.solve`` solver, as
    the JAX package's rescue runs it, cast to float32 and put back on the
    scenarios' device.  For these lanes this is the reference's own
    computation: its torch/OpenSees loop is float64 throughout."""
    device = scenario.node_x.device
    scen64 = scenario.map(lambda x: (x.to(torch.float64)
                                     if x.is_floating_point() else x).cpu())
    B, nelem = scen64.node_x.shape[0], scen64.num_nodes - 1
    I0 = torch.full((B, nelem), beam_cfg.I0, dtype=torch.float64)
    res = _optimize_compact(scen64, beam_cfg, opt_cfg, I0, refine=0,
                            fused=False, min_bucket=32, dd=False,
                            solve=solve_beam)
    pivot = beam_min_pivot(res.I_solved, scen64, beam_cfg.E, beam_cfg.A)
    return {k: (v.to(torch.float32) if v.is_floating_point() else v)
            .to(device) for k, v in _rescued(res, pivot).items()}


def _merge_rescued(batch: DatagenBatch, sub: dict, put) -> DatagenBatch:
    """A copy of ``batch`` with the rescued lanes scattered back.  ``put``
    holds the batch size on padding positions, whose rows are dropped."""
    keep = put < batch.valid.shape[0]
    idx = put[keep]

    def sc(dst, src):
        if dst is None:
            return None
        out = dst.clone()
        out[idx] = src[keep].to(dst.dtype)
        return out

    res, sol = batch.result, batch.result.solution
    sol = dataclasses.replace(
        sol,
        displacements=sc(sol.displacements, sub["displacements"]),
        deflections=sc(sol.deflections, sub["deflections"]),
        rotations=sc(sol.rotations, sub["rotations"]),
        shear_forces=sc(sol.shear_forces, sub["shear"]),
        bending_moments=sc(sol.bending_moments, sub["moment"]),
    )
    names = ("total", "primary", "bending_energy", "shear_energy")
    loss = LossComponents(**{f: sc(getattr(res.loss, f), sub["loss"][i])
                             for i, f in enumerate(names)})
    res = dataclasses.replace(
        res, I=sc(res.I, sub["I"]), I_solved=sc(res.I_solved, sub["I_solved"]),
        solution=sol, loss=loss, n_epochs=sc(res.n_epochs, sub["n_epochs"]),
        converged=sc(res.converged, sub["converged"]),
        pivot=sc(res.pivot, sub["pivot"]),
    )
    return dataclasses.replace(batch, result=res,
                               valid=sc(batch.valid, sub["valid"]),
                               residual=sc(batch.residual, sub["pivot"]))


def _rescue_local(batch: DatagenBatch, beam_cfg: BeamConfig,
                  opt_cfg: OptimizerConfig, mode: str) -> DatagenBatch:
    """Gather the batch's rejected lanes, re-optimize them in float64
    arithmetic (``mode`` "dd" or "f64", module docstring), and scatter
    them back.  The rejected lanes fill a power-of-two bucket of at least
    32, padded with lane 0, as in the JAX package."""
    if mode not in ("dd", "f64"):
        raise ValueError(f"unknown rescue mode: {mode!r}")
    with span("datagen.rescue") as sp:
        bad = torch.nonzero(~batch.valid).flatten()
        n_bad = bad.numel()
        sp.set(rejected=n_bad)
        if n_bad == 0:
            return batch
        B = batch.valid.shape[0]
        bucket = min(B, 1 << max(n_bad - 1, 31).bit_length())
        gidx = torch.cat([bad, bad.new_zeros(bucket - n_bad)])
        sub_scen = _gather_scenario(batch.scenario, gidx)
        rescue = _dd_rescue if mode == "dd" else _f64_rescue
        out = rescue(sub_scen, beam_cfg, opt_cfg)
        pos = torch.arange(bucket, device=gidx.device)
        put = torch.where(pos < n_bad, gidx, torch.full_like(gidx, B))
        return _merge_rescued(batch, out, put)


def _auto_rescue_mode(device: torch.device) -> str:
    """The rescue arithmetic for ``rescue=True``: the float64 kernels on a
    CUDA batch, the host float64 path elsewhere."""
    return "dd" if device.type == "cuda" else "f64"


def _resolve_rescue(rescue, scen_cfg: ScenarioConfig, grad_mode: str,
                    device: torch.device):
    """``generate_batch``'s ``rescue`` argument as a mode ("dd", "f64") or
    False (docstring there)."""
    explicit_dd = rescue == "dd"
    if rescue is None:
        rescue = scen_cfg.random_bridge or scen_cfg.num_nodes > 101
    if rescue is True:
        rescue = _auto_rescue_mode(device)
    if rescue == "dd" and grad_mode != "semi":
        if device.type == "cuda":
            raise NotImplementedError(
                f"grad_mode={grad_mode!r} on a CUDA batch: the rescue's "
                "float64 opt-step kernel (beam_opt_step_dd) is semi-gradient "
                "only and there is no float64 adjoint kernel; pass "
                "rescue='f64' to rescue on the host CPU in float64, or "
                "rescue=False")
        if explicit_dd:
            logging.getLogger(__name__).warning(
                "rescue='dd' requested but grad_mode=%r: the float64 kernels "
                "are semi-gradient only; falling back to the exact-adjoint "
                "host-f64 rescue", grad_mode,
            )
        rescue = "f64"
    return rescue


def generate_batch(generator: torch.Generator, batch_size: int,
                   scen_cfg: ScenarioConfig = ScenarioConfig(),
                   beam_cfg: Optional[BeamConfig] = None,
                   opt_cfg: OptimizerConfig = DATAGEN_OPT, refine: int = 1,
                   pivot_tol: float = 1e-9, compact: Optional[bool] = None,
                   rescue=None, device="cuda",
                   dtype=torch.float32, mesh=None,
                   data_axis: str = "data") -> DatagenBatch:
    """Draw ``batch_size`` scenarios from ``generator``, run the batch
    program on them (float32 on the card, as the JAX package runs it), and
    rescue the rejected lanes.

    ``mesh``: shard the lanes over its ``data_axis`` (module docstring);
    the batch must split evenly, the rank's device is the mesh's, and
    ``compact`` defaults on from 2048 lanes a rank.

    ``rescue``: None (default) rescues random-bridge batches and meshes
    finer than 101 nodes, the regimes whose valid lanes the float32 gate
    rejects, and skips the host sync elsewhere; True picks the arithmetic
    (``"dd"`` on the card, ``"f64"`` on the CPU); ``"dd"`` or ``"f64"``
    asks for one; False keeps only the float32 pass.  The float64 kernels
    are semi-gradient only: in adjoint mode a CPU batch rescues with
    ``"f64"`` (warning if ``"dd"`` was asked for), and a CUDA batch raises
    ``NotImplementedError`` unless ``rescue`` is ``"f64"`` or False.
    """
    if beam_cfg is None:
        beam_cfg = BeamConfig(udl=scen_cfg.udl)
    device = resolve_device(device) if mesh is None else mesh.device
    rescue = _resolve_rescue(rescue, scen_cfg, opt_cfg.grad_mode, device)
    with span("datagen.batch", lanes=batch_size):
        with span("datagen.sample"):
            scenario = sample_scenarios(generator, batch_size, scen_cfg,
                                        device=device, dtype=dtype)
        local = scenario
        if mesh is not None:
            rows = batch_sharding(mesh, data_axis).rows(batch_size)
            local = scenario.map(lambda x: x[rows])
        batch = run_batch(local, beam_cfg, opt_cfg, refine, pivot_tol,
                          compact)
        if rescue:
            # a rank rescues only its own rejected lanes
            batch = _rescue_local(batch, beam_cfg, opt_cfg, rescue)
        if mesh is not None:
            batch = dataclasses.replace(
                coll.gather_rows(dataclasses.replace(batch, scenario=None),
                                 mesh.group), scenario=scenario)
    return batch


def _batches(num_samples: int, batch_size: int,
             generator_of: Callable[[int], torch.Generator], batch_kw: dict,
             on_batch: Optional[Callable[[DatagenBatch], None]],
             skip: Callable[[int], bool] = lambda i: False):
    """Yield ``(i, batch)`` for the ``ceil(num_samples / batch_size)``
    batches of a run, batch i drawn from ``generator_of(i)`` through
    ``generate_batch(..., **batch_kw)``; batches with ``skip(i)`` are not
    generated.  ``on_batch``, if given, sees every generated batch."""
    for i in range(-(-num_samples // batch_size)):
        if skip(i):
            continue
        b = min(batch_size, num_samples - i * batch_size)
        batch = generate_batch(generator_of(i), b, **batch_kw)
        if on_batch is not None:
            on_batch(batch)
        yield i, batch


def generate_dataset(seed: int, num_samples: int, batch_size: int = 1024,
                     on_batch: Optional[Callable[[DatagenBatch], None]] = None,
                     **batch_kw) -> dict:
    """Generate ``num_samples`` scenarios in batches and return the valid
    ones as a host-side columnar dict in the reference's 13-key schema
    (OpenPyStruct_BeamOpt_training_SingleCore.py:73-87).  ``batch_kw`` goes
    to ``generate_batch`` (``scen_cfg``, ``beam_cfg``, ``opt_cfg``,
    ``refine``, ``pivot_tol``, ``compact``, ``rescue``, ``device``,
    ``dtype``, ``mesh``, ``data_axis``); one ``torch.Generator(seed)`` runs
    across the batches.  ``on_batch``, if given, sees every DatagenBatch
    (progress, statistics)."""
    generator = torch.Generator().manual_seed(seed)
    return merge_columnar([
        batch_to_columnar(batch) for _, batch in _batches(
            num_samples, batch_size, lambda i: generator, batch_kw,
            on_batch)])


def generate_dataset_json(seed: int, num_samples: int, path: str,
                          batch_size: int = 8192,
                          on_batch: Optional[Callable[[DatagenBatch], None]]
                          = None, **batch_kw) -> int:
    """Generate ``num_samples`` scenarios and stream the 13-key JSON to
    ``path`` batch by batch through ``native.JsonStreamWriter`` (the native
    C++ writer, or its Python fragments without a toolchain), serializing
    straight from each batch's arrays: peak host memory is one batch, and
    no per-sample Python lists are built.  ``batch_kw`` and the one
    ``torch.Generator(seed)`` across the batches are ``generate_dataset``'s,
    so the same seed and ``batch_size`` give the same samples.  Returns the
    number of valid samples written.  With a ``mesh`` rank 0 writes the file
    and every rank returns the count once it is written."""
    from openpystruct_tpu_torch.datagen.native import JsonStreamWriter

    mesh = batch_kw.get("mesh")
    writes = mesh is None or mesh.rank == 0
    generator = torch.Generator().manual_seed(seed)
    writer = JsonStreamWriter(path) if writes else None
    n = 0
    for _, batch in _batches(num_samples, batch_size, lambda i: generator,
                             batch_kw, on_batch):
        if writes:
            writer.append(_json_fields(batch))
        else:
            n += int(batch.valid.sum())
    if writes:
        n = writer.finalize()
    if mesh is not None:
        coll.barrier(mesh.group)
    return n


def shard_generator(seed: int, index: int) -> torch.Generator:
    """The generator of shard ``index``: seeded from
    ``np.random.SeedSequence([seed, index])``, the counterpart of the JAX
    package's ``fold_in(key, index)``.  A pure function of (seed, index), so
    a shard regenerated after a crash draws what the lost one drew."""
    s = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(s[0]) >> 1)


def generate_to_shards(seed: int, num_samples: int, shard_dir: str,
                       batch_size: int = 8192,
                       on_batch: Optional[Callable[[DatagenBatch], None]]
                       = None, **batch_kw) -> List[str]:
    """Crash-safe generation: one ``.npz`` shard (``io.write_npz_shard``)
    per batch, ``shard_{i:05d}.npz`` in ``shard_dir``; ``batch_kw`` as in
    ``generate_dataset``.

    Shard i draws from ``shard_generator(seed, i)``, so it does not depend on
    the other shards.  Each shard is written to ``.tmp.npz`` and renamed
    into place, so a shard on disk is whole; a restart skips the shards
    already there and generates only the missing ones (the reference writes
    its JSON once at the end, and a crash loses everything,
    OpenPyStruct_BeamOpt_training_SingleCore.py:263-264).  ``on_batch``
    sees each generated batch.  Returns every shard's path, in order.

    With a ``mesh`` every rank generates each missing shard (rank 0's view
    of which are missing, broadcast), rank 0 alone writes and renames it,
    and the ranks meet at a barrier after each shard.
    """
    mesh = batch_kw.get("mesh")
    writes = mesh is None or mesh.rank == 0
    paths = [os.path.join(shard_dir, f"shard_{i:05d}.npz")
             for i in range(-(-num_samples // batch_size))]
    if writes:
        os.makedirs(shard_dir, exist_ok=True)
    there = torch.tensor([os.path.exists(p) for p in paths],
                         dtype=torch.uint8)
    if mesh is not None:
        there = coll.broadcast(there, src=0, group=mesh.group)
    for i, batch in _batches(num_samples, batch_size,
                             lambda i: shard_generator(seed, i), batch_kw,
                             on_batch, skip=lambda i: bool(there[i])):
        if writes:
            # np.savez appends .npz to a name without it: keep it explicit
            tmp = paths[i][: -len(".npz")] + ".tmp.npz"
            write_npz_shard(batch, tmp)
            os.replace(tmp, paths[i])
        if mesh is not None:
            coll.barrier(mesh.group)
    return paths


def shards_to_json(shard_paths, path: str) -> int:
    """Convert ``.npz`` shards (``generate_to_shards``) to the 13-key JSON
    through ``native.JsonStreamWriter``, one shard in memory at a time.
    Returns the number of valid samples written."""
    from openpystruct_tpu_torch.datagen.native import JsonStreamWriter

    writer = JsonStreamWriter(path)
    for p in shard_paths:
        with np.load(p) as z:
            fields = dict(
                node_x=z["node_x"], roller=z["roller_mask"],
                loads=z["point_loads"], I=z["I"], shear=z["shear_forces"],
                moment=z["bending_moments"], defl=z["deflections"],
                rot=z["rotations"], valid=z["valid"],
            )
            for k in ("roller_order", "force_order"):
                if k in z.files:
                    fields[k] = z[k]
            writer.append(fields)
    return writer.finalize()
