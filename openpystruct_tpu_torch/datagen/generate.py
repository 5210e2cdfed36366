"""Batched training-data generation (port of ``datagen/generate.py``,
fixed-bridge path).

One batch: draw scenarios, optimize every lane's I field (one fused kernel
launch per epoch, with lane compaction for large batches), and keep the
lanes that pass the validity gate: finite values and a min Schur pivot
above ``pivot_tol``, the on-device analog of the reference dropping a sample
when ``ops.analyze`` fails (MultiCore.py:184-186).

Not ported yet: the random-bridge and n > 101 rescue, which re-optimizes
pivot-rejected lanes in double-double (JAX) arithmetic, and the native JSON
writer; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from openpystruct_tpu_torch.config import (
    DATAGEN_OPT,
    BeamConfig,
    OptimizerConfig,
    ScenarioConfig,
)
from openpystruct_tpu_torch.datagen.io import batch_to_columnar, merge_columnar
from openpystruct_tpu_torch.datagen.sampler import sample_scenarios
from openpystruct_tpu_torch.fem.beam import BeamScenario, beam_min_pivot
from openpystruct_tpu_torch.opt.beam_opt import (
    BeamOptResult,
    optimize_beam_batched,
    optimize_beam_compact,
)


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
    res = optimize(scenario, beam_cfg, opt_cfg, refine=refine)
    if res.pivot is not None:
        pivot = res.pivot   # the fused analysis measured it
    else:
        pivot = beam_min_pivot(res.I_solved, scenario, beam_cfg.E, beam_cfg.A)
    finite = (torch.isfinite(res.I).all(-1)
              & torch.isfinite(res.solution.displacements).all(-1).all(-1))
    return DatagenBatch(scenario=scenario, result=res,
                        valid=finite & (pivot > pivot_tol), residual=pivot)


def _check_supported(scen_cfg: ScenarioConfig, rescue) -> None:
    if scen_cfg.random_bridge or scen_cfg.num_nodes > 101 or rescue:
        raise NotImplementedError(
            "random-bridge, num_nodes > 101 and rescue datagen need the "
            "double-double rescue kernels (openpystruct_tpu "
            "ops/beam_kernel_dd.py), which are not ported yet"
        )


def generate_batch(generator: torch.Generator, batch_size: int,
                   scen_cfg: ScenarioConfig = ScenarioConfig(),
                   beam_cfg: Optional[BeamConfig] = None,
                   opt_cfg: OptimizerConfig = DATAGEN_OPT, refine: int = 1,
                   pivot_tol: float = 1e-9, compact: Optional[bool] = None,
                   rescue=None, device="cuda",
                   dtype=torch.float32) -> DatagenBatch:
    """Draw ``batch_size`` scenarios from ``generator`` and run the batch
    program on them (float32 on the card, as the JAX package runs it)."""
    _check_supported(scen_cfg, rescue)
    if beam_cfg is None:
        beam_cfg = BeamConfig(udl=scen_cfg.udl)
    scenario = sample_scenarios(generator, batch_size, scen_cfg,
                                device=device, dtype=dtype)
    return run_batch(scenario, beam_cfg, opt_cfg, refine, pivot_tol, compact)


def generate_dataset(seed: int, num_samples: int, batch_size: int = 1024,
                     scen_cfg: ScenarioConfig = ScenarioConfig(),
                     beam_cfg: Optional[BeamConfig] = None,
                     opt_cfg: OptimizerConfig = DATAGEN_OPT, refine: int = 1,
                     pivot_tol: float = 1e-9, compact: Optional[bool] = None,
                     rescue=None, device="cuda", dtype=torch.float32,
                     on_batch: Optional[Callable[[DatagenBatch], None]] = None,
                     ) -> dict:
    """Generate ``num_samples`` scenarios in batches and return the valid
    ones as a host-side columnar dict in the reference's 13-key schema
    (OpenPyStruct_BeamOpt_training_SingleCore.py:73-87).  ``on_batch``, if
    given, sees every DatagenBatch (progress, statistics)."""
    generator = torch.Generator().manual_seed(seed)
    chunks = []
    done = 0
    while done < num_samples:
        b = min(batch_size, num_samples - done)
        batch = generate_batch(generator, b, scen_cfg, beam_cfg, opt_cfg,
                               refine, pivot_tol, compact, rescue, device,
                               dtype)
        if on_batch is not None:
            on_batch(batch)
        chunks.append(batch_to_columnar(batch))
        done += b
    return merge_columnar(chunks)
