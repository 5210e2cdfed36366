#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: datagen (the
fixed bridge, the random bridge and the 201-node mesh with their float64
rescue), the split solve path, the differentiable fused analysis, the
accuracy autopilot with its streamed float64 large-mesh route, the
bidirectional block-Thomas experiment, the training path (features,
preprocessing, the TFD surrogate's fit and R^2), the file-based workflow
(crash-safe shards, the 13-key JSON through the native writer and reader,
every surrogate family trained from that file), and the frame path (the
banded frame solve, the batched frame optimizer, frame datagen, the checked
solve) with ``fit``'s checkpoint and resume.

    python3 chip_smoke.py [--seed 0] [--quick]

Phases, each of which raises on failure (exit code not 0):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``openpystruct_tpu_torch/ops/csrc``;
3. each float32 kernel against its plain PyTorch version at full width
   (B = 16384 lanes, n = 101): the plain version runs in float64 on the
   card as the truth, and the kernel's per-lane error, at the median and
   the 99th percentile, must be no more than twice the plain float32
   version's, or 1e-5 of the output's per-lane scale, whichever is larger;
   the validity masks (pivot > 1e-9) must be identical; then #2 given
   the epoch loop's lane state, the main path's one launch an epoch, on
   the same lanes with NaN lanes, done lanes (a whole 32-lane block among
   them), lanes at patience and totals exactly at best - tolerance: bitwise
   the bare step followed by ``freeze_lanes``, and against the plain
   version followed by ``freeze_lanes`` the same decisions, the done lanes
   untouched and the stepped lanes held by the rule above;
3b. each float64 rescue kernel against its plain version (float64 inside,
   float32 in and out) on 16384 random-bridge lanes plus the four
   quasi-cantilever lanes float32 cannot solve: per-lane error no more than
   1e-5 of the lane's scale, pivots within a relative 1e-3; the float32
   kernel's error on the quasi-cantilever lanes is printed beside them;
3c. the split-path kernels against their plain versions at B = 16384, n =
   101 and 201 on fixed-bridge and random-bridge systems, and n = 51 on
   random-bridge ones: the explicit-RHS beam solve (#3, x and pivot), the
   one-launch block-Thomas solve (#4, its x bitwise
   equal to #6's), the bidirectional one (#5, against its own plain
   version) and the streamed one (#6).  On the fixed bridge at n = 101 by
   phase 3's rule.  Elsewhere float32 keeps about no digits (plain
   float32's own error is ~1 of the lane's scale), so the forward errors
   are printed, not held; on all five cases each kernel's backward error
   (the residual of the system in float64, relative to |K| |x| + |b| per
   lane) must be no more than twice the plain float32 version's, or 1e-6,
   at the median, the 99th percentile and the worst lane (#3 at n = 51:
   the median and the 99th percentile, phase 3's rule; its worst lane is
   printed with its forward error and condition), with no more non-finite
   lanes; then, under torch.profiler, one call of each wrapper (#1-#9)
   launches its kernel and no copy (``block_tridiag_solve(bidi=True)``
   one kernel, #5), and one of the fused float64 route
   ``solve_beam_dd_streamed`` launches #9's two sweeps and nothing else;
3d. the streamed float64 solve (#9) against its plain version on the
   float64-assembled systems of phase 3b's 16384 random-bridge lanes plus
   the four quasi-cantilever lanes (n = 101) and of 16384 span-scaled
   tail-overhang lanes at n = 1001: per-lane error no more than 1e-5 of
   the lane's scale, pivots within a relative 1e-3 (phase 3b's rule); on
   the same lanes the fused route ``solve_beam_dd_streamed`` (#9's sweeps
   assembling the system themselves) against its plain version, u within
   1e-5 of the lane's scale and pivots within a relative 1e-6, its lanes
   bitwise equal to the unfused route (assembly, then #9) counted;
4. the main path: ``generate_dataset`` (DATAGEN_OPT, refine 1, lane
   compaction) over two 16384-lane fixed-bridge batches, the 13-key JSON
   written and read back, both kernels launched and no plain version
   called;
4b. random-bridge ``generate_dataset`` over two 16384-lane batches with the
   default rescue: at least 99% valid, the lanes the float32 pass kept
   bitwise equal to a run without rescue, rescued lanes pinned at their
   supports, every kernel launched, no plain version and no host rescue;
4c. one 16384-lane fixed-bridge batch at n = 201, where the float32 gate
   rejects the lanes and the rescue keeps at least 99% of them; before it,
   all four kernels against their plain versions at n = 201 by the rules of
   phases 3 and 3b, except that the float32 kernels' validity mask may be
   off float64's on up to twice as many lanes as plain float32's;
4d. the split path: ``optimize_beam_compact(fused=False)`` on 16384
   fixed-bridge lanes in semi and in adjoint mode (n = 101) and on 16384
   random-bridge lanes at n = 51 in semi mode, the solve launched forward
   (and backward in adjoint mode) and no plain version, each solve on the
   kernel ``block_tridiag.uses_streamed`` names for its lane count (#4 or
   #6; the launches by lane count printed); after the n = 101
   semi run, a window of PROFILE_EPOCHS epochs of its epoch body on the
   16384 lanes and on PROFILE_BUCKET of them under torch.profiler (device
   busy share, top device and host ops);
   then phase 5's rule on 512 lanes against the plain float32 and float64
   split paths (epochs cut to SPLIT_CHECK_EPOCHS for all three, to keep the
   host's plain runs short); then the gradient of ``beam_analysis`` (kernel
   #1 forward, #3 backward) on 16384 lanes against the plain float32 and
   float64 routes by phase 3's rule; then ``block_tridiag_solve(bidi=True)``
   (#5) on 16384 fixed-bridge lanes at n = 101 and 1001, held by backward
   error against the default route's by phase 3c's rule;
4e. ``solve_beam_checked(tol=1e-4)`` on 16384 random-bridge lanes at n =
   101, on 16384 fixed-span lanes at n = 201 and 501
   (tests/test_accuracy.py's family) and on 16384 span-scaled tail-overhang
   lanes at n = 1001 (tests/test_block_stream_dd.py's family, past
   ``fem.accuracy.DD_STREAM_FROM_N``): every lane it certifies within 1e-4
   of the lane's scale of the plain float64 solve, the escalation through
   the float64 analysis kernel below the threshold and the fused streamed
   float64 route (#9) from it, no plain version and nothing on the host;
5. the whole optimizer on 512 lanes with the kernels, with the plain
   float32 path and with the plain float64 path: the kernel path's median
   per-lane loss gap to float64 no more than twice the plain float32
   path's (or 1e-4), mean epochs of the two float32 paths within 5%;
5b. the rescue in "dd" (float64 kernels) and "f64" (plain float64 on the
   host) on the same 256 rejected random-bridge lanes, 100 epochs: equal
   valid masks, equal epochs on the rescued lanes, I within 1e-3 relative
   (1e-7 absolute), deflections within 1e-3 of the lane's scale;
6. times: CUDA events, median of 20 launches per kernel (wrapper and
   kernel alone; every kernel reads lanes-first tensors and copies none),
   beside the plain
   version's time and the kernel's bound (bytes read once and written
   once at 3.35 TB/s against the flops at 67 TFLOP/s float32 or 34 TFLOP/s
   float64, H100 SXM); for #3 (the masked K(I) x = rhs), #4, #5 and #6
   also the dense float32 ``torch.linalg.solve`` of the same systems, for
   #9 the dense float64 one
   (the library yardsticks); #4, #6 and #5 in turns (#4, #6, #5, #5, #6,
   #4) at n = 51, 101, 201, 301 and 1001 and at 512, 2048, 4096, 8192 and
   16384 lanes (the compaction buckets and the full batch), launcher and
   wrapper, #4's and #6's outputs bitwise equal, #4 only where one lane's
   C and y fit a block, with the kernel each case's times imply beside the
   one ``block_tridiag.uses_streamed`` picks, and #5's time beside that
   one's;
   and solve_beam_checked's two escalation routes in turns on 16384
   fixed-span lanes at n = 201, 501, 1001 and 2001 (the float64 analysis
   wrapper, #7, against the fused ``solve_beam_dd_streamed``, #9), each
   route's peak device memory, and the ``DD_STREAM_FROM_N`` they imply;
7. the training path, north star steps 5-6: ``generate_batch`` over
   TRAIN_BATCHES x 16384 fixed-bridge lanes (kernels #1 and #2, no plain
   version), ``batch_feature_arrays``, ``prepare_dataset_device`` with the
   TFD family's n_cases, c and head padding, ``build_family("tfd")`` at its
   bfloat16 default, ``fit`` for TRAIN_EPOCHS epochs (10 a host sync) and
   ``evaluate_r2`` in chunks of 4096: every loss finite, the best val loss
   below the first epoch's, R^2 finite and above 0, TF32 still off after
   ``fit``; the best params saved and reloaded (``train/checkpoint.py``)
   give a bitwise-equal ``predict``; the same weights' float32 R^2 and
   gap are printed, and a one-epoch fit is profiled (device busy share,
   top device and host ops);
8. the file-based workflow: ``generate_to_shards`` writes SHARDS x
   SHARD_LANES random-bridge lanes (#2, #1 and the rescue's #8, #7, no
   plain version) as ``.npz`` shards to ``.smoke_tmp/``; shard SHARD_LOST
   is deleted and a second call regenerates exactly that one (one final
   analysis launched), bitwise the lost one; ``shards_to_json`` writes the
   13-key JSON through the native C++ writer and ``read_json_dataset``
   reads it through the native reader (the phase fails if either did not
   build and load), every column bitwise the shards' valid lanes, and
   ``json.load`` of shard 0's JSON gives the same columns; one 16384-lane
   fixed-bridge batch through ``generate_dataset`` (phase 4's route, the
   columnar lists) and through ``generate_dataset_json`` (the file written
   by the native writer), their valid samples/s printed (no gate on
   speed), the file's I, deflections and L equal to the lists'; then for the
   FNN (n_cases 6, c 1.0) and the PINN (c 0.5, label 302 with the
   deflections and rotations) ``prepare_dataset`` on the read-back file,
   ``build_family`` at the published width in bfloat16, ``fit`` for
   FILE_EPOCHS epochs and ``evaluate_r2`` (the PINN's on the I slice): every
   loss finite, the best val loss below the first epoch's, R^2 finite and
   above 0, TF32 off; ``save_preprocessing`` -> ``load_preprocessing`` ->
   ``build_user_input`` -> ``predict`` bitwise the in-memory scalers'.
   ``.smoke_tmp/`` is removed at the end;
9. the other surrogate families from phase 8's file (the columns its
   native reader read; no data of its own): the FNO's ``SpectralConv1d``
   on the card against tests/test_models.py's numpy complex-FFT oracle on
   its six cases within 1e-5 of scale; then for the GNN (AdamW), the FNO
   (float32), ``bnn`` and ``bnn-meta`` (n_cases 8; the scaled KL through
   ``param_loss_fn``) ``prepare_dataset`` with the family's n_cases, c
   and head padding, ``build_family`` at the published widths, ``fit`` for
   FILE_EPOCHS epochs and ``evaluate_r2``: phase 8's gates (losses finite,
   the best val loss below the first epoch's, R^2 > 0, TF32 off), the KL
   term finite and positive, its value at the first and the last epoch
   printed; for ``bnn-meta`` ``mc_output_stats`` with MC_SAMPLES samples
   on the val groups, the mean and std finite, every std positive, the MC
   mean's R^2 and the median std printed;
10. the frame path (no kernel lies on it: the nine launch counters stay 0),
   FRAME_LANES lanes, float32, ``FrameConfig()``: (10a) ``solve_frame``
   banded against dense float64 at 3x3, 10x1, 1x10, 10x10 and 20x20 on
   lognormal I, per-lane error at most FRAME_F32_TOL at the median and
   FRAME_F32_MAX at the worst lane, pivots within FRAME_PIVOT_RTOL of the
   float64 ones and above the validity gate; on a batch with 70-95% of the
   members at the 1e-8 clamp every lane with float32 error of
   FRAME_GARBAGE_ERR or more fails the pivot gate; dense and banded
   solves/s at 3x3 and 10x10; (10b) with TF32 asked for by the caller, the
   10x10 solves and their gradients bitwise those of full float32, the
   caller's setting kept; (10c) ``optimize_frame_batched`` at 3x3 and 10x10
   timed for FRAME_FIXED_EPOCHS epochs dense and banded (it/s, frames/s =
   it/s / 5000), one banded epoch's launches under torch.profiler, then the
   full budget at 3x3 and 10x10 semi and 3x3 adjoint: I finite and at
   least the clamp, every lane's loss below its initial one, the valid
   share, epochs, two calls cut to FRAME_REPEAT_EPOCHS the same bits;
   (10d) ``generate_frame_dataset`` over the 1-10 x 1-10 topology draw
   (FRAME_DATA_SAMPLES samples, epochs cut to FRAME_DATA_EPOCHS): ragged
   rows, each row's lengths its topology's, valid rows/s; (10e)
   ``solve_frame_checked(tol=1e-4)`` on healthy and clamp lanes of a 3x4
   frame: escalation in float64 on the card, healthy and escalated lanes
   within tol of float64 dense, every clamp lane left in float32 above the
   pivot floor and within 10 x tol, ``on_fail="raise"`` raising; (10f) the
   FNN on phase 8's columns, ``fit`` killed at half with
   ``checkpoint_dir`` and resumed: losses, best epoch and params bitwise
   the uninterrupted run's;
11. the command line on the card (``openpystruct_tpu_torch.cli.main`` in
   this process, the nine counters set to 0 before and read after each
   call; no wrapper's plain version may run): ``datagen`` of CLI_SAMPLES
   fixed-bridge samples in one batch to a JSON (#1, #2 launched), read
   back natively with the 13 keys; ``datagen --random-bridge`` of
   CLI_RB_SAMPLES samples through ``--shard-dir`` (#7, #8 launched);
   ``train --model tfd --epochs CLI_EPOCHS`` on the first file with
   ``--checkpoint``, ``--metrics-jsonl``, ``--tensorboard`` and
   ``--profile``: one JSONL entry per epoch, the events file's records
   passing their CRCs and decoding to the logged losses, the trace naming
   CUDA kernels; ``predict --model tfd`` on that checkpoint: nelem finite
   values; ``beam-opt`` at its 1000-epoch default; ``frame-opt --bays 3
   --stories 3 --batch 256 --epochs 200``; ``bench --profile``: its three
   JSON lines printed, #1 and #2 launched, the trace naming
   ``beam_analysis_kernel`` and ``beam_opt_step_kernel``; once more
   ``predict`` through ``python -m openpystruct_tpu_torch`` in a
   subprocess; ``--watch`` and ``--plot`` only where matplotlib imports;
12. distribution (``parallel``, one process per device): (12a) a NCCL group
   of size 1 in this process on cuda:0: ``generate_batch(mesh=)`` on 16384
   fixed-bridge lanes bitwise ``generate_batch`` without a mesh (#1, #2
   launched, no plain version), the TFD's ``fit(mesh=)`` on phase 7's
   features for DIST_EPOCHS epochs bitwise ``fit`` without one, and
   ``all_processes_min_max`` on a CUDA tensor its plain min and max; (12b)
   two gloo ranks spawned on cuda:0 (NCCL refuses two ranks on one card):
   2 x DIST_LANES random-bridge lanes, the gathered rows on both ranks
   bitwise the one-rank batch, #1, #2, #7 and #8 launched on each rank and
   each rank's rescue given exactly its own rejected lanes; the FNN's
   ``fit(mesh=)`` on phase 8's columns (float32, dropout 0): both ranks
   bitwise identical and within rtol 1e-4 of the one-rank fit, and
   ``shuffle_scope="per_shard"`` on unequal rows finite and identical on
   both; (12c) ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m openpystruct_tpu_torch datagen --mesh`` writes a
   13-key JSON and ``train --mesh`` trains the TFD from it.

``--quick`` stops after phase 3d.  Prints the card line, a JSON line of
kernel results, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or away from the repository, it fails before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = "openpystruct_tpu_torch/ops/csrc/"
SOURCE = {
    "beam_analysis": CSRC + "beam_opt.cu",
    "beam_opt_step": CSRC + "beam_opt.cu",
    "beam_analysis_dd": CSRC + "beam_opt_dd.cu",
    "beam_opt_step_dd": CSRC + "beam_opt_dd.cu",
    "beam_solve": CSRC + "beam_kernel.cu",
    "block_tridiag_solve": CSRC + "block_resident.cu",
    "block_tridiag_solve_streamed": CSRC + "block_stream.cu",
    "block_tridiag_solve_bidi": CSRC + "block_tridiag.cu",
    "solve_dd_streamed": CSRC + "block_stream_dd.cu",
}
REPLACES = {
    "beam_analysis": "openpystruct_tpu/ops/beam_kernel.py:751",
    "beam_opt_step": "openpystruct_tpu/ops/beam_kernel.py:819",
    "beam_analysis_dd": "openpystruct_tpu/ops/beam_kernel_dd.py:337",
    "beam_opt_step_dd": "openpystruct_tpu/ops/beam_kernel_dd.py:376",
    "beam_solve": "openpystruct_tpu/ops/beam_kernel.py:682",
    "block_tridiag_solve": "openpystruct_tpu/ops/block_tridiag.py:143",
    # _fwd_kernel; its _bwd_kernel is block_stream.py:111
    "block_tridiag_solve_streamed": "openpystruct_tpu/ops/block_stream.py:68",
    "block_tridiag_solve_bidi": "openpystruct_tpu/ops/block_tridiag.py:186",
    # _fwd_kernel_dd; its _bwd_kernel_dd is block_stream_dd.py:131
    "solve_dd_streamed": "openpystruct_tpu/ops/block_stream_dd.py:75",
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
F64_FLOPS_PER_S = 34e12        # H100 SXM, float64 outside the tensor cores
PIVOT_TOL = 1e-9
BATCH = 16384          # lanes per batch: the JAX package's datagen batch
SAMPLES = 2 * BATCH    # two batches on the main path
CHECK_BATCH = 512      # lanes of the whole-optimizer check (phase 5)
RESCUE_CHECK = 256     # rejected lanes of the dd vs f64 check (phase 5b)
DD_TOL = 1e-5          # float64 kernel vs plain, of the lane's scale
SPLIT_CHECK_EPOCHS = 30  # epoch cut of phase 4d's 512-lane check
SPLIT_NS = (51, 101, 201)      # meshes of phase 3c (51: random bridge only)
CHECKED_TOL = 1e-4     # solve_beam_checked's tolerance in phase 4e
# meshes and lane counts at which phase 6 times #4 against #6: the
# dispatch (block_tridiag.uses_streamed) follows n = 51-301; the lane counts
# are the compaction buckets and the full batch
TURN_NS = (51, 101, 201, 301, 1001)
TURN_LANES = (512, 2048, 4096, 8192, 16384)
PROFILE_EPOCHS = 8             # the profiled window of phase 4d's split path
PROFILE_BUCKET = 2048          # and the lanes of its second, bucket-size one
DD_ROUTE_NS = (201, 501, 1001, 2001)  # meshes that set DD_STREAM_FROM_N
DD_ROUTE_DEFAULT = 788         # the JAX package's own escalation point
DD_CHECK_N = 1001      # the span-scaled overhang lanes of phases 3d, 4e
BACKWARD_FLOOR = 1e-6  # floor of phase 3c's backward-error rule
TRAIN_BATCHES = 16     # 16384-lane fixed-bridge batches that feed phase 7
TRAIN_EPOCHS = 30      # phase 7's fixed epoch count (the JAX capstone: 150)
SHARDS = 4             # phase 8: random-bridge shards of SHARD_LANES lanes
SHARD_LANES = 8192
SHARD_LOST = 2         # the shard phase 8 deletes and regenerates
FILE_EPOCHS = 30       # phase 8's fixed epoch count for the FNN and the PINN
# phase 9's families, each trained FILE_EPOCHS epochs from phase 8's file
SURROGATES = ("gnn", "fno", "bnn", "bnn-meta")
MC_SAMPLES = 50        # mc_output_stats' samples (the Meta script's, :864)
# phase 10, the frame path: lanes per batch (the JAX package's frame
# benchmark protocol), the solve check's topologies (the reference's range
# 1-10 and 20x20, past the JAX package's blocked-factor switch at m = 49)
FRAME_LANES = 256
FRAME_SOLVE_TOPOLOGIES = ((3, 3), (10, 1), (1, 10), (10, 10), (20, 20))
FRAME_TIMED = ((3, 3), (10, 10))   # dense vs banded timed here
# the healthy regime's float32 error, per lane: BENCHMARKS.md puts it at
# <= 1e-4 on a few lanes; on 256 lanes of this law the JAX package's own
# float32 banded solve (CPU) reaches a median of 1.0e-4 and a worst lane of
# 4.2e-4 at 20x20, and worst lanes of 2.6e-4 (1x10) and 2.7e-4 (10x10)
FRAME_F32_TOL = 2e-4      # at the median
FRAME_F32_MAX = 1e-3      # at the worst lane
FRAME_PIVOT_RTOL = 1e-3   # float32 pivots vs float64 ones, healthy regime
FRAME_GARBAGE_ERR = 1e-2  # float32 error of a garbage lane (JAX: >= 0.12)
FRAME_FIXED_EPOCHS = 200  # the JAX package's in-loop timing protocol
FRAME_OPT_RUNS = ((3, 3, "semi"), (10, 10, "semi"), (3, 3, "adjoint"))
# run twice on the same inputs, cut to FRAME_REPEAT_EPOCHS: the same bits
FRAME_REPEATED = ((3, 3, "semi"), (3, 3, "adjoint"))
FRAME_REPEAT_EPOCHS = 400
FRAME_DATA_SAMPLES = 128  # 10d's samples over the 1-10 x 1-10 draw
FRAME_DATA_EPOCHS = 60    # 10d's epoch cut (10c runs the full 5000)
FRAME_CHECKED_TOL = 1e-4
RESUME_EPOCHS = 6         # 10f: the FNN's epochs, killed at half
# phase 11, the command line: datagen's samples (one batch of the JAX
# package's datagen size; the random bridge at the CLI's default batch),
# and the TFD's epochs
CLI_SAMPLES = 16384
CLI_RB_SAMPLES = 8192
CLI_EPOCHS = 5
# phase 12, distribution: lanes a rank of 12b's random bridge (two ranks),
# the epochs of its fits (12a's TFD, 12b's FNN, 12c's CLI train) and 12c's
# datagen samples.  Two epochs: the two-rank FNN's losses stay within 1e-5
# of the one-rank fit's there; Adam then amplifies the rounding of the
# gradient's sum order (1.9e-4 at epoch 4, 4.2e-4 at 5, on the card)
DIST_LANES = 8192
DIST_EPOCHS = 2
DIST_CLI_SAMPLES = 8192
# tests/test_models.py's spectral-conv oracle cases: (n, modes, degenerate)
SPECTRAL_CASES = ((6, 4, False), (6, 4, True), (8, 4, False), (7, 4, False),
                  (9, 5, True), (6, 10, False))
SPLIT_KERNELS = ("beam_solve", "block_tridiag_solve",
                 "block_tridiag_solve_streamed", "block_tridiag_solve_bidi")
DATAGEN_KERNELS = ("beam_analysis", "beam_opt_step", "beam_analysis_dd",
                   "beam_opt_step_dd")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Bounds.  Bytes: every input read once, every output written once.  Flops
# per node and lane (an FMA counts 2), counted from csrc/beam_opt.cu for
# the opt step (kinds "semi", "adjoint") and the analysis:
#   first forward sweep 108 (stiffness 10, assembly 30, scaling 14, scaled
#   U 8, factor 32, forward substitution 14), back sweep 14, each
#   refinement a residual 134, a forward substitution 14 and a back sweep
#   16; the last semi back sweep's element work 72 (stiffness 9, forces 25,
#   loss 16, gradient 7, Adam 15); in adjoint mode that sweep does 110
#   (no Adam; cotangents, rows and g_hat 53), then the adjoint solve's
#   forward substitution 14, its back and refinement sweeps as the
#   primal's, banded products 8 and Adam 15; the analysis adds the axial
#   chain and pivot 20 to the first sweep, its back sweeps read C (8, 10
#   in a refinement) and its last one does stiffness 9, unscaling 4 and
#   forces 25;
# and from csrc/beam_opt_dd.cu for the float64 kernels (kinds
# "analysis_dd", "opt_dd"): the forward sweep 129 (stiffness 11, assembly
# with the axial terms 42, scaling 12, scaled U 8, factor 31, forward
# substitution 14, axial chain and pivot 11), the backward sweep 61
# (stiffness and U again 22, back substitution 14, unscaling 2, forces
# 23), no refinement; the opt step adds loss 23 and Adam 15, all counted
# at the float64 rate.
# ---------------------------------------------------------------------------


def flops_per_lane(n, refine, kind):
    # block-Thomas (#4, #5, #6), per row: S = D - U^T C 54, cofactor
    # inverse 42, C = Sinv U 45, y 33, back sweep 18; #5's meeting row adds
    # ~110 once per lane, under 1% at n = 101 and not counted; #9 adds the
    # pivot's |det| and min per row
    if kind == "thomas":
        return 192 * n
    if kind == "thomas_dd":
        return 194 * n
    # #9's beam mode (the escalation route): the same solve, the row's
    # assembly ~95 (element 15, node with its three scales 26, scaled
    # blocks and right-hand side 54) and the unscaling 3
    if kind == "route_dd":
        return (194 + 95 + 3) * n
    # explicit-RHS 3-DOF solve (#3), per node, over the nonzeros of each
    # block (csrc/beam_kernel.cu): the first forward sweep 165 (the two
    # elements' stiffness 20, assembly 23, scales 6, scaled block and
    # right-hand side 16, scaled U 20; the chain's S 23, q 13, det2, det3
    # and the division 5, Sinv 9, y 10, C 18, pivot 2), back sweep 13,
    # unscaling 3; a refinement sweep: residual 168 (15 error-free terms of
    # 11), forward substitution 23, back sweep 16
    if kind == "solve3":
        return (181 + 207 * refine) * n
    if kind in ("analysis_dd", "opt_dd"):
        return (129 + 61 + (23 + 15 if kind == "opt_dd" else 0)) * n
    if kind in ("semi", "adjoint"):
        sweeps = 14 + refine * (134 + 14 + 16)
        if kind == "semi":
            return (108 + sweeps + 72) * n
        return (108 + sweeps + 110 + 14 + sweeps + 8 + 15) * n
    # the analysis (#1): C saved, axial pivot, no loss
    return (108 + 20 + 8 + refine * (134 + 14 + 10) + 38) * n


def bytes_per_lane(n, kind):
    nelem = n - 1
    if kind == "thomas":
        # diag (n, 3, 3), upper (n-1, 3, 3), b (n, 3) in; x (n, 3) out
        return 4 * (9 * n + 9 * nelem + 3 * n + 3 * n)
    if kind == "thomas_dd":
        # the same system in float64 in; x (n, 3) and the pivot float32 out
        return 8 * (9 * n + 9 * nelem + 3 * n) + 4 * (3 * n + 1)
    if kind == "solve3":
        # I, Le, free (n, 3), rhs (n, 3) in; x (n, 3), pivot out
        return 4 * (2 * nelem + 3 * n + 3 * n + 3 * n + 1)
    # I, Le, free (n, 3), loads (n), udl: float32 in every kernel
    inputs = 2 * nelem + 3 * n + n + 1
    if kind == "route_dd":
        return 4 * (inputs + 3 * n + 1)            # u, pivot
    if kind.startswith("analysis"):
        outputs = 3 * n + 2 * nelem + 1            # u, V, M, pivot
    else:
        inputs += 2 * nelem                        # mu, nu
        outputs = 3 * nelem + 4                    # I, mu, nu, stats
        outputs += kind == "opt_dd"                # pivot
    return 4 * (inputs + outputs)


def bound_ms(B, n, refine, kind):
    rate = F64_FLOPS_PER_S if kind.endswith("_dd") else F32_FLOPS_PER_S
    t_bytes = B * bytes_per_lane(n, kind) / HBM_BYTES_PER_S
    t_ops = B * flops_per_lane(n, refine, kind) / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, reps, warmup=2):
    """Median over ``reps`` launches of CUDA-event time, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def lane_errors(torch, x, truth):
    """Per-lane error of ``x`` against ``truth``, relative to the lane's
    largest |truth| value."""
    x = x.double().reshape(x.shape[0], -1)
    truth = truth.reshape(truth.shape[0], -1)
    scale = truth.abs().amax(1).clamp_min(1e-300)
    err = (x - truth).abs().amax(1) / scale
    # a lane that went non-finite is infinitely wrong, not unordered
    return torch.where(torch.isnan(err), torch.inf, err)


def finite_or_none(x):
    return x if x is not None and x < float("inf") else None


def hold(torch, name, kern, plain32, truth, floor=1e-5, gate=True):
    """Phase 3's rule: the kernel's per-lane error against ``truth`` no
    more than twice the plain float32 version's, or ``floor``, at the median
    and the 99th percentile.  With ``gate`` False the errors are printed and
    not held.  Returns the max abs error and the two 99th percentiles."""
    ek = lane_errors(torch, kern, truth)
    ep = lane_errors(torch, plain32, truth)
    row = {}
    for q in (0.5, 0.99):
        k, p = ek.quantile(q).item(), ep.quantile(q).item()
        limit = max(2.0 * p, floor)
        row[q] = (k, p, limit)
        if gate and not k <= limit:
            raise AssertionError(
                f"{name}: kernel error {k:.3e} at q={q} exceeds "
                f"{limit:.3e} (plain float32 {p:.3e})")
    max_abs = (kern.double() - truth).abs().max().item()
    log(f"  {name:>14}: kernel err p50 {row[0.5][0]:.3e} p99 "
        f"{row[0.99][0]:.3e} | plain f32 p50 {row[0.5][1]:.3e} p99 "
        f"{row[0.99][1]:.3e} | max |kernel - f64| {max_abs:.3e}"
        + ("" if gate else " (printed, not held)"))
    return dict(abs=max_abs, rel_p99=row[0.99][0],
                plain32_rel_p99=row[0.99][1])


def backward_errors(torch, matvec, diag, upper, b, x):
    """Per-lane backward error of ``x`` for the symmetric block-tridiagonal
    system K x = b, in float64: max_i |b - K x|_i over max_i (|K| |x| +
    |b|)_i, both in Jacobi-scaled rows; a non-finite lane is inf.  A stable
    solve keeps it near float32's rounding (~1e-7) however ill-conditioned
    K is, so it tells a wrong kernel from float32's own forward error."""
    d, u, b, x = (t.double() for t in (diag, upper, b, x))
    s = torch.rsqrt(torch.diagonal(d, dim1=-2, dim2=-1))
    r = (b - matvec(d, u, x)) * s
    den = (matvec(d.abs(), u.abs(), x.abs()) + b.abs()) * s
    err = r.abs().amax((1, 2)) / den.amax((1, 2)).clamp_min(1e-300)
    return torch.where(torch.isfinite(err), err, torch.inf)


def hold_backward(torch, name, ek, ep, versus="plain f32",
                  held=(0.5, 0.99, 1.0)):
    """Phase 3c's rule on backward errors: the kernel's no more than twice
    the plain float32 version's (or ``versus``'s), or BACKWARD_FLOOR, at
    the median, the 99th percentile and the worst lane (the quantiles in
    ``held``; the others are printed), and no more non-finite lanes.
    Returns the kernel's 99th percentile."""
    ks, ps = ek.sort().values, ep.sort().values
    row = []
    for q in (0.5, 0.99, 1.0):
        i = round(q * (len(ks) - 1))
        k, p = ks[i].item(), ps[i].item()
        row.append((k, p))
        if q in held and not k <= max(2.0 * p, BACKWARD_FLOOR):
            raise AssertionError(f"{name}: backward error {k:.3e} at q={q} "
                                 f"exceeds twice {versus}'s {p:.3e}")
    bad_k, bad_p = (int((~torch.isfinite(e)).sum()) for e in (ek, ep))
    if bad_k > bad_p:
        raise AssertionError(f"{name}: {bad_k} non-finite lanes, {versus} "
                             f"{bad_p}")
    log(f"  {name:>14}: backward err p50 / p99 / max: kernel "
        + " / ".join(f"{k:.2e}" for k, _ in row) + f" | {versus} "
        + " / ".join(f"{p:.2e}" for _, p in row)
        + ("" if len(held) == 3 else " (held at q in "
           + (", ".join(map(str, held)) or "none") + ")"))
    return row[1][0]


def check_kernels(torch, tk, inputs, scalars, E, A, G, refine,
                  phase="phase 3", same_masks=True):
    """Run each kernel (wrapper) and its plain version in float32 and
    float64 on the same inputs; returns max abs errors per kernel.

    ``same_masks``: the validity masks of all three must be identical.
    Where float32 cannot decide validity (n = 201, whose lanes only the
    float64 rescue keeps), pass False: the kernel's mask may then disagree
    with float64 on no more lanes than twice the plain float32 version's,
    the rule the errors are held to."""
    def cast(dtype, keys):
        return [inputs[k].to(dtype) for k in keys]

    ana_keys = ("I", "Le", "free", "loads", "udl")
    opt_keys = ("I", "mu", "nu", "Le", "free", "loads", "udl")
    errs = {}

    n = inputs["I"].shape[1] + 1
    log(f"{phase}: beam_analysis vs plain (refine={refine}, n={n})")
    kern = tk.beam_analysis(*cast(torch.float32, ana_keys), E, A, refine)
    p32 = tk.beam_analysis_reference(*cast(torch.float32, ana_keys), E, A,
                                     refine)
    p64 = tk.beam_analysis_reference(*cast(torch.float64, ana_keys), E, A,
                                     refine)
    torch.cuda.synchronize()
    names = ("u", "V", "M")
    for nm, k, p, t in zip(names, kern[:3], p32[:3], p64[:3]):
        e = hold(torch, nm, k, p, t)
        if nm == "u":
            errs["beam_analysis"] = e
    hold(torch, "pivot", kern[3][:, None], p32[3][:, None], p64[3][:, None])
    masks = [(x[3] > PIVOT_TOL) for x in (kern, p32, p64)]
    if same_masks:
        if not (torch.equal(masks[0], masks[2])
                and torch.equal(masks[1], masks[2])):
            raise AssertionError("valid masks (pivot > 1e-9) differ")
        log(f"  valid lanes {int(masks[0].sum())}/{masks[0].numel()} "
            "(identical in kernel, plain f32, plain f64)")
    else:
        off_k, off_p = (int((m != masks[2]).sum()) for m in masks[:2])
        log("  valid lanes (pivot > 1e-9) kernel / plain f32 / plain f64: "
            + " / ".join(str(int(m.sum())) for m in masks)
            + f" of {masks[0].numel()} | lanes off float64's mask: kernel "
            f"{off_k}, plain f32 {off_p}")
        if not off_k <= 2 * off_p:
            raise AssertionError(f"kernel's mask off float64's on {off_k} "
                                 f"lanes, plain float32's on {off_p}")

    for semi in (True, False):
        mode = "semi" if semi else "adjoint"
        log(f"{phase}: beam_opt_step ({mode}, refine={refine}, n={n}) vs "
            "plain")
        tail = (*scalars, E, A, G)
        kw = dict(grad_semi=semi, refine=refine)
        kern = tk.beam_opt_step(*cast(torch.float32, opt_keys), *tail, **kw)
        p32 = tk.beam_opt_step_reference(*cast(torch.float32, opt_keys),
                                         *tail, **kw)
        p64 = tk.beam_opt_step_reference(*cast(torch.float64, opt_keys),
                                         *tail, **kw)
        torch.cuda.synchronize()
        for nm, k, p, t in zip(("I", "mu", "nu"), kern, p32, p64):
            e = hold(torch, nm, k, p, t)
            if nm == "I" and e["abs"] >= errs.get("beam_opt_step",
                                                  {"abs": -1.0})["abs"]:
                errs["beam_opt_step"] = e
        for c, nm in enumerate(("total", "primary", "bending", "shear")):
            hold(torch, nm, kern[3][:, c:c + 1], p32[3][:, c:c + 1],
                 p64[3][:, c:c + 1])
    return errs


def tie_best(torch, total, tolerance):
    """Per lane, a best with best - tolerance == total in float32, as the
    bookkeeping subtracts, where one exists; NaN where none does."""
    best = total + tolerance
    for _ in range(64):
        gap = best - tolerance
        best = torch.where(gap < total, torch.nextafter(
            best, torch.full_like(best, float("inf"))), best)
        best = torch.where(gap > total, torch.nextafter(
            best, torch.full_like(best, -float("inf"))), best)
    return torch.where(best - tolerance == total, best, float("nan"))


def lanes_same(torch, a, b):
    """Per lane (row), ``a`` and ``b`` equal, NaN where both are NaN."""
    eq = a == b
    if a.is_floating_point():
        eq |= torch.isnan(a) & torch.isnan(b)
    return eq.reshape(eq.shape[0], -1).all(1)


def check_lane_state(torch, tk, inputs, scalars, E, A, G, refine, tolerance,
                     patience, phase="phase 3"):
    """#2 given the epoch loop's lane state (``beam_opt_step(lane_state=)``,
    one launch an epoch on the main path) on phase 3's inputs with NaN
    lanes (lane % 97 == 5 and lane 40), done lanes (lane % 7 == 3 and the
    whole block of lanes 32-63, whose solve the kernel skips), lanes one
    epoch short of ``patience``, lanes that improve or not by a margin, and
    lanes whose total lies exactly at best - tolerance (lane % 1000 == 0),
    semi and adjoint.  Its outputs and the state it updates in place must
    be bitwise the bare step's followed by ``freeze_lanes``.  Against the
    plain version followed by ``freeze_lanes``: I_solved and n_epochs
    bitwise, done and no_improve equal off the tied lanes, the lanes done
    on entry their inputs bitwise, the NaN lanes NaN, and the stepped lanes'
    I, mu, nu and total held by phase 3's rule."""
    B, nelem = inputs["I"].shape
    dev = inputs["I"].device
    lane = torch.arange(B, device=dev)
    nan_lane = (lane % 97 == 5) | (lane == 40)
    entry_done = (lane % 7 == 3) | ((lane >= 32) & (lane < 64))
    I = inputs["I"].clone()
    I[nan_lane, 3] = float("nan")
    ins = [I] + [inputs[k].float()
                 for k in ("mu", "nu", "Le", "free", "loads", "udl")]
    tail = (*scalars, E, A, G)
    gen = torch.Generator().manual_seed(B)
    names = tk._LANE_TENSORS + ("stats",)
    for semi in (True, False):
        mode = "semi" if semi else "adjoint"
        kw = dict(grad_semi=semi, refine=refine)
        bare = tk.beam_opt_step(*ins, *tail, **kw)
        total = bare[3][:, 0]
        tf = torch.nan_to_num(total, nan=1.0)
        margin = 0.25 * tf.abs() + 1e-2
        best = torch.where(lane % 4 < 2, tf + tolerance + margin,
                           tf + tolerance - margin)
        tie = (lane % 1000 == 0) & ~nan_lane
        best[tie] = tie_best(torch, total[tie], tolerance)
        tie &= ~torch.isnan(best)
        best = torch.nan_to_num(best, nan=1.0)
        no_improve = torch.randint(0, patience, (B,), generator=gen,
                                   dtype=torch.int32).to(dev)
        no_improve[lane % 5 == 4] = patience - 1
        st0 = tk.LaneState(
            entry_done.clone(), best, no_improve,
            torch.randint(0, 50, (B,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.rand((B, nelem), generator=gen).to(dev),
            torch.rand((B, 4), generator=gen).to(dev), tolerance, patience)

        def fresh():
            return st0._replace(**{k: getattr(st0, k).clone()
                                   for k in names})

        st = fresh()
        out = tk.beam_opt_step(*ins, *tail, **kw, lane_state=st)
        got = dict(zip(("I", "mu", "nu", "stats"), out),
                   **{k: getattr(st, k) for k in tk._LANE_TENSORS})
        want = tk.freeze_lanes(I, ins[1], ins[2], bare, fresh())
        p32 = tk.beam_opt_step_reference(*ins, *tail, **kw)
        p64 = tk.beam_opt_step_reference(*(t.double() for t in ins), *tail,
                                         **kw)
        plain = tk.freeze_lanes(I, ins[1], ins[2], p32, fresh())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        log(f"{phase}: beam_opt_step ({mode}) with the lane state, {B} "
            f"lanes: vs the bare kernel step + freeze_lanes")
        for k, v in got.items():
            off = int((~lanes_same(torch, v, want[k])).sum())
            if off:
                raise AssertionError(f"lane state ({mode}): {k} differs from "
                                     f"the bare step + freeze_lanes on {off} "
                                     "lanes")
        act = ~entry_done
        improved = act & (got["no_improve"] == 0)
        newly_done = act & got["done"]
        ties_kept = act & tie & (got["no_improve"] == no_improve + 1)
        log(f"  bitwise on every output and state tensor | improved "
            f"{int(improved.sum())}, newly done {int(newly_done.sum())}, "
            f"done on entry {int(entry_done.sum())}, NaN "
            f"{int(nan_lane.sum())}, tied (not improved) "
            f"{int(ties_kept.sum())} of {int((act & tie).sum())}")
        if not (int(improved.sum()) and int(newly_done.sum())
                and int((act & tie).sum())
                and torch.equal(ties_kept, act & tie)):
            raise AssertionError(f"lane state ({mode}): a case is missing, "
                                 "or a tied lane counted as improved")
        log(f"{phase}: beam_opt_step ({mode}) with the lane state vs plain "
            "+ freeze_lanes")
        for k in ("I_solved", "n_epochs"):
            if not bool(lanes_same(torch, got[k], plain[k]).all()):
                raise AssertionError(f"lane state ({mode}): {k} differs from "
                                     "the plain version's")
        for k in ("done", "no_improve"):
            off = int((~lanes_same(torch, got[k], plain[k]) & ~tie).sum())
            if off:
                raise AssertionError(f"lane state ({mode}): {k} differs from "
                                     f"the plain version's on {off} lanes")
        for k in ("I", "mu", "nu", "stats"):
            off = int((~lanes_same(torch, got[k], plain[k])
                       & entry_done).sum())
            if off:
                raise AssertionError(f"lane state ({mode}): {off} lanes done "
                                     f"on entry changed {k}")
        if not torch.equal(torch.isnan(got["stats"][:, 0]) & act,
                           nan_lane & act):
            raise AssertionError(f"lane state ({mode}): the NaN lanes' "
                                 "totals are not NaN, or others are")
        step = act & ~nan_lane
        for k, c in (("I", 0), ("mu", 1), ("nu", 2)):
            hold(torch, k, got[k][step], p32[c][step], p64[c][step])
        hold(torch, "total", got["stats"][step, :1], p32[3][step, :1],
             p64[3][step, :1])


# ---------------------------------------------------------------------------
# Phase 3b: the float64 rescue kernels against their plain versions
# ---------------------------------------------------------------------------


def quasi_cantilever(torch, BeamScenario, constraint_mask, gen, device):
    """The four lanes of tests/test_beam_kernel_dd.py float32 cannot solve:
    one roller 1-5 nodes from the pin leaves a ~195 m overhang; I is a mild
    ripple around 0.05.  Inputs in make_inputs' layout, float32."""
    n = 101
    node_x = torch.linspace(0.0, 200.0, n, dtype=torch.float64).repeat(4, 1)
    roller = torch.zeros((4, n), dtype=torch.bool)
    loads = torch.zeros((4, n), dtype=torch.float64)
    for b, r in enumerate((1, 2, 3, 5)):
        roller[b, r] = True
        loads[b, 60 + 5 * b] = -3.5e5
    sc = BeamScenario(node_x=node_x, roller_mask=roller, point_loads=loads,
                      udl=torch.full((4,), -1000.0, dtype=torch.float64))
    x = dict(
        I=0.05 * (0.8 + 0.4 * torch.rand((4, n - 1), generator=gen)),
        mu=torch.randn((4, n - 1), generator=gen) * 0.1,
        nu=torch.rand((4, n - 1), generator=gen) * 1e-2 + 1e-4,
        Le=torch.diff(node_x, dim=-1), free=(~constraint_mask(sc)).double(),
        loads=loads, udl=sc.udl,
    )
    return {k: v.to(device=device, dtype=torch.float32) for k, v in x.items()}


def check_dd_kernels(torch, tk, tkd, inputs, n_qc, scalars, E, A, G,
                     phase="phase 3b"):
    """Both float64 kernels (wrappers) against their plain versions on the
    same float32 inputs; the last ``n_qc`` lanes (none if 0) are the
    quasi-cantilever ones.  Returns max abs errors per kernel."""
    ana = [inputs[k] for k in ("I", "Le", "free", "loads", "udl")]
    opt = [inputs[k] for k in ("I", "mu", "nu", "Le", "free", "loads", "udl")]
    kern = tkd.beam_analysis_dd(*ana, E, A)
    plain = tkd.beam_analysis_dd_reference(*ana, E, A)
    kern_o = tkd.beam_opt_step_dd(*opt, *scalars, E, A, G)
    plain_o = tkd.beam_opt_step_dd_reference(*opt, *scalars, E, A, G)
    torch.cuda.synchronize()
    B, n = ana[0].shape[0], ana[0].shape[1] + 1
    log(f"{phase}: float64 kernels vs plain float64 versions, {B} lanes, "
        f"n={n}" + (f" ({B - n_qc} random-bridge + {n_qc} quasi-cantilever)"
                    if n_qc else ""))
    rel = {}
    for name, k, p in (("u", kern[0], plain[0]), ("V", kern[1], plain[1]),
                       ("M", kern[2], plain[2]), ("I_new", kern_o[0],
                                                  plain_o[0]),
                       ("mu", kern_o[1], plain_o[1]),
                       ("nu", kern_o[2], plain_o[2]),
                       ("stats", kern_o[3], plain_o[3])):
        e = lane_errors(torch, k, p.double())
        worst = e.max().item()
        rel[name] = e.quantile(0.99).item()
        log(f"  {name:>6}: per-lane err p50 {e.quantile(0.5).item():.3e} p99 "
            f"{e.quantile(0.99).item():.3e} max {worst:.3e}")
        if not worst <= DD_TOL:
            raise AssertionError(f"{name}: float64 kernel error {worst:.3e} "
                                 f"exceeds {DD_TOL:.0e} of the lane's scale")
    for name, k, p in (("analysis", kern[3], plain[3]),
                       ("opt step", kern_o[4], plain_o[4])):
        ratio = k.double() / p.double()
        log(f"  pivot ratio kernel/plain ({name}): min "
            f"{ratio.min().item():.9f} max {ratio.max().item():.9f}")
        if not ((ratio - 1.0).abs() <= 1e-3).all():
            raise AssertionError(f"{name} pivot off by more than 1e-3")
    # against the plain float64 version: there is no plain float32 one
    errs = {"beam_analysis_dd": dict(
                abs=(kern[0].double() - plain[0].double()).abs().max().item(),
                rel_p99=rel["u"], plain32_rel_p99=None),
            "beam_opt_step_dd": dict(
                abs=(kern_o[0].double() - plain_o[0].double()).abs().max()
                .item(), rel_p99=rel["I_new"], plain32_rel_p99=None)}
    if not n_qc:
        return errs
    # the lanes the rescue exists for: the float32 kernel fails on them
    qc = [t[-n_qc:] for t in ana]
    u32 = tk.beam_analysis(*qc, E, A, 1)[0]
    torch.cuda.synchronize()
    truth = plain[0][-n_qc:, :, 1].double()
    e32 = lane_errors(torch, u32[..., 1], truth).tolist()
    e64 = lane_errors(torch, kern[0][-n_qc:, :, 1], truth).tolist()
    log("  quasi-cantilever deflection error per lane: float32 kernel "
        + ", ".join(f"{e:.3e}" for e in e32) + " | float64 kernel "
        + ", ".join(f"{e:.3e}" for e in e64) + " | float64 pivots "
        + ", ".join(f"{p:.3e}" for p in plain[3][-n_qc:].tolist()))
    return errs


# ---------------------------------------------------------------------------
# Phase 3c: the split-path kernels against their plain versions
# ---------------------------------------------------------------------------


def scaled_system(torch, assemble_beam_system, I, sc, E, A):
    """The Jacobi-scaled (diag, upper, f) solve_beam_batched hands the
    solve, in the inputs' dtype."""
    d, u, f = assemble_beam_system(I, sc, E, A)
    s = torch.rsqrt(torch.diagonal(d, dim1=-2, dim2=-1))
    return (d * s[..., :, None] * s[..., None, :],
            u * s[..., :-1, :, None] * s[..., 1:, None, :], f * s)


def split_inputs(torch, sample_scenarios, constraint_mask,
                 assemble_beam_system, seed, B, n, cfg, E, A, dev):
    """Float32 inputs of the three split-path kernels on the card: the
    scaled beam system (d, u, f) of lognormal-I scenarios, and for the
    explicit-RHS solve I, Le, the free mask and a right-hand side, the
    scenario's load vector with a random axial component of its scale."""
    gen = torch.Generator().manual_seed(seed)
    sc = sample_scenarios(gen, B, dataclasses.replace(cfg, num_nodes=n),
                          device=dev, dtype=torch.float32)
    I = (torch.exp(torch.randn((B, n - 1), generator=gen) * 0.3)
         * 0.5).to(dev)
    d, u, f = scaled_system(torch, assemble_beam_system, I, sc, E, A)
    rhs = assemble_beam_system(I, sc, E, A)[2]
    axial = torch.randn((B, n), generator=gen).to(dev)
    rhs[..., 0] = axial * rhs.abs().amax((1, 2))[:, None]
    return dict(sys=(d, u, f), I=I, Le=torch.diff(sc.node_x, dim=-1),
                free=(~constraint_mask(sc)).to(torch.float32), rhs=rhs,
                scenario=sc)


def check_split_kernels(torch, tk, tbt, tbs, matvec, assemble_beam_system,
                        x, E, A, refine, label, gate, held3=(0.5, 0.99, 1.0)):
    """#3, #4, #5 and #6 against their plain versions in float32 and
    float64 on the same float32 inputs: forward errors by phase 3's rule
    (held if ``gate``, else printed), backward errors held (#3's at the
    quantiles in ``held3``), #4's x bitwise equal to #6's; #5's plain
    float32 version is the two-chain one.  Returns per kernel the forward
    errors against float64 (``hold``) and the backward error's 99th
    percentile."""
    errs = {}
    sys32 = x["sys"]
    sys64 = [t.double() for t in sys32]
    kern4 = tbt.launch_thomas(*sys32)
    kern5 = tbt.launch_thomas_bidi(*sys32)
    kern6 = tbs.block_tridiag_solve_streamed(*sys32)
    if not torch.equal(kern4, kern6):
        raise AssertionError(f"#4 and #6 differ ({label})")
    p32 = tbt.thomas_reference(*sys32)
    p32_bidi = tbt.thomas_bidi_reference(*sys32)
    p64 = tbt.thomas_reference(*sys64)
    torch.cuda.synchronize()
    log(f"phase 3c: {label}: block-Thomas kernels vs plain")
    bw_p32 = backward_errors(torch, matvec, *sys32, p32)
    bw_p32_bidi = backward_errors(torch, matvec, *sys32, p32_bidi)
    for name, tag, kern, plain, bw_plain in (
            ("block_tridiag_solve", "#4", kern4, p32, bw_p32),
            ("block_tridiag_solve_bidi", "#5", kern5, p32_bidi, bw_p32_bidi),
            ("block_tridiag_solve_streamed", "#6", kern6, p32, bw_p32)):
        errs[name] = hold(torch, f"{tag} x", kern, plain, p64, gate=gate)
        errs[name]["backward_p99"] = hold_backward(
            torch, f"{tag} x", backward_errors(torch, matvec, *sys32, kern),
            bw_plain)
    del p32, p32_bidi, p64, sys64, kern4, kern5, kern6
    args32 = [x[k] for k in ("I", "Le", "free", "rhs")]
    args64 = [t.double() for t in args32]
    kern = tk.beam_solve(*args32, E, A, refine)
    p32 = tk.beam_solve_reference(*args32, E, A, refine)
    p64 = tk.beam_solve_reference(*args64, E, A, refine)
    torch.cuda.synchronize()
    log(f"phase 3c: {label}: beam_solve (refine={refine}) vs plain")
    errs["beam_solve"] = hold(torch, "#3 x", kern[0], p32[0], p64[0],
                              gate=gate)
    hold(torch, "#3 pivot", kern[1][:, None], p32[1][:, None],
         p64[1][:, None], gate=gate)
    # #3 solves the scenario's K, masked, with the explicit RHS
    sc64 = x["scenario"].map(lambda t: t.double() if t.is_floating_point()
                             else t)
    d64, u64, _ = assemble_beam_system(args64[0], sc64, E, A)
    b64 = args64[3] * args64[2]
    bw_k = backward_errors(torch, matvec, d64, u64, b64, kern[0])
    bw_p = backward_errors(torch, matvec, d64, u64, b64, p32[0])
    errs["beam_solve"]["backward_p99"] = hold_backward(
        torch, "#3 x", bw_k, bw_p, held=held3)
    if 1.0 not in held3:
        # the lane the rule does not hold: its errors and its condition
        j = int(torch.where(torch.isfinite(bw_k), bw_k, -1.0).argmax())
        K, _ = dense_system(torch, d64[j:j + 1], u64[j:j + 1], b64[j:j + 1])
        s = torch.rsqrt(torch.diagonal(K[0]))
        cond = torch.linalg.cond(s[:, None] * K[0] * s[None, :]).item()
        fwd_k, fwd_p = (lane_errors(torch, t[j:j + 1], p64[0][j:j + 1]
                                    ).item() for t in (kern[0], p32[0]))
        worst = dict(lane=j, forward=fwd_k, plain32_forward=fwd_p,
                     backward=bw_k[j].item(), plain32_backward=bw_p[j].item(),
                     cond_scaled=cond)
        errs["beam_solve"]["worst_lane"] = worst
        log(f"  #3 worst lane {j}: forward err {fwd_k:.3e} (plain f32 "
            f"{fwd_p:.3e}), backward err {worst['backward']:.3e} (plain f32 "
            f"{worst['plain32_backward']:.3e}), cond of the scaled K "
            f"{cond:.3e}")
    return errs


def dense_system(torch, diag, upper, b):
    """The dense (B, 3n, 3n) matrices and (B, 3n, 1) right-hand sides of
    symmetric block-tridiagonal systems, in their dtype."""
    B, n = diag.shape[:2]
    K = torch.zeros((B, n, 3, n, 3), dtype=diag.dtype, device=diag.device)
    idx = torch.arange(n, device=diag.device)
    K[:, idx, :, idx, :] = diag.transpose(0, 1)
    K[:, idx[:-1], :, idx[1:], :] = upper.transpose(0, 1)
    K[:, idx[1:], :, idx[:-1], :] = upper.transpose(0, 1).transpose(-1, -2)
    return K.reshape(B, 3 * n, 3 * n), b.reshape(B, 3 * n, 1)


def overhang(torch, BeamScenario, n, B, seed, dev, tails=(16, 48)):
    """tests/test_block_stream_dd.py's n = 641 family at n nodes: a
    span-scaled beam (Le = 2 m) pinned at node 0 with rollers every 64
    nodes from node 63, the last one a tail of U(16, 48) nodes (32-96 m)
    before the free end, one point load in the tail's outer half, and
    I = 0.05 U(0.8, 1.2).  At n = 1001 float32 misses by 1e-2 to 1e-1 of
    the lane's scale, and the float64 pivots lie at 1e-11 to 1e-9: the
    autopilot escalates every lane and certifies most of them."""
    gen = torch.Generator().manual_seed(seed)
    lane = torch.arange(B)
    tail = torch.randint(tails[0], tails[1] + 1, (B,), generator=gen)
    last = n - 1 - tail
    node = torch.arange(n)[None, :]
    roller = (node >= 63) & ((node - 63) % 64 == 0) & (node <= last[:, None])
    roller[lane, last] = True
    loads = torch.zeros((B, n))
    pos = last + tail // 2 + (torch.rand(B, generator=gen)
                              * (tail // 2)).long()
    loads[lane, pos] = -3.5e5
    I = 0.05 * (0.8 + 0.4 * torch.rand((B, n - 1), generator=gen))
    sc = BeamScenario(node_x=torch.linspace(0.0, 2.0 * (n - 1), n).repeat(
        B, 1), roller_mask=roller, point_loads=loads,
        udl=torch.full((B,), -1000.0))
    return I.to(dev), sc.map(lambda t: t.to(dev))


def beam_args(torch, constraint_mask, I, sc):
    """(I, Le, free, loads, udl) of the float64 analysis and the streamed
    float64 solve, float32."""
    return (I, torch.diff(sc.node_x, dim=-1),
            (~constraint_mask(sc)).to(torch.float32), sc.point_loads, sc.udl)


def max_ulps(torch, a, b):
    """Largest distance between two float32 tensors in units in the last
    place (NaN against NaN counts as equal)."""
    ia, ib = (t.float().view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(2 ** 31) - ia, ia)
    ib = torch.where(ib < 0, -(2 ** 31) - ib, ib)
    d = (ia - ib).abs()
    d[torch.isnan(a) & torch.isnan(b)] = 0
    return int(d.max().item()) if d.numel() else 0


def check_dd_streamed(torch, tsd, args, E, A, label, pivots_of=None):
    """Kernel #9's system solve (the wrapper) against its plain version on
    the float64 systems assembled from ``args``: per-lane error of x no more
    than DD_TOL of the lane's scale, pivots within a relative 1e-3.  Then
    the fused route ``solve_beam_dd_streamed`` on ``args`` against its plain
    version (the same assembly and the plain solve): u within DD_TOL of the
    lane's scale, pivots within a relative 1e-6; its lanes bitwise equal to
    the unfused route (the assembly, then #9) are counted and the largest
    gaps printed in ulps.  With ``pivots_of`` (the float64 analysis's pivots
    of the same lanes), their ratio to #9's is printed.  Returns the max abs
    error and the per-lane error's 99th percentile of both."""
    diag, upper, f, s = tsd.assemble_beam_system_dd(*args, E, A)
    kern = tsd.solve_dd_streamed(diag, upper, f)
    plain = tsd.thomas_dd_reference(diag, upper, f)
    fused = tsd.solve_beam_dd_streamed(*args, E, A)
    unfused_u = (kern[0].to(s.dtype) * s).float()
    plain_u = (plain[0].to(s.dtype) * s).float()
    del diag, upper, f, s
    torch.cuda.synchronize()
    e = lane_errors(torch, kern[0], plain[0].double())
    ratio = kern[1].double() / plain[1].double()
    log(f"phase 3d: {label}: #9 x per-lane err p50 "
        f"{e.quantile(0.5).item():.3e} p99 {e.quantile(0.99).item():.3e} "
        f"max {e.max().item():.3e} | pivot ratio kernel/plain min "
        f"{ratio.min().item():.9f} max {ratio.max().item():.9f} | pivots "
        f"min {plain[1].min().item():.3e} max {plain[1].max().item():.3e}")
    if not e.max().item() <= DD_TOL:
        raise AssertionError(f"#9: error {e.max().item():.3e} exceeds "
                             f"{DD_TOL:.0e} of the lane's scale")
    if not ((ratio - 1.0).abs() <= 1e-3).all():
        raise AssertionError("#9 pivot off by more than 1e-3")
    e_f = lane_errors(torch, fused[0], plain_u.double())
    ratio_f = fused[1].double() / plain[1].double()
    bits = lambda t: t.view(torch.int32).reshape(t.shape[0], -1)
    same = ((bits(fused[0]) == bits(unfused_u)).all(1)
            & (bits(fused[1][:, None]) == bits(kern[1][:, None])).all(1))
    log(f"  fused route: u per-lane err p50 {e_f.quantile(0.5).item():.3e} "
        f"p99 {e_f.quantile(0.99).item():.3e} max {e_f.max().item():.3e} | "
        f"pivot ratio to plain min {ratio_f.min().item():.12f} max "
        f"{ratio_f.max().item():.12f} | bitwise the unfused route on "
        f"{int(same.sum())}/{same.numel()} lanes (max gap u "
        f"{max_ulps(torch, fused[0], unfused_u)} ulp, pivot "
        f"{max_ulps(torch, fused[1], kern[1])} ulp)")
    if not e_f.max().item() <= DD_TOL:
        raise AssertionError(f"fused #9 route: error {e_f.max().item():.3e} "
                             f"exceeds {DD_TOL:.0e} of the lane's scale")
    if not ((ratio_f - 1.0).abs() <= 1e-6).all():
        raise AssertionError("fused #9 route: pivot off by more than 1e-6")
    if pivots_of is not None:
        r7 = pivots_of.double() / kern[1][-len(pivots_of):].double()
        log("  #7 pivot (a_axial |det2|) / #9 pivot (min |det S_i|) on the "
            "quasi-cantilever lanes: " + ", ".join(f"{r:.6f}"
                                                   for r in r7.tolist()))
    return dict(abs=(kern[0].double() - plain[0].double()).abs().max()
                .item(), rel_p99=e.quantile(0.99).item(),
                plain32_rel_p99=None,
                fused_abs=(fused[0].double() - plain_u.double()).abs().max()
                .item(), fused_rel_p99=e_f.quantile(0.99).item(),
                fused_bitwise_lanes=int(same.sum()))


# ---------------------------------------------------------------------------
# Phases 4d, 4e: the split path and the accuracy autopilot
# ---------------------------------------------------------------------------


def analysis_loss(u, V, M):
    """A loss on every differentiable output head of the analysis (the
    JAX package's tests/test_fused_vjp.py loss)."""
    return ((M**2).sum() * 1e-9 + (V**2).sum() * 1e-7
            + (u[..., 1]**2).sum() * 1e3)


def fixed_span(torch, BeamScenario, n, B, seed, dev):
    """tests/test_accuracy.py's family: a fixed 200 m span at n nodes
    (cond ~ n^4), rollers at tags 10/30/70/85/100 of the 101-node mesh
    scaled to n, one point load at mid-span, I = 0.05 U(0.2, 2)."""
    gen = torch.Generator().manual_seed(seed)
    node_x = torch.linspace(0.0, 200.0, n).repeat(B, 1)
    roller = torch.zeros((B, n), dtype=torch.bool)
    roller[:, [t * (n - 1) // 100 for t in (9, 29, 69, 84, 99)]] = True
    loads = torch.zeros((B, n))
    loads[:, n // 2] = -3.5e5 * (0.5 + torch.rand(B, generator=gen))
    I = 0.05 * (0.2 + 1.8 * torch.rand((B, n - 1), generator=gen))
    sc = BeamScenario(node_x=node_x, roller_mask=roller, point_loads=loads,
                      udl=torch.full((B,), -1000.0))
    return I.to(dev), sc.map(lambda t: t.to(dev))


# ---------------------------------------------------------------------------
# Phases 4b, 4c, 5b: the rescue
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed_rescues(torch, gen_mod, record):
    """Record mode, rejected lanes and wall seconds of every rescue the
    datagen entry points run inside the block."""
    orig = gen_mod._rescue_local

    def timed(batch, beam_cfg, opt_cfg, mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rejected = int((~batch.valid).sum())
        out = orig(batch, beam_cfg, opt_cfg, mode)
        torch.cuda.synchronize()
        record.append(dict(mode=mode, rejected=rejected,
                           seconds=time.perf_counter() - t0))
        return out

    gen_mod._rescue_local = timed
    try:
        yield record
    finally:
        gen_mod._rescue_local = orig


def check_supports(torch, batch, lanes):
    """Exact zero deflection at the pin and the rollers, and u_x == 0, on
    the selected lanes; finite I."""
    sol = batch.result.solution
    defl = sol.deflections[lanes]
    if not ((defl[:, 0] == 0).all()
            and (defl[batch.scenario.roller_mask[lanes]] == 0).all()
            and (sol.displacements[lanes][..., 0] == 0).all()):
        raise AssertionError("nonzero displacement at a support")
    if not torch.isfinite(batch.result.I[lanes]).all():
        raise AssertionError("non-finite I on a kept lane")


def check_rescued(torch, batch, first):
    """``batch`` (rescued) against ``first`` (the same draws, no rescue):
    the float32-kept lanes bitwise unchanged, the rescued lanes pinned at
    their supports.  Returns the number of rescued lanes."""
    kept = first.valid
    if not batch.valid[kept].all():
        raise AssertionError("a lane the float32 pass kept was dropped")
    for a, b in ((batch.result.I, first.result.I),
                 (batch.result.n_epochs, first.result.n_epochs),
                 (batch.result.solution.deflections,
                  first.result.solution.deflections)):
        if not torch.equal(a[kept], b[kept]):
            raise AssertionError("the rescue changed a float32-kept lane")
    rescued = batch.valid & ~kept
    check_supports(torch, batch, rescued)
    return int(rescued.sum())


def reset_counts(*modules):
    for m in modules:
        m.reset_counts()


def read_counts(*modules):
    launches, plain = {}, {}
    for m in modules:
        launches.update(m.LAUNCHES)
        plain.update(m.PLAIN_CALLS)
    return launches, plain


@contextlib.contextmanager
def launches_by_lanes(tbt, tbs):
    """Count the launches of #4 and #6 by lane count while the block runs,
    as {("#4" or "#6", lanes): launches}: the launchers are wrapped, their
    own counters left as they are."""
    counts = {}
    orig = tbt.launch_thomas, tbs.launch_thomas_streamed

    def counted(tag, fn):
        def launch(diag, upper, b):
            key = (tag, diag.shape[0])
            counts[key] = counts.get(key, 0) + 1
            return fn(diag, upper, b)
        return launch

    tbt.launch_thomas = counted("#4", orig[0])
    tbs.launch_thomas_streamed = counted("#6", orig[1])
    try:
        yield counts
    finally:
        tbt.launch_thomas, tbs.launch_thomas_streamed = orig


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler, from a synchronized card to one.
    Returns the profiler and the wall time in s."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def device_kernels(torch, fn):
    """The device kernels one call of ``fn`` launches, as {name: count},
    from torch.profiler tracing the card alone (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def report_profile(prof, wall, label, top=6):
    """The device's busy share of the wall time (the profiler's own host
    overhead makes the idle share an upper bound), and the device ops and
    host ops that take the most time."""
    from torch.autograd import DeviceType

    # one pass over the events (each key_averages() call walks all of them:
    # ~10 s for a training epoch's); a user annotation (the optimizer's
    # step range) spans kernels counted on their own
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    log(f"  {label}: wall {wall:.3f} s under the profiler, device busy "
        + (f"{busy:.3f} s ({busy / wall:.1%})" if busy > 0
           else "not measured (no device events)"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total * 1e-3:9.1f} ms  {e.count:6d}x  "
            f"{e.key[:70]}")
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:top]
    for e in cpu:
        log(f"    host {e.self_cpu_time_total * 1e-3:9.1f} ms  {e.count:6d}x  "
            f"{e.key[:60]}")


def profile_batch(torch, run_batch, sample_scenarios, seed, B, beam, opt,
                  refine):
    """One batch program under torch.profiler (``report_profile``)."""
    sc = sample_scenarios(torch.Generator().manual_seed(seed), B,
                          device="cuda", dtype=torch.float32)
    out = {}
    prof, wall = profiled(torch, lambda: out.setdefault(
        "batch", run_batch(sc, beam, opt, refine)))
    epochs = int(out["batch"].result.n_epochs.max())
    report_profile(prof, wall, f"profiled batch ({B} lanes, {epochs} epochs)")


def profile_split_window(torch, sc, beam, opt, refine):
    """PROFILE_EPOCHS epochs of the split optimizer's epoch body (the
    ``optimize_beam_compact(fused=False)`` loop's, host syncs included) on
    all of ``sc``'s lanes under torch.profiler, after 4 epochs of warm-up
    (``report_profile``)."""
    from openpystruct_tpu_torch.opt.beam_opt import (
        _default_I0,
        _lane_state_init,
        _make_freeze_body,
        _make_kernel_step,
        _run_epochs,
    )

    B, n = sc.node_x.shape
    body = _make_freeze_body(_make_kernel_step(
        sc, beam, opt, refine, False, torch.float32), opt)
    state, epoch = _run_epochs(body, _lane_state_init(_default_I0(
        sc, beam, (B, n - 1))), 0, 4, lambda st: True)
    prof, wall = profiled(torch, lambda: _run_epochs(
        body, state, epoch, epoch + PROFILE_EPOCHS, lambda st: True))
    report_profile(prof, wall, f"profiled split-path window ({B} lanes, "
                   f"n={n}, {opt.grad_mode}, epochs {epoch}-"
                   f"{epoch + PROFILE_EPOCHS - 1})", top=8)


def training_path(torch, seed, mods):
    """Phase 7: generate -> features -> device preprocessing -> TFD fit ->
    R^2, all on the card.  Returns the kernels' launches on the path and the
    prepared dataset (phase 12's)."""
    import numpy as np

    from openpystruct_tpu_torch.data import prepare_dataset_device
    from openpystruct_tpu_torch.datagen import (
        batch_feature_arrays,
        generate_batch,
    )
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.train import (
        evaluate_r2,
        fit,
        load_checkpoint,
        predict,
        save_checkpoint,
    )

    lanes = TRAIN_BATCHES * BATCH
    log(f"phase 7: the training path: generate_batch {TRAIN_BATCHES} x "
        f"{BATCH} fixed-bridge lanes -> batch_feature_arrays -> "
        f"prepare_dataset_device -> TFD fit ({TRAIN_EPOCHS} epochs) -> R^2")
    reset_counts(*mods)
    gen = torch.Generator().manual_seed(seed + 70)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [batch_feature_arrays(generate_batch(gen, BATCH, device="cuda"))
             for _ in range(TRAIN_BATCHES)]
    arrays = {k: torch.cat([f[k] for f in feats]) for k in feats[0]}
    n_valid = int(arrays["valid"].sum())
    t_gen = time.perf_counter() - t0
    launches, plain = read_counts(*mods)
    log(f"  generate + featurize: {t_gen:.2f} s, {lanes / t_gen:.1f} "
        f"samples/s ({n_valid} valid of {lanes}) | launches "
        f"{ {k: v for k, v in launches.items() if v} } plain calls "
        f"{ {k: v for k, v in plain.items() if v} }")
    if not (launches["beam_analysis"] > 0 and launches["beam_opt_step"] > 0):
        raise AssertionError(f"a datagen kernel was not launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the path: {plain}")
    del feats

    spec = FAMILIES["tfd"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = prepare_dataset_device(arrays, n_cases=spec.train.n_cases,
                                c=spec.train.c, nheads_pad=spec.nheads_pad)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    if ds.X_train.device.type != "cuda" or not torch.isfinite(
            ds.X_train).all():
        raise AssertionError("preprocessing left the card or is not finite")
    log(f"  preprocess: {t_prep:.3f} s ({ds.X_train.shape[0]} train / "
        f"{ds.X_val.shape[0]} val groups, feat {ds.feat_dim})")

    model, spec, fit_kwargs = build_family("tfd", ds.feat_dim)
    cfg = dataclasses.replace(spec.train, num_epochs=TRAIN_EPOCHS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(model, ds.X_train, ds.Y_train, ds.X_val, ds.Y_val, cfg,
              epochs_per_sync=10, device="cuda", **fit_kwargs)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    ep = len(res.train_losses)
    if not (np.isfinite(res.train_losses).all()
            and np.isfinite(res.val_losses).all()):
        raise AssertionError(f"a non-finite loss: {res.train_losses} "
                             f"{res.val_losses}")
    if not res.val_losses.min() < res.val_losses[0]:
        raise AssertionError(f"no val improvement: {res.val_losses}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on after fit")
    log(f"  train: {ep} epochs in {t_train:.2f} s, "
        f"{ep * ds.X_train.shape[0] / t_train:.1f} samples/s (epochs x "
        f"train groups / s) | {model.dtype} | best epoch {res.best_epoch}, "
        f"val loss {res.val_losses[0]:.4f} -> {res.val_losses.min():.4f}, "
        f"train loss {res.train_losses[0]:.4f} -> {res.train_losses[-1]:.4f}")

    t0 = time.perf_counter()
    r2 = evaluate_r2(model, res.params, ds.X_val, ds.Y_val, ds.scaler_Y,
                     batch_size=4096)
    log(f"  validation R^2 {r2:.4f} ({time.perf_counter() - t0:.2f} s)")
    if not (math.isfinite(r2) and r2 > 0):
        raise AssertionError(f"R^2 {r2}")

    tmp = REPO / ".smoke_tmp"
    tmp.mkdir(exist_ok=True)
    try:
        save_checkpoint(str(tmp / "tfd_best.pt"), res.params)
        back = load_checkpoint(str(tmp / "tfd_best.pt"), device="cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    X = ds.X_val[:4096]
    same = torch.equal(predict(model, res.params, X, ds.scaler_Y, seed=1),
                       predict(model, back, X, ds.scaler_Y, seed=1))
    if not same:
        raise AssertionError("the reloaded checkpoint predicts otherwise")
    # the same weights in float32, whose diffusion step adds noise
    m32 = build_family("tfd", ds.feat_dim, compute_dtype="float32")[0]
    r2_32 = evaluate_r2(m32, res.params, ds.X_val, ds.Y_val, ds.scaler_Y,
                        batch_size=4096)
    y16 = predict(model, res.params, X, seed=1)
    y32 = predict(m32, res.params, X, seed=1)
    log(f"  checkpoint reloaded, predict bitwise equal | the same weights "
        f"in float32 (its diffusion step adds noise): R^2 {r2_32:.4f}, "
        f"bfloat16 - float32 max "
        f"{(y16 - y32).abs().max().item() / y32.abs().max().item():.3e} "
        f"of the output scale")

    prof, wall = profiled(torch, lambda: fit(
        model, ds.X_train, ds.Y_train, ds.X_val, ds.Y_val,
        dataclasses.replace(cfg, num_epochs=1), epochs_per_sync=1,
        device="cuda"))
    steps = ds.X_train.shape[0] // cfg.batch_size
    report_profile(prof, wall, f"profiled one-epoch fit ({steps} steps of "
                   f"{cfg.batch_size}, val, set-up)", top=8)
    return launches, ds


def ragged_rows(values, mask, order):
    """Each row's values where ``mask`` holds, in ``order``'s rank (ascending
    node order without one), as the writer lists them: (the concatenated
    values, the selected node indices, the row lengths)."""
    import numpy as np

    n = mask.shape[1]
    rank = np.broadcast_to(np.arange(n), mask.shape) if order is None \
        else order
    idx = np.argsort(np.where(mask, rank, np.iinfo(np.int64).max), axis=1,
                     kind="stable")
    sel = np.take_along_axis(mask, idx, axis=1)
    return (np.take_along_axis(values, idx, axis=1)[sel], idx[sel],
            mask.sum(axis=1))


def hold_columns(data, arrays, rows=None, bitwise=True):
    """Every column of a dataset read back against the shards' valid lanes:
    the float columns bitwise (the writer prints float32 values' shortest
    round trip), node tags and counts exactly.  ``rows`` limits the check to
    the first rows.  ``bitwise=False`` holds values equal instead, for
    ``json.load``, which reads the writer's "-0" as the integer 0."""
    import numpy as np

    def same(got, a):
        if bitwise:
            return got.shape == a.shape and got.tobytes() == a.tobytes()
        return np.array_equal(got, a)

    v = arrays["valid"]
    take = (lambda a: a[v][:rows])
    node_x, loads = take(arrays["node_x"]), take(arrays["point_loads"])
    ro = arrays.get("roller_order")
    fo = arrays.get("force_order")
    ro = None if ro is None else take(ro)
    fo = None if fo is None else take(fo)
    rmask, fmask = take(arrays["roller_mask"]), loads != 0.0
    want = {
        "I_values": take(arrays["I"]),
        "shear_forces": take(arrays["shear_forces"]),
        "bending_moments": take(arrays["bending_moments"]),
        "node_positions": node_x,
        "deflections": take(arrays["deflections"]),
        "rotations": take(arrays["rotations"]),
    }
    rx, r_idx, r_len = ragged_rows(node_x, rmask, ro)
    fx, f_idx, f_len = ragged_rows(node_x, fmask, fo)
    fv = ragged_rows(loads, fmask, fo)[0]
    ragged = {"roller_x_locations": (rx, r_len),
              "force_x_locations": (fx, f_len),
              "force_values": (fv, f_len),
              "roller_nodes": ((r_idx + 1).astype(np.float32), r_len),
              "force_nodes": ((f_idx + 1).astype(np.float32), f_len)}
    for key, a in want.items():
        got = np.asarray(data[key], dtype=np.float32)[:rows]
        if not same(got, a):
            raise AssertionError(f"column {key} differs from the shards")
    for key, (a, lengths) in ragged.items():
        col = list(data[key])[:rows]
        got = np.concatenate([np.asarray(r, dtype=np.float32) for r in col])
        if ([len(r) for r in col] != lengths.tolist()
                or not same(got, a.astype(np.float32))):
            raise AssertionError(f"column {key} differs from the shards")
    if not (np.array_equal(np.asarray(data["L"], np.float64)[:rows],
                           node_x[:, -1].astype(np.float64))
            and (np.asarray(data["num_nodes"])[:rows]
                 == node_x.shape[1]).all()):
        raise AssertionError("columns L / num_nodes differ from the shards")


def file_workflow(torch, seed, mods):
    """Phase 8: shards -> kill and resume -> JSON through the native writer
    -> the native reader -> preprocessing -> the FNN and the PINN -> R^2 ->
    persisted scalers -> predict.  Returns the kernels' launches in the
    phase and the columns the native reader read (phase 9's data)."""
    import os

    import numpy as np

    from openpystruct_tpu_torch.config import ScenarioConfig
    from openpystruct_tpu_torch.data import (
        build_user_input,
        load_preprocessing,
        prepare_dataset,
        save_preprocessing,
    )
    from openpystruct_tpu_torch.data.pipeline import FEATURE_KEYS
    from openpystruct_tpu_torch.datagen import (
        generate_dataset,
        generate_dataset_json,
        generate_to_shards,
        native_available,
        read_json_dataset,
        read_npz_shards,
        reader_available,
        shards_to_json,
    )
    from openpystruct_tpu_torch.datagen import native as tnative
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.train import evaluate_r2, fit, predict

    lanes = SHARDS * SHARD_LANES
    log(f"phase 8: the file-based workflow: generate_to_shards {SHARDS} x "
        f"{SHARD_LANES} random-bridge lanes -> shard {SHARD_LOST} deleted "
        "and regenerated -> shards_to_json (native) -> read_json_dataset "
        f"(native) -> prepare_dataset -> FNN and PINN fit ({FILE_EPOCHS} "
        "epochs) -> R^2 -> save/load_preprocessing -> predict")
    t0 = time.perf_counter()
    if not (native_available() and reader_available()):
        raise AssertionError("the native JSON writer or reader did not build "
                             "and load (no fallback on the card)")
    libs = [tnative.library_path(src, flags).name for src, flags in (
        ("dataset_writer.cpp", tnative.WRITER_FLAGS),
        ("dataset_reader.cpp", tnative.READER_FLAGS))]
    log(f"  native writer and reader built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {libs}")

    tmp = REPO / ".smoke_tmp" / "files"
    shutil.rmtree(tmp, ignore_errors=True)
    shard_dir = tmp / "shards"
    rb = ScenarioConfig(random_bridge=True)
    reset_counts(*mods)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = generate_to_shards(seed + 80, lanes, str(shard_dir),
                                   batch_size=SHARD_LANES, scen_cfg=rb,
                                   device="cuda")
        torch.cuda.synchronize()
        t_shards = time.perf_counter() - t0
        first, plain = read_counts(*mods)
        if any(plain.values()):
            raise AssertionError(f"a plain version ran on the path: {plain}")
        arrays = read_npz_shards(paths)
        n_valid = int(arrays["valid"].sum())
        log(f"  generate_to_shards: {t_shards:.2f} s, {n_valid} valid of "
            f"{lanes} ({n_valid / t_shards:.1f} valid samples/s, .npz "
            f"{sum(os.path.getsize(p) for p in paths) / 2**20:.1f} MiB) | "
            f"launches { {k: v for k, v in first.items() if v} }")

        with np.load(paths[SHARD_LOST]) as z:
            lost = {k: z[k] for k in z.files}
        os.remove(paths[SHARD_LOST])
        seen = []
        t0 = time.perf_counter()
        again = generate_to_shards(seed + 80, lanes, str(shard_dir),
                                   batch_size=SHARD_LANES, scen_cfg=rb,
                                   device="cuda", on_batch=seen.append)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        after = read_counts(*mods)[0]
        resumed = {k: after[k] - first[k] for k in after}
        if again != paths or len(seen) != 1 or resumed["beam_analysis"] != 1:
            raise AssertionError(f"the resume regenerated {len(seen)} shards "
                                 f"({resumed['beam_analysis']} final "
                                 "analyses), not one")
        with np.load(paths[SHARD_LOST]) as z:
            same = set(z.files) == set(lost) and all(
                z[k].tobytes() == lost[k].tobytes() for k in lost)
        if not same:
            raise AssertionError(f"shard {SHARD_LOST} regenerated otherwise")
        log(f"  shard {SHARD_LOST} deleted and regenerated in "
            f"{t_resume:.2f} s, bitwise the lost one; launches "
            f"{ {k: v for k, v in resumed.items() if v} }")

        path = tmp / "dataset.json"
        t0 = time.perf_counter()
        written = shards_to_json(paths, str(path))
        t_json = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        data = read_json_dataset(str(path), native=True)
        t_read = time.perf_counter() - t0
        if written != n_valid or len(data["L"]) != n_valid or not isinstance(
                data["I_values"], np.ndarray):
            raise AssertionError("the native JSON round trip lost rows or "
                                 "fell back to json.load")
        hold_columns(data, arrays)
        log(f"  shards_to_json: {size / 2**30:.3f} GiB in {t_json:.2f} s "
            f"({size / 2**20 / t_json:.1f} MiB/s) | read_json_dataset "
            f"(native) {t_read:.2f} s ({size / 2**20 / t_read:.1f} MiB/s) | "
            f"every column bitwise the shards' {n_valid} valid lanes")
        path0 = tmp / "shard0.json"
        n0 = shards_to_json(paths[:1], str(path0))
        t0 = time.perf_counter()
        with open(path0) as f:
            doc = json.load(f)
        t_load0 = time.perf_counter() - t0
        hold_columns(doc, read_npz_shards(paths[:1]), bitwise=False)
        hold_columns(data, arrays, rows=n0)
        log(f"  json.load of shard 0's JSON ({n0} rows, "
            f"{path0.stat().st_size / 2**20:.1f} MiB) {t_load0:.2f} s: the "
            "same columns (equal in value: json.load reads -0 as 0)")
        del doc, arrays, lost

        # the streamed route against phase 4's on one fixed-bridge batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols = generate_dataset(seed + 81, BATCH, batch_size=BATCH,
                                device="cuda")
        t_lists = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_stream = generate_dataset_json(seed + 81, BATCH, str(tmp /
                                         "stream.json"), batch_size=BATCH,
                                         device="cuda")
        t_stream = time.perf_counter() - t0
        stream = read_json_dataset(str(tmp / "stream.json"))
        if n_stream != len(cols["I_values"]) or not all(
                np.array_equal(np.asarray(cols[k], np.float32),
                               np.asarray(stream[k], np.float32))
                for k in ("I_values", "deflections", "L")):
            raise AssertionError("the streamed JSON differs from the "
                                 "columnar lists")
        log(f"  one {BATCH}-lane fixed-bridge batch: generate_dataset "
            f"(phase 4's route, columnar lists, no file) {t_lists:.2f} s, "
            f"{n_stream / t_lists:.1f} valid samples/s | "
            f"generate_dataset_json (native writer, the file written) "
            f"{t_stream:.2f} s, {n_stream / t_stream:.1f} valid samples/s "
            f"| {(tmp / 'stream.json').stat().st_size / 2**20:.1f} MiB, "
            "I, deflections and L equal to the lists'")
        del cols, stream
        launches, plain = read_counts(*mods)
        if any(plain.values()):
            raise AssertionError(f"a plain version ran on the path: {plain}")
        missing = [k for k in DATAGEN_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"not launched in phase 8: {missing}")

        for name in ("fnn", "pinn"):
            spec = FAMILIES[name]
            t0 = time.perf_counter()
            ds = prepare_dataset(data, n_cases=spec.train.n_cases,
                                 c=spec.train.c,
                                 extra_label_keys=spec.extra_label_keys)
            t_prep = time.perf_counter() - t0
            model, spec, fit_kwargs = build_family(name, ds.feat_dim,
                                                   label_dim=ds.label_dim)
            cfg = dataclasses.replace(spec.train, num_epochs=FILE_EPOCHS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit(model, ds.X_train, ds.Y_train, ds.X_val, ds.Y_val, cfg,
                      epochs_per_sync=10, device="cuda", **fit_kwargs)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            ep = len(res.train_losses)
            if not (np.isfinite(res.train_losses).all()
                    and np.isfinite(res.val_losses).all()):
                raise AssertionError(f"{name}: a non-finite loss")
            if not res.val_losses.min() < res.val_losses[0]:
                raise AssertionError(f"{name}: no val improvement: "
                                     f"{res.val_losses}")
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
                raise AssertionError("TF32 is on after fit")
            sl = slice(0, 100) if name == "pinn" else None
            r2 = evaluate_r2(model, res.params, ds.X_val, ds.Y_val,
                             ds.scaler_Y, label_slice=sl, batch_size=4096,
                             device="cuda")
            if not (math.isfinite(r2) and r2 > 0):
                raise AssertionError(f"{name}: R^2 {r2}")
            pre = tmp / f"{name}_preprocessing.npz"
            save_preprocessing(ds, str(pre), nelem=100)
            back = load_preprocessing(str(pre))
            lists = [list(data[k][:ds.n_cases]) for k in FEATURE_KEYS]
            x_mem = build_user_input(*lists, ds.scalers, ds.n_cases,
                                     ds.max_lengths)
            x_disk = build_user_input(*lists, back["scalers"],
                                      back["n_cases"], back["max_lengths"])
            y_mem = predict(model, res.params, x_mem, ds.scaler_Y,
                            device="cuda")
            y_disk = predict(model, res.params, x_disk, back["scaler_Y"],
                             device="cuda")
            if not torch.equal(y_mem, y_disk) or back["nelem"] != 100:
                raise AssertionError(f"{name}: the persisted scalers predict "
                                     "otherwise")
            stats = [k for k in res.params["model"] if "running_" in k]
            log(f"  {name}: prepare_dataset {t_prep:.2f} s ({ds.X_train.shape[0]} "
                f"train / {ds.X_val.shape[0]} val groups, feat {ds.feat_dim}, "
                f"label {ds.label_dim}) | fit {ep} epochs in {t_train:.2f} s, "
                f"{ep * ds.X_train.shape[0] / t_train:.1f} samples/s (epochs "
                f"x train groups / s) | {model.dtype} | best epoch "
                f"{res.best_epoch}, val loss {res.val_losses[0]:.4f} -> "
                f"{res.val_losses.min():.4f} | R^2 "
                f"{'(I slice) ' if sl else ''}{r2:.4f} | "
                f"{len(stats)} BatchNorm buffers carried | persisted "
                "scalers: predict bitwise equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, data


def spectral_oracle(x, wr, wi, n, modes, degen):
    """tests/test_models.py's complex rfft -> truncate -> mix -> zero-pad ->
    irfft formulation of the FNO's spectral conv (numpy, complex128)."""
    import numpy as np

    m_eff = min(modes, n // 2 + 1)
    w = (wr + 1j * wi)[:, :, :m_eff]
    xm = np.fft.rfft(x, n=n, axis=-1)[:, :, :m_eff]
    if degen:
        out_m = xm.sum(axis=1)[:, None, :] * w.sum(axis=1)[None, :, :]
    else:
        out_m = np.einsum("bim,iom->bom", xm, w)
    out_ft = np.zeros((x.shape[0], wr.shape[1], n // 2 + 1), np.complex128)
    out_ft[:, :, :m_eff] = out_m
    return np.fft.irfft(out_ft, n=n, axis=-1)


def surrogate_families(torch, data, seed):
    """Phase 9: the GNN, the FNO and the Bayesian TFDs trained on the card
    from phase 8's file (``data``, the columns its native reader read), the
    FNO's spectral conv against the complex-FFT oracle, ``mc_output_stats``
    for ``bnn-meta``."""
    import numpy as np

    from openpystruct_tpu_torch.data import prepare_dataset
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.models import SpectralConv1d, mc_output_stats
    from openpystruct_tpu_torch.train import evaluate_r2, fit

    log(f"phase 9: the GNN, the FNO and the Bayesian TFDs from phase 8's "
        f"file ({len(data['L'])} samples): prepare_dataset -> fit "
        f"({FILE_EPOCHS} epochs) -> R^2; mc_output_stats({MC_SAMPLES}) for "
        "bnn-meta; the spectral conv vs the complex-FFT oracle")
    rng = np.random.default_rng(seed + 90)
    for n, modes, degen in SPECTRAL_CASES:
        x = rng.normal(size=(3, 5, n)).astype(np.float32)
        conv = SpectralConv1d(5, 5, modes, degenerate_mixing=degen).cuda()
        with torch.no_grad():
            y = conv(torch.from_numpy(x).cuda()).cpu().numpy()
        ref = spectral_oracle(x.astype(np.float64), *(
            w.detach().cpu().numpy().astype(np.float64)
            for w in (conv.weights_real, conv.weights_imag)), n, modes, degen)
        err = float(np.abs(y - ref).max() / np.abs(ref).max())
        if not err <= 1e-5:
            raise AssertionError(f"spectral conv (n={n}, modes={modes}, "
                                 f"degenerate={degen}): {err:.3e} of scale")
    log(f"  SpectralConv1d on the card = the numpy complex-FFT oracle on "
        f"{len(SPECTRAL_CASES)} cases (n 6-9, Nyquist, modes past it, "
        "degenerate) within 1e-5 of scale")

    for name in SURROGATES:
        spec = FAMILIES[name]
        t0 = time.perf_counter()
        ds = prepare_dataset(data, n_cases=spec.train.n_cases,
                             c=spec.train.c, nheads_pad=spec.nheads_pad,
                             extra_label_keys=spec.extra_label_keys)
        t_prep = time.perf_counter() - t0
        model, spec, fit_kwargs = build_family(name, ds.feat_dim,
                                               label_dim=ds.label_dim)
        kl_terms = []
        if "param_loss_fn" in fit_kwargs:
            term = fit_kwargs["param_loss_fn"]

            def recorded(params, term=term):
                value = term(params)
                if torch.is_grad_enabled():   # the train steps' terms
                    kl_terms.append(value.detach())
                return value

            fit_kwargs["param_loss_fn"] = recorded
        cfg = dataclasses.replace(spec.train, num_epochs=FILE_EPOCHS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(model, ds.X_train, ds.Y_train, ds.X_val, ds.Y_val, cfg,
                  epochs_per_sync=10, device="cuda", **fit_kwargs)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        ep = len(res.train_losses)
        if not (np.isfinite(res.train_losses).all()
                and np.isfinite(res.val_losses).all()):
            raise AssertionError(f"{name}: a non-finite loss")
        if not res.val_losses.min() < res.val_losses[0]:
            raise AssertionError(f"{name}: no val improvement: "
                                 f"{res.val_losses}")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise AssertionError("TF32 is on after fit")
        r2 = evaluate_r2(model, res.params, ds.X_val, ds.Y_val, ds.scaler_Y,
                         batch_size=4096, device="cuda")
        if not (math.isfinite(r2) and r2 > 0):
            raise AssertionError(f"{name}: R^2 {r2}")
        line = (f"  {name}: prepare_dataset {t_prep:.2f} s "
                f"({ds.X_train.shape[0]} train / {ds.X_val.shape[0]} val "
                f"groups, n_cases {ds.n_cases}, feat {ds.feat_dim}) | fit "
                f"{ep} epochs in {t_train:.2f} s, "
                f"{ep * ds.X_train.shape[0] / t_train:.1f} samples/s (epochs "
                f"x train groups / s) | {model.dtype} | best epoch "
                f"{res.best_epoch}, val loss {res.val_losses[0]:.4f} -> "
                f"{res.val_losses.min():.4f} | R^2 {r2:.4f}")
        if kl_terms:
            # fit's train steps an epoch (the partial batch dropped)
            n_tr = ds.X_train.shape[0]
            steps = max(n_tr // min(cfg.batch_size, n_tr), 1)
            kl = torch.stack(kl_terms).cpu().numpy()
            if not (np.isfinite(kl).all() and (kl > 0).all()):
                raise AssertionError(f"{name}: the KL term {kl}")
            line += (f" | KL term (BNN_KL_SCALE x KL, mean of the epoch's "
                     f"steps) epoch 1 {kl[:steps].mean():.4f}, epoch {ep} "
                     f"{kl[(ep - 1) * steps:ep * steps].mean():.4f}")
        log(line)
        if name == "bnn-meta":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, std = mc_output_stats(model, res.params, ds.X_val,
                                        n_samples=MC_SAMPLES,
                                        scaler_Y=ds.scaler_Y, device="cuda")
            torch.cuda.synchronize()
            t_mc = time.perf_counter() - t0
            if not (torch.isfinite(mean).all() and torch.isfinite(std).all()
                    and (std > 0).all()):
                raise AssertionError("mc_output_stats: a non-finite mean or "
                                     "std, or no spread")
            labels = (torch.as_tensor(ds.Y_val, device="cuda")
                      * torch.as_tensor(ds.scaler_Y.scale, device="cuda")
                      + torch.as_tensor(ds.scaler_Y.mean, device="cuda"))
            labels = labels.clamp(0.0, 1e10).double()
            preds = mean.clamp(0.0, 1e10).double()
            r2_mc = float(1.0 - ((labels - preds) ** 2).sum()
                          / ((labels - labels.mean()) ** 2).sum())
            log(f"  bnn-meta: mc_output_stats({MC_SAMPLES} samples, "
                f"{ds.X_val.shape[0]} val groups) {t_mc:.2f} s | R^2 of the "
                f"MC mean {r2_mc:.4f} | median std "
                f"{float(std.median()):.4g} (un-standardized)")


# ---------------------------------------------------------------------------
# Phase 10: the frame path
# ---------------------------------------------------------------------------


def lane_rel(torch, x, truth):
    """Per-lane max |x - truth| relative to the lane's max |truth|, float64;
    a lane with a non-finite value counts as inf."""
    d = (x.double() - truth).flatten(1).abs().amax(1)
    err = d / truth.flatten(1).abs().amax(1)
    return torch.where(torch.isfinite(x.flatten(1)).all(1), err,
                       torch.full_like(err, float("inf")))


def healthy_I(torch, gen, B, E, I0, dev):
    """(B, E) float32 lognormal I (sigma 0.5) around I0, the healthy
    regime of the JAX package's float32 calibration."""
    return (torch.exp(0.5 * torch.randn(B, E, generator=gen, dtype=torch.float64))
            * I0).float().to(dev)


def garbage_I(torch, gen, B, E, I0, dev):
    """Healthy I with 70-95% of each lane's members at the 1e-8 clamp."""
    I = healthy_I(torch, gen, B, E, I0, "cpu")
    frac = 0.70 + 0.25 * torch.rand(B, 1, generator=gen)
    rank = torch.argsort(torch.rand(B, E, generator=gen), dim=1).argsort(1)
    return torch.where(rank < (frac * E).long(), 1e-8, I).to(dev)


def wall_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_bits(torch, a, b):
    """Two results (dataclasses of tensors, or tensors) hold the same bits."""
    if dataclasses.is_dataclass(a):
        return all(same_bits(torch, getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if a is None or b is None:
        return a is b
    return torch.equal(a, b) or (a.dtype.is_floating_point and torch.equal(
        a.nan_to_num(7.0), b.nan_to_num(7.0)) and torch.equal(
        a.isnan(), b.isnan()))


def frame_checked(torch, gen, cfg):
    """Phase 10e: ``solve_frame_checked`` on healthy and clamp lanes of a
    3x4 frame on the card, and its raise mode."""
    import numpy as np

    from openpystruct_tpu_torch.fem import (
        build_frame,
        solve_frame,
        solve_frame_checked,
    )
    from openpystruct_tpu_torch.fem.frame_banded import FRAME_VALID_PIVOT

    dev = torch.device("cuda")
    st = build_frame(3, 4, cfg, device="cuda")
    half = FRAME_LANES // 2
    I = torch.cat([
        healthy_I(torch, gen, half, st.num_elems, cfg.I0, dev),
        garbage_I(torch, gen, half, st.num_elems, cfg.I0, dev)])
    (sol, info), t = wall_s(torch, lambda: solve_frame_checked(
        I, st, cfg, tol=FRAME_CHECKED_TOL))
    ref = solve_frame(I.double(), st, cfg, torch.float64, method="dense")
    err = lane_rel(torch, sol.displacements, ref.displacements).cpu().numpy()
    cert = info["est"] <= FRAME_CHECKED_TOL
    esc = info["used_f64"]
    healthy = np.arange(FRAME_LANES) < half
    # a clamp lane left in float32 (est <= tol, pivot >= FRAME_VALID_PIVOT)
    # is held within 10 x tol: below the pivot floor every lane escalates,
    # where the JAX package's rule certified some far off (the port departs
    # from it on purpose)
    left = cert & ~esc & ~healthy
    held = cert & (esc | healthy)
    if not (sol.displacements.is_cuda and esc.any() and held.any()
            and (err[held] <= FRAME_CHECKED_TOL).all()
            and (err[left] <= 10 * FRAME_CHECKED_TOL).all()
            and (info["pivot"][~esc] >= FRAME_VALID_PIVOT).all()):
        raise AssertionError(
            f"solve_frame_checked: {int(esc.sum())} escalated, "
            f"{int(held.sum())} held, worst held error "
            f"{err[held].max() if held.any() else float('nan'):.3e}, "
            f"worst clamp lane left in float32 "
            f"{err[left].max() if left.any() else 0.0:.3e}")
    # tests/test_frame_banded.py's uncertifiable lane: 2x8, 95% of the
    # members at the clamp (scaled pivot ~1.6e-7, float64 bound ~7e-10)
    st2 = build_frame(2, 8, cfg, device="cuda")
    rng = np.random.default_rng(5)
    bad = np.exp(rng.normal(size=(1, st2.num_elems)) * 0.5) * cfg.I0
    bad[0, rng.choice(st2.num_elems, size=int(0.95 * st2.num_elems),
                      replace=False)] = 1e-8
    try:
        solve_frame_checked(torch.tensor(bad, dtype=torch.float32,
                                         device=dev),
                            st2, cfg, tol=1e-11, on_fail="raise")
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError("on_fail='raise' did not raise")
    log(f"phase 10e: solve_frame_checked(tol={FRAME_CHECKED_TOL}) on "
        f"{FRAME_LANES} 3x4 lanes ({half} healthy, {half} with 70-95% of "
        f"members at the clamp): {t:.3f} s, {int(esc.sum())} lanes escalated "
        f"to float64 on the card, {int(cert.sum())} certified; the healthy "
        f"and the escalated ones within {err[held].max():.2e} of float64 "
        f"dense; {int(left.sum())} clamp lanes left in float32, worst error "
        + (f"{err[left].max():.2e}" if left.any() else "-")
        + f" (gate {10 * FRAME_CHECKED_TOL:g})"
        + f" | on_fail='raise' at tol 1e-11: ValueError ({raised[:60]}...)")


def frame_path(torch, data, seed, mods):
    """Phase 10: the frame path on the card: the banded solve against the
    float64 dense one (10a), TF32 (10b), the batched optimizer under the
    reference budget (10c), mixed-topology datagen (10d), the checked solve
    (10e) and fit's resume on phase 8's columns (10f)."""
    import numpy as np

    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.data import prepare_dataset
    from openpystruct_tpu_torch.datagen import generate_frame_dataset
    from openpystruct_tpu_torch.datagen.frames import sample_frame_loads
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.fem import (
        build_frame,
        frame_min_pivot,
        solve_frame,
        solve_frame_banded,
    )
    from openpystruct_tpu_torch.fem.frame_banded import FRAME_VALID_PIVOT
    from openpystruct_tpu_torch.opt import frame_loss, optimize_frame_batched
    from openpystruct_tpu_torch.train import fit
    from torch.autograd import DeviceType

    cfg = FrameConfig()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 100)
    reset_counts(*mods)

    # ---- 10a: banded float32 vs dense float64 -----------------------------
    log(f"phase 10a: solve_frame banded float32 vs dense float64 on the card, "
        f"{FRAME_LANES} lanes, healthy and garbage-regime I")
    for nb, ns in FRAME_SOLVE_TOPOLOGIES:
        st = build_frame(nb, ns, cfg, device="cuda")
        I = healthy_I(torch, gen, FRAME_LANES, st.num_elems, cfg.I0, dev)
        sol32, piv32 = solve_frame_banded(I, st, cfg)
        sol64, piv64 = solve_frame_banded(I.double(), st, cfg, torch.float64)
        dense64 = solve_frame(I.double(), st, cfg, torch.float64,
                              method="dense")
        err = lane_rel(torch, sol32.displacements, dense64.displacements)
        err64 = lane_rel(torch, sol64.displacements, dense64.displacements)
        piv_gap = ((piv32.double() - piv64).abs() / piv64).max()
        if not (float(err.median()) <= FRAME_F32_TOL
                and float(err.max()) <= FRAME_F32_MAX
                and float(err64.max()) <= 1e-10
                and float(piv_gap) <= FRAME_PIVOT_RTOL
                and bool((piv32 > FRAME_VALID_PIVOT).all())):
            raise AssertionError(
                f"{nb}x{ns}: float32 error median {float(err.median()):.3e} "
                f"max {float(err.max()):.3e}, float64 "
                f"banded vs dense {float(err64.max()):.3e}, pivot gap "
                f"{float(piv_gap):.3e}, min pivot {float(piv32.min()):.3e}")
        # the clamp batch: a lane whose float32 solve is garbage (error to
        # float64 of FRAME_GARBAGE_ERR or more, or NaN) must fail the pivot
        # gate; a nearly uniform clamp is benign (Jacobi scaling), so some
        # lanes pass it, and their worst error is printed
        bad = garbage_I(torch, gen, FRAME_LANES, st.num_elems, cfg.I0, dev)
        solg, pivg = solve_frame_banded(bad, st, cfg)
        errg = lane_rel(torch, solg.displacements, solve_frame(
            bad.double(), st, cfg, torch.float64,
            method="dense").displacements)
        garbage = ~(errg < FRAME_GARBAGE_ERR)
        passed = pivg > FRAME_VALID_PIVOT
        if (garbage & passed).any() or not garbage.any():
            raise AssertionError(
                f"{nb}x{ns}: {int((garbage & passed).sum())} of "
                f"{int(garbage.sum())} garbage lanes pass the pivot gate")
        line = (f"  {nb}x{ns} (m = {3 * (nb + 1)}, {st.num_nodes * 3} DOF): "
                f"float32 banded vs float64 dense per-lane error median "
                f"{float(err.median()):.2e} max {float(err.max()):.2e} | "
                f"float64 banded vs dense max {float(err64.max()):.1e} | "
                f"pivots {float(piv32.min()):.3e}-{float(piv32.max()):.3e}, "
                f"max gap to float64 {float(piv_gap):.1e} | clamp batch: "
                f"{int(garbage.sum())} garbage lanes (error >= "
                f"{FRAME_GARBAGE_ERR:g} or NaN; {int(pivg.isnan().sum())} NaN "
                f"pivots), all below the gate (max pivot "
                f"{float(pivg[garbage].nan_to_num(0.0).max()):.2e}); "
                f"{int(passed.sum())} lanes pass it, max error "
                + (f"{float(errg[passed].max()):.1e}, min pivot "
                   f"{float(pivg[passed].min()):.2e}" if passed.any()
                   else "-"))
        if (nb, ns) in FRAME_TIMED:
            rates = []
            for method in ("dense", "banded"):
                ms = time_ms(torch, lambda: solve_frame(
                    I, st, cfg, method=method), 10)
                rates.append(FRAME_LANES / ms * 1e3)
            line += (f" | solves/s (float32, {FRAME_LANES} lanes a call, "
                     f"median of 10): dense {rates[0]:.4g}, banded "
                     f"{rates[1]:.4g}")
        log(line)

    # ---- 10b: TF32 asked for by the caller --------------------------------
    st = build_frame(10, 10, cfg, device="cuda")
    I = healthy_I(torch, gen, FRAME_LANES, st.num_elems, cfg.I0, dev)
    prev = torch.get_float32_matmul_precision()
    outs = {}
    try:
        for prec in ("highest", "high"):
            torch.set_float32_matmul_precision(prec)
            outs[prec] = []
            for method in ("banded", "dense"):
                Iv = I.clone().requires_grad_(True)
                sol = solve_frame(Iv, st, cfg, method=method)
                (sol.displacements ** 2).sum().backward()
                outs[prec].append((sol, Iv.grad))
            if torch.get_float32_matmul_precision() != prec:
                raise AssertionError("the frame path changed the caller's "
                                     "float32 matmul precision")
    finally:
        torch.set_float32_matmul_precision(prev)
    for (a, ga), (b, gb) in zip(outs["highest"], outs["high"]):
        if not (same_bits(torch, a, b) and torch.equal(ga, gb)):
            raise AssertionError("TF32 set by the caller changed the frame "
                                 "solve's bits")
    log("phase 10b: with torch.set_float32_matmul_precision('high') set by "
        "the caller, the 10x10 banded and dense solves and their gradients "
        "give the bits of 'highest' (the frame path turns TF32 off for its "
        "own calls and restores the caller's setting)")

    # ---- 10c: the batched optimizer under the reference budget ------------
    log(f"phase 10c: optimize_frame_batched, B = {FRAME_LANES}, FrameConfig() "
        f"(max_epochs {cfg.max_epochs}, tolerance {cfg.tolerance}, patience "
        f"{cfg.patience}), float32")
    for nb, ns in FRAME_TIMED:
        st = build_frame(nb, ns, cfg, device="cuda")
        udl, lat = sample_frame_loads(gen, FRAME_LANES, cfg, device="cuda")
        fixed = dataclasses.replace(cfg, max_epochs=FRAME_FIXED_EPOCHS,
                                    tolerance=-1.0)
        rates = []
        for method in ("dense", "banded"):
            optimize_frame_batched(st, udl, lat, dataclasses.replace(
                fixed, max_epochs=2), method=method)      # warm-up
            _, t = wall_s(torch, lambda: optimize_frame_batched(
                st, udl, lat, fixed, method=method))
            rates.append(FRAME_LANES * FRAME_FIXED_EPOCHS / t)
        prof, wall = profiled(torch, lambda: optimize_frame_batched(
            st, udl, lat, dataclasses.replace(fixed, max_epochs=8)))
        ev = prof.key_averages()
        launches = sum(e.count for e in ev if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == DeviceType.CUDA) * 1e-6
        log(f"  {nb}x{ns}: {FRAME_FIXED_EPOCHS} epochs, every lane running: "
            f"dense {rates[0]:.4g} it/s ({rates[0] / 5000:.4g} frames/s), "
            f"banded {rates[1]:.4g} it/s ({rates[1] / 5000:.4g} frames/s) | "
            f"one banded epoch: {launches / 8:.0f} kernel launches, "
            f"{1e3 * wall / 8:.2f} ms wall under the profiler, device busy "
            + (f"{busy / wall:.1%}" if busy > 0 else "not measured"))
    for nb, ns, mode in FRAME_OPT_RUNS:
        st = build_frame(nb, ns, cfg, device="cuda")
        udl, lat = sample_frame_loads(gen, FRAME_LANES, cfg, device="cuda")
        res, t = wall_s(torch, lambda: optimize_frame_batched(
            st, udl, lat, cfg, grad_mode=mode))
        n = res.n_epochs.cpu().numpy()
        I0 = torch.full((FRAME_LANES, st.num_elems), cfg.I0, device=dev)
        with torch.no_grad():
            loss0 = frame_loss(I0, solve_frame(I0, st, cfg, udl=udl,
                                               lateral_load=lat), cfg).total
        pivot = frame_min_pivot(res.I, st, cfg)
        valid = (torch.isfinite(res.I).all(1) & (pivot > FRAME_VALID_PIVOT))
        if not (bool(torch.isfinite(res.I).all())
                and bool((res.I >= 1e-8).all())
                and bool((res.loss.total < loss0).all())):
            raise AssertionError(f"{nb}x{ns} {mode}: I not finite or below "
                                 "the clamp, or a lane's loss did not drop")
        # it/s: lanes x the loop's epochs / s (every lane occupies the batch
        # until the last stops); frames/s = it/s / 5000 (BENCHMARKS.md)
        its = float(n.max()) * FRAME_LANES / t
        line = (f"  {nb}x{ns} {mode}: {t:.2f} s | epochs median "
                f"{int(np.median(n))} max {int(n.max())}, "
                f"{int((n < cfg.max_epochs).sum())} of {FRAME_LANES} lanes "
                f"stopped early | {its:.4g} it/s, {its / 5000:.4g} frames/s, "
                f"{1e3 * t / float(n.max()):.2f} ms an epoch | loss "
                f"{float(loss0.median()):.4g} -> "
                f"{float(res.loss.total.median()):.4g} (medians) | valid "
                f"{int(valid.sum())}/{FRAME_LANES}, pivots "
                f"{float(pivot.min()):.3f}-{float(pivot.max()):.3f}")
        if (nb, ns, mode) in FRAME_REPEATED:
            cut = dataclasses.replace(cfg, max_epochs=FRAME_REPEAT_EPOCHS)
            a, b = (optimize_frame_batched(st, udl, lat, cut, grad_mode=mode)
                    for _ in range(2))
            if not same_bits(torch, a, b):
                raise AssertionError(f"{nb}x{ns} {mode}: two calls differ")
            line += (f" | two calls cut to {FRAME_REPEAT_EPOCHS} epochs: "
                     "the same bits")
        log(line)

    # ---- 10d: mixed-topology datagen --------------------------------------
    dcfg = dataclasses.replace(cfg, max_epochs=FRAME_DATA_EPOCHS)
    log(f"phase 10d: generate_frame_dataset over 1-10 bays x 1-10 stories, "
        f"{FRAME_DATA_SAMPLES} samples, min_bucket 8; cut: max_epochs "
        f"{cfg.max_epochs} -> {FRAME_DATA_EPOCHS} (10c runs the full budget)")
    data_f, t = wall_s(torch, lambda: generate_frame_dataset(
        seed + 110, FRAME_DATA_SAMPLES, dcfg, device="cuda"))
    rows = len(data_f["I_values"])
    topos = sorted(set(zip(data_f["num_bays"], data_f["num_stories"])))
    for i in range(rows):
        b, s_ = data_f["num_bays"][i], data_f["num_stories"][i]
        ne = s_ * (b + 1) + s_ * b
        if not (len(data_f["I_values"][i]) == ne
                and len(data_f["axial_forces"][i]) == ne
                and len(data_f["bending_moments"][i]) == ne
                and len(data_f["displacements"][i]) == (b + 1) * (s_ + 1)
                and np.isfinite(data_f["I_values"][i]).all()):
            raise AssertionError(f"row {i} ({b}x{s_}): lengths or values off")
    widths = {len(r) for r in data_f["I_values"]}
    if not (rows <= FRAME_DATA_SAMPLES and len(widths) > 1
            and all(1 <= b <= 10 and 1 <= s_ <= 10 for b, s_ in topos)):
        raise AssertionError(f"{rows} rows, widths {sorted(widths)}")
    log(f"  {rows} valid rows of {FRAME_DATA_SAMPLES} samples over "
        f"{len(topos)} topologies in {t:.2f} s: {rows / t:.1f} valid rows/s | "
        f"{len(widths)} row widths (ragged), every row's lengths its "
        "topology's, no padding lane")

    # ---- 10e: the checked solve -------------------------------------------
    frame_checked(torch, gen, cfg)

    launches, plain = read_counts(*mods)
    if any(launches.values()) or any(plain.values()):
        raise AssertionError(f"a beam kernel ran on the frame path: "
                             f"{launches} {plain}")

    # ---- 10f: fit's resume on phase 8's columns ---------------------------
    spec = FAMILIES["fnn"]
    ds = prepare_dataset(data, n_cases=spec.train.n_cases, c=spec.train.c)
    fcfg = dataclasses.replace(spec.train, num_epochs=RESUME_EPOCHS)
    ck = REPO / ".smoke_tmp" / "resume"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        def run(c, **kw):
            model, _, fit_kwargs = build_family("fnn", ds.feat_dim,
                                                label_dim=ds.label_dim)
            return fit(model, ds.X_train, ds.Y_train, ds.X_val, ds.Y_val, c,
                       epochs_per_sync=2, device="cuda", **fit_kwargs, **kw)

        full, t_full = wall_s(torch, lambda: run(fcfg))
        run(dataclasses.replace(fcfg, num_epochs=RESUME_EPOCHS // 2),
            checkpoint_dir=str(ck))
        resumed, t_res = wall_s(torch, lambda: run(fcfg,
                                                   resume_from=str(ck)))
    finally:
        shutil.rmtree(REPO / ".smoke_tmp", ignore_errors=True)
    if not (np.array_equal(full.train_losses, resumed.train_losses)
            and np.array_equal(full.val_losses, resumed.val_losses)
            and full.best_epoch == resumed.best_epoch
            and all(torch.equal(v, resumed.params["model"][k])
                    for k, v in full.params["model"].items())
            and torch.equal(full.params["alpha"], resumed.params["alpha"])):
        raise AssertionError("the resumed fit differs from the "
                             "uninterrupted one")
    log(f"phase 10f: the FNN on phase 8's columns ({ds.X_train.shape[0]} "
        f"train groups), {RESUME_EPOCHS} epochs uninterrupted ({t_full:.2f} "
        f"s) vs killed at {RESUME_EPOCHS // 2} with checkpoint_dir and "
        f"resumed ({t_res:.2f} s for the rest): losses, best epoch "
        f"{full.best_epoch} and best params bitwise equal")


def trace_kernels(path):
    """{name: count} of the device kernels in a Chrome trace JSON."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    counts = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def cli_path(torch, seed, mods):
    """Phase 11: every subcommand of ``python -m openpystruct_tpu_torch`` on
    the card, in this process, with the kernels' launches counted per call;
    then ``predict`` through the module entry in a subprocess.  Returns the
    launches summed over the calls."""
    import os

    import numpy as np

    from openpystruct_tpu_torch import cli
    from openpystruct_tpu_torch.datagen import SCHEMA_KEYS, read_json_dataset
    from openpystruct_tpu_torch.utils.tb_writer import read_scalars

    d = REPO / ".smoke_tmp" / "cli"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    total = {}

    def step(name, argv, want=()):
        """One ``cli.main(argv)`` call with the counters set to 0 just
        before it and read just after it."""
        reset_counts(*mods)
        t0 = time.perf_counter()
        out = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launches, plain = read_counts(*mods)
        missing = [k for k in want if launches[k] == 0]
        if missing or any(plain.values()):
            raise AssertionError(f"phase 11 {name}: not launched {missing}, "
                                 f"plain calls {plain}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"phase 11 {name}: {t:.2f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        return out, t

    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    log("phase 11: the command line on the card, cli.main in this process"
        + ("" if plots else "; matplotlib is absent: --watch and --plot "
           "not run (host plotting, not device work)"))

    # ---- datagen: the fixed bridge to JSON, the random bridge by shards --
    fixed = d / "fixed.json"
    n, t = step("datagen", ["datagen", "--num-samples", CLI_SAMPLES,
                            "--batch-size", CLI_SAMPLES, "--seed", seed + 110,
                            "--output", fixed],
                want=("beam_analysis", "beam_opt_step"))
    back = read_json_dataset(str(fixed))
    if tuple(back) != SCHEMA_KEYS or any(len(v) != n for v in back.values()):
        raise AssertionError(f"datagen's file: {list(back)} rows "
                             f"{[len(v) for v in back.values()]} of {n}")
    log(f"  {n} valid of {CLI_SAMPLES} ({n / t:.1f} valid samples/s with "
        "the JSON), read back natively with the 13 keys")
    n_rb, t = step("datagen --random-bridge",
                   ["datagen", "--random-bridge", "--num-samples",
                    CLI_RB_SAMPLES, "--seed", seed + 111, "--shard-dir",
                    d / "shards", "--output", d / "rb.json"],
                   want=DATAGEN_KERNELS)
    log(f"  {n_rb} valid of {CLI_RB_SAMPLES} ({n_rb / t:.1f} valid "
        "samples/s through the shards)")

    # ---- train with every observability flag, then predict ---------------
    ck = d / "tfd.pt"
    flags = ["--checkpoint", ck, "--metrics-jsonl", d / "m.jsonl",
             "--tensorboard", d / "tb", "--profile", d / "prof"]
    if plots:
        flags += ["--watch", d / "watch.png", "--plot", d / "loss.png"]
    (res, r2), t = step("train", ["train", "--model", "tfd", "--data", fixed,
                                  "--epochs", CLI_EPOCHS, "--seed", seed,
                                  *flags])
    ep = len(res.train_losses)
    lines = [json.loads(x) for x in (d / "m.jsonl").read_text().splitlines()]
    (events,) = (d / "tb").iterdir()
    scalars = read_scalars(str(events))     # raises on a bad CRC
    want_sc = [(e + 1, k, float(np.float32(v))) for e in range(ep)
               for k, v in (("train_loss", res.train_losses[e]),
                            ("val_loss", res.val_losses[e]))]
    (trace,) = (d / "prof").iterdir()
    kern = trace_kernels(trace)
    if not (ep == CLI_EPOCHS and [x["step"] for x in lines]
            == list(range(1, ep + 1)) and scalars == want_sc and kern
            and math.isfinite(r2)):
        raise AssertionError(f"train: {ep} epochs, {len(lines)} JSONL "
                             f"entries, {len(scalars)} scalars, "
                             f"{len(kern)} kernels in the trace, R^2 {r2}")
    if plots and not all((d / f).stat().st_size > 1000
                         for f in ("watch.png", "loss.png")):
        raise AssertionError("train: --watch or --plot wrote no PNG")
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {ep} epochs, R^2 {r2:.4f}; {len(lines)} JSONL entries; "
        f"{len(scalars)} TensorBoard scalars, CRCs good, equal to the "
        f"losses; trace {trace.stat().st_size / 2**20:.1f} MiB with "
        f"{sum(kern.values())} kernel events of {len(kern)} kernels, most "
        f"launched: " + "; ".join(f"{c}x {k[:50]}" for k, c in top))
    pred, _ = step("predict", ["predict", "--model", "tfd", "--checkpoint",
                               ck, "--preproc", f"{ck}_preproc.npz",
                               "--seed", seed])
    if not (pred.shape == (len(back["I_values"][0]),)
            and np.isfinite(pred).all()):
        raise AssertionError(f"predict: {pred.shape}, finite "
                             f"{np.isfinite(pred).all()}")
    log(f"  predict: {pred.shape[0]} finite values, I in "
        f"[{pred.min():.4g}, {pred.max():.4g}] m^4")

    # ---- the two optimizers ----------------------------------------------
    hist, t = step("beam-opt", ["beam-opt", "--seed", seed])
    if not (np.isfinite(hist).all() and hist[-1, 0] < hist[0, 0]):
        raise AssertionError(f"beam-opt: loss {hist[0, 0]} -> {hist[-1, 0]}")
    log(f"  {len(hist)} epochs, {len(hist) / t:.1f} epochs/s, total loss "
        f"{hist[0, 0]:.4f} -> {hist[-1, 0]:.4f}")
    batch, t = step("frame-opt", ["frame-opt", "--bays", 3, "--stories", 3,
                                  "--batch", FRAME_LANES, "--epochs",
                                  FRAME_FIXED_EPOCHS, "--seed", seed])
    valid = int(batch.valid.sum())
    if not valid or not batch.result.I.is_cuda:
        raise AssertionError(f"frame-opt: {valid} valid lanes")
    log(f"  {valid} of {FRAME_LANES} valid, "
        f"{FRAME_LANES * FRAME_FIXED_EPOCHS / t:.0f} lane-epochs/s")

    # ---- bench under the profiler ----------------------------------------
    out, t = step("bench --profile", ["bench", "--profile",
                                      d / "bench_prof"],
                  want=("beam_analysis", "beam_opt_step"))
    names = [x["metric"] for x in out]
    (btrace,) = (d / "bench_prof").iterdir()
    with open(btrace, "rb") as fh:
        raw = fh.read()
    named = {k: raw.count(k.encode()) for k in ("beam_analysis_kernel",
                                                "beam_opt_step_kernel")}
    if names != ["BeamOpt iters/sec", "surrogate samples/sec/chip",
                 "batched beam FEA solves/sec"] or not all(named.values()) \
            or not all(math.isfinite(x["value"]) and x["value"] > 0
                       for x in out):
        raise AssertionError(f"bench: {out}, trace names {named}")
    log(f"  bench: " + "; ".join(f"{x['metric']} {x['value']}" for x in out)
        + f" | trace {len(raw) / 2**20:.1f} MiB naming {named}")

    # ---- the module entry --------------------------------------------------
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "openpystruct_tpu_torch", "predict",
         "--model", "tfd", "--checkpoint", str(ck), "--preproc",
         f"{ck}_preproc.npz", "--seed", str(seed)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "predicted I (m^4):" not in proc.stdout:
        raise AssertionError(f"python -m openpystruct_tpu_torch predict: rc "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    log(f"phase 11 python -m openpystruct_tpu_torch predict: rc 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    shutil.rmtree(d, ignore_errors=True)
    return total


def on_cpu(torch, obj):
    """``obj`` (a tensor, a dataclass of them, None) with every tensor on
    the host."""
    from openpystruct_tpu_torch.parallel.collectives import tree_map

    return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                    else x, obj)


@contextlib.contextmanager
def first_step_grads(harness):
    """While the block runs, record the gradients that the first optimizer
    step applies, after the ranks' all-reduce and before the clip (a list
    it yields, empty until that step)."""
    got, real = [], harness._Optimizer.step

    def step(self, sync=None):
        def record(grads):
            if sync is not None:
                sync(grads)
            if not got:
                got.append([g.detach().cpu().clone() for g in grads])
        real(self, record)

    harness._Optimizer.step = step
    try:
        yield got
    finally:
        harness._Optimizer.step = real


def grad_gap(torch, a, b):
    """||a - b|| / ||b|| over every tensor of two gradient lists."""
    a, b = (torch.cat([g.double().reshape(-1) for g in x]) for x in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@contextlib.contextmanager
def recorded_rescues(gen_mod):
    """While the block runs, record the float32 pass's rejected-lane mask of
    every batch ``generate._rescue_local`` is given (a list it yields)."""
    calls, real = [], gen_mod._rescue_local

    def rescue(batch, *a):
        calls.append((~batch.valid).cpu())
        return real(batch, *a)

    gen_mod._rescue_local = rescue
    try:
        yield calls
    finally:
        gen_mod._rescue_local = real


def dist_fnn_cfg():
    """Phase 12b's FNN training: the family's recipe, DIST_EPOCHS epochs,
    dropout 0 and float32 (the JAX multihost test's settings, so the
    one-rank fit is comparable)."""
    from openpystruct_tpu_torch.families import FAMILIES

    return dataclasses.replace(FAMILIES["fnn"].train, num_epochs=DIST_EPOCHS,
                               dropout_rate=0.0, compute_dtype="float32")


def dist_rank(rank, tmp, seed):
    """Phase 12b's rank (spawned, two gloo ranks on cuda:0): the random
    bridge's 2 x DIST_LANES lanes over the mesh with the launches counted,
    then the FNN's data-parallel fit on phase 8's columns, globally and per
    shard on unequal rows.  Writes its results to ``tmp/rank{rank}.pt``."""
    import numpy as np
    import torch

    from openpystruct_tpu_torch import parallel
    from openpystruct_tpu_torch.config import ScenarioConfig
    from openpystruct_tpu_torch.datagen import generate as gen_mod
    from openpystruct_tpu_torch.datagen import generate_batch
    from openpystruct_tpu_torch.ops import beam_kernel as tk
    from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
    from openpystruct_tpu_torch.ops import block_stream as tbs
    from openpystruct_tpu_torch.ops import block_stream_dd as tsd
    from openpystruct_tpu_torch.ops import block_tridiag as tbt
    from openpystruct_tpu_torch.train import fit, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = parallel.default_mesh(device="cuda:0")
    got = {"backend": torch.distributed.get_backend(mesh.group)}
    mods = (tk, tkd, tbt, tbs, tsd)
    reset_counts(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_rescues(gen_mod) as rescues:
        batch = generate_batch(torch.Generator().manual_seed(seed + 121),
                               2 * DIST_LANES,
                               ScenarioConfig(random_bridge=True), mesh=mesh)
    torch.cuda.synchronize()
    got["t_datagen"] = time.perf_counter() - t0
    got["launches"], got["plain"] = read_counts(*mods)
    got["batch"], got["rescues"] = on_cpu(torch, batch), rescues
    with np.load(Path(tmp) / "fnn.npz") as z:
        X, Y, Xv, Yv = (z[k] for k in ("X", "Y", "Xv", "Yv"))
    n = len(X)
    mine = slice(rank * n // 2, (rank + 1) * n // 2)
    # unequal rows, as tests/multihost_worker.py splits them
    split = n // 2 + 2
    uneven = slice(0, split) if rank == 0 else slice(split, n)
    cfg = dist_fnn_cfg()
    for key, rows, kw in (("fit", mine, {}),
                          ("per_shard", uneven,
                           {"shuffle_scope": "per_shard"})):
        t0 = time.perf_counter()
        with first_step_grads(harness) as grads:
            res = fit(dist_fnn(torch, cfg, X.shape[-1], Y.shape[-1]),
                      X[rows], Y[rows], Xv, Yv, cfg, mesh=mesh, **kw)
        torch.cuda.synchronize()
        got[f"t_{key}"] = time.perf_counter() - t0
        got[f"grads_{key}"] = grads[0]
        got[key] = dict(train=res.train_losses, val=res.val_losses,
                        step=res.state["step"],
                        params={k: v.cpu() for k, v in
                                res.params["model"].items()})
    torch.save(got, Path(tmp) / f"rank{rank}.pt")


def dist_fnn(torch, cfg, feat, label):
    """The FNN family's model at its published widths (``build_family``'s),
    with ``cfg``'s dropout and dtype."""
    from openpystruct_tpu_torch.models import FNNWithResidual

    return FNNWithResidual(input_dim=cfg.n_cases * feat,
                           hidden_dim=cfg.hidden_units, num_blocks=4,
                           output_dim=label, dropout_rate=cfg.dropout_rate,
                           dtype=getattr(torch, cfg.compute_dtype))


def distribution(torch, seed, mods, ds7, file_data):
    """Phase 12: distribution.  12a: a NCCL group of size 1 in this process
    on cuda:0, ``generate_batch(mesh=)`` and a TFD ``fit(mesh=)`` on phase
    7's features bitwise their runs without a mesh, ``all_processes_min_max``
    on the card.  12b: two gloo ranks spawned on cuda:0, the random bridge's
    gathered rows bitwise the one-rank batch with #1, #2, #7 and #8 launched
    on each rank and each rank rescuing only its own lanes; the FNN's
    data-parallel fit on phase 8's columns, both ranks bitwise identical and
    within rtol 1e-4 of the one-rank fit, and per shard on unequal rows.
    12c: ``datagen --mesh`` and ``train --mesh`` under torchrun.  Returns
    (12a's launches of the mesh runs, 12b's per-rank launches)."""
    import os

    import numpy as np
    import torch.distributed as dist

    from openpystruct_tpu_torch import parallel
    from openpystruct_tpu_torch.config import ScenarioConfig
    from openpystruct_tpu_torch.data import prepare_dataset
    from openpystruct_tpu_torch.datagen import SCHEMA_KEYS, generate_batch
    from openpystruct_tpu_torch.datagen import generate as gen_mod
    from openpystruct_tpu_torch.datagen import read_json_dataset
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.train import fit, harness

    tmp = REPO / ".smoke_tmp" / "dist"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    launches_a = {}
    try:
        # ---- 12a: a NCCL group of size 1 ---------------------------------
        t0 = time.perf_counter()
        parallel.initialize_multihost(init_method=f"file://{tmp / 'nccl'}",
                                      world_size=1, rank=0, device="cuda:0")
        mesh = parallel.default_mesh()
        backend = dist.get_backend(mesh.group)
        if backend != "nccl" or mesh.device != torch.device("cuda", 0):
            raise AssertionError(f"12a: {backend} on {mesh.device}")
        log(f"phase 12a: a {backend} group of size {mesh.world_size} on "
            f"{mesh.device}, mesh {mesh.shape}")
        gen = lambda: torch.Generator().manual_seed(seed + 120)  # noqa: E731
        plain = generate_batch(gen(), BATCH, device="cuda")
        reset_counts(*mods)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        meshed = generate_batch(gen(), BATCH, mesh=mesh)
        torch.cuda.synchronize()
        t_mesh = time.perf_counter() - t1
        launches, plain_calls = read_counts(*mods)
        for k, v in launches.items():
            launches_a[k] = launches_a.get(k, 0) + v
        if not (same_bits(torch, meshed, plain) and launches["beam_analysis"]
                and launches["beam_opt_step"]) or any(plain_calls.values()):
            raise AssertionError(f"12a datagen: bitwise "
                                 f"{same_bits(torch, meshed, plain)}, "
                                 f"launches {launches}, plain {plain_calls}")
        log(f"  generate_batch(mesh=) on {BATCH} fixed-bridge lanes bitwise "
            f"generate_batch without a mesh ({int(meshed.valid.sum())} "
            f"valid), {t_mesh:.2f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        del plain, meshed
        # the random bridge on one rank: 12b's reference
        with recorded_rescues(gen_mod) as rescues:
            rb_one = on_cpu(torch, generate_batch(
                torch.Generator().manual_seed(seed + 121), 2 * DIST_LANES,
                ScenarioConfig(random_bridge=True), device="cuda"))
        cfg = dataclasses.replace(FAMILIES["tfd"].train,
                                  num_epochs=DIST_EPOCHS)
        res = []
        for m in (None, mesh):
            model, _, kw = build_family("tfd", ds7.feat_dim)
            t1 = time.perf_counter()
            res.append(fit(model, ds7.X_train, ds7.Y_train, ds7.X_val,
                           ds7.Y_val, cfg, epochs_per_sync=DIST_EPOCHS,
                           device="cuda", mesh=m, **kw))
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t1
        a, b = res
        same = (np.array_equal(a.train_losses, b.train_losses)
                and np.array_equal(a.val_losses, b.val_losses)
                and all(torch.equal(a.params["model"][k], b.params["model"][k])
                        for k in a.params["model"])
                and torch.equal(a.params["alpha"], b.params["alpha"]))
        if not same:
            raise AssertionError(f"12a fit: {a.train_losses} vs "
                                 f"{b.train_losses}")
        log(f"  TFD fit(mesh=) on phase 7's {ds7.X_train.shape[0]} train "
            f"groups, {DIST_EPOCHS} epochs: bitwise fit without a mesh "
            f"(losses, {len(a.params['model'])} tensors, alpha); "
            f"{t_fit:.2f} s, train loss {b.train_losses[0]:.4f} -> "
            f"{b.train_losses[-1]:.4f}")
        x = torch.randn(4097, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
        lo, hi = parallel.all_processes_min_max(x)
        if not (lo.is_cuda and torch.equal(lo, x.min())
                and torch.equal(hi, x.max())):
            raise AssertionError(f"12a min/max: {lo}, {hi}")
        log(f"  all_processes_min_max on a CUDA tensor: ({float(lo):.6f}, "
            f"{float(hi):.6f}) on {lo.device}, its plain min and max")
        dist.destroy_process_group()
        log(f"phase 12a: {time.perf_counter() - t0:.1f} s")

        # ---- 12b: two gloo ranks on cuda:0 -------------------------------
        t0 = time.perf_counter()
        fspec = FAMILIES["fnn"].train
        ds8 = prepare_dataset(file_data, n_cases=fspec.n_cases, c=fspec.c)
        np.savez(tmp / "fnn.npz", X=ds8.X_train, Y=ds8.Y_train,
                 Xv=ds8.X_val, Yv=ds8.Y_val)
        parallel.spawn(dist_rank, 2, tmp / "gloo", args=(str(tmp), seed),
                       backend="gloo", device="cuda:0", timeout=600)
        t_spawn = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        bad = rescues[0]
        per_rank = []
        for r, got in enumerate(ranks):
            mine = bad[r * DIST_LANES:(r + 1) * DIST_LANES]
            want = [x for x in DATAGEN_KERNELS if not got["launches"][x]]
            ok = (got["backend"] == "gloo" and not want
                  and not any(got["plain"].values())
                  and same_bits(torch, got["batch"], rb_one)
                  and len(got["rescues"]) == 1
                  and torch.equal(got["rescues"][0], mine))
            if not ok:
                raise AssertionError(
                    f"12b rank {r}: {got['backend']}, not launched {want}, "
                    f"plain {got['plain']}, bitwise "
                    f"{same_bits(torch, got['batch'], rb_one)}, rescues "
                    f"{[int(c.sum()) for c in got['rescues']]} of "
                    f"{int(mine.sum())}")
            per_rank.append({k: v for k, v in got["launches"].items()})
            log(f"  rank {r}: random bridge {DIST_LANES} of "
                f"{2 * DIST_LANES} lanes in {got['t_datagen']:.2f} s, its "
                f"rescue took its {int(mine.sum())} rejected lanes of the "
                f"one-rank run's {int(bad.sum())}; launches "
                f"{ {k: v for k, v in got['launches'].items() if v} }")
        log(f"  gathered rows on both ranks bitwise the one-rank batch "
            f"({int(rb_one.valid.sum())} of {2 * DIST_LANES} valid)")
        fcfg = dist_fnn_cfg()
        with first_step_grads(harness) as one_grads:
            one = fit(dist_fnn(torch, fcfg, ds8.feat_dim, ds8.label_dim),
                      ds8.X_train, ds8.Y_train, ds8.X_val, ds8.Y_val, fcfg,
                      device="cuda")
        # the first step's synced gradient against the one-rank gradient
        # of the same global batch: a wrong scale or a misplaced row shows
        # here, where Adam and the clip would hide it from the losses
        g_gaps = [grad_gap(torch, got["grads_fit"], one_grads[0])
                  for got in ranks]
        f0, f1 = ranks[0]["fit"], ranks[1]["fit"]
        twins = (np.array_equal(f0["train"], f1["train"])
                 and np.array_equal(f0["val"], f1["val"])
                 and all(torch.equal(f0["params"][k], f1["params"][k])
                         for k in f0["params"]))
        gaps = {k: np.abs(f0[k] - getattr(one, f"{k}_losses"))
                / np.abs(getattr(one, f"{k}_losses")) for k in ("train", "val")}
        gap = max(float(g.max()) for g in gaps.values())
        p0, p1 = ranks[0]["per_shard"], ranks[1]["per_shard"]
        ps_twins = (np.array_equal(p0["train"], p1["train"])
                    and all(torch.equal(p0["params"][k], p1["params"][k])
                            for k in p0["params"]))
        if not (twins and gap <= 1e-4 and ps_twins
                and max(g_gaps) <= 1e-5
                and np.isfinite(p0["train"]).all()
                and f0["step"] == one.state["step"]):
            raise AssertionError(f"12b fit: twins {twins}, gap {gaps}, "
                                 f"first-step gradients {g_gaps}, per "
                                 f"shard twins {ps_twins} {p0['train']}, "
                                 f"steps {f0['step']} {one.state['step']}")
        log(f"  FNN fit(mesh=) on phase 8's columns ({len(ds8.X_train)} "
            f"train groups split over 2 ranks, {DIST_EPOCHS} epochs, "
            f"float32, dropout 0): ranks bitwise identical, losses within "
            f"{gap:.2e} relative of the one-rank fit's (rtol 1e-4; by epoch "
            f"train {np.array2string(gaps['train'], precision=2)}, val "
            f"{np.array2string(gaps['val'], precision=2)}); the first "
            f"step's synced gradient {max(g_gaps):.2e} relative (in norm) "
            f"of the one-rank gradient (bound 1e-5); "
            f"{ranks[0]['t_fit']:.2f} s on rank 0; per_shard on "
            f"{len(ds8.X_train) // 2 + 2} and "
            f"{len(ds8.X_train) - len(ds8.X_train) // 2 - 2} rows: finite, "
            f"ranks bitwise identical, train loss {p0['train'][0]:.4f} -> "
            f"{p0['train'][-1]:.4f}, {ranks[0]['t_per_shard']:.2f} s")
        log(f"phase 12b: {time.perf_counter() - t0:.1f} s (the two ranks "
            f"{t_spawn:.1f} s of it)")

        # ---- 12c: the command line under torchrun -------------------------
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(REPO))
        run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "openpystruct_tpu_torch"]
        out_json = tmp / "mesh.json"
        for argv, says in (
                (["datagen", "--mesh", "--num-samples", DIST_CLI_SAMPLES,
                  "--batch-size", DIST_CLI_SAMPLES, "--seed", seed + 122,
                  "--output", out_json], "valid samples ->"),
                (["train", "--mesh", "--model", "tfd", "--data", out_json,
                  "--epochs", DIST_EPOCHS, "--seed", seed],
                 "R² on Validation")):
            t1 = time.perf_counter()
            proc = subprocess.run(run + [str(a) for a in argv], cwd=REPO,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            said = [x for x in proc.stdout.splitlines() if says in x]
            if proc.returncode != 0 or len(said) != 1:
                raise AssertionError(f"12c {argv[0]}: rc {proc.returncode}: "
                                     f"{proc.stdout[-2000:]}"
                                     f"{proc.stderr[-3000:]}")
            log(f"  torchrun ... {argv[0]} --mesh: rc 0 in "
                f"{time.perf_counter() - t1:.2f} s | {said[0].strip()}")
        back = read_json_dataset(str(out_json))
        if tuple(back) != SCHEMA_KEYS or len(back["I_values"]) == 0:
            raise AssertionError(f"12c datagen's file: {list(back)}")
        log(f"  datagen's file: the 13 keys, {len(back['I_values'])} rows")
        log(f"phase 12c: {time.perf_counter() - t0:.1f} s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches_a, per_rank


def make_inputs(torch, sample_scenarios, constraint_mask, seed, B, device,
                cfg=None):
    gen = torch.Generator().manual_seed(seed)
    kw = {} if cfg is None else dict(cfg=cfg)
    sc = sample_scenarios(gen, B, device=device, dtype=torch.float32, **kw)
    nelem = sc.num_nodes - 1
    # I lognormal around 0.5 (bench.py's inputs); Adam moments of a few
    # epochs' scale
    I = torch.exp(torch.randn((B, nelem), generator=gen) * 0.3) * 0.5
    mu = torch.randn((B, nelem), generator=gen) * 0.1
    nu = torch.rand((B, nelem), generator=gen) * 1e-2 + 1e-4
    return dict(
        I=I.to(device), mu=mu.to(device), nu=nu.to(device),
        Le=torch.diff(sc.node_x, dim=-1),
        free=(~constraint_mask(sc)).to(torch.float32),
        loads=sc.point_loads, udl=sc.udl,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-3d only (a first check of a new kernel)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from openpystruct_tpu_torch.config import (
        DATAGEN_OPT,
        BeamConfig,
        ScenarioConfig,
    )
    from openpystruct_tpu_torch.datagen import (
        SCHEMA_KEYS,
        generate_batch,
        generate_dataset,
        read_json_dataset,
        run_batch,
        sample_scenarios,
        write_json_dataset,
    )
    from openpystruct_tpu_torch.datagen import generate as gen_mod
    from openpystruct_tpu_torch.fem import accuracy as tacc
    from openpystruct_tpu_torch.fem import solve_beam_checked
    from openpystruct_tpu_torch.fem.beam import (
        BeamScenario,
        assemble_beam_system,
        constraint_mask,
    )
    from openpystruct_tpu_torch.fem.solve import block_tridiag_matvec
    from openpystruct_tpu_torch.ops import _build
    from openpystruct_tpu_torch.ops import beam_kernel as tk
    from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
    from openpystruct_tpu_torch.ops import block_stream as tbs
    from openpystruct_tpu_torch.ops import block_stream_dd as tsd
    from openpystruct_tpu_torch.ops import block_tridiag as tbt
    from openpystruct_tpu_torch.opt.beam_opt import (
        _adam_scalars,
        optimize_beam_batched,
        optimize_beam_compact,
    )
    mods = (tk, tkd, tbt, tbs, tsd)

    # FEM math never runs in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: the card ------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"phase 1: card {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | device count {torch.cuda.device_count()}")

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(["beam_kernel", "block_tridiag", "block_resident",
                          "block_stream", "block_stream_dd", "beam_opt",
                          "beam_opt_dd"])
    log(f"phase 2: built {len(built)} libraries in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for info in built.values():
        log(f"  {Path(info['path']).name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())

    beam = BeamConfig(udl=-1000.0)
    E, A, G = beam.E, beam.A, beam.G
    refine = 1

    # ---- phase 3: kernels against their plain versions --------------------
    B = BATCH if not args.quick else min(BATCH, 2048)
    inputs = make_inputs(torch, sample_scenarios, constraint_mask, args.seed,
                         B, dev)
    n = inputs["I"].shape[1] + 1
    scalars = _adam_scalars(DATAGEN_OPT, 3, torch.float32)
    errs = check_kernels(torch, tk, inputs, scalars, E, A, G, refine)
    check_lane_state(torch, tk, inputs, scalars, E, A, G, refine,
                     DATAGEN_OPT.tolerance, DATAGEN_OPT.patience)

    # ---- phase 3b: the float64 rescue kernels against their plain versions
    rb_cfg = ScenarioConfig(random_bridge=True)
    rb_inputs = make_inputs(torch, sample_scenarios, constraint_mask,
                            args.seed + 3, B, dev, cfg=rb_cfg)
    qc = quasi_cantilever(torch, BeamScenario, constraint_mask,
                          torch.Generator().manual_seed(args.seed + 4), dev)
    errs.update(check_dd_kernels(
        torch, tk, tkd, {k: torch.cat([rb_inputs[k], qc[k]]) for k in qc},
        4, scalars, E, A, G))

    # ---- phase 3c: the split-path kernels against their plain versions ----
    errs_split = {}
    for n_s in SPLIT_NS:
        # the fixed bridge's roller tags need n >= 100
        for label, cfg_s in (("fixed bridge", ScenarioConfig()),
                             ("random bridge", rb_cfg))[n_s < 100:]:
            x = split_inputs(torch, sample_scenarios, constraint_mask,
                             assemble_beam_system, args.seed + 10 + n_s, B,
                             n_s, cfg_s, E, A, dev)
            gate = n_s == 101 and label == "fixed bridge"
            e = check_split_kernels(torch, tk, tbt, tbs, block_tridiag_matvec,
                                    assemble_beam_system, x, E, A, refine,
                                    f"{label}, B={B}, n={n_s}", gate,
                                    held3=(0.5, 0.99) if n_s < 100 else (
                                        0.5, 0.99, 1.0))
            errs_split[(n_s, label)] = e
            if gate:
                split101 = x
            del x
    errs.update(errs_split[(101, "fixed bridge")])

    # the wrappers phase 6 times and the calls they are held against:
    # phase 3's inputs for #1-#2, phase 3b's random-bridge lanes for #7-#8
    # and #9, phase 3c's fixed-bridge n = 101 systems for #3-#6
    ana_keys = ("I", "Le", "free", "loads", "udl")
    ana = [inputs[k] for k in ana_keys]
    opt = [inputs[k] for k in ("I", "mu", "nu", "Le", "free", "loads", "udl")]
    rb_ana = [rb_inputs[k] for k in ana_keys]
    rb_opt = [rb_inputs[k]
              for k in ("I", "mu", "nu", "Le", "free", "loads", "udl")]
    sys32 = split101["sys"]
    opt_kw = dict(grad_semi=True, refine=refine)
    # every kernel reads the callers' tensors as they lie
    cases = {
        "beam_analysis": dict(
            wrapper=lambda: tk.beam_analysis(*ana, E, A, refine),
            kernel=lambda: tk.launch_beam_analysis(*ana, E, A, refine),
            plain=lambda: tk.beam_analysis_reference(*ana, E, A, refine),
            kind="analysis"),
        "beam_opt_step": dict(
            wrapper=lambda: tk.beam_opt_step(*opt, *scalars, E, A, G,
                                             **opt_kw),
            kernel=lambda: tk.launch_beam_opt_step(*opt, *scalars, E, G,
                                                   **opt_kw),
            plain=lambda: tk.beam_opt_step_reference(*opt, *scalars, E, A,
                                                     G, **opt_kw),
            kind="semi"),
        # the rescue's kernels on random-bridge lanes (phase 3b's inputs)
        "beam_analysis_dd": dict(
            wrapper=lambda: tkd.beam_analysis_dd(*rb_ana, E, A),
            kernel=lambda: tkd.launch_beam_analysis_dd(*rb_ana, E, A),
            plain=lambda: tkd.beam_analysis_dd_reference(*rb_ana, E, A),
            kind="analysis_dd"),
        "beam_opt_step_dd": dict(
            wrapper=lambda: tkd.beam_opt_step_dd(*rb_opt, *scalars, E, A, G),
            kernel=lambda: tkd.launch_beam_opt_step_dd(*rb_opt, *scalars, E,
                                                       A, G),
            plain=lambda: tkd.beam_opt_step_dd_reference(*rb_opt, *scalars,
                                                         E, A, G),
            kind="opt_dd"),
    }
    # the split-path kernels on phase 3c's fixed-bridge n = 101 inputs
    sv = [split101[k] for k in ("I", "Le", "free", "rhs")]
    cases.update({
        "beam_solve": dict(
            wrapper=lambda: tk.beam_solve(*sv, E, A, refine),
            kernel=lambda: tk.launch_beam_solve(*sv, E, A, refine),
            plain=lambda: tk.beam_solve_reference(*sv, E, A, refine),
            kind="solve3"),
        # #4's wrapper is the call block_tridiag_solve makes when it
        # dispatches to #4
        "block_tridiag_solve": dict(
            wrapper=lambda: tbt.launch_thomas(
                *(x.contiguous() for x in sys32)),
            kernel=lambda: tbt.launch_thomas(*sys32),
            plain=lambda: tbt.thomas_reference(*sys32), kind="thomas"),
        "block_tridiag_solve_streamed": dict(
            wrapper=lambda: tbs.block_tridiag_solve_streamed(*sys32),
            kernel=lambda: tbs.launch_thomas_streamed(*sys32),
            plain=lambda: tbt.thomas_backward_reference(
                *tbt.thomas_forward_reference(*sys32)),
            kind="thomas"),
        "block_tridiag_solve_bidi": dict(
            wrapper=lambda: tbt.block_tridiag_solve(*sys32, bidi=True),
            kernel=lambda: tbt.launch_thomas_bidi(*sys32),
            plain=lambda: tbt.thomas_bidi_reference(*sys32), kind="thomas"),
    })
    # #9 on the float64 systems of phase 3b's random-bridge lanes, read as
    # they lie
    sys_dd = tsd.assemble_beam_system_dd(*(rb_inputs[k] for k in ana_keys),
                                         E, A)[:3]
    cases["solve_dd_streamed"] = dict(
        wrapper=lambda: tsd.solve_dd_streamed(*sys_dd),
        kernel=lambda: tsd.launch_thomas_streamed_dd(*sys_dd),
        plain=lambda: tsd.thomas_dd_reference(*sys_dd), kind="thomas_dd")

    # ---- phase 3c: what one call of each wrapper launches: its kernel
    # alone.  Traced before any longer profile (a trace after phase 4's
    # windows has shown no kernel at all).
    launched = {}
    for name, c in cases.items():
        launched[name] = device_kernels(torch, c["wrapper"])
        copies = [k for k in launched[name] if "at::" in k or "Copy" in k
                  or "Memcpy" in k or "Memset" in k]
        log(f"phase 3c: one {name} call launches "
            + ", ".join(f"{k[:60]} x{v}" for k, v in launched[name].items()))
        if copies or not launched[name]:
            raise AssertionError(f"{name}'s wrapper launched "
                                 f"{copies or 'nothing the profiler saw'}")
    # #5 is one launch: both chains, the meeting row and both back sweeps
    if (sum(launched["block_tridiag_solve_bidi"].values()) != 1
            or not all("bidi_kernel" in k
                       for k in launched["block_tridiag_solve_bidi"])):
        raise AssertionError("block_tridiag_solve(bidi=True) launched "
                             f"{launched['block_tridiag_solve_bidi']}, not "
                             "one bidi_kernel")
    # the fused float64 route: #9's two sweeps in their beam mode, nothing
    # else (no float64 assembly, no copy)
    fused_kernels = device_kernels(
        torch, lambda: tsd.solve_beam_dd_streamed(*rb_ana, E, A))
    log("phase 3c: one solve_beam_dd_streamed call launches "
        + ", ".join(f"{k[:60]} x{v}" for k, v in fused_kernels.items()))
    if (sum(fused_kernels.values()) != 2
            or not all("stream_dd_" in k and ", true>" in k
                       for k in fused_kernels)):
        raise AssertionError(f"the fused #9 route launched {fused_kernels}")

    # ---- phase 3d: the streamed float64 solve against its plain version --
    qc_piv = tkd.beam_analysis_dd(*(qc[k] for k in ana_keys), E, A)[3]
    rb_qc = [torch.cat([rb_inputs[k], qc[k]]) for k in ana_keys]
    errs["solve_dd_streamed"] = check_dd_streamed(
        torch, tsd, rb_qc, E, A, f"{B} random-bridge + 4 quasi-cantilever "
        "lanes, n=101", pivots_of=qc_piv)
    del rb_qc
    I_o, sc_o = overhang(torch, BeamScenario, DD_CHECK_N, B, args.seed + 12,
                         dev)
    errs_fine_dd = check_dd_streamed(
        torch, tsd, beam_args(torch, constraint_mask, I_o, sc_o), E, A,
        f"{B} span-scaled overhang lanes, n={DD_CHECK_N}")
    del I_o, sc_o
    if args.quick:
        log(f"quick check passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # ---- phase 4: the main path -------------------------------------------
    log(f"phase 4: generate_dataset(seed={args.seed}, {SAMPLES}, "
        f"batch_size={BATCH}) on {kind}")
    epochs, stamps, valid, lanes = [], [], 0, 0

    def on_batch(batch):
        nonlocal valid, lanes
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        res = batch.result
        epochs.append(res.n_epochs.double().mean().item())
        valid += int(batch.valid.sum())
        lanes += batch.valid.numel()
        # physics: no deflection at the pin and the rollers, u_x == 0
        defl = res.solution.deflections
        if not (defl[:, 0] == 0).all() or not (
                defl[batch.scenario.roller_mask] == 0).all():
            raise AssertionError("nonzero deflection at a support")
        if not (res.solution.displacements[..., 0] == 0).all():
            raise AssertionError("nonzero axial displacement")

    reset_counts(tk, tkd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols = generate_dataset(args.seed, SAMPLES, batch_size=BATCH,
                            device="cuda", on_batch=on_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts(tk, tkd)
    path_fb = dict(launches)
    log(f"  launches {launches} plain calls {plain}")
    # the default rescue is off for the fixed bridge at n = 101
    if not (launches["beam_analysis"] > 0 and launches["beam_opt_step"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    if any(v != 0 for v in plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    n_batches = -(-SAMPLES // BATCH)
    mean_epochs = statistics.fmean(epochs)
    log(f"  valid {valid}/{lanes} ({valid / lanes:.4f}) | mean epochs "
        f"{mean_epochs:.2f} | {lanes / wall:.1f} lanes/s, "
        f"{valid / wall:.1f} valid samples/s | wall {wall:.2f} s")
    log(f"  first batch program (sample + optimize + gate) "
        f"{stamps[0] - t0:.2f} s | last batch to columnar lists "
        f"{t0 + wall - stamps[-1]:.2f} s")
    if valid == 0 or len(cols["I_values"]) != valid:
        raise AssertionError("dataset rows do not match the valid lanes")
    profile_batch(torch, run_batch, sample_scenarios, args.seed + 2,
                  BATCH, beam, DATAGEN_OPT, refine)

    tmp = REPO / ".smoke_tmp"
    tmp.mkdir(exist_ok=True)
    try:
        path = tmp / "dataset.json"
        t0 = time.perf_counter()
        write_json_dataset(cols, str(path))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = read_json_dataset(str(path), native=False)
        t_read = time.perf_counter() - t0
        size_mb = path.stat().st_size / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if set(back) != set(SCHEMA_KEYS) or any(
            len(back[k]) != valid for k in SCHEMA_KEYS):
        raise AssertionError("JSON round trip lost keys or rows")
    if back["I_values"][0] != cols["I_values"][0] or any(
            len(r) != n - 1 for r in back["I_values"]):
        raise AssertionError("JSON round trip changed the I rows")
    log(f"  JSON {size_mb:.1f} MiB: write {t_write:.1f} s, read "
        f"{t_read:.1f} s, {len(SCHEMA_KEYS)} keys x {valid} rows")

    # ---- phase 4b: random-bridge datagen with the rescue on the card -------
    log(f"phase 4b: random-bridge generate_dataset(seed={args.seed}, "
        f"{SAMPLES}, batch_size={BATCH}), default rescue")
    rescues, batches = [], []
    reset_counts(tk, tkd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_rescues(torch, gen_mod, rescues):
        cols_rb = generate_dataset(args.seed, SAMPLES, batch_size=BATCH,
                                   scen_cfg=rb_cfg, device="cuda",
                                   on_batch=batches.append)
    torch.cuda.synchronize()
    wall_rb = time.perf_counter() - t0
    launches_rb, plain_rb = read_counts(tk, tkd)
    log(f"  launches {launches_rb} plain calls {plain_rb}")
    if not all(launches_rb[k] > 0 for k in DATAGEN_KERNELS):
        raise AssertionError(f"a kernel was not launched: {launches_rb}")
    if any(v != 0 for v in plain_rb.values()):
        raise AssertionError(f"a plain version ran: {plain_rb}")
    if [r["mode"] for r in rescues] != ["dd"] * len(batches):
        raise AssertionError(f"the rescue did not run on the card: {rescues}")
    lanes_rb = sum(b.valid.numel() for b in batches)
    valid_rb = sum(int(b.valid.sum()) for b in batches)
    rejected = sum(r["rejected"] for r in rescues)
    t_rescue = sum(r["seconds"] for r in rescues)
    # the same draws without the rescue: the float32 pass alone
    gen = torch.Generator().manual_seed(args.seed)
    firsts = [generate_batch(gen, b.valid.numel(), rb_cfg, rescue=False,
                             device="cuda") for b in batches]
    rescued = sum(check_rescued(torch, b, f) for b, f in zip(batches, firsts))
    log(f"  float32 pass rejected {rejected}/{lanes_rb} "
        f"({rejected / lanes_rb:.4f}); rescued {rescued} | rescue wall "
        f"{t_rescue:.2f} s (" + ", ".join(f"{r['seconds']:.2f}"
                                         for r in rescues) + ")")
    log(f"  valid {valid_rb}/{lanes_rb} ({valid_rb / lanes_rb:.4f}) | "
        f"{valid_rb / wall_rb:.1f} valid samples/s | wall {wall_rb:.2f} s")
    if valid_rb < 0.99 * lanes_rb:
        raise AssertionError(f"valid share {valid_rb / lanes_rb:.4f} < 0.99")
    if len(cols_rb["I_values"]) != valid_rb or len(set(cols_rb["L"])) < (
            0.99 * valid_rb):
        raise AssertionError("dataset rows or per-lane L do not match")

    # ---- phase 4c: a mesh finer than 101 nodes ---------------------------
    fine_cfg = ScenarioConfig(num_nodes=201)
    fine_inputs = make_inputs(torch, sample_scenarios, constraint_mask,
                              args.seed + 5, BATCH, dev, cfg=fine_cfg)
    errs_fine = check_kernels(torch, tk, fine_inputs, scalars, E, A, G,
                              refine, phase="phase 4c", same_masks=False)
    errs_fine.update(check_dd_kernels(torch, tk, tkd, fine_inputs, 0, scalars,
                                      E, A, G, phase="phase 4c"))
    del fine_inputs
    log(f"phase 4c: generate_batch({BATCH}, num_nodes=201), default rescue")
    rescues = []
    reset_counts(tk, tkd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_rescues(torch, gen_mod, rescues):
        fine = generate_batch(torch.Generator().manual_seed(args.seed),
                              BATCH, fine_cfg, device="cuda")
    torch.cuda.synchronize()
    wall_fine = time.perf_counter() - t0
    launches_fine, plain_fine = read_counts(tk, tkd)
    if (not all(launches_fine[k] > 0 for k in DATAGEN_KERNELS)
            or any(v != 0 for v in plain_fine.values())
            or [r["mode"] for r in rescues] != ["dd"]):
        raise AssertionError(f"n=201 did not run the kernels only: "
                             f"{launches_fine} {plain_fine} {rescues}")
    valid_fine = int(fine.valid.sum())
    check_supports(torch, fine, fine.valid)
    log(f"  float32 pass rejected {rescues[0]['rejected']}/{BATCH}; "
        f"valid {valid_fine}/{BATCH} ({valid_fine / BATCH:.4f}) | "
        f"wall {wall_fine:.2f} s, rescue {rescues[0]['seconds']:.2f} s | "
        f"mean epochs {fine.result.n_epochs.double().mean().item():.2f} | "
        f"launches {launches_fine}")
    if valid_fine < 0.99 * BATCH:
        raise AssertionError(f"n=201 valid share {valid_fine / BATCH:.4f} "
                             "< 0.99")

    # ---- phase 4d: the split path on the card ----------------------------
    # fixed bridge at n = 101 in both modes, then a 51-node random-bridge
    # mesh; each solve goes to the kernel block_tridiag.uses_streamed names
    # for its lane count (#4 or #6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    path_split, split_by_lanes = {}, {}
    for mode, cfg_d in (("semi", ScenarioConfig()),
                        ("adjoint", ScenarioConfig()),
                        ("semi", dataclasses.replace(rb_cfg, num_nodes=51))):
        split_sc = sample_scenarios(
            torch.Generator().manual_seed(args.seed + 6), BATCH, cfg_d,
            device="cuda", dtype=torch.float32)
        opt_m = dataclasses.replace(DATAGEN_OPT, grad_mode=mode)
        log(f"phase 4d: optimize_beam_compact({BATCH} "
            f"{'random-bridge' if cfg_d.random_bridge else 'fixed-bridge'} "
            f"lanes, n={cfg_d.num_nodes}, fused=False, grad_mode={mode!r}, "
            f"refine={refine})")
        reset_counts(*mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launches_by_lanes(tbt, tbs) as by_lanes:
            res = optimize_beam_compact(split_sc, beam, opt_m, refine=refine,
                                        fused=False)
            torch.cuda.synchronize()
        wall_split = time.perf_counter() - t0
        launches, plain = read_counts(*mods)
        solves = (launches["block_tridiag_solve"]
                  + launches["block_tridiag_solve_streamed"])
        log(f"  launches {launches} plain calls {plain}")
        log("  solves by lane count: " + ", ".join(
            f"{tag} {k} at {lanes}" for (tag, lanes), k in
            sorted(by_lanes.items(), key=lambda kv: (-kv[0][1], kv[0][0]))))
        if solves == 0 or any(v != 0 for v in plain.values()):
            raise AssertionError(f"the split path did not run the kernels "
                                 f"only: {launches} {plain}")
        wrong = [(tag, lanes) for tag, lanes in by_lanes
                 if (tag == "#6") != tbt.uses_streamed(cfg_d.num_nodes,
                                                       lanes, sms)]
        if wrong or sum(by_lanes.values()) != solves:
            raise AssertionError(f"solves not sent where uses_streamed "
                                 f"says: {wrong} of {by_lanes}")
        for (tag, lanes), k in by_lanes.items():
            key = f"{tag} n={cfg_d.num_nodes} B={lanes}"
            split_by_lanes[key] = split_by_lanes.get(key, 0) + k
        finite = torch.isfinite(res.I)
        if not (res.I[finite] >= DATAGEN_OPT.clamp_min).all():
            raise AssertionError("unclamped I on the split path")
        if not cfg_d.random_bridge and not finite.all():
            raise AssertionError("non-finite I on the fixed bridge")
        epochs_split = res.n_epochs.double()
        log(f"  {BATCH / wall_split:.1f} lanes/s, wall {wall_split:.2f} s | "
            f"mean epochs {epochs_split.mean().item():.2f}, max "
            f"{int(epochs_split.max())} | {solves} solves | finite I on "
            f"{int(finite.all(-1).sum())}/{BATCH} lanes")
        for k, v in launches.items():
            path_split[k] = path_split.get(k, 0) + v
        if mode == "semi" and cfg_d.num_nodes == 101:
            profile_split_window(torch, split_sc, beam, opt_m, refine)
            profile_split_window(torch, sample_scenarios(
                torch.Generator().manual_seed(args.seed + 6), PROFILE_BUCKET,
                cfg_d, device="cuda", dtype=torch.float32), beam, opt_m,
                refine)

    cut = dataclasses.replace(DATAGEN_OPT, max_epochs=SPLIT_CHECK_EPOCHS)
    gen = torch.Generator().manual_seed(args.seed + 8)
    sc = sample_scenarios(gen, CHECK_BATCH, device="cpu", dtype=torch.float64)
    for mode in ("semi", "adjoint"):
        log(f"phase 4d: split path on {CHECK_BATCH} lanes, {mode}: kernels, "
            f"plain f32, plain f64 (max_epochs cut from "
            f"{DATAGEN_OPT.max_epochs} to {SPLIT_CHECK_EPOCHS} for all three)")
        runs = {}
        for name, device, dtype in (("kernel", "cuda", torch.float32),
                                    ("plain32", "cpu", torch.float32),
                                    ("plain64", "cpu", torch.float64)):
            scen = sc.map(lambda x: (x.to(dtype) if x.is_floating_point()
                                     else x).to(device))
            t0 = time.perf_counter()
            res = optimize_beam_batched(
                scen, beam, dataclasses.replace(cut, grad_mode=mode),
                refine=refine, fused=False)
            runs[name] = (res.loss.total.double().cpu(),
                          res.n_epochs.double().cpu(),
                          time.perf_counter() - t0)
        truth = runs["plain64"][0]
        gaps = {k: ((runs[k][0] - truth).abs() / truth.abs()).median().item()
                for k in ("kernel", "plain32")}
        ep = {k: runs[k][1].mean().item() for k in runs}
        log(f"  median loss gap to f64: kernel {gaps['kernel']:.3e}, plain "
            f"f32 {gaps['plain32']:.3e} | mean epochs kernel "
            f"{ep['kernel']:.2f} plain32 {ep['plain32']:.2f} plain64 "
            f"{ep['plain64']:.2f} | "
            + ", ".join(f"{k} {runs[k][2]:.1f} s" for k in runs))
        if not gaps["kernel"] <= max(2.0 * gaps["plain32"], 1e-4):
            raise AssertionError(f"split-path loss gap ({mode}): {gaps}")
        if not abs(ep["kernel"] - ep["plain32"]) <= 0.05 * ep["plain32"]:
            raise AssertionError(f"split-path mean epochs differ: {ep}")

    log(f"phase 4d: gradient of beam_analysis on {BATCH} lanes (kernel #1 "
        "forward, #3 backward) vs the plain float32 and float64 routes")
    xg = make_inputs(torch, sample_scenarios, constraint_mask, args.seed + 9,
                     BATCH, dev)
    grads = {}
    for name, device, dtype in (("kernel", "cuda", torch.float32),
                                ("plain32", "cpu", torch.float32),
                                ("plain64", "cpu", torch.float64)):
        x = {k: v.to(device=device, dtype=dtype, copy=True)
             for k, v in xg.items()}
        I, loads, udl = (x[k].requires_grad_(True)
                         for k in ("I", "loads", "udl"))
        if name == "kernel":
            reset_counts(*mods)
        out = tk.beam_analysis(I, x["Le"], x["free"], loads, udl, E, A,
                               refine)
        grads[name] = torch.autograd.grad(analysis_loss(*out[:3]),
                                          (I, loads, udl))
        if name == "kernel":
            torch.cuda.synchronize()
            path_grad, plain = read_counts(*mods)
            if (path_grad["beam_analysis"] != 1 or path_grad["beam_solve"] != 1
                    or any(v != 0 for v in plain.values())):
                raise AssertionError(f"the gradient did not run kernels #1 "
                                     f"and #3 only: {path_grad} {plain}")
    truth = [g.to(dev) for g in grads["plain64"]]
    for nm, k, p, t in zip(("gI", "gloads", "gudl"), grads["kernel"],
                           grads["plain32"], truth):
        if nm == "gudl":
            k, p, t = k[:, None], p[:, None], t[:, None]
        hold(torch, nm, k, p.to(dev), t)
    del xg, grads, truth

    # the bidirectional experiment as a user calls it; the default route
    # (#6 at these n) is its yardstick
    path_bidi = 0
    for n_b in (101, DD_CHECK_N):
        sys_b = (split101 if n_b == 101 else split_inputs(
            torch, sample_scenarios, constraint_mask, assemble_beam_system,
            args.seed + 13, BATCH, n_b, ScenarioConfig(), E, A, dev))["sys"]
        log(f"phase 4d: block_tridiag_solve(bidi=True) on {BATCH} "
            f"fixed-bridge lanes, n={n_b}, vs the default route")
        reset_counts(*mods)
        torch.cuda.synchronize()
        x_b = tbt.block_tridiag_solve(*sys_b, bidi=True)
        torch.cuda.synchronize()
        launches, plain = read_counts(*mods)
        if (launches["block_tridiag_solve_bidi"] != 1
                or any(v != 0 for v in plain.values())):
            raise AssertionError(f"bidi=True did not run kernel #5 only: "
                                 f"{launches} {plain}")
        path_bidi += launches["block_tridiag_solve_bidi"]
        x_d = tbt.block_tridiag_solve(*sys_b)
        hold_backward(torch, "#5 x", backward_errors(
            torch, block_tridiag_matvec, *sys_b, x_b), backward_errors(
            torch, block_tridiag_matvec, *sys_b, x_d), versus="default route")
        del sys_b, x_b, x_d

    # ---- phase 4e: the accuracy autopilot ---------------------------------
    # the large-mesh case past DD_STREAM_FROM_N, at DD_CHECK_N or, past
    # that, at the smallest measured n at or above the threshold
    n_big = (DD_CHECK_N if tacc.DD_STREAM_FROM_N <= DD_CHECK_N else
             min(k for k in DD_ROUTE_NS if k >= tacc.DD_STREAM_FROM_N))
    path_checked = {}
    for label, n_c in (("random bridge", 101), ("fixed span", 201),
                       ("fixed span", 501), ("span-scaled overhang", n_big)):
        if label == "span-scaled overhang":
            I_c, sc_c = overhang(torch, BeamScenario, n_c, BATCH,
                                 args.seed + 14, dev)
        elif label == "random bridge":
            gen = torch.Generator().manual_seed(args.seed + 11)
            sc_c = sample_scenarios(gen, BATCH, rb_cfg, device=dev,
                                    dtype=torch.float32)
            I_c = (torch.exp(torch.randn((BATCH, n_c - 1), generator=gen)
                             * 0.3) * 0.5).to(dev)
        else:
            I_c, sc_c = fixed_span(torch, BeamScenario, n_c, BATCH,
                                   args.seed + n_c, dev)
        log(f"phase 4e: solve_beam_checked(tol={CHECKED_TOL:g}) on {BATCH} "
            f"{label} lanes, n={n_c}")
        reset_counts(*mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sol, info = solve_beam_checked(I_c, sc_c, E, A, tol=CHECKED_TOL)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        launches, plain = read_counts(*mods)
        used = info["used_dd"]
        if any(v != 0 for v in plain.values()):
            raise AssertionError(f"a plain version ran: {plain}")
        if not sol.deflections.is_cuda or not used.is_cuda:
            raise AssertionError("solve_beam_checked left the card")
        dd_kernel = ("solve_beam_dd_streamed"
                     if n_c >= tacc.DD_STREAM_FROM_N else "beam_analysis_dd")
        others = {"solve_beam_dd_streamed", "beam_analysis_dd",
                  "solve_dd_streamed"} - {dd_kernel}
        if (used.any() and launches[dd_kernel] == 0
                or any(launches[k] != 0 for k in others)):
            raise AssertionError(f"lanes escalated without {dd_kernel}, or "
                                 f"through {others}: {launches}")
        if label == "span-scaled overhang" and not used.any():
            raise AssertionError("the large mesh escalated no lane")
        for k, v in launches.items():
            path_checked[k] = path_checked.get(k, 0) + v
        # the plain float64 solve of the same inputs, on the card
        sc64 = sc_c.map(lambda t: t.double() if t.is_floating_point() else t)
        d64, u64, f64 = assemble_beam_system(I_c.double(), sc64, E, A)
        s64 = torch.rsqrt(torch.diagonal(d64, dim1=-2, dim2=-1))
        sys64 = (d64 * s64[..., :, None] * s64[..., None, :],
                 u64 * s64[..., :-1, :, None] * s64[..., 1:, None, :],
                 f64 * s64)
        del d64, u64
        truth = (tbt.thomas_reference(*sys64) * s64)[..., 1]
        err = lane_errors(torch, sol.deflections, truth)
        certified = (info["est"] <= CHECKED_TOL) & (
            ~used | (info["pivot"] > 1e-12))
        worst = err[certified].max().item() if certified.any() else 0.0
        log(f"  escalated {int(used.sum())}/{BATCH} | certified "
            f"{int(certified.sum())}/{BATCH}, worst certified deflection "
            f"error {worst:.3e} of the lane's scale (all lanes: p50 "
            f"{err.quantile(0.5).item():.3e}, max {err.max().item():.3e}) | "
            f"warnings {len(caught)} | wall {wall_c:.2f} s | launches "
            f"{launches}")
        for w in caught:
            log(f"  warning: {w.message}")
        if not worst <= CHECKED_TOL:
            raise AssertionError(f"a certified lane is {worst:.3e} off "
                                 "float64")
    if path_checked["beam_analysis_dd"] == 0:
        raise AssertionError("phase 4e escalated no lane through #7")
    del sys64, truth, sol

    # ---- phase 5: the whole optimizer, kernels vs plain -------------------
    log(f"phase 5: optimize_beam_batched on {CHECK_BATCH} lanes: "
        "kernels, plain f32, plain f64")
    gen = torch.Generator().manual_seed(args.seed + 1)
    sc = sample_scenarios(gen, CHECK_BATCH, device="cpu",
                          dtype=torch.float64)
    runs = {}
    for name, device, dtype in (("kernel", "cuda", torch.float32),
                                ("plain32", "cpu", torch.float32),
                                ("plain64", "cpu", torch.float64)):
        scen = sc.map(lambda x: (x.to(dtype) if x.is_floating_point() else x)
                      .to(device))
        t0 = time.perf_counter()
        res = optimize_beam_batched(scen, beam, DATAGEN_OPT, refine=refine)
        runs[name] = (res.loss.total.double().cpu(),
                      res.n_epochs.double().cpu(), time.perf_counter() - t0)
    truth = runs["plain64"][0]
    gaps = {k: ((runs[k][0] - truth).abs() / truth.abs()).median().item()
            for k in ("kernel", "plain32")}
    ep = {k: runs[k][1].mean().item() for k in runs}
    log(f"  median loss gap to f64: kernel {gaps['kernel']:.3e}, plain f32 "
        f"{gaps['plain32']:.3e} | mean epochs kernel {ep['kernel']:.2f} "
        f"plain32 {ep['plain32']:.2f} plain64 {ep['plain64']:.2f} | "
        + ", ".join(f"{k} {runs[k][2]:.1f} s" for k in runs))
    if not gaps["kernel"] <= max(2.0 * gaps["plain32"], 1e-4):
        raise AssertionError(f"loss gap: {gaps}")
    if not abs(ep["kernel"] - ep["plain32"]) <= 0.05 * ep["plain32"]:
        raise AssertionError(f"mean epochs differ: {ep}")

    # ---- phase 5b: the rescue in float64 kernels vs float64 on the host --
    opt100 = dataclasses.replace(DATAGEN_OPT, max_epochs=100)
    bad = torch.nonzero(~firsts[0].valid).flatten()[:RESCUE_CHECK]
    first = run_batch(firsts[0].scenario.map(lambda x: x[bad]), beam, opt100,
                      refine)
    log(f"phase 5b: rescue 'dd' vs 'f64' on {bad.numel()} rejected "
        f"random-bridge lanes ({int((~first.valid).sum())} rejected at "
        "max_epochs 100)")
    out, secs = {}, {}
    for mode in ("dd", "f64"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode] = gen_mod._rescue_local(first, beam, opt100, mode)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
    bd, bf = out["dd"], out["f64"]
    if not torch.equal(bd.valid, bf.valid):
        raise AssertionError("dd and f64 rescues keep different lanes")
    resc = bd.valid & ~first.valid
    if not torch.equal(bd.result.n_epochs[resc], bf.result.n_epochs[resc]):
        raise AssertionError("dd and f64 rescues stop at different epochs")
    I_d, I_f = bd.result.I[resc].double(), bf.result.I[resc].double()
    if not ((I_d - I_f).abs() <= 1e-7 + 1e-3 * I_f.abs()).all():
        raise AssertionError("dd and f64 rescues reach different I")
    d_gap = lane_errors(torch, bd.result.solution.deflections[resc],
                        bf.result.solution.deflections[resc].double())
    if not (d_gap < 1e-3).all():
        raise AssertionError("dd and f64 rescues reach other deflections")
    log(f"  valid masks equal ({int(bd.valid.sum())}/{bd.valid.numel()}); "
        f"{int(resc.sum())} rescued lanes, epochs equal | max I gap "
        f"{((I_d - I_f).abs() / I_f.abs()).max().item():.3e} rel | max "
        f"deflection gap {d_gap.max().item():.3e} of lane scale | dd "
        f"{secs['dd']:.2f} s, f64 {secs['f64']:.2f} s")

    # ---- phase 6: times -----------------------------------------------------
    log(f"phase 6: times at B={B}, n={n} (CUDA events, median)")
    counts_before = read_counts(*mods)[0]
    # launches on each kernel's main path: the fixed bridge (phase 4) for
    # #1-#2, the random bridge (phase 4b) for #7-#8, the gradient of the
    # analysis (4d) for #3, the split path (4d) and the autopilot (4e) for
    # #4 and #6, the bidi=True runs (4d) for #5, the autopilot's large
    # mesh (4e) for #9
    path_launches = dict(
        path_fb, beam_analysis_dd=launches_rb["beam_analysis_dd"],
        beam_opt_step_dd=launches_rb["beam_opt_step_dd"],
        beam_solve=path_grad["beam_solve"],
        block_tridiag_solve=(path_split["block_tridiag_solve"]
                             + path_checked["block_tridiag_solve"]),
        block_tridiag_solve_streamed=(
            path_split["block_tridiag_solve_streamed"]
            + path_checked["block_tridiag_solve_streamed"]),
        block_tridiag_solve_bidi=path_bidi,
        solve_dd_streamed=path_checked["solve_beam_dd_streamed"])
    for k in ("block_tridiag_solve", "block_tridiag_solve_streamed",
              "block_tridiag_solve_bidi", "solve_dd_streamed"):
        if path_launches[k] == 0:
            raise AssertionError(f"{k} was not launched on its path")
    errs_fine.update(errs_split[(201, "fixed bridge")])
    adjoint_ms = time_ms(torch, lambda: tk.launch_beam_opt_step(
        *opt, *scalars, E, G, grad_semi=False, refine=refine), 20)

    # the library yardsticks: one dense LU solve of the same systems, in
    # float32 for #3 (the masked K(I) and right-hand side it assembles),
    # #4, #5 and #6 (no TF32 in an LU), in float64 for #9
    sys_solve = (*assemble_beam_system(sv[0], split101["scenario"], E,
                                       A)[:2], sv[3] * sv[2])
    library = {}
    for kind_l, sys_l, plain_l in (
            ("solve3", sys_solve, lambda: tk.beam_solve_reference(
                *sv, E, A, refine)[0]),
            ("thomas", sys32, lambda: tbt.thomas_reference(*sys32)),
            ("thomas_dd", sys_dd, lambda: tsd.thomas_dd_reference(
                *sys_dd)[0])):
        K, rhs_d = dense_system(torch, *sys_l)
        Bd, nd = sys_l[0].shape[:2]
        x_dense = torch.linalg.solve(K, rhs_d).reshape(Bd, nd, 3)
        dense_gap = lane_errors(torch, plain_l(),
                                x_dense.double()).median().item()
        library[kind_l] = time_ms(torch, lambda: torch.linalg.solve(K, rhs_d),
                                  3, warmup=1)
        log(f"  library ({kind_l}): torch.linalg.solve on the dense ({Bd}, "
            f"{3 * nd}, {3 * nd}) {sys_l[0].dtype} systems "
            f"{library[kind_l]:.3f} ms (p50 per-lane gap to the plain "
            f"version {dense_gap:.2e})")
        del K, rhs_d, x_dense
        torch.cuda.empty_cache()
    del sys_solve

    kernels = []
    for name, c in cases.items():
        t_wrap = time_ms(torch, c["wrapper"], 20)
        t_kern = time_ms(torch, c["kernel"], 20)
        t_plain = time_ms(torch, c["plain"], 5, warmup=1)
        b_ms, b_by = bound_ms(B, n, refine, c["kind"])
        lib_ms = library.get(c["kind"])
        log(f"  {name}: wrapper {t_wrap:.3f} ms, kernel {t_kern:.3f} ms, no "
            f"layout copy | plain {t_plain:.3f} ms | bound "
            f"{1e3 * b_ms:.1f} us ({b_by}) | library "
            + (f"{lib_ms:.3f} ms" if lib_ms is not None else "none")
            + f" | {path_launches[name]} launches on its path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=path_launches[name],
            max_abs_err=errs[name]["abs"], ms=t_wrap, plain_ms=t_plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            kernel_only_ms=t_kern,
            wrapper_device_kernels=launched.get(name),
            # per-lane errors against float64, of the lane's scale, p99
            rel_err_p99=errs[name]["rel_p99"],
            plain32_rel_err_p99=errs[name]["plain32_rel_p99"],
            rel_err_p99_n201=finite_or_none(
                errs_fine.get(name, {}).get("rel_p99")),
            plain32_rel_err_p99_n201=finite_or_none(
                errs_fine.get(name, {}).get("plain32_rel_p99")),
        ))
        if name in SPLIT_KERNELS:
            kernels[-1]["backward_err_p99"] = {
                f"{lb}, n={n_s}": e[name]["backward_p99"]
                for (n_s, lb), e in errs_split.items() if name in e}
    kernels[1]["adjoint_kernel_only_ms"] = adjoint_ms
    kernels[1]["adjoint_bound_ms"] = bound_ms(B, n, refine, "adjoint")[0]
    log(f"  beam_opt_step adjoint: kernel {adjoint_ms:.3f} ms | bound "
        f"{1e3 * kernels[1]['adjoint_bound_ms']:.1f} us")
    log("  library_ms: no single PyTorch call computes #1-#2 or #7-#8")
    for k in kernels:
        if k["name"] == "solve_dd_streamed":
            k["rel_err_p99_n1001"] = errs_fine_dd["rel_p99"]
            k["fused_route"] = {
                f"{key}_{label}": e[key] for label, e in (
                    ("n101", errs["solve_dd_streamed"]),
                    (f"n{DD_CHECK_N}", errs_fine_dd))
                for key in ("fused_abs", "fused_rel_p99",
                            "fused_bitwise_lanes")}
        if k["name"] == "beam_solve":
            k["worst_lane_n51"] = errs_split[(51, "random bridge")][
                "beam_solve"].get("worst_lane")
    del sys_dd

    # #4, #6 and #5 in turns #4, #6, #5, #5, #6, #4 by mesh and lane count:
    # the launchers and the wrappers block_tridiag_solve reaches, #4's and
    # #6's x bitwise equal; #4 only where its resident set fits; #5 beside
    # the kernel uses_streamed picks
    log(f"phase 6: one-launch #4 vs streamed #6 vs bidirectional #5, n in "
        f"{TURN_NS}, lanes in {TURN_LANES} (kernel and wrapper ms, mean of "
        "two medians of 20)")
    turns_bt = {}
    for n_t in TURN_NS:
        # the fixed bridge's roller tags need n >= 100: the 51-node mesh
        # is phase 4d's random bridge (the kernels' work is data-blind)
        sf = split_inputs(torch, sample_scenarios, constraint_mask,
                          assemble_beam_system, args.seed + 20 + n_t,
                          max(TURN_LANES), n_t,
                          ScenarioConfig() if n_t >= 100 else rb_cfg, E, A,
                          dev)["sys"]
        if n_t == min(TURN_NS):
            # #4's library yardstick at the split path's smallest mesh
            K, rhs_d = dense_system(torch, *sf)
            lib_small = time_ms(torch, lambda: torch.linalg.solve(K, rhs_d),
                                3, warmup=1)
            log(f"  library at n={n_t}: torch.linalg.solve on the dense "
                f"{tuple(K.shape)} float32 systems {lib_small:.3f} ms")
            del K, rhs_d
            torch.cuda.empty_cache()
        for lanes in TURN_LANES:
            s_l = [x[:lanes] for x in sf]
            fits = tbt.resident_lanes(lanes, n_t) > 0
            x6 = tbs.launch_thomas_streamed(*s_l)
            if fits and not torch.equal(tbt.launch_thomas(*s_l), x6):
                raise AssertionError(f"#4 differs from #6 at {lanes} lanes, "
                                     f"n={n_t}")
            kern = (lambda: tbt.launch_thomas(*s_l),
                    lambda: tbs.launch_thomas_streamed(*s_l),
                    lambda: tbt.launch_thomas_bidi(*s_l))
            wrap = (lambda: tbt.launch_thomas(*(x.contiguous()
                                                 for x in s_l)),
                    lambda: tbs.block_tridiag_solve_streamed(*s_l),
                    lambda: tbt.block_tridiag_solve(*s_l, bidi=True))
            row = {}
            for what, fns in (("kernel", kern), ("wrapper", wrap)):
                t = [time_ms(torch, fns[j], 20) if fits or j else None
                     for j in (0, 1, 2, 2, 1, 0)]
                row[what] = ((t[0] + t[5]) / 2 if fits else None,
                             (t[1] + t[4]) / 2, (t[2] + t[3]) / 2)
            row["bound"] = bound_ms(lanes, n_t, 0, "thomas")[0]
            row["implied"] = ("#4" if fits and row["kernel"][0]
                              <= row["kernel"][1] else "#6")
            row["rule"] = "#6" if tbt.uses_streamed(n_t, lanes, sms) else "#4"
            row["lanes_per_block"] = tbt.resident_lanes(lanes, n_t)
            turns_bt[(n_t, lanes)] = row
            k4, k6, k5 = row["kernel"]
            w4, w6, w5 = row["wrapper"]
            j_rule = 1 if row["rule"] == "#6" else 0
            row["bidi_vs_rule"] = w5 / row["wrapper"][j_rule]
            log(f"  n={n_t} B={lanes}: #4 " + (
                f"{k4:.4f} ms (wrapper {w4:.4f}, {row['lanes_per_block']} "
                "lanes a block)" if fits else "does not fit")
                + f" | #6 {k6:.4f} ms (wrapper {w6:.4f}) | #5 {k5:.4f} ms "
                f"(wrapper {w5:.4f}, {row['bidi_vs_rule']:.3f}x "
                f"{row['rule']}'s) | bound {1e3 * row['bound']:.1f} us | "
                f"this run implies {row['implied']}, uses_streamed sends to "
                f"{row['rule']}"
                + ("" if row["implied"] == row["rule"] else "  <- differs"))
            del s_l, x6
        del sf
    differ = [k for k, r in turns_bt.items() if r["implied"] != r["rule"]]
    log(f"  dispatch: {len(turns_bt) - len(differ)} of {len(turns_bt)} cases "
        f"as uses_streamed rules; differs at (n, B) {differ}")
    faster5 = [k for k, r in turns_bt.items() if r["bidi_vs_rule"] < 1.0]
    log(f"  bidi=True's wrapper beats the default route's in "
        f"{len(faster5)} of {len(turns_bt)} cases: (n, B) {faster5}")
    turn_names = ("block_tridiag_solve", "block_tridiag_solve_streamed",
                  "block_tridiag_solve_bidi")
    for k in kernels:
        if k["name"] in turn_names:
            j = turn_names.index(k["name"])
            k["kernel_ms_by_n_and_lanes"] = {
                f"n={n_t} B={lanes}": r["kernel"][j]
                for (n_t, lanes), r in turns_bt.items()}
            k["wrapper_ms_by_n_and_lanes"] = {
                f"n={n_t} B={lanes}": r["wrapper"][j]
                for (n_t, lanes), r in turns_bt.items()}
            k[f"library_ms_n{min(TURN_NS)}"] = lib_small
            if j == 2:
                k["wrapper_vs_default_route_by_n_and_lanes"] = {
                    f"n={n_t} B={lanes}": r["bidi_vs_rule"]
                    for (n_t, lanes), r in turns_bt.items()}
                continue
            k["launches_by_lanes"] = {
                key[3:]: v for key, v in split_by_lanes.items()
                if key.startswith(("#4", "#6")[j])}

    # solve_beam_checked's escalation routes, each whole: the float64
    # analysis wrapper (#7) against the fused streamed route (#9); in turns
    # #7, #9, #9, #7, then each route's peak device memory over one call
    log(f"phase 6: escalation routes at B={BATCH} on fixed-span lanes, n in "
        f"{DD_ROUTE_NS}: beam_analysis_dd (#7) vs solve_beam_dd_streamed "
        "(#9, fused) (ms, mean of two medians of 5)")
    route, peak = {}, {}
    for n_r in DD_ROUTE_NS:
        args_r = beam_args(torch, constraint_mask, *fixed_span(
            torch, BeamScenario, n_r, BATCH, args.seed + 30 + n_r, dev))
        fns = (lambda: tkd.beam_analysis_dd(*args_r, E, A),
               lambda: tsd.solve_beam_dd_streamed(*args_r, E, A))
        turns = [time_ms(torch, fns[j], 5, warmup=1) for j in (0, 1, 1, 0)]
        route[n_r] = ((turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
        peak[n_r] = []
        for fn in fns:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[n_r].append((torch.cuda.max_memory_allocated() - base)
                             / 2**30)
        log(f"  n={n_r}: #7 route {route[n_r][0]:.3f} ms ({turns[0]:.3f}, "
            f"{turns[3]:.3f}) | #9 route {route[n_r][1]:.3f} ms "
            f"({turns[1]:.3f}, {turns[2]:.3f}) | #9/#7 "
            f"{route[n_r][1] / route[n_r][0]:.3f} | #9 route bound "
            f"{1e3 * bound_ms(BATCH, n_r, 0, 'route_dd')[0]:.1f} us | peak "
            f"device memory above the inputs #7 {peak[n_r][0]:.3f} GiB, #9 "
            f"{peak[n_r][1]:.3f} GiB")
        del args_r, fns
        torch.cuda.empty_cache()
    implied_dd = min((k for k in DD_ROUTE_NS if route[k][1] <= route[k][0]),
                     default=DD_ROUTE_DEFAULT)
    log(f"  DD_STREAM_FROM_N this run implies: {implied_dd}; "
        f"accuracy.DD_STREAM_FROM_N = {tacc.DD_STREAM_FROM_N}")
    route_names = ("beam_analysis_dd", "solve_dd_streamed")
    for k in kernels:
        if k["name"] in route_names:
            j = route_names.index(k["name"])
            k["route_ms_by_n"] = {str(n_r): v[j] for n_r, v in route.items()}
            k["route_peak_gib_by_n"] = {str(n_r): v[j]
                                        for n_r, v in peak.items()}
        if k["name"] == "solve_dd_streamed":
            k["route_bound_ms_by_n"] = {
                str(n_r): bound_ms(BATCH, n_r, 0, "route_dd")[0]
                for n_r in route}
    if read_counts(*mods)[0] == counts_before:
        raise AssertionError("timing loop launched nothing")

    # ---- phase 7: the training path on the card ---------------------------
    t0 = time.perf_counter()
    train_launches, train_ds = training_path(torch, args.seed, mods)
    for k in kernels:
        k["launches_training_path"] = train_launches[k["name"]]
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # ---- phase 8: the file-based workflow on the card ---------------------
    t0 = time.perf_counter()
    file_launches, file_data = file_workflow(torch, args.seed, mods)
    for k in kernels:
        k["launches_file_workflow"] = file_launches[k["name"]]
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    # ---- phase 9: the other surrogate families from phase 8's file -------
    t0 = time.perf_counter()
    surrogate_families(torch, file_data, args.seed)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # ---- phase 10: the frame path, and fit's resume on phase 8's file -----
    t0 = time.perf_counter()
    frame_path(torch, file_data, args.seed, mods)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # ---- phase 11: the command line on the card ---------------------------
    t0 = time.perf_counter()
    cli_launches = cli_path(torch, args.seed, mods)
    for k in kernels:
        k["launches_cli"] = cli_launches[k["name"]]
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- phase 12: distribution -------------------------------------------
    t0 = time.perf_counter()
    dist_launches, rank_launches = distribution(torch, args.seed, mods,
                                                train_ds, file_data)
    del train_ds, file_data
    for k in kernels:
        k["launches_distribution"] = dist_launches[k["name"]]
        k["launches_distribution_ranks"] = [r[k["name"]]
                                            for r in rank_launches]
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    log(f"done in {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
