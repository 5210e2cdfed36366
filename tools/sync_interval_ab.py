#!/usr/bin/env python3
"""Time one datagen batch program at several host-sync intervals.

    python3 tools/sync_interval_ab.py

The optimizer reads the per-lane done flags on the host every
``_SYNC_EVERY`` epochs (opt/beam_opt.py).  The results do not depend on the
interval (tests/test_torch_beam_opt.py); this script measures what each
interval costs in wall time on one CUDA card, in turns (1, 4, 16, 4, 1, ...).
"""

import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from openpystruct_tpu_torch.config import DATAGEN_OPT, BeamConfig  # noqa: E402
from openpystruct_tpu_torch.datagen import run_batch, sample_scenarios  # noqa: E402
from openpystruct_tpu_torch.opt import beam_opt  # noqa: E402


BATCH, SEED, REPS, INTERVALS = 16384, 3, 2, (1, 4, 16)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sc = sample_scenarios(torch.Generator().manual_seed(SEED), BATCH,
                          device="cuda")
    beam = BeamConfig(udl=-1000.0)
    run_batch(sc, beam, DATAGEN_OPT)          # build + warm up
    walls = {k: [] for k in INTERVALS}
    order = []
    for r in range(REPS):
        order += INTERVALS if r % 2 == 0 else INTERVALS[::-1]
    for k in order:
        beam_opt._SYNC_EVERY = k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = run_batch(sc, beam, DATAGEN_OPT)
        torch.cuda.synchronize()
        walls[k].append(time.perf_counter() - t0)
    print(f"{torch.cuda.get_device_name(0)}: batch {BATCH}, "
          f"{int(b.result.n_epochs.max())} epochs")
    for k in INTERVALS:
        print(f"  sync every {k:3d} epochs: wall median "
              f"{statistics.median(walls[k]):.3f} s  {walls[k]}")


if __name__ == "__main__":
    main()
