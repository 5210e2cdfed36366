#!/usr/bin/env python3
"""Time chip_smoke.py's phase 7 (the training path) in two checkouts, in
turns, on one CUDA card.

    python3 tools/training_path_ab.py --base DIR --change DIR [--reps 2]

Each run is a fresh process that builds the kernels of its checkout (cached
in that checkout's ``ops/_build/`` after its first run, and not timed), then
calls that checkout's ``chip_smoke.training_path`` and times it.  The runs
go base, change, change, base (``--reps 2``), so a drift of the host's speed
during the call falls on both sides alike.  Prints the card's name and power
limit, each run's phase 7 wall and the lines phase 7 logs, and the median
wall of each side.
"""

import argparse
import json
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from openpystruct_tpu_torch.ops import _build
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
from openpystruct_tpu_torch.ops import block_stream as tbs
from openpystruct_tpu_torch.ops import block_stream_dd as tsd
from openpystruct_tpu_torch.ops import block_tridiag as tbt
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["beam_kernel", "block_tridiag", "block_resident",
              "block_stream", "block_stream_dd", "beam_opt", "beam_opt_dd"])
torch.cuda.synchronize()
t0 = time.perf_counter()
cs.training_path(torch, 0, (tk, tkd, tbt, tbs, tsd))
torch.cuda.synchronize()
print(json.dumps({"phase7_s": time.perf_counter() - t0}))
"""


def run(root: str) -> tuple:
    p = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root,
                       capture_output=True, text=True, timeout=900)
    if p.returncode:
        sys.exit(f"{root}: exit {p.returncode}\n{p.stdout}\n{p.stderr}")
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-1])["phase7_s"], lines[:-1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip(), flush=True)
    sides = {"base": args.base, "change": args.change}
    order = []
    for r in range(args.reps):
        order += ["base", "change"] if r % 2 == 0 else ["change", "base"]
    walls = {k: [] for k in sides}
    for k in order:
        wall, lines = run(sides[k])
        walls[k].append(wall)
        print(f"{k}: phase 7 {wall:.2f} s", flush=True)
        for line in lines:
            if line.startswith("  "):
                print(f"  {k} |{line}", flush=True)
    for k in sides:
        print(f"{k}: median {statistics.median(walls[k]):.2f} s  {walls[k]}")


if __name__ == "__main__":
    main()
