#!/usr/bin/env python3
"""A/B the float32 block-Thomas kernels (#4 and #6) of two checkouts on one
CUDA card: are their outputs bitwise equal?

    python tools/block_tridiag_ab.py run --tree DIR --out FILE.json
    python tools/block_tridiag_ab.py compare A.json B.json

``run`` imports the PyTorch port and ``chip_smoke.py`` of the checkout at
DIR, builds its ``ops/csrc/block_tridiag.cu``, and solves chip_smoke.py
phase 3c's systems (fixed and random bridge at n = 101 and 201, 16384 lanes,
seed 0) with kernel #4 (``launch_thomas``) and kernel #6
(``block_tridiag_solve_streamed``).  It writes a SHA-256 of each output's
bytes, and each kernel's largest per-lane difference to the plain float32
version (``thomas_reference``) relative to the lane's largest |x|; the same
for #4 on the 300-lane systems of the checkout's
``tests/test_torch_cuda.py`` (``_systems`` with seeds 7 and 8, the bar of
its ``test_block_tridiag_kernels_unchanged_by_templating``).  ``compare``
exits 1 unless the two runs hashed the same outputs.  One process per
checkout: both trees hold a package of the same name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def run(tree: Path, out: Path, seed: int = 0, B: int = 16384) -> None:
    sys.path.insert(0, str(tree.resolve()))
    sys.path.insert(0, str(tree.resolve() / "tests"))
    import torch

    import chip_smoke as cs
    from openpystruct_tpu_torch.config import BeamConfig, ScenarioConfig
    from openpystruct_tpu_torch.datagen import sample_scenarios
    from openpystruct_tpu_torch.fem.beam import (
        assemble_beam_system,
        constraint_mask,
    )
    from openpystruct_tpu_torch.ops import block_stream as tbs
    from openpystruct_tpu_torch.ops import block_tridiag as tbt

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    beam = BeamConfig(udl=-1000.0)
    dev = torch.device("cuda")
    result = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    for n in (101, 201):
        for label, cfg in (("fixed bridge", ScenarioConfig()),
                           ("random bridge",
                            ScenarioConfig(random_bridge=True))):
            # phase 3c's inputs: its seed rule and its generator
            x = cs.split_inputs(torch, sample_scenarios, constraint_mask,
                                assemble_beam_system, seed + 10 + n, B, n,
                                cfg, beam.E, beam.A, dev)
            sys32 = x["sys"]
            outs = {
                "#4": tbt.lanes_first(tbt.launch_thomas(
                    *(tbt.lanes_last(t) for t in sys32))),
                "#6": tbs.block_tridiag_solve_streamed(*sys32),
            }
            plain = tbt.thomas_reference(*sys32)
            torch.cuda.synchronize()
            for tag, k in outs.items():
                diff = cs.lane_errors(torch, k, plain.double())
                result[f"{label}, n={n}, {tag}"] = dict(
                    sha256=hashlib.sha256(
                        k.cpu().numpy().tobytes()).hexdigest(),
                    max_rel_vs_plain32=diff.max().item())
            del x, sys32, outs, plain
    from test_torch_cuda import _lane_err, _systems

    for test_seed, cfg in ((7, ScenarioConfig()),
                           (8, ScenarioConfig(random_bridge=True))):
        x32 = _systems(300, test_seed, dev, torch.float32, cfg)
        k = tbt.lanes_first(tbt.launch_thomas(
            *(tbt.lanes_last(t) for t in x32)))
        plain = tbt.thomas_reference(*x32)
        torch.cuda.synchronize()
        result[f"card test systems, seed {test_seed}, #4"] = dict(
            sha256=hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest(),
            max_rel_vs_plain32=_lane_err(k, plain))
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def compare(a: Path, b: Path) -> int:
    ra, rb = (json.loads(p.read_text()) for p in (a, b))
    keys = [k for k in ra if isinstance(ra[k], dict)]
    same = all(ra[k]["sha256"] == rb.get(k, {}).get("sha256") for k in keys)
    for k in keys:
        print(f"{k}: {'equal' if ra[k]['sha256'] == rb[k]['sha256'] else 'DIFFER'}"
              f" | max per-lane diff to plain float32: "
              f"{ra[k]['max_rel_vs_plain32']:.3e} / "
              f"{rb[k]['max_rel_vs_plain32']:.3e}")
    print("bitwise equal" if same else "outputs differ")
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", type=Path, required=True)
    r.add_argument("--out", type=Path, required=True)
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.tree, args.out)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
