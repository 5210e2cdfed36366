#!/usr/bin/env python3
"""A/B the rescue's float64 opt-step kernel (#8) of two checkouts on one
CUDA card: are its outputs bitwise equal, and how long does a launch take?

    python tools/beam_opt_dd_ab.py run --tree DIR --out PREFIX [--layout L]
    python tools/beam_opt_dd_ab.py compare PREFIX_A PREFIX_B

``run`` imports the PyTorch port and ``chip_smoke.py`` of the checkout at
DIR and runs its ``beam_opt_step_dd`` wrapper on chip_smoke.py phase 3b's
inputs (16384 random-bridge lanes plus the four quasi-cantilever lanes, n =
101) and phase 4c's (16384 fixed-bridge lanes, n = 201), seed 0.  It writes
the outputs to PREFIX.npz and, to PREFIX.json, a SHA-256 of each and of the
other rescue and datagen kernels' outputs on phases 3, 3b and 3c's inputs
(#1 ``beam_analysis``, #2 ``beam_opt_step`` semi and adjoint, #3
``beam_solve``, #7 ``beam_analysis_dd``), then CUDA-event medians of 20
launches of #8's wrapper and of its kernel alone at B = 256, 2048, 8192 and
16384, n = 101 and 201.  ``--layout`` names the checkout's launch contract:
``lanes_first`` (the launcher takes the optimizer's tensors as they are)
or ``lanes_last`` (the launcher takes lane-innermost copies, as before the
redesign).

``compare`` reports, per input set, whether I, mu, nu and the pivot are
bitwise equal (else their largest difference, absolute and in float32
units in the last place) and the largest stats difference, whether the
other kernels hashed the same, and the two runs' times side by side.  It
exits 1 unless I, mu, nu, the pivot and every hash agree.  One process per
checkout: both trees hold a package of the same name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

FIELDS = ("I", "mu", "nu", "stats", "pivot")
EXACT = ("I", "mu", "nu", "pivot")     # held bitwise; stats sum in any order
SWEEP_B = (256, 2048, 8192, 16384)
SWEEP_N = (101, 201)


def _sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def run(tree: Path, out: Path, layout: str = "lanes_first", seed: int = 0,
        B: int = 16384) -> None:
    sys.path.insert(0, str(tree.resolve()))
    import torch

    import chip_smoke as cs
    from openpystruct_tpu_torch.config import (
        DATAGEN_OPT,
        BeamConfig,
        ScenarioConfig,
    )
    from openpystruct_tpu_torch.datagen import sample_scenarios
    from openpystruct_tpu_torch.fem.beam import (
        BeamScenario,
        assemble_beam_system,
        constraint_mask,
    )
    from openpystruct_tpu_torch.ops import beam_kernel as tk
    from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
    from openpystruct_tpu_torch.ops.block_tridiag import lanes_last
    from openpystruct_tpu_torch.opt.beam_opt import _adam_scalars

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    beam = BeamConfig(udl=-1000.0)
    E, A, G = beam.E, beam.A, beam.G
    scalars = _adam_scalars(DATAGEN_OPT, 3, torch.float32)
    rb_cfg = ScenarioConfig(random_bridge=True)
    opt_keys = ("I", "mu", "nu", "Le", "free", "loads", "udl")
    ana_keys = ("I", "Le", "free", "loads", "udl")

    def inputs(case, lanes, with_qc=True):
        if case == "rb101":     # phase 3b
            x = cs.make_inputs(torch, sample_scenarios, constraint_mask,
                               seed + 3, lanes, dev, cfg=rb_cfg)
            if not with_qc:
                return x
            qc = cs.quasi_cantilever(torch, BeamScenario, constraint_mask,
                                     torch.Generator().manual_seed(seed + 4),
                                     dev)
            return {k: torch.cat([x[k], qc[k]]) for k in qc}
        return cs.make_inputs(torch, sample_scenarios, constraint_mask,
                              seed + 5, lanes, dev,
                              cfg=ScenarioConfig(num_nodes=201))  # phase 4c

    result = dict(tree=str(tree), card=torch.cuda.get_device_name(0),
                  layout=layout, hashes={}, times={})
    arrays = {}
    for case in ("rb101", "fixed201"):
        x = inputs(case, B)
        outs = tkd.beam_opt_step_dd(*(x[k] for k in opt_keys), *scalars,
                                    E, A, G)
        for f, t in zip(FIELDS, outs):
            arrays[f"{case}.{f}"] = t.cpu().numpy()
            result["hashes"][f"#8 {case} {f}"] = _sha(t)
        if case == "rb101":
            result["hashes"]["#7 rb101"] = _sha(torch.cat(
                [t.reshape(len(t), -1) for t in tkd.beam_analysis_dd(
                    *(x[k] for k in ana_keys), E, A)], 1))
    # the other beam kernels, on phase 3's and 3c's inputs
    x = cs.make_inputs(torch, sample_scenarios, constraint_mask, seed, B, dev)
    result["hashes"]["#1 fixed101"] = _sha(torch.cat(
        [t.reshape(len(t), -1) for t in tk.beam_analysis(
            *(x[k] for k in ana_keys), E, A, 1)], 1))
    for semi in (True, False):
        result["hashes"][f"#2 fixed101 {'semi' if semi else 'adjoint'}"] = (
            _sha(torch.cat([t.reshape(len(t), -1) for t in tk.beam_opt_step(
                *(x[k] for k in opt_keys), *scalars, E, A, G, grad_semi=semi,
                refine=1)], 1)))
    s3 = cs.split_inputs(torch, sample_scenarios, constraint_mask,
                         assemble_beam_system, seed + 111, B, 101,
                         ScenarioConfig(), E, A, dev)
    result["hashes"]["#3 fixed101"] = _sha(torch.cat(
        [t.reshape(len(t), -1) for t in tk.beam_solve(
            *(s3[k] for k in ("I", "Le", "free", "rhs")), E, A, 1)], 1))
    del x, s3

    for n in SWEEP_N:
        for lanes in SWEEP_B:
            x = inputs("rb101" if n == 101 else "fixed201", lanes, False)
            opt = [x[k] for k in opt_keys]
            row = dict(wrapper=cs.time_ms(torch, lambda: tkd.beam_opt_step_dd(
                *opt, *scalars, E, A, G), 20))
            if layout == "lanes_last":
                opt = [lanes_last(t) for t in opt[:-1]] + [opt[-1]]
            row["kernel"] = cs.time_ms(
                torch, lambda: tkd.launch_beam_opt_step_dd(
                    *opt, *scalars, E, A, G), 20)
            result["times"][f"n={n} B={lanes}"] = row
            del x, opt
    torch.cuda.synchronize()
    np.savez(out.with_suffix(".npz"), **arrays)
    out.with_suffix(".json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place (same-sign
    finite values; NaN against NaN counts as equal)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    d = np.abs(ia - ib)
    d[np.isnan(a) & np.isnan(b)] = 0
    return int(d.max()) if d.size else 0


def compare_dumps(a: Path, b: Path) -> dict:
    """Per output: bitwise equality, largest |difference| and ULP distance;
    per hash: equality.  ``equal`` is True when every exact output and
    every hash agrees."""
    ja, jb = (json.loads(p.with_suffix(".json").read_text()) for p in (a, b))
    na, nb = (np.load(p.with_suffix(".npz")) for p in (a, b))
    rows = {}
    for key in sorted(na.files):
        x, y = na[key], nb[key]
        same = x.shape == y.shape and x.tobytes() == y.tobytes()
        diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
        diff[np.isnan(x) & np.isnan(y)] = 0.0
        scale = np.abs(y.astype(np.float64)).max() if y.size else 0.0
        rows[key] = dict(bitwise=same, max_abs=float(np.nanmax(diff))
                         if diff.size else 0.0,
                         max_rel=float(np.nanmax(diff) / scale)
                         if scale > 0 else 0.0,
                         max_ulps=_ulps(x, y),
                         exact=key.split(".")[-1] in EXACT)
    hashes = {k: v == jb["hashes"].get(k)
              for k, v in ja["hashes"].items() if not k.startswith("#8")}
    equal = (all(r["bitwise"] for r in rows.values() if r["exact"])
             and all(hashes.values()) and set(na.files) == set(nb.files))
    return dict(outputs=rows, hashes=hashes, equal=equal,
                times=(ja.get("times", {}), jb.get("times", {})))


def compare(a: Path, b: Path) -> int:
    r = compare_dumps(a, b)
    for key, row in r["outputs"].items():
        print(f"#8 {key}: " + ("bitwise equal" if row["bitwise"] else
                               f"DIFFER max |a - b| {row['max_abs']:.3e} "
                               f"({row['max_rel']:.3e} of scale, "
                               f"{row['max_ulps']} ulp)")
              + ("" if row["exact"] else " (held to rounding, not bits)"))
    for k, same in r["hashes"].items():
        print(f"{k}: {'equal' if same else 'DIFFER'}")
    ta, tb = r["times"]
    for k in ta:
        print(f"{k}: " + " | ".join(
            f"{f} {ta[k][f]:.4f} / {tb.get(k, {}).get(f, float('nan')):.4f}"
            for f in ("kernel", "wrapper")) + " ms")
    print("bitwise equal" if r["equal"] else "outputs differ")
    return 0 if r["equal"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", type=Path, required=True)
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--layout", choices=("lanes_first", "lanes_last"),
                   default="lanes_first")
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        args.out.parent.mkdir(parents=True, exist_ok=True)
        run(args.tree, args.out, args.layout)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
