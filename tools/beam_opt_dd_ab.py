#!/usr/bin/env python3
"""A/B a fused-sweep beam kernel of two checkouts on one CUDA card: the
rescue's float64 Adam step #8 (``--kernel opt_dd``, the default), the
datagen's float32 #2 (``--kernel opt``), the float32 analysis #1
(``--kernel analysis``), the float64 analysis #7 (``--kernel
analysis_dd``) or the explicit-RHS solve #3 (``--kernel solve``).  Are its
outputs equal, and how long does a launch take?

    python tools/beam_opt_dd_ab.py run --tree DIR --out PREFIX [--layout L]
                                       [--kernel K]
    python tools/beam_opt_dd_ab.py compare PREFIX_A PREFIX_B

``run`` imports the PyTorch port and ``chip_smoke.py`` of the checkout at
DIR.  With ``opt_dd`` it runs the ``beam_opt_step_dd`` wrapper on
chip_smoke.py phase 3b's inputs (16384 random-bridge lanes plus the four
quasi-cantilever lanes, n = 101) and phase 4c's (16384 fixed-bridge lanes, n
= 201), seed 0, and hashes the other beam kernels' outputs on phases 3, 3b
and 3c's inputs (#1 ``beam_analysis``, #2 ``beam_opt_step`` semi and
adjoint, #3 ``beam_solve``, #7 ``beam_analysis_dd``).  With ``opt`` it runs
``beam_opt_step`` in semi and adjoint mode (refine 1) on phase 3's inputs
(16384 fixed-bridge lanes, n = 101) and phase 4c's, and hashes #1, #3, #7
and #8.  With ``analysis`` it runs ``beam_analysis`` (refine 1) on phases
3, 3b and 4c's inputs with each output's per-lane error to the plain
float64 version beside plain float32's, and at refine 0 and 2 on phase 3's,
and hashes #2, #3, #7 and #8; with
``analysis_dd`` it runs ``beam_analysis_dd`` on phases 3b and 4c's inputs
and hashes #1, #2, #3 and #8; with ``solve`` it runs ``beam_solve`` on
phase 3c's inputs (fixed bridge at n = 101 and 201, random bridge at n =
51, 101 and 201, a right-hand side with an axial component) at refine 0, 1
and 2, with each lane's error to the plain float64 version beside plain
float32's at refine 1, and hashes #1, #2, #7 and #8.  It writes the outputs to PREFIX.npz and, to
PREFIX.json, a SHA-256 of each and of the other kernels' outputs, then
CUDA-event medians of 20 launches of the kernel's wrapper and of its
launcher alone at B = 256, 2048, 8192 and 16384, n = 101 and 201 (for #2
in both modes; #3 also at n = 51; the launcher of #2, #1 and #3 also at
refine 0, 1 and 2 at B = 256 and 16384, n = 101; with ``solve`` also the
analysis gradient #3 serves, ``beam_analysis`` forward and backward on
16384 lanes of chip_smoke.py phase 4d's inputs).  ``--layout`` names the checkout's launch
contract: ``lanes_first`` (the launcher takes the callers' tensors as they
are) or ``lanes_last`` (the launcher takes lane-innermost copies, as before
the redesign).

``compare`` reports, per output, whether the two runs are bitwise equal
(else their largest difference, absolute and in float32 units in the last
place, and the entries that differ only in the sign of a zero; for #2, #1
and #3 also each run's per-lane error to the plain float64 version beside
plain float32's; for a pivot the lanes whose validity at 1e-9 flips),
whether the other kernels hashed the same, and the two runs' times side by
side.  It exits 1 when a hash differs, and besides: for #8 unless I, mu, nu
and the pivot are bitwise equal; for #7 unless the pivot is and u, V, M are
within 1 ulp; for #1 if a lane's validity flips; for #3 unless x and the
pivot are equal in value (a zero's sign aside, NaN where the other has
NaN) and no lane's validity flips.  #2 and #1 are held to float32
rounding, not bits (their ulp distance is reported).  One process per checkout: both trees hold a package of the
same name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

FIELDS = ("I", "mu", "nu", "stats", "pivot")
ANA_FIELDS = ("u", "V", "M", "pivot")
# per kernel: the outputs held bitwise, and the ulps the others may differ
# by (None: reported, not held)
EXACT = {"opt_dd": ("I", "mu", "nu", "pivot"), "opt": (), "analysis": (),
         "analysis_dd": ("pivot",), "solve": ()}
# per kernel: the outputs held equal in value, a zero's sign aside
VALUE_EQUAL = {"solve": ("x", "pivot")}
ULP_LIMIT = {"analysis_dd": 1}
PIVOT_TOL = 1e-9     # the datagen's validity gate
SWEEP_B = (256, 2048, 8192, 16384)
SWEEP_N = (101, 201)
MODES = ("semi", "adjoint")
TAG = {"opt_dd": "#8", "opt": "#2", "analysis": "#1", "analysis_dd": "#7",
       "solve": "#3"}
# chip_smoke.py phase 3c's meshes and bridges for #3 (51: random bridge
# only) and the meshes #3 is timed at
SOLVE_CASES = (("fixed", 101), ("fixed", 201), ("random", 51),
               ("random", 101), ("random", 201))
SOLVE_N = (51, 101, 201)
SOLVE_KEYS = ("I", "Le", "free", "rhs")


def _sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _sha_all(outs) -> str:
    import torch

    return _sha(torch.cat([t.reshape(len(t), -1) for t in outs], 1))


def run(tree: Path, out: Path, layout: str = "lanes_first",
        kernel: str = "opt_dd", seed: int = 0, B: int = 16384) -> None:
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
        if case == "fixed101":  # phase 3
            return cs.make_inputs(torch, sample_scenarios, constraint_mask,
                                  seed, lanes, dev)
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

    def split(bridge, n, lanes):
        # chip_smoke.py phase 3c's inputs (its seed for the mesh)
        return cs.split_inputs(torch, sample_scenarios, constraint_mask,
                               assemble_beam_system, seed + 10 + n, lanes, n,
                               rb_cfg if bridge == "random" else
                               ScenarioConfig(), E, A, dev)

    def opt_step(x, mode):
        return tk.beam_opt_step(*(x[k] for k in opt_keys), *scalars, E, A, G,
                                grad_semi=mode == "semi", refine=1)

    result = dict(tree=str(tree), card=torch.cuda.get_device_name(0),
                  layout=layout, kernel=kernel, hashes={}, times={})
    arrays = {}
    hashes = result["hashes"]

    def keep_errors(key, outs, plain):
        # per-lane error to float64, of the lane's scale: the kernel's and
        # plain float32's p50, p99
        for f, t, p32, p64 in zip(key[1], outs, *plain):
            errs = [cs.lane_errors(torch, y.reshape(len(y), -1),
                                   p64.reshape(len(p64), -1))
                    for y in (t, p32)]
            result.setdefault("errors", {})[f"{key[0]}.{f}"] = [
                e.quantile(q).item() for e in errs for q in (0.5, 0.99)]

    for case in ("rb101", "fixed201"):
        x = inputs(case, B)
        outs = tkd.beam_opt_step_dd(*(x[k] for k in opt_keys), *scalars,
                                    E, A, G)
        for f, t in zip(FIELDS, outs):
            if kernel == "opt_dd":
                arrays[f"{case}.{f}"] = t.cpu().numpy()
            hashes[f"#8 {case} {f}"] = _sha(t)
        outs = tkd.beam_analysis_dd(*(x[k] for k in ana_keys), E, A)
        if case == "rb101":
            hashes["#7 rb101"] = _sha_all(outs)
        if kernel == "analysis_dd":
            for f, t in zip(ANA_FIELDS, outs):
                arrays[f"{case}.{f}"] = t.cpu().numpy()
    if kernel == "analysis":
        # #1 on phases 3, 3b and 4c's inputs, beside the plain versions
        for case in ("fixed101", "rb101", "fixed201"):
            x = inputs(case, B)
            outs = tk.beam_analysis(*(x[k] for k in ana_keys), E, A, 1)
            plain = [tk.beam_analysis_reference(
                *(x[k].to(dt) for k in ana_keys), E, A, 1)
                for dt in (torch.float32, torch.float64)]
            for f, t in zip(ANA_FIELDS, outs):
                arrays[f"{case}.{f}"] = t.cpu().numpy()
            keep_errors((case, ANA_FIELDS[:3]), outs[:3],
                        [p[:3] for p in plain])
            if case == "fixed101":    # the other refinement counts
                for r in (0, 2):
                    outs = tk.beam_analysis(*(x[k] for k in ana_keys), E, A,
                                            r)
                    for f, t in zip(ANA_FIELDS, outs):
                        arrays[f"{case}.refine{r}.{f}"] = t.cpu().numpy()
    if kernel == "solve":
        # #3 on phase 3c's inputs at each refinement count, beside the
        # plain versions at refine 1
        for bridge, n in SOLVE_CASES:
            x = split(bridge, n, B)
            sv = [x[k] for k in SOLVE_KEYS]
            case = f"{bridge}{n}"
            for r in (0, 1, 2):
                outs = tk.beam_solve(*sv, E, A, r)
                for f, t in zip(("x", "pivot"), outs):
                    arrays[f"{case}.refine{r}.{f}"] = t.cpu().numpy()
                if r == 1:
                    plain = [tk.beam_solve_reference(
                        *(t.to(dt) for t in sv), E, A, 1)
                        for dt in (torch.float32, torch.float64)]
                    keep_errors((case, ("x",)), outs[:1],
                                [p[:1] for p in plain])
            del x, sv
    # the float32 beam kernels, on phase 3's, 4c's and 3c's inputs
    for case in ("fixed101", "fixed201"):
        x = inputs(case, B)
        if case == "fixed101":
            hashes["#1 fixed101"] = _sha_all(tk.beam_analysis(
                *(x[k] for k in ana_keys), E, A, 1))
        for mode in MODES:
            outs = opt_step(x, mode)
            if kernel == "opt":
                plain = [tk.beam_opt_step_reference(
                    *(x[k].to(dt) for k in opt_keys), *scalars, E, A, G,
                    grad_semi=mode == "semi", refine=1)
                    for dt in (torch.float32, torch.float64)]
                for f, t in zip(FIELDS, outs):
                    arrays[f"{case}.{mode}.{f}"] = t.cpu().numpy()
                keep_errors((f"{case}.{mode}", FIELDS[:4]), outs, plain)
            if case == "fixed101":
                hashes[f"#2 fixed101 {mode}"] = _sha_all(outs)
    s3 = cs.split_inputs(torch, sample_scenarios, constraint_mask,
                         assemble_beam_system, seed + 111, B, 101,
                         ScenarioConfig(), E, A, dev)
    hashes["#3 fixed101"] = _sha_all(tk.beam_solve(
        *(s3[k] for k in ("I", "Le", "free", "rhs")), E, A, 1))
    del x, s3

    def lanes_last(t):
        """(B, ...) -> contiguous (..., B): the lane-innermost copy a
        launcher took before its redesign."""
        return t.movedim(0, -1).contiguous()

    def copies(opt):
        return ([lanes_last(t) for t in opt[:-1]] + [opt[-1]]
                if layout == "lanes_last" else opt)

    def copies_all(ts):
        return [lanes_last(t) for t in ts] if layout == "lanes_last" else ts

    for n in SOLVE_N if kernel == "solve" else SWEEP_N:
        for lanes in SWEEP_B:
            if kernel == "solve":
                x = split("random" if n < 100 else "fixed", n, lanes)
                sv = [x[k] for k in SOLVE_KEYS]
                sv_t = copies_all(sv)
                result["times"][f"n={n} B={lanes}"] = dict(
                    wrapper=cs.time_ms(torch, lambda: tk.beam_solve(
                        *sv, E, A, 1), 20),
                    kernel=cs.time_ms(torch, lambda: tk.launch_beam_solve(
                        *sv_t, E, A, 1), 20))
                del x, sv, sv_t
                continue
            if kernel in ("analysis", "analysis_dd"):
                x = inputs("fixed201" if n == 201 else "rb101"
                           if kernel == "analysis_dd" else "fixed101",
                           lanes, False)
                ana = [x[k] for k in ana_keys]
                fns = ((lambda: tk.beam_analysis(*ana, E, A, 1),
                        lambda: tk.launch_beam_analysis(*ana_t, E, A, 1))
                       if kernel == "analysis" else
                       (lambda: tkd.beam_analysis_dd(*ana, E, A),
                        lambda: tkd.launch_beam_analysis_dd(*ana_t, E, A)))
                ana_t = copies(ana)
                result["times"][f"n={n} B={lanes}"] = dict(
                    wrapper=cs.time_ms(torch, fns[0], 20),
                    kernel=cs.time_ms(torch, fns[1], 20))
                continue
            if kernel == "opt_dd":
                x = inputs("rb101" if n == 101 else "fixed201", lanes, False)
                opt = [x[k] for k in opt_keys]
                row = dict(wrapper=cs.time_ms(
                    torch, lambda: tkd.beam_opt_step_dd(*opt, *scalars, E, A,
                                                        G), 20))
                opt = copies(opt)
                row["kernel"] = cs.time_ms(
                    torch, lambda: tkd.launch_beam_opt_step_dd(
                        *opt, *scalars, E, A, G), 20)
                result["times"][f"n={n} B={lanes}"] = row
                continue
            x = inputs("fixed101" if n == 101 else "fixed201", lanes)
            opt = [x[k] for k in opt_keys]
            opt_t = copies(opt)
            for mode in MODES:
                kw = dict(grad_semi=mode == "semi", refine=1)
                result["times"][f"n={n} B={lanes} {mode}"] = dict(
                    wrapper=cs.time_ms(torch, lambda: tk.beam_opt_step(
                        *opt, *scalars, E, A, G, **kw), 20),
                    kernel=cs.time_ms(torch, lambda: tk.launch_beam_opt_step(
                        *opt_t, *scalars, E, G, **kw), 20))
            del x, opt, opt_t
    if kernel == "analysis":
        # what a refinement (a forward and a back sweep) costs: the kernel
        # alone at refine 0, 1, 2
        for lanes in (256, 16384):
            ana_t = copies([inputs("fixed101", lanes)[k] for k in ana_keys])
            result["times"][f"n=101 B={lanes} by refine"] = [
                cs.time_ms(torch, lambda: tk.launch_beam_analysis(
                    *ana_t, E, A, r), 20) for r in (0, 1, 2)]
    if kernel == "solve":
        # what a refinement (a forward and a back sweep) costs: the kernel
        # alone at refine 0, 1, 2
        for lanes in (256, 16384):
            sv_t = copies_all([split("fixed", 101, lanes)[k]
                               for k in SOLVE_KEYS])
            result["times"][f"n=101 B={lanes} by refine"] = [
                cs.time_ms(torch, lambda: tk.launch_beam_solve(
                    *sv_t, E, A, r), 20) for r in (0, 1, 2)]
        # the analysis gradient #3 serves (chip_smoke.py phase 4d's inputs
        # and loss): beam_analysis forward (#1) and backward (#3), whole
        xg = cs.make_inputs(torch, sample_scenarios, constraint_mask,
                            seed + 9, B, dev)
        I_g, loads_g, udl_g = (xg[k].clone().requires_grad_(True)
                               for k in ("I", "loads", "udl"))

        def gradient():
            out = tk.beam_analysis(I_g, xg["Le"], xg["free"], loads_g, udl_g,
                                   E, A, 1)
            return torch.autograd.grad(cs.analysis_loss(*out[:3]),
                                       (I_g, loads_g, udl_g))

        result["times"][f"analysis gradient n=101 B={B}"] = dict(
            wall=cs.time_ms(torch, gradient, 20))
    if kernel == "opt":
        # what a refinement (a forward and a back sweep) costs: the kernel
        # alone at refine 0, 1, 2
        for lanes in (256, 16384):
            opt_t = copies([inputs("fixed101", lanes)[k] for k in opt_keys])
            for mode in MODES:
                result["times"][f"n=101 B={lanes} {mode} by refine"] = [
                    cs.time_ms(torch, lambda: tk.launch_beam_opt_step(
                        *opt_t, *scalars, E, G, grad_semi=mode == "semi",
                        refine=r), 20) for r in (0, 1, 2)]
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
    """Per output: bitwise equality, largest |difference| and ULP distance,
    the entries equal in value that differ in the sign of a zero, for a
    pivot the lanes whose validity at PIVOT_TOL flips; per hash of another
    kernel: equality.  ``equal`` is True when every hash agrees, every
    exact output is bitwise equal, every output held in value is equal in
    value, every other output is within the kernel's ULP_LIMIT, and (#1,
    #3) no lane's validity flips."""
    ja, jb = (json.loads(p.with_suffix(".json").read_text()) for p in (a, b))
    na, nb = (np.load(p.with_suffix(".npz")) for p in (a, b))
    kernel = ja.get("kernel", "opt_dd")
    tag = TAG[kernel]
    limit = ULP_LIMIT.get(kernel)
    rows = {}
    for key in sorted(na.files):
        x, y = na[key], nb[key]
        same = x.shape == y.shape and x.tobytes() == y.tobytes()
        diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
        diff[np.isnan(x) & np.isnan(y)] = 0.0
        scale = np.abs(y.astype(np.float64)).max() if y.size else 0.0
        field = key.split(".")[-1]
        both_nan = np.isnan(x) & np.isnan(y) if x.shape == y.shape else None
        value_equal = x.shape == y.shape and bool(
            ((x == y) | both_nan).all())
        signed_zeros = int(((x == y) & (x == 0) & (np.signbit(x)
                                                   != np.signbit(y))).sum()
                           ) if x.shape == y.shape else 0
        rows[key] = dict(bitwise=same, value_equal=value_equal,
                         signed_zeros=signed_zeros,
                         held_value=field in VALUE_EQUAL.get(kernel, ()),
                         max_abs=float(np.nanmax(diff))
                         if diff.size else 0.0,
                         max_rel=float(np.nanmax(diff) / scale)
                         if scale > 0 else 0.0,
                         max_ulps=_ulps(x, y),
                         exact=field in EXACT[kernel],
                         held_ulps=None if field in EXACT[kernel]
                         or field == "stats" else limit)
        if field == "pivot":
            rows[key]["flips"] = int(((x > PIVOT_TOL) != (y > PIVOT_TOL))
                                     .sum())
    hashes = {k: v == jb["hashes"].get(k)
              for k, v in ja["hashes"].items() if not k.startswith(tag)}
    equal = (all(r["bitwise"] for r in rows.values() if r["exact"])
             and all(r["value_equal"] for r in rows.values()
                     if r["held_value"])
             and all(r["max_ulps"] <= r["held_ulps"] for r in rows.values()
                     if r["held_ulps"] is not None)
             and (kernel not in ("analysis", "solve")
                  or all(r.get("flips", 0) == 0 for r in rows.values()))
             and all(hashes.values()) and set(na.files) == set(nb.files))
    errors = {k: (v, jb.get("errors", {}).get(k, [float("nan")] * 4))
              for k, v in ja.get("errors", {}).items()}
    return dict(kernel=kernel, outputs=rows, hashes=hashes, equal=equal,
                errors=errors,
                times=(ja.get("times", {}), jb.get("times", {})))


def compare(a: Path, b: Path) -> int:
    r = compare_dumps(a, b)
    tag = TAG[r["kernel"]]
    for key, row in r["outputs"].items():
        held = ("" if row["exact"] else " (held in value)"
                if row["held_value"] else " (held to rounding, not bits)"
                if row["held_ulps"] is None else
                f" (held to {row['held_ulps']} ulp)")
        print(f"{tag} {key}: " + (
            "bitwise equal" if row["bitwise"] else
            f"equal in value, {row['signed_zeros']} zeros of the other sign"
            if row["value_equal"] else
            f"DIFFER max |a - b| {row['max_abs']:.3e} ({row['max_rel']:.3e} "
            f"of scale, {row['max_ulps']} ulp; {row['signed_zeros']} zeros "
            "of the other sign)") + held
              + (f"; validity at {PIVOT_TOL:g} flips on {row['flips']} "
                 "lanes" if "flips" in row else ""))
    for k, same in r["hashes"].items():
        print(f"{k}: {'equal' if same else 'DIFFER'}")
    for key, (ea, eb) in r["errors"].items():
        print(f"{tag} {key} per-lane error to float64, p50 / p99: a "
              f"{ea[0]:.3e} / {ea[1]:.3e}, b {eb[0]:.3e} / {eb[1]:.3e}, "
              f"plain float32 {ea[2]:.3e} / {ea[3]:.3e}")
    ta, tb = r["times"]
    for k in ta:
        if k.endswith("by refine"):
            print(f"{k} 0, 1, 2: " + " | ".join(
                f"{a:.4f} / {b:.4f}" for a, b in zip(ta[k], tb.get(k, ()))))
            continue
        if k.startswith("analysis gradient"):
            print(f"{k}: wall (CUDA events, forward and backward) "
                  f"{ta[k]['wall']:.4f} / "
                  f"{tb.get(k, {}).get('wall', float('nan')):.4f} ms")
            continue
        print(f"{k}: " + " | ".join(
            f"{f} {ta[k][f]:.4f} / {tb.get(k, {}).get(f, float('nan')):.4f}"
            for f in ("kernel", "wrapper")) + " ms")
    print({"opt_dd": "bitwise equal", "solve": "equal in value"}.get(
        r["kernel"], "hashes equal") if r["equal"] else "outputs differ")
    return 0 if r["equal"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", type=Path, required=True)
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--layout", choices=("lanes_first", "lanes_last"),
                   default="lanes_first")
    r.add_argument("--kernel", choices=tuple(TAG), default="opt_dd")
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        args.out.parent.mkdir(parents=True, exist_ok=True)
        run(args.tree, args.out, args.layout, args.kernel)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
