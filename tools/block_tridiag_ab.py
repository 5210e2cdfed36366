#!/usr/bin/env python3
"""A/B the float32 block-Thomas kernels (#4, #5, #6) and the streamed
float64 solve (#9) of two checkouts on one CUDA card: are their outputs
equal, and how long do #4, #5, #6 and #9 take?

    python tools/block_tridiag_ab.py run --tree DIR --out PREFIX
                                         [--layout lanes_first|lanes_last]
                                         [--bidi-layout lanes_first|lanes_last]
                                         [--dd-layout lanes_first|lanes_last]
    python tools/block_tridiag_ab.py compare PREFIX_A PREFIX_B

``run`` imports the PyTorch port and ``chip_smoke.py`` of the checkout at
DIR and builds its kernels.  On chip_smoke.py phase 3c's systems (fixed and
random bridge at n = 101 and 201, 16384 lanes, seed 0) it solves with #4
(``launch_thomas``), #5 (``launch_thomas_bidi``) and #6
(``block_tridiag_solve_streamed``); on phase 3d's float64 systems (phase
3b's 16384 random-bridge lanes plus the four quasi-cantilever lanes at n =
101, and 16384 span-scaled overhang lanes at n = 1001) with #9
(``solve_dd_streamed``, x and pivot) and with the escalation route built on
it (``solve_beam_dd_streamed`` on the same lanes, u and pivot: the float64
assembly and #9, or #9 assembling the rows itself); and on the 300-lane
systems of the checkout's ``tests/test_torch_cuda.py`` (``_systems``,
seeds 7 and 8) with #4.  It writes a SHA-256 of each output, and another
of it with every -0 made +0, and each float32 kernel's largest per-lane
difference to the plain float32 version (``thomas_reference``) relative to
the lane's largest |x| to PREFIX.json, and #4's and #6's outputs to
PREFIX.npz.  Then CUDA-event medians of 20 launches of #4 and
of #6 at B = 512, 2048, 8192 and 16384 lanes and n = 51 (random bridge),
101, 201 and 1001 (fixed bridge): the wrapper (for #6
``block_tridiag_solve_streamed``, for #4 the call ``block_tridiag_solve``
makes when it dispatches to #4) and the launcher alone
(``launch_thomas_streamed``, ``launch_thomas``); and the device time per
launch, the mean of 20 under torch.profiler (#6 by sweep, forward and
backward; #4 its one kernel); the same for #5, the wrapper
``block_tridiag_solve(bidi=True)`` and the launcher ``launch_thomas_bidi``
(its device us of all its kernels).  Then #9 at B = 512, 2048, 8192 and 16384
lanes and n = 101, 201 and 1001 (chip_smoke.py phase 6's fixed-span
lanes): the wrapper ``solve_dd_streamed`` and the launcher
``launch_thomas_streamed_dd`` on the float64-assembled systems (CUDA-event
medians of 20, device us per launch by sweep), and the route
``solve_beam_dd_streamed`` on the lanes (median of 20, device us of all its
kernels).  ``--layout`` names #4's launcher contract: ``lanes_first`` (it
takes the systems as they are) or ``lanes_last`` (it takes lane-innermost
copies, as before its redesign; they are made outside the launcher's
timing, inside the wrapper's); ``--bidi-layout`` names #5's and
``--dd-layout`` #9's the same way (``lanes_last`` before their
redesigns).  #6 is taken lanes-first, so the tree is one from after #6's
redesign.

``compare`` prints each hash's verdict (equal; equal but for the sign of
zeros, "±0", reported apart and held equal; or differ), #4's and #6's
verdicts (bitwise equal, or the largest gap in float32 units in the last
place), the launchers' layouts and the two runs' times side by side.  It
exits 1 unless #4, #5 and #9 (the route included) hash equal up to ±0: #6
is reported, not held to bits.  One process per checkout: both trees hold
a package of the same name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

SWEEP_B = (512, 2048, 8192, 16384)
SWEEP_N = (51, 101, 201, 1001)
DD_SWEEP_N = (101, 201, 1001)
HELD = ("#4", "#5", "#9")       # held to bits; #6 is reported
DEVICE_US = ("fwd", "bwd", "kernel")   # device us fields, in print order


def _lanes_last(t):
    """(B, ...) -> contiguous (..., B): the lane-innermost copy a launcher
    took before its redesign."""
    return t.movedim(0, -1).contiguous()


def _lanes_first(t):
    return t.movedim(-1, 0).contiguous()


def _sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _device_us(torch, fn, sweeps=("fwd", "bwd"), reps=20) -> dict:
    """Mean device time in us per call of each sweep ``fn`` launches, under
    torch.profiler, by a part of the kernel's name (``fwd``, ``bwd``); with
    no ``sweeps``, of all its kernels together (``kernel``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for sweep in sweeps or ("kernel",):
                if not sweeps or sweep in e.key:
                    out[sweep] = (out.get(sweep, 0.0)
                                  + e.self_device_time_total / reps)
    return out


def run(tree: Path, out: Path, layout: str = "lanes_first",
        dd_layout: str = "lanes_first", bidi_layout: str = "lanes_first",
        seed: int = 0, B: int = 16384) -> None:
    sys.path.insert(0, str(tree.resolve()))
    sys.path.insert(0, str(tree.resolve() / "tests"))
    import torch

    import chip_smoke as cs
    from openpystruct_tpu_torch.config import BeamConfig, ScenarioConfig
    from openpystruct_tpu_torch.datagen import sample_scenarios
    from openpystruct_tpu_torch.fem.beam import (
        BeamScenario,
        assemble_beam_system,
        constraint_mask,
    )
    from openpystruct_tpu_torch.ops import block_stream as tbs
    from openpystruct_tpu_torch.ops import block_stream_dd as tsd
    from openpystruct_tpu_torch.ops import block_tridiag as tbt

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    beam = BeamConfig(udl=-1000.0)
    E, A = beam.E, beam.A
    dev = torch.device("cuda")
    result = dict(tree=str(tree), card=torch.cuda.get_device_name(0),
                  layout=layout, dd_layout=dd_layout,
                  bidi_layout=bidi_layout, hashes={},
                  hashes_pm0={}, errors={}, times={})
    arrays = {}

    def put(key, t):
        """Record the output's SHA-256, and one with every -0 made +0."""
        result["hashes"][key] = _sha(t)
        result["hashes_pm0"][key] = _sha(t + 0.0)

    rb_cfg = ScenarioConfig(random_bridge=True)

    def four(s):
        """#4 on lanes-first systems, through the tree's launcher."""
        if layout == "lanes_last":
            return _lanes_first(tbt.launch_thomas(
                *(_lanes_last(t) for t in s)))
        return tbt.launch_thomas(*s)

    def five(s):
        """#5's launcher on lanes-first systems, through the tree's
        contract; with lane-innermost copies made before the call."""
        if bidi_layout == "lanes_last":
            t = [_lanes_last(x) for x in s]
            return lambda: tbt.launch_thomas_bidi(*t)
        return lambda: tbt.launch_thomas_bidi(*s)

    for n in (101, 201):
        for label, cfg in (("fixed bridge", ScenarioConfig()),
                           ("random bridge", rb_cfg)):
            # phase 3c's inputs: its seed rule and its generator
            x = cs.split_inputs(torch, sample_scenarios, constraint_mask,
                                assemble_beam_system, seed + 10 + n, B, n,
                                cfg, E, A, dev)
            sys32 = x["sys"]
            outs = {"#4": four(sys32),
                    "#5": tbt.block_tridiag_solve(*sys32, bidi=True),
                    "#6": tbs.block_tridiag_solve_streamed(*sys32)}
            plain = tbt.thomas_reference(*sys32).double()
            torch.cuda.synchronize()
            key = f"{label}, n={n}"
            for tag, k in outs.items():
                put(f"{tag} {key}", k)
                result["errors"][f"{tag} {key}"] = cs.lane_errors(
                    torch, k, plain).max().item()
            arrays[key] = outs["#6"].cpu().numpy()
            arrays[f"#4 {key}"] = outs["#4"].cpu().numpy()
            del x, sys32, outs, plain
    # phase 3d's inputs: 3b's random-bridge lanes and the quasi-cantilever
    # ones at n = 101, the span-scaled overhang at n = 1001
    ana_keys = ("I", "Le", "free", "loads", "udl")
    rb = cs.make_inputs(torch, sample_scenarios, constraint_mask, seed + 3,
                        B, dev, cfg=rb_cfg)
    qc = cs.quasi_cantilever(torch, BeamScenario, constraint_mask,
                             torch.Generator().manual_seed(seed + 4), dev)
    I_o, sc_o = cs.overhang(torch, BeamScenario, cs.DD_CHECK_N, B, seed + 12,
                            dev)
    for key, args in (
            ("random bridge + quasi-cantilever, n=101",
             [torch.cat([rb[k], qc[k]]) for k in ana_keys]),
            (f"overhang, n={cs.DD_CHECK_N}",
             cs.beam_args(torch, constraint_mask, I_o, sc_o))):
        x_dd, piv = tsd.solve_dd_streamed(
            *tsd.assemble_beam_system_dd(*args, E, A)[:3])
        put(f"#9 {key} x", x_dd)
        put(f"#9 {key} pivot", piv)
        u, piv = tsd.solve_beam_dd_streamed(*args, E, A)
        put(f"#9 route {key} u", u)
        put(f"#9 route {key} pivot", piv)
    del rb, qc, I_o, sc_o
    from test_torch_cuda import _systems

    for test_seed, cfg in ((7, ScenarioConfig()), (8, rb_cfg)):
        x32 = _systems(300, test_seed, dev, torch.float32, cfg)
        put(f"#4 card test systems, seed {test_seed}", four(x32))

    for n in SWEEP_N:
        # the fixed bridge's roller tags need n >= 100
        full = cs.split_inputs(torch, sample_scenarios, constraint_mask,
                               assemble_beam_system, seed + 20 + n,
                               max(SWEEP_B), n,
                               ScenarioConfig() if n >= 100 else rb_cfg, E,
                               A, dev)["sys"]
        for lanes in SWEEP_B:
            s = [t[:lanes] for t in full]
            s4 = ([_lanes_last(t) for t in s] if layout == "lanes_last"
                  else s)
            result["times"][f"n={n} B={lanes}"] = dict(
                wrapper=cs.time_ms(
                    torch, lambda: tbs.block_tridiag_solve_streamed(*s), 20),
                kernel=cs.time_ms(
                    torch, lambda: tbs.launch_thomas_streamed(*s), 20),
                device_us=_device_us(
                    torch, lambda: tbs.launch_thomas_streamed(*s)))
            result["times"][f"#4 n={n} B={lanes}"] = dict(
                wrapper=cs.time_ms(torch, lambda: four(s), 20),
                kernel=cs.time_ms(
                    torch, lambda: tbt.launch_thomas(*s4), 20),
                device_us=_device_us(
                    torch, lambda: tbt.launch_thomas(*s4), sweeps=()))
            launch5 = five(s)
            result["times"][f"#5 n={n} B={lanes}"] = dict(
                wrapper=cs.time_ms(torch, lambda: tbt.block_tridiag_solve(
                    *s, bidi=True), 20),
                kernel=cs.time_ms(torch, launch5, 20),
                device_us=_device_us(torch, launch5, sweeps=()))
            del s, s4, launch5
        del full

    def nine(s):
        """#9's launcher on lanes-first systems, through the tree's
        contract; with lane-innermost copies made before the call."""
        if dd_layout == "lanes_last":
            t = [_lanes_last(x) for x in s]
            return lambda: tsd.launch_thomas_streamed_dd(*t)
        return lambda: tsd.launch_thomas_streamed_dd(*s)

    for n in DD_SWEEP_N:
        full = cs.beam_args(torch, constraint_mask, *cs.fixed_span(
            torch, BeamScenario, n, max(SWEEP_B), seed + 30 + n, dev))
        for lanes in SWEEP_B:
            args = [t[:lanes] for t in full]
            s = tsd.assemble_beam_system_dd(*args, E, A)[:3]
            launch = nine(s)
            result["times"][f"#9 n={n} B={lanes}"] = dict(
                wrapper=cs.time_ms(
                    torch, lambda: tsd.solve_dd_streamed(*s), 20),
                kernel=cs.time_ms(torch, launch, 20),
                device_us=_device_us(torch, launch))
            route = lambda: tsd.solve_beam_dd_streamed(*args, E, A)
            result["times"][f"#9 route n={n} B={lanes}"] = dict(
                route=cs.time_ms(torch, route, 20),
                device_us=_device_us(torch, route, sweeps=()))
            del args, s, launch, route
            torch.cuda.empty_cache()
        del full
    torch.cuda.synchronize()
    np.savez(out.with_suffix(".npz"), **arrays)
    out.with_suffix(".json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place (NaN against
    NaN counts as equal)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    d = np.abs(ia - ib)
    d[np.isnan(a) & np.isnan(b)] = 0
    return int(d.max()) if d.size else 0


def _verdict(ja: dict, jb: dict, key: str) -> str:
    """"equal", "±0" (equal once every -0 is made +0) or "differ"."""
    if ja["hashes"][key] == jb["hashes"].get(key):
        return "equal"
    pa, pb = ja.get("hashes_pm0", {}), jb.get("hashes_pm0", {})
    if key in pa and pa[key] == pb.get(key):
        return "±0"
    return "differ"


def compare_dumps(a: Path, b: Path) -> dict:
    """Per hash: its verdict (``_verdict``); per #4 and #6 output (npz keys
    "#4 ..." and the rest): bitwise equality and ulp gap.  ``equal`` is
    True when every #4, #5 and #9 hash agrees, up to the sign of zeros."""
    ja, jb = (json.loads(p.with_suffix(".json").read_text()) for p in (a, b))
    na, nb = (np.load(p.with_suffix(".npz")) for p in (a, b))
    hashes = {k: _verdict(ja, jb, k) for k in ja["hashes"]}
    held = [v != "differ" for k, v in hashes.items() if k.startswith(HELD)]
    four, six = {}, {}
    for key in sorted(na.files):
        x, y = na[key], nb[key]
        same = x.shape == y.shape and x.tobytes() == y.tobytes()
        row = dict(bitwise=same, max_ulps=0 if same else _ulps(x, y))
        if key.startswith("#4 "):
            four[key[3:]] = row
        else:
            six[key] = row
    return dict(hashes=hashes, four=four, six=six,
                equal=bool(held) and all(held)
                and set(na.files) == set(nb.files),
                layouts=(ja.get("layout"), jb.get("layout")),
                dd_layouts=(ja.get("dd_layout", "lanes_first"),
                            jb.get("dd_layout", "lanes_first")),
                bidi_layouts=(ja.get("bidi_layout", "lanes_last"),
                              jb.get("bidi_layout", "lanes_last")),
                errors=(ja.get("errors", {}), jb.get("errors", {})),
                times=(ja.get("times", {}), jb.get("times", {})))


def compare(a: Path, b: Path) -> int:
    r = compare_dumps(a, b)
    words = {"equal": "equal", "±0": "equal but for the sign of zeros (±0)",
             "differ": "DIFFER"}
    for k, verdict in r["hashes"].items():
        if not k.startswith("#6"):
            print(f"{k}: {words[verdict]}")
    for tag in ("four", "six"):
        for key, row in r[tag].items():
            print(f"#{4 if tag == 'four' else 6} {key}: " + (
                "bitwise equal" if row["bitwise"] else
                f"differs by up to {row['max_ulps']} ulp"))
    for tag, lays in (("#4", r["layouts"]), ("#5", r["bidi_layouts"]),
                      ("#9", r["dd_layouts"])):
        print(f"{tag} launcher takes " + " / ".join(
            {"lanes_last": "lane-innermost copies of the"}.get(
                lay, "the lanes-first") for lay in lays) + " systems")
    ea, eb = r["errors"]
    for k in ea:
        print(f"{k}: max per-lane diff to plain float32 {ea[k]:.3e} / "
              f"{eb.get(k, float('nan')):.3e}")
    ta, tb = r["times"]
    for k in ta:
        print(f"{k}: " + " | ".join(
            f"{f} {ta[k][f]:.4f} / {tb.get(k, {}).get(f, float('nan')):.4f}"
            for f in ("kernel", "wrapper", "route") if f in ta[k]) + " ms")
        da, db = (t.get(k, {}).get("device_us", {}) for t in (ta, tb))
        if da or db:
            print("  device us " + " | ".join(
                f"{f} {da.get(f, float('nan')):.1f} / "
                f"{db.get(f, float('nan')):.1f}" for f in DEVICE_US
                if f in da or f in db))
    six = all(row["bitwise"] for row in r["six"].values())
    print("#6 " + ("bitwise equal" if six else "differs in ulps (reported)"))
    if not all(row["bitwise"] for row in r["four"].values()):
        print("#4 differs")
    pm0 = [k for k, v in r["hashes"].items() if v == "±0"]
    print(("#4, #5, #9 hashes equal" + (f" ({len(pm0)} up to ±0)" if pm0
                                        else "")) if r["equal"]
          else "outputs differ")
    return 0 if r["equal"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", type=Path, required=True)
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--layout", choices=("lanes_first", "lanes_last"),
                   default="lanes_first")
    r.add_argument("--dd-layout", choices=("lanes_first", "lanes_last"),
                   default="lanes_first")
    r.add_argument("--bidi-layout", choices=("lanes_first", "lanes_last"),
                   default="lanes_first")
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        args.out.parent.mkdir(parents=True, exist_ok=True)
        run(args.tree, args.out, args.layout, args.dd_layout,
            args.bidi_layout)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
