"""Readings that the limits of a cell's comparison are set from, on the card.

    python3 portbench/checks/calibrate.py --workload <cell> --seconds <s> \\
        --program <seed> ... --control <seed> ... --fault <name> ...

prints one JSON line a reading:

- ``program``: the program's numbers over a run's window (``--seconds``)
  on each seed, every seed in this one process (the kernels built once);
- ``control``: the plain reference put in the program's place and computed
  in TF32 (``reference/beam.py``, precision "tf32"), the step below the
  configuration's float32 with TF32 off, over one batch of the cell's own
  lanes; its rows (``--rows`` of them, about as many as a run compares)
  judged as a run judges the program's;
- ``fault``: the program with a fault of ``checks/faults.py`` planted,
  over a run's window, on the first ``--program`` seed.

The numbers are ``reference/judge.py``'s; ``limits`` in the cell's
workload file are set between the program's largest and the control's
smallest reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

from portbench.harness import card, registry  # noqa: E402
from portbench.harness.readings import Readings  # noqa: E402
from portbench.reference import beam as rb  # noqa: E402
from portbench.reference import judge as rj  # noqa: E402
from portbench.reference import sampler  # noqa: E402


def program(cell, seed, seconds, fault=None):
    entry = registry.load_module("entries", cell["workload"]["entry"])
    s = entry.Session(cell, seed, "cuda", False)
    if fault is None:
        s.setup()
        r = Readings()
        s.window(seconds, r)
    else:
        from portbench.checks.faults import planted

        with planted(fault):
            s.setup()
            r = Readings()
            s.window(seconds, r)
    t = time.perf_counter()
    out = s.check()
    return dict(batches=len(r.batches),
                valid_share=sum(b.valid for b in r.batches)
                / sum(b.lanes for b in r.batches),
                check_s=time.perf_counter() - t, **out)


def control(cell, seed, n_rows, device="cuda"):
    import torch

    cfg, opt = cell["config"], dict(cell["config"]["optimizer"])
    opt.update({k: cell["traffic"][k] for k in ("grad_mode",)
                if k in cell["traffic"]})
    lanes = int(cell["traffic"]["lanes"])
    sc = sampler.draw(torch.Generator().manual_seed(seed), lanes,
                      cfg["scenario"])
    for k in ("node_x", "point_loads", "udl"):
        sc[k] = sc[k].astype(np.float32).astype(np.float64)
    bm = rb.make_beams(sc, cfg["beam"], torch.float32, device)
    ar = rb.Arith("tf32")
    t = time.perf_counter()
    res = rb.optimize(bm, opt, cfg["beam"]["I0"], ar)
    u, V, M, piv = rb.analysis(res.I_solved, bm, ar)
    valid = (torch.isfinite(res.I).all(-1) & torch.isfinite(u).all(-1).all(-1)
             & (piv > float(cfg["datagen"]["pivot_tol"])))
    float(valid.sum())
    secs = time.perf_counter() - t
    rows = np.sort(np.random.default_rng([seed, 1]).choice(
        lanes, n_rows, replace=False))
    idx = torch.as_tensor(rows, device=device)
    kept = {k: torch.as_tensor(sc[k]).to(device)[idx]
            for k in rj.SCENARIO_FIELDS}
    kept.update(I=res.I[idx], I_solved=res.I_solved[idx], u=u[idx],
                V=V[idx], M=M[idx], valid=valid[idx])
    del bm, res, u, V, M, piv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref_sc = rj.replay(seed, cfg, lanes, [rows])
    ref = rj.reference_rows(ref_sc, cfg, opt, device)
    return dict(control_s=secs, valid_share=float(valid.double().mean()),
                **rj.judge(kept, ref_sc, ref, opt))


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--program", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--fault", nargs="*", default=[])
    p.add_argument("--rows", type=int, default=320)
    a = p.parse_args(argv)
    card.set_cache_dirs()
    import torch

    card.require(torch, 1)
    cell = registry.cell(a.workload)
    runs = ([("program", s, None) for s in a.program]
            + [("control", s, None) for s in a.control]
            + [("fault", a.program[0], f) for f in a.fault])
    for kind, seed, fault in runs:
        t = time.perf_counter()
        if kind == "control":
            out = control(cell, seed, a.rows)
        else:
            out = program(cell, seed, a.seconds, fault)
        print(json.dumps(dict(workload=a.workload, kind=kind, seed=seed,
                              fault=fault, wall=time.perf_counter() - t,
                              **out)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
