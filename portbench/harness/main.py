"""One run of one cell (``portbench/run.py``)."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from portbench.harness import card, registry
from portbench.harness.readings import Readings
from portbench.harness.trace import top


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv, t_start: float) -> int:
    """Run the cell named in ``argv`` on the card; return the exit code."""
    args = _args(argv)
    card.set_cache_dirs()
    cell = registry.cell(args.workload)
    import torch

    try:
        card.require(torch, int(cell["workload"]["chips"]))
    except card.NoCard as e:
        _err(f"portbench: {e}")
        return 2
    entry = registry.load_module("entries", cell["workload"]["entry"])
    session = entry.Session(cell, args.seed, "cuda", bool(args.trace))
    return run(cell, session, args, t_start)


def run(cell, session, args, t_start: float) -> int:
    """Set up ``session``, measure its window, judge it and print the
    result; return the exit code."""
    import torch

    chips = int(cell["workload"]["chips"])
    session.setup()
    r = Readings(setup_s=time.perf_counter() - t_start)
    session.window(args.seconds, r)
    on_card = session.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = sum(b.lanes for b in r.batches)
    failed = attempted - sum(b.valid for b in r.batches)

    t_check = time.perf_counter()
    verdict = session.check()
    limits = cell["workload"]["limits"]
    missing = set(verdict["numbers"]) ^ set(limits)
    if missing:
        raise ValueError(f"numbers without a limit or limits without a "
                         f"number: {sorted(missing)}")
    checks = {k: dict(value=v, limit=limits[k])
              for k, v in verdict["numbers"].items()}
    correct = attempted > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    for m in cell["per_layer"] if args.trace else cell["end_to_end"]:
        value = registry.load_module("metrics", m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if on_card else session.device.type,
               kind=(torch.cuda.get_device_name() if on_card
                     else session.device.type),
               count=chips, memory_peak_bytes=int(peak))
    line = dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, device=dev)
    if args.trace:
        dev.update(busy_s=r.profile["busy_s"], window_s=r.window_s)
        line["breakdown"] = dict(
            device_ops=top(r.profile["device_ops"], key=lambda v: v[0]),
            idle_gaps=top(r.profile["idle_gaps"]))
    line["checks"] = checks

    bad = card.forbidden_modules()
    if bad:
        _err(f"portbench: the process holds {', '.join(bad)}: the port and "
             "the benchmark may load neither JAX nor the JAX package")
        return 3
    _err(f"portbench: {cell['name']} seed {args.seed} on "
         f"{card.power_limit() if on_card else session.device.type}, "
         f"{torch.get_num_threads()} host threads; "
         f"{len(r.batches)} batches in the window, setup {r.setup_s:.3f} s, "
         f"check {time.perf_counter() - t_check:.3f} s")
    _err("portbench: batch seconds " + " ".join(
        f"{b.t1 - b.t0:.3f}" for b in r.batches))
    for k, v in verdict["info"].items():
        _err(f"portbench: {k} {v}")
    for k, c in checks.items():
        _err(f"check {k} {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0
