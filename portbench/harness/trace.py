"""torch.profiler over a traced window, read in memory.

The profiler traces the host's operators and the card's operations; no
trace file is written.  From the events: the device operations by name
(summed device time and count), the union of the intervals in which an
operation ran on the device (``busy_s``), and the idle gaps between them,
each named by the innermost host operation running at its midpoint
("python" where none ran).  The profiler's own host cost widens the gaps,
so the idle share it gives is an upper bound.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

#: gaps shorter than this are summed under one name instead of attributed
SHORT_GAP_US = 10.0


class Profiler:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """``summarize`` of the profiler's raw events (read without
        building its tree of ``FunctionEvent``, which takes ~60 us an
        event)."""
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)
        rows = []
        for e in events:
            if e.is_user_annotation():
                continue
            kind = {DeviceType.CUDA: "device",
                    DeviceType.CPU: "host"}.get(e.device_type())
            if kind is not None:
                start = (e.start_ns() - base) * 1e-3
                rows.append((kind, e.name(), start,
                             start + e.duration_ns() * 1e-3))
        return summarize(rows)


def summarize(rows) -> dict:
    """``rows``: (``"device"`` or ``"host"``, name, start us, end us).
    Returns ``device_ops``: {name: [seconds, count]}; ``busy_s``;
    ``n_device``: operations on the device; ``idle_gaps``: {host op:
    seconds}."""
    dev, host = [], []
    ops = defaultdict(lambda: [0.0, 0])
    for kind, name, start, end in rows:
        if kind == "device":
            dev.append((start, end))
            o = ops[name]
            o[0] += (end - start) * 1e-6
            o[1] += 1
        else:
            host.append((start, end, name))
    dev.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return dict(device_ops={k: list(v) for k, v in ops.items()},
                busy_s=busy * 1e-6, n_device=len(dev),
                idle_gaps=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> dict:
    """Sum the gaps by the innermost host op running at their midpoints:
    sweep the midpoints in order with a heap of the ops begun so far, the
    latest begun on top, dropping ops that ended before the midpoint."""
    out = defaultdict(float)
    long_gaps = []
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_US:
            out[f"gaps under {SHORT_GAP_US:g} us"] += (g1 - g0) * 1e-6
        else:
            long_gaps.append(((g0 + g1) / 2, g1 - g0))
    long_gaps.sort()
    host.sort()
    heap, i = [], 0
    for mid, length in long_gaps:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        # midpoints rise, so an op that ended before this one is done with
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "python"] += length * 1e-6
    return dict(out)


def top(d: dict, k: int = 10, key=lambda v: v):
    """The ``k`` entries of ``d`` with the largest ``key(value)``, as
    [[name, value], ...]."""
    return [[n, key(v)] for n, v in sorted(d.items(), key=lambda kv: -key(kv[1]))[:k]]
