"""What a run measured, for the metric readers (``portbench/metrics``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Batch:
    t0: float          # host clock when the batch was called
    t1: float          # when its result was on the host
    lanes: int         # lanes drawn
    valid: int         # lanes the batch returned valid


@dataclasses.dataclass
class Readings:
    setup_s: float = 0.0
    #: the measured window [start, start + window_s] on the host clock; with
    #: --trace 1 the traced window, from the first batch's call to the last
    #: batch's result
    start: float = 0.0
    window_s: float = 0.0
    batches: list = dataclasses.field(default_factory=list)
    #: lanes each kernel mode had to run, by (kind, n, refine), as the
    #: program's results count them (--trace 1 only)
    needed: dict = dataclasses.field(default_factory=dict)
    #: launches by (kind, lanes, n, refine), from the launch wrappers
    launches: dict = dataclasses.field(default_factory=dict)
    #: ``trace.summarize`` of the traced window (--trace 1 only)
    profile: Optional[dict] = None

    def in_window(self, b: Batch) -> float:
        """The share of batch ``b``'s time that lies inside the window."""
        lo, hi = max(b.t0, self.start), min(b.t1, self.start + self.window_s)
        return max(0.0, hi - lo) / (b.t1 - b.t0) if b.t1 > b.t0 else 0.0
