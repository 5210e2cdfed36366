"""Profiling helper around ``torch.profiler`` (port of
``utils/profiling.py``, which wraps ``jax.profiler``).

The reference has no profiler hooks at all (SURVEY.md section 5); this adds
a host + device trace of the enclosed code as a Chrome trace JSON, which
``chrome://tracing``, Perfetto or TensorBoard's profile plugin open.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a host + device trace into ``log_dir``::

        with profile_trace("/tmp/trace") as prof:
            train_step(...)  # traced

    CPU activity always, CUDA activity when a card is present.  On exit
    the trace is written to ``log_dir/trace_<pid>_<ns>.json`` (the path is
    ``prof.trace_path``); ``prof`` is the ``torch.profiler.profile``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
