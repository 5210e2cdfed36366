"""Profiling helpers around ``torch.profiler`` (port of
``utils/profiling.py``, which wraps ``jax.profiler``).

The reference has no profiler hooks at all (SURVEY.md section 5).
``profile_trace`` adds a host + device trace of the enclosed code as a
Chrome trace JSON, which ``chrome://tracing``, Perfetto or TensorBoard's
profile plugin open.

``span`` and ``count`` mark the program's layers from inside: the datagen
path opens a span at each layer boundary (``datagen.batch``,
``datagen.sample``, ``datagen.run_batch``, ``opt.stage``, ``opt.sync``,
``datagen.rescue``) and the kernel wrappers count their launches into the
innermost open span, so that a count has the span's time and place.  Both
record only while a ``torch.profiler`` records in the process (the
benchmark's traced window, ``profile_trace``, the CLI's ``--profile``);
otherwise each is one check of the profiler's flag.  A recorded span is
also a ``record_function`` annotation, so it appears among the profiler's
events and in every Chrome trace, on the device trace's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
from torch.autograd import profiler as _profiler

_SPANS = []      # every span recorded since the last reset, in open order
_OPEN = []       # the spans open now, outermost first
_LOOSE = {}      # the counts made with no span open: {(name, key): n}
_IDS = itertools.count(1)


class _Off:
    """The span of a process no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "_rf")

    def __init__(self, name, attrs):
        parent = _OPEN[-1] if _OPEN else None
        sid = next(_IDS)
        self.rec = dict(name=name, id=sid,
                        parent=parent["id"] if parent else None,
                        batch=_OPEN[0]["id"] if _OPEN else sid,
                        t0=None, t1=None, attrs=attrs, counts={})

    def __enter__(self):
        _SPANS.append(self.rec)
        _OPEN.append(self.rec)
        self._rf = torch.profiler.record_function(self.rec["name"])
        self._rf.__enter__()
        self.rec["t0"] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec["t1"] = time.perf_counter()
        self._rf.__exit__(*exc)
        _OPEN.pop()    # spans nest: this one is the innermost open
        return False

    def set(self, **attrs):
        """Add attributes to the span's record, e.g. what it ran."""
        self.rec["attrs"].update(attrs)


def span(name: str, **attrs):
    """A context manager around one layer's work::

        with span("opt.stage", lanes=B) as s:
            ...
            s.set(epochs=n)

    While a profiler records, the span appends a record to ``spans()``:
    ``name``, ``id``, ``parent`` (the enclosing span's id, or None),
    ``batch`` (the id of the outermost open span: on the datagen path the
    ``datagen.batch`` of the batch), ``t0`` and ``t1`` on
    ``time.perf_counter``, ``attrs``, and ``counts`` (what ``count``
    added while this was the innermost open span); its body runs inside
    ``torch.profiler.record_function(name)``.  Otherwise it returns one
    shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def count(name: str, value: int, **key) -> None:
    """Add ``value`` to the counter ``name`` under ``key`` in the innermost
    open span's ``counts``, as ``{(name, tuple(sorted(key.items()))): n}``,
    while a profiler records; otherwise return at once."""
    if not _profiler._is_profiler_enabled:
        return
    into = _OPEN[-1]["counts"] if _OPEN else _LOOSE
    k = (name, tuple(sorted(key.items())))
    into[k] = into.get(k, 0) + value


def spans() -> list:
    """The span records since the last ``reset()``, in the order opened
    (an open span has ``t1`` None)."""
    return list(_SPANS)


def counts() -> dict:
    """Every count since the last ``reset()``, in spans or not:
    ``{name: {key: n}}``, a key as ``tuple(sorted(key.items()))``."""
    out = {}
    for by_key in [s["counts"] for s in _SPANS] + [_LOOSE]:
        for (name, k), v in by_key.items():
            into = out.setdefault(name, {})
            into[k] = into.get(k, 0) + v
    return out


def reset() -> None:
    """Drop the recorded spans and counts."""
    _SPANS.clear()
    _LOOSE.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a host + device trace into ``log_dir``::

        with profile_trace("/tmp/trace") as prof:
            train_step(...)  # traced

    CPU activity always, CUDA activity when a card is present.  The spans
    and counts are reset on entry and hold the enclosed code's.  On exit
    the trace is written to ``log_dir/trace_<pid>_<ns>.json`` (the path is
    ``prof.trace_path``); ``prof`` is the ``torch.profiler.profile``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
