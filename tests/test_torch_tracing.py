"""Port: the spans and counters of the datagen path
(``openpystruct_tpu_torch/utils/profiling.py``) and the benchmark's
readers of them, on CPU batches.

- (a) With no profiler, ``generate_batch`` records no span and no count,
  and ``span()`` is the shared no-op.
- (b) Under ``torch.profiler``: one ``datagen.batch`` holding one
  ``datagen.sample`` and one ``datagen.run_batch``, all of one batch id;
  an ``opt.stage`` per stage of the compaction schedule, whose epochs sum
  to the epochs launched; every ``opt.sync`` inside a stage; the same
  names as user annotations among the profiler's events, the sampler's
  ``aten::sort`` inside ``datagen.sample``'s; the batch bitwise the
  untraced one.
- (c) The program's ``launch`` counts, kept in the innermost open span,
  equal what the benchmark's wrappers (``portbench/entries/datagen.py``
  ``_wrappers``) record on the same batches, and ``launched_epochs_per_lane``
  reads the wrappers' launched lanes over the lanes drawn.
- (d) The readers ``sampler_s_per_batch``, ``host_ms_per_epoch``,
  ``sync_wait_ms_per_epoch`` and ``launched_epochs_per_lane`` on an empty
  ``Readings`` and on hand-built spans.
- ``datagen --profile``: the Chrome trace carries the spans.
"""

import json
import sys
import types
from pathlib import Path

import pytest
import torch

from openpystruct_tpu_torch import cli
from openpystruct_tpu_torch.config import ScenarioConfig
from openpystruct_tpu_torch.datagen import generate
from openpystruct_tpu_torch.opt.beam_opt import _compact_sizes
from openpystruct_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.entries.datagen import _wrappers  # noqa: E402
from portbench.harness import registry  # noqa: E402
from portbench.harness.readings import Readings  # noqa: E402

# a 21-node fixed bridge, so that the CPU runs 2048 lanes in seconds
SCEN = ScenarioConfig(num_nodes=21, fixed_roller_tags=(3, 8, 14, 17, 20))
LANES = [64, 2048]
REFINE = 1
READERS = ["sampler_s_per_batch", "host_ms_per_epoch",
           "sync_wait_ms_per_epoch", "launched_epochs_per_lane"]


def _key(**key):
    return tuple(sorted(key.items()))


def _batch(lanes):
    return generate.generate_batch(torch.Generator().manual_seed(5), lanes,
                                   SCEN, refine=REFINE, device="cpu")


def _events(prof):
    """(name, is user annotation, start ns, end ns) of the profiler's raw
    events."""
    return [(e.name(), e.is_user_annotation(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


@pytest.fixture(scope="module")
def runs():
    """For each lane count: the batch untraced, then traced under
    torch.profiler and the benchmark's wrappers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for lanes in LANES:
            profiling.reset()
            off = _batch(lanes)
            off_rec = (profiling.spans(), profiling.counts())
            r = Readings()
            session = types.SimpleNamespace(
                generate=generate, cfg={"datagen": {"refine": REFINE}})
            with _wrappers(session, r), torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                profiling.reset()
                on = _batch(lanes)
            out[lanes] = dict(
                off=off, off_rec=off_rec, on=on, spans=profiling.spans(),
                counts=profiling.counts(), events=_events(prof),
                launches=dict(r.launches),
                needed={k: int(v) for k, v in r.needed.items()})
    finally:
        torch.set_num_threads(threads)
        profiling.reset()
    return out


@pytest.mark.parametrize("lanes", LANES)
def test_off_records_nothing(runs, lanes):
    assert runs[lanes]["off_rec"] == ([], {})
    assert profiling.span("datagen.batch", lanes=1) is profiling._OFF
    with profiling.span("opt.stage") as s:
        s.set(epochs=3)
    profiling.count("launch", 1, kind="semi")
    assert profiling.spans() == [] and profiling.counts() == {}


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.mark.parametrize("lanes", LANES)
def test_spans_of_a_traced_batch(runs, lanes):
    run = runs[lanes]
    spans = run["spans"]
    (batch,) = _by_name(spans, "datagen.batch")
    (sample,) = _by_name(spans, "datagen.sample")
    (prog,) = _by_name(spans, "datagen.run_batch")
    assert batch["parent"] is None and batch["attrs"] == {"lanes": lanes}
    assert sample["parent"] == prog["parent"] == batch["id"]
    assert {s["batch"] for s in spans} == {batch["id"]}
    assert all(s["t1"] is not None and batch["t0"] <= s["t0"] <= s["t1"]
               <= batch["t1"] for s in spans)
    # fixed bridge, rescue off by default: no rescue span
    assert not _by_name(spans, "datagen.rescue")

    stages = _by_name(spans, "opt.stage")
    sizes = _compact_sizes(lanes, 512) if lanes >= 2048 else [lanes]
    assert [s["attrs"]["lanes"] for s in stages] == sizes
    assert all(s["parent"] == prog["id"] for s in stages)
    n = SCEN.num_nodes
    for s in stages:
        # one step launch an epoch, at the stage's bucket, counted in the
        # stage's own span
        semi = _key(kind="semi", lanes=s["attrs"]["lanes"], n=n, refine=REFINE)
        assert s["counts"] == {("launch", semi): s["attrs"]["epochs"]}
    launched = run["counts"]["launch"]
    assert sum(s["attrs"]["epochs"] for s in stages) == sum(
        v for k, v in launched.items() if dict(k)["kind"] == "semi") > 0
    stage_ids = {s["id"] for s in stages}
    syncs = _by_name(spans, "opt.sync")
    assert syncs and all(s["parent"] in stage_ids for s in syncs)

    # the same spans as user annotations in the profiler's events
    notes = [e for e in run["events"] if e[1]]
    assert sorted(e[0] for e in notes) == sorted(s["name"] for s in spans)
    (note,) = [e for e in notes if e[0] == "datagen.sample"]
    sorts = [e for e in run["events"] if e[0] == "aten::sort" and not e[1]]
    assert any(note[2] <= e[2] and e[3] <= note[3] for e in sorts)

    # tracing changes no result
    off, on = run["off"], run["on"]
    for a, b in ((off.result.I, on.result.I), (off.valid, on.valid),
                 (off.result.n_epochs, on.result.n_epochs),
                 (off.scenario.point_loads, on.scenario.point_loads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", LANES)
def test_counts_equal_the_benchmark_wrappers(runs, lanes):
    run = runs[lanes]
    assert set(run["counts"]) == {"launch"}
    as_wrappers = {(k["kind"], k["lanes"], k["n"], k["refine"]): v
                   for k, v in ((dict(k), v)
                                for k, v in run["counts"]["launch"].items())}
    assert run["launches"] and as_wrappers == run["launches"]
    (batch,) = _by_name(run["spans"], "datagen.batch")
    r = Readings(start=batch["t0"], window_s=batch["t1"] - batch["t0"])
    reader = registry.load_module("metrics", "launched_epochs_per_lane")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "spans", lambda: run["spans"])
        got = reader.read(r)
    assert got == sum(v * lanes_ for (kind, lanes_, _, _), v
                      in run["launches"].items() if kind == "semi") / lanes
    # the work the batch program needed is in the batch it returns
    n = SCEN.num_nodes
    assert run["needed"][("analysis", n, REFINE)] == lanes
    assert run["needed"][("semi", n, REFINE)] == int(
        run["on"].result.n_epochs.sum())


def _span(sid, name, t0, t1, parent=None, counts=None, **attrs):
    return dict(name=name, id=sid, parent=parent, batch=None, t0=t0, t1=t1,
                attrs=attrs, counts=counts or {})


def _steps(kind, lanes, k):
    """A span's ``counts``: ``k`` launches of ``kind`` at ``lanes``."""
    return {("launch", _key(kind=kind, lanes=lanes, n=21, refine=1)): k}


# two batches in the window [10, 20], one before it and one straddling
# its end: (sampler s, run_batch s, stage s, epochs and launches, sync s)
# each
HAND = [
    _span(1, "datagen.batch", 5.0, 9.0, lanes=64),
    _span(2, "datagen.sample", 5.0, 6.0, 1),
    _span(3, "datagen.run_batch", 6.0, 9.0, 1),
    _span(4, "opt.stage", 6.0, 9.0, 3, _steps("semi", 64, 40), lanes=64,
          epochs=40),
    _span(5, "opt.sync", 6.0, 8.0, 4),
    _span(10, "datagen.batch", 10.0, 14.0, lanes=64),
    _span(11, "datagen.sample", 10.0, 10.5, 10),
    _span(12, "datagen.run_batch", 10.5, 14.0, 10,
          _steps("analysis", 64, 1)),
    _span(13, "opt.stage", 10.5, 12.5, 12, _steps("semi", 64, 8), lanes=64,
          epochs=8),
    _span(14, "opt.sync", 10.5, 11.0, 13),
    _span(15, "opt.sync", 12.0, 12.5, 13),
    _span(16, "opt.stage", 12.5, 14.0, 12, _steps("semi", 32, 2), lanes=32,
          epochs=2),
    _span(17, "opt.sync", 13.5, 14.0, 16),
    _span(20, "datagen.batch", 14.0, 19.0, lanes=64),
    _span(21, "datagen.sample", 14.0, 15.5, 20),
    _span(22, "datagen.run_batch", 15.5, 19.0, 20),
    _span(23, "opt.stage", 15.5, 19.0, 22, _steps("adjoint", 64, 10),
          lanes=64, epochs=10),
    _span(24, "opt.sync", 15.5, 16.5, 23),
    # a rescue's stage and sync: not the batch program's
    _span(25, "datagen.rescue", 19.0, 19.5, 20),
    _span(26, "opt.stage", 19.0, 19.5, 25, _steps("semi", 32, 100),
          lanes=32, epochs=100),
    _span(27, "opt.sync", 19.0, 19.5, 26),
    _span(30, "datagen.batch", 19.5, 21.0, lanes=64),
    _span(31, "datagen.sample", 19.5, 20.5, 30),
    _span(32, "datagen.run_batch", 20.5, 21.0, 30),
]
EXPECT = {
    "sampler_s_per_batch": (0.5 + 1.5) / 2,
    # stages 2.0 + 1.5 + 3.5 s less syncs 0.5 + 0.5 + 0.5 + 1.0 s, 20 epochs
    "host_ms_per_epoch": 1e3 * (7.0 - 2.5) / 20,
    # syncs 2.5 s over the same 20 epochs
    "sync_wait_ms_per_epoch": 1e3 * 2.5 / 20,
    # step launches' lanes 8 x 64 + 2 x 32 + 10 x 64 over 2 x 64 lanes drawn
    "launched_epochs_per_lane": (512 + 64 + 640) / 128,
}


@pytest.mark.parametrize("name", READERS)
def test_reader(name, monkeypatch):
    reader = registry.load_module("metrics", name)
    assert reader.read(Readings()) is None
    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    assert reader.read(Readings()) is None
    assert reader.read(Readings(start=10.0, window_s=10.0)) == pytest.approx(
        EXPECT[name], rel=1e-12)
    # a version of the program without spans reads nothing
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(Readings(start=10.0, window_s=10.0)) is None


def test_datagen_profile_writes_the_spans(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        n = cli.main(["datagen", "--num-samples", "48", "--batch-size", "24",
                      "--max-epochs", "15", "--refine", "0",
                      "--random-bridge", "--num-nodes", "21", "--output",
                      str(tmp_path / "ds.json"), "--profile",
                      str(tmp_path / "prof"), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert n > 0
    (trace,) = (tmp_path / "prof").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e.get("name") for e in events
             if e.get("cat") == "user_annotation"]
    for name, k in (("datagen.batch", 2), ("datagen.sample", 2),
                    ("datagen.run_batch", 2), ("datagen.rescue", 2)):
        assert names.count(name) == k, name
    assert names.count("opt.stage") >= 2 and "opt.sync" in names
    assert [s["name"] for s in profiling.spans()].count("datagen.batch") == 2
