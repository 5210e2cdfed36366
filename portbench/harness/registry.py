"""Find a cell's files by name.

Each configuration, traffic mix, cell, per-layer or end-to-end metric and
entry is a file of its own, named after it:

    portbench/configs/<config>.json
    portbench/traffic/<traffic>.json
    portbench/workloads/<cell>.json
    portbench/metrics/<metric>.py      (a ``read(readings)`` function)
    portbench/entries/<entry>.py       (a ``Session`` class)

and ``BENCHMARK.json`` at the root of the checkout says which metrics a
cell reports.  Nothing here lists them: adding one is adding its file.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded by its path (a
    name may hold dots)."""
    path = BENCH_DIR / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    """A cell's workload file with its configuration, traffic and the
    metrics ``BENCHMARK.json`` gives it: ``end_to_end`` and ``per_layer``
    as lists of metric entries."""
    wl = load_json("workloads", name)
    bench = benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if len(entry) != 1:
        raise ValueError(f"BENCHMARK.json has no cell named {name!r}")
    for key in ("config", "traffic", "chips"):
        if entry[0][key] != wl[key]:
            raise ValueError(f"{name}: {key} is {wl[key]!r} in its file, "
                             f"{entry[0][key]!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(
        name=name, workload=wl,
        config=load_json("configs", wl["config"]),
        traffic=load_json("traffic", wl["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )
