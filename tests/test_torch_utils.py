"""Port: the observability utilities (``utils/tb_writer.py``,
``utils/metrics.py``, ``utils/profiling.py``) against the JAX package's.

- ``TBEventWriter``: with ``time.time`` and ``socket.gethostname`` pinned,
  the port's events file has the JAX writer's name and bytes for the same
  scalars; ``_masked_crc`` agrees on random data; ``read_scalars`` decodes
  the logged values (float32) and refuses a corrupted record.
- ``MetricsLogger(tensorboard_dir=, jsonl=)``: one JSONL line per entry,
  one scalar per numeric metric, byte for byte what the JAX writer writes
  for the same calls.
- ``profile_trace``: a Chrome trace JSON naming the traced ops.
- Importing the port, its CLI, viz and bench pulls in no matplotlib and
  no tensorboard.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openpystruct_tpu.utils import tb_writer as jtb
from openpystruct_tpu_torch.utils import MetricsLogger, profile_trace
from openpystruct_tpu_torch.utils import tb_writer as ttb

REPO = Path(__file__).resolve().parent.parent
SCALARS = [("train_loss", 0.731, 1), ("val_loss", 1.25e-3, 1),
           ("train_loss", -2.5, 2), ("val_loss", float("inf"), 2),
           ("lr", 3e-3, 300), ("count", 7, 2 ** 40)]


@pytest.fixture
def pinned_clock(monkeypatch):
    """time.time returns 1.7e9 + 0.25 k at its k-th call (reset by
    calling the fixture's value); the host name is fixed."""
    calls = [0]

    def fake_time():
        calls[0] += 1
        return 1.7e9 + 0.25 * calls[0]

    monkeypatch.setattr(time, "time", fake_time)
    monkeypatch.setattr(socket, "gethostname", lambda: "card-host")
    return lambda: calls.__setitem__(0, 0)


def _write(mod, logdir):
    w = mod.TBEventWriter(str(logdir))
    for tag, v, step in SCALARS:
        w.scalar(tag, v, step)
    w.flush()
    w.close()
    return Path(w.path)


def test_events_file_is_jax_bytes(tmp_path, pinned_clock):
    pinned_clock()
    j = _write(jtb, tmp_path / "jax")
    pinned_clock()
    t = _write(ttb, tmp_path / "port")
    assert t.name == j.name == "events.out.tfevents.1700000000.card-host"
    assert t.read_bytes() == j.read_bytes()


def test_masked_crc_matches():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 33, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttb._masked_crc(data) == jtb._masked_crc(data)
    # the CRC-32C check value of "123456789"
    assert ttb._crc32c(b"123456789") == 0xE3069283


def test_read_scalars_decodes_and_checks(tmp_path):
    path = _write(ttb, tmp_path)
    got = ttb.read_scalars(str(path))
    want = [(step, tag, float(np.float32(v))) for tag, v, step in SCALARS]
    assert got == want
    raw = bytearray(path.read_bytes())
    raw[-6] ^= 0x01     # a byte of the last record's data
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_scalars(str(path))


def test_metrics_logger_tensorboard_and_jsonl(tmp_path, pinned_clock):
    entries = [dict(step=e, train_loss=1.0 / e, val_loss=2.0 / e, note="x")
               for e in (1, 2, 3)]
    pinned_clock()
    m = MetricsLogger(jsonl=str(tmp_path / "m.jsonl"),
                      tensorboard_dir=str(tmp_path / "tb"))
    for e in entries:
        m.log(**e)
    m.log(train_loss=9.0)           # no step: JSONL only
    m.close()
    lines = [json.loads(s) for s in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(lines) == 4 and lines[0]["step"] == 1
    assert [x["train_loss"] for x in lines] == [1.0, 0.5, 1.0 / 3, 9.0]
    (events,) = (tmp_path / "tb").iterdir()
    assert ttb.read_scalars(str(events)) == [
        (e["step"], k, float(np.float32(e[k])))
        for e in entries for k in ("train_loss", "val_loss")]
    # the same calls on the JAX package's writer: the same bytes (one
    # time.time per entry for the JSONL, then one per scalar)
    pinned_clock()
    w = jtb.TBEventWriter(str(tmp_path / "jtb"))
    for e in entries:
        time.time()
        for k in ("train_loss", "val_loss"):
            w.scalar(k, e[k], e["step"])
    w.close()
    assert events.read_bytes() == Path(w.path).read_bytes()


def test_profile_trace_writes_chrome_json(tmp_path):
    with profile_trace(str(tmp_path / "prof")) as prof:
        a = torch.ones(64, 64)
        (a @ a).sum()
    path = Path(prof.trace_path)
    assert path.parent == tmp_path / "prof" and path.suffix == ".json"
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


def test_imports_need_no_matplotlib_or_tensorboard():
    code = (
        "import sys\n"
        "import openpystruct_tpu_torch, openpystruct_tpu_torch.cli\n"
        "import openpystruct_tpu_torch.viz, openpystruct_tpu_torch.bench\n"
        "import openpystruct_tpu_torch.utils, openpystruct_tpu_torch.train\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'tensorboard', 'tensorboardX', 'jax')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
