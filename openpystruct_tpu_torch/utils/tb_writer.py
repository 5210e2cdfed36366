"""Zero-dependency TensorBoard event-file writer (port of
``utils/tb_writer.py``, copied: the module imports no JAX).

The reference has no structured observability at all (print() lines,
SURVEY.md section 5); ``MetricsLogger`` adds JSONL plus this optional
TensorBoard sink.  Neither TensorFlow, tensorboardX nor the tensorboard
package is a dependency (``torch.utils.tensorboard`` needs the last), so
the event files are written directly: a TB scalar stream is TFRecord
framing (length + masked-crc32c header per record) around hand-encoded
protobuf ``Event`` messages — both formats are tiny and stable, and
encoding them by hand keeps the sink dependency-free.  For the same
scalars, wall times and host name the file is byte for byte the JAX
package's.

Wire-format facts used (protobuf encoding spec + TFRecord spec):
- Event: wall_time = field 1 (double), step = field 2 (varint int64),
  file_version = field 3 (bytes), summary = field 5 (message).
- Summary: value = repeated field 1 (message).
- Summary.Value: tag = field 1 (bytes), simple_value = field 2 (float).
- TFRecord: u64le(len) + u32le(maskedcrc(len_bytes)) + data +
  u32le(maskedcrc(data)); crc is crc32c with TF's rotate-and-add mask.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # protobuf int64 two's-complement
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _varint_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
    msg = _f64(1, wall_time)
    if step:
        msg += _varint_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary is not None:
        msg += _bytes_field(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes_field(1, tag.encode()) + _f32(2, float(value))
    return _bytes_field(1, val)


class TBEventWriter:
    """Minimal ``SummaryWriter``-alike: ``scalar(tag, value, step)`` into
    a standard ``events.out.tfevents.*`` file under ``logdir`` that
    TensorBoard reads directly."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        ts = time.time()
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(ts)}.{host}"
        )
        self._fh = open(self.path, "ab")
        self._record(_event(ts, file_version="brain.Event:2"))

    def _record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(data)
        self._fh.write(struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int):
        self._record(
            _event(time.time(), step=int(step),
                   summary=_scalar_summary(tag, value))
        )

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(msg: bytes):
    """(field, value) pairs of a protobuf message: ints for varints, bytes
    for fixed-width and length-delimited fields."""
    i = 0
    while i < len(msg):
        key, i = _read_varint(msg, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(msg, i)
        elif wire in (1, 5):
            w = 8 if wire == 1 else 4
            v, i = msg[i:i + w], i + w
        elif wire == 2:
            n, i = _read_varint(msg, i)
            v, i = msg[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, v


def read_scalars(path: str):
    """The scalars of an events file as ``[(step, tag, value), ...]``, in
    file order; raises ``ValueError`` on a record whose length or data CRC
    does not match."""
    with open(path, "rb") as fh:
        buf = fh.read()
    out, i = [], 0
    while i < len(buf):
        header = buf[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", buf[i + 8:i + 12])
        data = buf[i + 12:i + 12 + n]
        (dcrc,) = struct.unpack("<I", buf[i + 12 + n:i + 16 + n])
        if crc != _masked_crc(header) or dcrc != _masked_crc(data):
            raise ValueError(f"bad record CRC at byte {i} of {path}")
        i += 16 + n
        ev = dict(_fields(data))
        if 5 not in ev:
            continue
        for f, val in _fields(ev[5]):
            v = dict(_fields(val))
            out.append((ev.get(2, 0), v[1].decode(),
                        struct.unpack("<f", v[2])[0]))
    return out
