"""ctypes bindings for the native dataset writer and reader (port of
``datagen/native.py``).

The C++ sources are the port's own copies, ``datagen/csrc/dataset_writer.cpp``
and ``datagen/csrc/dataset_reader.cpp``.  Each is compiled on first use with
``g++ -O3 -std=c++17 -shared -fPIC`` (``-pthread`` for the writer) into
``ops/_build/`` (listed in ``.gitignore``), beside the CUDA libraries, under a
name keyed by the hash of the source and the flags: an edited source is
rebuilt, an unchanged one is built once per checkout.  A build goes to a
temporary name first and is renamed into place, so processes that build at
the same time do not load a half-written library.

Plain C ABI and ctypes, as in the JAX package.  The functions take numpy
arrays: a caller pulls the JSON's fields to the host first
(``generate._json_fields``).  Without a toolchain ``native_available`` and
``reader_available`` are False; ``JsonStreamWriter`` then renders the same
fragments in Python and ``io.read_json_dataset`` falls back to ``json.load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "ops" / "_build"

WRITER_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
READER_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
# node_x, roller, loads, I, shear, moment, defl, rot, valid, roller_order,
# force_order after (dir or path, B, n)
_FIELD_ARGS = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _F32P, _U8P,
               _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _U8P, _I32P, _I32P]

_libs: dict = {}
_failed: set = set()


def library_path(source: str, flags) -> Path:
    """Where the library built from ``csrc/<source>`` with ``flags`` goes."""
    src = (_CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return _BUILD / f"lib{Path(source).stem}-{digest[:16]}.so"


def _compile(source: str, flags) -> ctypes.CDLL:
    out = library_path(source, flags)
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, str(_CSRC / source), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def _load(source: str, flags, bind) -> Optional[ctypes.CDLL]:
    """The library built from ``source``, or None when it cannot be built
    or loaded (the failure is remembered for the process)."""
    if source in _libs:
        return _libs[source]
    if source in _failed:
        return None
    try:
        lib = _compile(source, flags)
    except (OSError, subprocess.CalledProcessError):
        _failed.add(source)
        return None
    bind(lib)
    _libs[source] = lib
    return lib


def _bind_writer(lib):
    lib.opsio_write_json_dataset.restype = ctypes.c_int
    lib.opsio_write_json_dataset.argtypes = _FIELD_ARGS + [ctypes.c_int]
    lib.opsio_append_json_chunk.restype = ctypes.c_int
    lib.opsio_append_json_chunk.argtypes = _FIELD_ARGS + [ctypes.c_int,
                                                          ctypes.c_int]
    lib.opsio_finalize_json.restype = ctypes.c_int
    lib.opsio_finalize_json.argtypes = [ctypes.c_char_p, ctypes.c_char_p]


def _bind_reader(lib):
    lib.opsio_read_open.restype = ctypes.c_void_p
    lib.opsio_read_open.argtypes = [ctypes.c_char_p]
    for fn in ("opsio_read_rows", "opsio_read_nvals"):
        getattr(lib, fn).restype = ctypes.c_longlong
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.opsio_read_is_scalar.restype = ctypes.c_int
    lib.opsio_read_is_scalar.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.opsio_read_fill.restype = ctypes.c_int
    lib.opsio_read_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.opsio_read_close.restype = None
    lib.opsio_read_close.argtypes = [ctypes.c_void_p]


def _build_and_load() -> Optional[ctypes.CDLL]:
    """The native writer, or None without a toolchain."""
    return _load("dataset_writer.cpp", WRITER_FLAGS, _bind_writer)


def _build_and_load_reader() -> Optional[ctypes.CDLL]:
    """The native reader, or None without a toolchain."""
    return _load("dataset_reader.cpp", READER_FLAGS, _bind_reader)


def native_available() -> bool:
    return _build_and_load() is not None


def reader_available() -> bool:
    return _build_and_load_reader() is not None


def read_json_dataset_native(path: str, keys) -> Optional[dict]:
    """Parse the columnar dataset JSON with the native reader.

    Returns a dict mapping each present key to:
      - a (rows, width) float32 array when every row has the same length,
      - a list of float32 row arrays when the rows are ragged,
      - a (rows,) float64 array for scalar columns (num_nodes, L).
    Missing keys are omitted; with duplicate keys the last one wins.
    Returns None when the reader is unavailable or the file does not parse
    (callers fall back to ``json.load``).
    """
    lib = _build_and_load_reader()
    if lib is None:
        return None
    h = lib.opsio_read_open(str(path).encode())
    if not h:
        return None
    try:
        out = {}
        for key in keys:
            kb = key.encode()
            rows = lib.opsio_read_rows(h, kb)
            if rows < 0:
                continue
            vals = np.empty(lib.opsio_read_nvals(h, kb), np.float64)
            offs = np.empty(rows + 1, np.int64)
            if lib.opsio_read_fill(
                    h, kb, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))):
                return None
            if lib.opsio_read_is_scalar(h, kb):
                out[key] = vals
                continue
            widths = np.diff(offs)
            v32 = vals.astype(np.float32)
            if rows and (widths == widths[0]).all():
                out[key] = v32.reshape(rows, -1)
            else:
                out[key] = [v32[offs[i]:offs[i + 1]] for i in range(rows)]
        return out
    finally:
        lib.opsio_read_close(h)


def _contig_fields(fields: dict) -> tuple:
    """The nine schema arrays and the two optional draw orders as the C
    types the writer reads (None for an absent order)."""
    def f32(k):
        return np.ascontiguousarray(fields[k], dtype=np.float32)

    def u8(k):
        return np.ascontiguousarray(fields[k], dtype=np.uint8)

    def i32(k):
        x = fields.get(k)
        return None if x is None else np.ascontiguousarray(x, dtype=np.int32)

    return (f32("node_x"), u8("roller"), f32("loads"), f32("I"),
            f32("shear"), f32("moment"), f32("defl"), f32("rot"),
            u8("valid"), i32("roller_order"), i32("force_order"))


# the writer's thread count: 0 renders on every hardware thread
_ALL_THREADS = 0


def _c_args(arrs) -> list:
    """(B, n, pointers...) for the writer's entry points; an absent order
    is a NULL pointer (ascending node order)."""
    B, n = arrs[0].shape
    ptrs = []
    for a, ptype in zip(arrs, _FIELD_ARGS[3:]):
        ptrs.append(ptype() if a is None else a.ctypes.data_as(ptype))
    return [B, n, *ptrs]


def write_json_dataset_native(fields: dict, path: str) -> int:
    """Serialize a fields dict (numpy arrays node_x, roller, loads, I, shear,
    moment, defl, rot, valid[, roller_order, force_order], as
    ``generate._json_fields`` returns) straight to the 13-key JSON, dropping
    the invalid lanes.  Returns the number of samples written; raises
    RuntimeError when the native writer is unavailable."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError("native dataset writer unavailable (no g++?)")
    arrs = _contig_fields(fields)
    written = lib.opsio_write_json_dataset(str(path).encode(),
                                           *_c_args(arrs), _ALL_THREADS)
    if written < 0:
        raise RuntimeError(f"native writer failed with code {written}")
    return written


class JsonStreamWriter:
    """Serialize dataset batches one at a time to the 13-key columnar JSON.

    Each ``append(fields)`` renders one batch to per-key fragment files in a
    directory beside the target; ``finalize()`` stitches them into the
    document and removes the directory.  Peak host memory is one batch.

    Uses the native writer when it is available, otherwise the same
    fragments rendered in Python (``json.dumps``); the two routes write the
    JAX package's bytes, route for route.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.written = 0
        self._lib = _build_and_load()
        out_dir = os.path.dirname(os.path.abspath(self.path)) or "."
        self._dir = tempfile.mkdtemp(prefix=".jsonstream-", dir=out_dir)

    def append(self, fields: dict) -> int:
        """Render and append one batch; returns the valid samples
        appended."""
        if self._lib is None:
            r = self._py_append(fields)
        else:
            r = self._lib.opsio_append_json_chunk(
                self._dir.encode(), *_c_args(_contig_fields(fields)),
                1 if self.written else 0, _ALL_THREADS)
            if r < 0:
                raise RuntimeError(f"native chunk append failed: {r}")
        self.written += r
        return r

    def _py_append(self, fields: dict) -> int:
        from openpystruct_tpu_torch.datagen.io import (
            SCHEMA_KEYS,
            columnar_from_fields,
        )

        cols = columnar_from_fields(fields)
        kept = len(cols["I_values"])
        if not kept:
            return 0
        for key_i, key in enumerate(SCHEMA_KEYS):
            frag = os.path.join(self._dir, f"col_{key_i:02d}.part")
            with open(frag, "a") as f:
                if self.written:
                    f.write(",")
                # the column body without its enclosing brackets
                f.write(json.dumps(cols[key])[1:-1])
        return kept

    def finalize(self) -> int:
        """Stitch the fragments into the JSON; returns the total samples."""
        from openpystruct_tpu_torch.datagen.io import SCHEMA_KEYS

        if self._lib is not None:
            r = self._lib.opsio_finalize_json(self._dir.encode(),
                                              self.path.encode())
            if r < 0:
                raise RuntimeError(f"native finalize failed: {r}")
        else:
            with open(self.path, "w") as out:
                out.write("{")
                for key_i, key in enumerate(SCHEMA_KEYS):
                    if key_i:
                        out.write(",")
                    out.write(f'"{key}":[')
                    frag = os.path.join(self._dir, f"col_{key_i:02d}.part")
                    if os.path.exists(frag):
                        with open(frag) as f:
                            shutil.copyfileobj(f, out)
                    out.write("]")
                out.write("}")
        shutil.rmtree(self._dir, ignore_errors=True)
        return self.written
