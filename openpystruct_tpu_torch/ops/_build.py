"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The library goes to
``ops/_build/`` (listed in ``.gitignore``) under a name keyed by the hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is built once per checkout.  Nothing is built when a module is
imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"

# IEEE division and square root stay on (no --use_fast_math): the error-free
# transforms of the compensated refinement need exactly rounded arithmetic.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}
#: per library: {"path", "seconds" (0.0 when found built), "log"}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD / f"lib{name}-{digest[:16]}.so"


def build(names) -> dict:
    """Build every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``BUILD_INFO``."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_INFO.setdefault(name, dict(path=str(out), seconds=0.0,
                                             log=""))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = dict(path=str(out), seconds=secs, log=log)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(BUILD_INFO[name]["path"])
        return _loaded[name]
