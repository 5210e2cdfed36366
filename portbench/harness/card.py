"""The card the run is on, and what the run must not have loaded."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from portbench.harness.registry import ROOT

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "openpystruct_tpu")

#: the driver's cache of kernels compiled from PTX, at a fixed path inside
#: the checkout (the port's own kernels are built by nvcc into
#: ``openpystruct_tpu_torch/ops/_build/``, inside the checkout too)
CACHE_DIRS = dict(CUDA_CACHE_PATH="cuda")


def set_cache_dirs() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)


class NoCard(RuntimeError):
    pass


def require(torch, chips: int) -> None:
    """Raise ``NoCard`` unless CUDA has at least ``chips`` cards."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: the benchmark "
                     "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or "unknown"."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def forbidden_modules() -> list:
    """The forbidden top-level names ``sys.modules`` holds, compared
    whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))
