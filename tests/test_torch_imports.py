"""Port hygiene: the port and chip_smoke.py never import JAX or the JAX
package, and chip_smoke.py fails without a card, printing no result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "openpystruct_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "openpystruct_tpu")
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_pulls_in_no_jax():
    modules = sorted(
        "openpystruct_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN) + "]\n"
        + "assert not bad, bad\n"
        + "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "openpystruct_tpu_torch.ops", "openpystruct_tpu_torch.ops.block_stream",
    "openpystruct_tpu_torch.ops.block_stream_dd",
    "openpystruct_tpu_torch.ops.beam_kernel",
    "openpystruct_tpu_torch.fem.accuracy", "openpystruct_tpu_torch.fem.solve",
])
def test_module_imports_first(module):
    """ops imports fem.solve and fem imports ops inside its functions:
    each side imports cleanly as the first module of a process."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_builds_no_kernel():
    """Importing every module, the float64 rescue kernels', the
    block-Thomas solves', the streamed float64 solve's and the autopilot's
    included, runs no nvcc and loads no library: kernels build at their
    first launch."""
    modules = sorted(p for p in PORT.rglob("*.py") if p.name != "__init__.py")
    for name in ("ops/beam_kernel_dd.py", "ops/block_tridiag.py",
                 "ops/block_stream.py", "ops/block_stream_dd.py",
                 "fem/accuracy.py"):
        assert PORT / name in modules
    code = (
        "".join("import openpystruct_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts) + "\n"
            for p in modules)
        + "from openpystruct_tpu_torch.ops import _build\n"
        + "assert _build._loaded == {} and _build.BUILD_INFO == {}\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    runs = [(REPO, REPO / "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    runs.append((tmp_path, alone))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                assert "ok" not in json.loads(line)
