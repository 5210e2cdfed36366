"""The source patches of tools/bidi_clock_probe.py against kernel #5's
source as it stands: the probe runs only on a CUDA card, but whether its
clock64 stamps and variants still fit ``ops/csrc/block_tridiag.cu`` is
plain text, checked here."""

import importlib.util
from pathlib import Path

import pytest

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "bidi_clock_probe.py"


def _tool():
    spec = importlib.util.spec_from_file_location("bidi_clock_probe", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", [
    "as is", "forward rolled", "forward unrolled 2", "forward unrolled 8",
    "no right arithmetic", "back rolled"])
def test_patch_fits_the_source(variant):
    """Each variant applies to the current source: six clock64 stamps, the
    stamps' buffer passed from the C entry point through every launch, and
    the variant's own change, which no other variant makes."""
    tool = _tool()
    src = tool.SOURCE.read_text()
    out = tool.patched(src, variant)
    assert out.count("clock64()") == 6
    assert out.count("x, B, n, st, clk);") == 4
    assert "long long* clk) {" in out
    others = {v: tool.patched(src, v) for v in tool.VARIANTS if v != variant}
    assert all(o != out for o in others.values())
    assert (out == tool.patched(src, "as is")) == (variant == "as is")


def test_patch_refuses_what_it_does_not_fit():
    """An unknown variant, or a source the stamps no longer fit, raises
    rather than building a probe of something else."""
    tool = _tool()
    src = tool.SOURCE.read_text()
    with pytest.raises(ValueError, match="unknown variant"):
        tool.patched(src, "faster")
    with pytest.raises(ValueError, match="no longer fits"):
        tool.patched(src.replace("__syncthreads();", "__syncwarp();"),
                     "as is")
