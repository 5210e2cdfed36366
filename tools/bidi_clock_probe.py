#!/usr/bin/env python3
"""Where kernel #5's time goes: SM cycles by phase of the bidirectional
block-Thomas kernel, from clock64 stamps in patched copies of its source,
on one CUDA card.

    python tools/bidi_clock_probe.py [--cases 512x101,512x1001,16384x101]

Copies ``openpystruct_tpu_torch/ops/csrc/block_tridiag.cu`` with clock64
stamps (block start, the left chain's first tile, each chain's end of the
forward sweep, the meeting row done, the block barrier passed, each chain's
end of its back sweep) written to one extra pointer argument, in these
variants:

- ``as is``: the stamps alone;
- ``forward rolled``, ``forward unrolled 2``, ``forward unrolled 8``: each
  chain's forward row loop rolled or unrolled 2 or 8 rows deep (the kernel
  unrolls it 4 deep; its first build, 8);
- ``no right arithmetic``: the right chain stages and stores its rows but
  runs no row step (x is wrong; it shows what the left chain costs alone);
- ``back rolled``: the back sweeps' full-tile row loops rolled too.

Each is built with ``nvcc`` (the port's flags) into
``openpystruct_tpu_torch/ops/_build/probe/`` and launched through ctypes on
random SPD systems of B lanes and n rows per case.  Prints per variant and
case the CUDA-event ms a launch (mean of 20), the median over blocks of the
cycles from block start to each stamp, and the forward sweep's cycles a row
(left chain, after its first tile) and the back sweeps' (both).  Every
variant but ``no right arithmetic`` must give x bitwise equal to the
kernel's own (``block_tridiag.launch_thomas_bidi``), or the probe exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "openpystruct_tpu_torch" / "ops" / "csrc" / "block_tridiag.cu"
OUT = REPO / "openpystruct_tpu_torch" / "ops" / "_build" / "probe"
STAMPS = ("left fwd end", "right fwd end", "meeting done", "after barrier",
          "left bwd end", "right bwd end", "left first tile")

# (old, new): each old text must occur once in the source
_STAMP_EDITS = (
    ("float* __restrict__ x, int B, int n) {\n  extern __shared__",
     "float* __restrict__ x, int B, int n, long long* clk) {\n"
     "  long long* ck = clk + (size_t)blockIdx.x * 8;\n"
     "  if (threadIdx.x == 0) ck[0] = clock64();\n  extern __shared__"),
    ("      bar_sync<32 * (1 + kStagers)>(fwd_full(s, c % R));\n      row =",
     "      bar_sync<32 * (1 + kStagers)>(fwd_full(s, c % R));\n"
     "      if (c == 0 && t == 0 && s == 0) ck[7] = clock64();\n      row ="),
    ("    if (s == 1) {  // the right chain's carry",
     "    if (t == 0) ck[1 + s] = clock64();\n"
     "    if (s == 1) {  // the right chain's carry"),
    ("      for (int a = 0; a < 3; ++a) carry[(21 + a) * 32 + t] = xm.v[a];\n"
     "    }",
     "      for (int a = 0; a < 3; ++a) carry[(21 + a) * 32 + t] = xm.v[a];\n"
     "      if (t == 0) ck[3] = clock64();\n    }"),
    ("  __syncthreads();\n\n  // ---- back sweeps",
     "  __syncthreads();\n  if (threadIdx.x == 0) ck[4] = clock64();\n\n"
     "  // ---- back sweeps"),
    ("    bar_arrive<kSide>(bwd_empty(s, j % R));\n  }\n}",
     "    bar_arrive<kSide>(bwd_empty(s, j % R));\n  }\n"
     "  if (t == 0) ck[5 + s] = clock64();\n}"),
    ("float* ws, float* x, int B, int n, cudaStream_t st) {",
     "float* ws, float* x, int B, int n, cudaStream_t st, long long* clk) {"),
    ("ws, x,\n                                                  B, n);",
     "ws, x,\n                                                  B, n, clk);"),
    ("float* ws, float* x, int B, int n, void* stream) {",
     "float* ws, float* x, int B, int n, void* stream,\n"
     "                    long long* clk) {"),
)
_FWD_LOOPS = (
    "#pragma unroll 4\n"
    "        for (int r = 0; r < min(tl.cnt, m - tl.lo); ++r) {",
    "#pragma unroll 4\n        for (int r = tl.cnt - 1; r >= 0; --r) {",
)
_BWD_LOOPS = (
    "#pragma unroll\n        for (int r = kT - 1; r >= 0; --r) step(r);",
    "#pragma unroll\n        for (int r = 0; r < kT; ++r) step(r);",
)
_RIGHT_STEP = (
    "          right_row(read_m(row + 9 * r), read_m(row + 9 * kT + 9 * r),\n"
    "                    read_v(row + 18 * kT + 3 * r), k, sinv_r);")
FORWARD = {"forward rolled": "1", "forward unrolled 2": "2",
           "forward unrolled 8": "8"}
VARIANTS = ("as is", *FORWARD, "no right arithmetic", "back rolled")


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the probe's patch no longer fits the source: "
                         f"{old[:60]!r} occurs {src.count(old)} times")
    return src.replace(old, new)


def patched(src: str, variant: str) -> str:
    """The kernel source with clock64 stamps, changed as ``variant`` says."""
    for old, new in _STAMP_EDITS:
        src = _replace(src, old, new)
    # the launcher's switch passes the stamps' buffer on
    src = src.replace("x, B, n, st);", "x, B, n, st, clk);")
    if variant in FORWARD:
        for old in _FWD_LOOPS:
            src = _replace(src, old, old.replace(
                "unroll 4", "unroll " + FORWARD[variant]))
    elif variant == "no right arithmetic":
        src = _replace(src, _RIGHT_STEP, "          k.y.v[0] += row[9 * r];")
    elif variant == "back rolled":
        for old in _BWD_LOOPS:
            src = _replace(src, old, old.replace("unroll", "unroll 1"))
    elif variant != "as is":
        raise ValueError(f"unknown variant {variant!r}")
    return src


def _lanes(B: int, sms: int) -> int:
    """Lanes per block the kernel picks (block_tridiag.cu pick_lanes)."""
    for L in (4, 8, 16):
        if -(-B // L) <= 2 * sms:
            return L
    return 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="512x101,512x1001,2048x101,16384x101",
                    help="comma-separated BxN")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from openpystruct_tpu_torch.ops import _build
    from openpystruct_tpu_torch.ops import block_tridiag as tbt

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for v in VARIANTS:
        cu = OUT / f"probe_{v.replace(' ', '_')}.cu"
        cu.write_text(patched(src, v))
        procs[v] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(
                ".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{v}: nvcc exited {proc.returncode}\n{log}")
        regs = sorted({int(line.split("Used ")[1].split(" ")[0])
                       for line in log.splitlines() if "Used " in line})
        print(f"{v}: registers {regs}")
        lib = ctypes.CDLL(str(OUT / f"probe_{v.replace(' ', '_')}.so"))
        lib.thomas_bidi_f32.argtypes = [P] * 5 + [I] * 2 + [P, P]
        lib.thomas_bidi_f32.restype = I
        libs[v] = lib
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = []
    for case in args.cases.split(","):
        B, n = (int(s) for s in case.split("x"))
        g = torch.Generator().manual_seed(B + n)
        d = torch.randn((B, n, 3, 3), generator=g, dtype=torch.float64)
        d = d @ d.transpose(-1, -2) + 6.0 * torch.eye(3, dtype=torch.float64)
        u = torch.randn((B, n - 1, 3, 3), generator=g,
                        dtype=torch.float64) * 0.3
        b = torch.randn((B, n, 3), generator=g, dtype=torch.float64)
        d, u, b = (t.float().to(dev) for t in (d, u, b))
        ref = tbt.launch_thomas_bidi(d, u, b)
        blocks = -(-B // _lanes(B, sms))
        ws = torch.empty(-(-B // 32) * 32 * n * 12, device=dev)
        x = torch.empty((B, n, 3), device=dev)
        clk = torch.zeros(blocks * 8, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        m = n // 2
        for v, lib in libs.items():
            def launch():
                rc = lib.thomas_bidi_f32(d.data_ptr(), u.data_ptr(),
                                         b.data_ptr(), ws.data_ptr(),
                                         x.data_ptr(), B, n, stream,
                                         clk.data_ptr())
                if rc != 0:
                    raise SystemExit(f"{v}: CUDA error {rc}")
            for _ in range(3):
                launch()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(20):
                launch()
            end.record()
            torch.cuda.synchronize()
            if v != "no right arithmetic" and not torch.equal(x, ref):
                bad.append((v, case))
            c = clk.view(blocks, 8).cpu().numpy().astype(np.float64)
            med = dict(zip(STAMPS, np.median(c[:, 1:] - c[:, :1], axis=0)))
            fwd_row = ((med["left fwd end"] - med["left first tile"])
                       / max(m - 8, 1))
            bwd_row = (max(med["left bwd end"], med["right bwd end"])
                       - med["after barrier"]) / m
            print(f"B={B} n={n} [{v}] {start.elapsed_time(end) / 20:.4f} ms "
                  "a launch | median cycles from block start: "
                  + ", ".join(f"{k} {med[k]:.0f}" for k in STAMPS)
                  + f" | forward {fwd_row:.0f} a row (left, past its first "
                  f"tile), back {bwd_row:.0f} a row")
    if bad:
        print(f"x differs from the kernel's own: {bad}")
        return 1
    print("every variant but 'no right arithmetic' bitwise the kernel's x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
