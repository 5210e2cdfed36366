#!/usr/bin/env python3
"""Count the SASS instructions of a built kernel library, by kernel and by
opcode class, on the machine with the card (``cuobjdump`` ships with the
CUDA toolkit; there is no profiler there).

    python tools/sass_stats.py beam_opt [--dump PATH]

Builds ``openpystruct_tpu_torch/ops/csrc/<name>.cu`` if it is not built,
disassembles it with ``cuobjdump -sass`` and prints, for each kernel, its
static instruction count and the counts of the classes that set a lane's
latency: special-function (MUFU: the reciprocal and square-root seeds of
each IEEE division and square root), float arithmetic, async-copy, global,
shared, local and generic memory, integer and address arithmetic, barriers
and branches.  Static counts: a loop body counts once.  ``--dump`` also
writes the whole disassembly to PATH.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CLASSES = (
    ("MUFU", re.compile(r"^MUFU")),
    ("float", re.compile(r"^(FFMA|FMUL|FADD|FMNMX|FSETP|FSEL|FCHK)")),
    ("double", re.compile(r"^(DFMA|DMUL|DADD|DSETP)")),
    ("async copy", re.compile(r"^(LDGSTS|LDGDEPBAR|DEPBAR)")),
    ("global load", re.compile(r"^LDG")),
    ("global store", re.compile(r"^STG")),
    ("shared", re.compile(r"^(LDS|STS)")),
    ("local load/store", re.compile(r"^(LDL|STL)")),
    ("generic load/store", re.compile(r"^(LD|ST)(\.|$)")),
    ("integer", re.compile(r"^(IMAD|IADD3|LEA|SHF|LOP3|ISETP|VIADD|IMNMX|"
                           r"VIMNMX|SEL|MOV|PRMT)")),
    ("barrier", re.compile(r"^(BAR|WARPSYNC)")),
    ("branch", re.compile(r"^(BRA|BSSY|BSYNC|CALL|RET|EXIT)")),
)
LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")


def stats(sass: str) -> dict:
    """{kernel: Counter of classes, with "total"} from cuobjdump output."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = LINE.search(line)
        if cur is None or not m or m.group(1).startswith("NOP"):
            continue
        op = m.group(1)
        cur["total"] += 1
        for name, pat in CLASSES:
            if pat.match(op):
                cur[name] += 1
                break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("name", help="source name under ops/csrc, e.g. beam_opt")
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from openpystruct_tpu_torch.ops import _build

    lib = _build.build([args.name])[args.name]["path"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    if args.dump:
        args.dump.parent.mkdir(parents=True, exist_ok=True)
        args.dump.write_text(sass)
    for kernel, c in stats(sass).items():
        print(f"{kernel}: " + ", ".join(
            f"{k} {c[k]}" for k in ("total",) + tuple(n for n, _ in CLASSES)
            if c[k]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
