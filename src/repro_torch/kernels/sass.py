"""What the compiler made of the hand-written kernels: loops and opcodes.

    PYTHONPATH=src python -m repro_torch.kernels.sass [SOURCE ...] [--out DIR]

Builds the named ``csrc/`` sources (all of them by default) as the kernels
are built at first use, disassembles each library with ``cuobjdump -sass``,
writes the full listing to ``DIR/<source>.sass`` (default
``csrc/build/sass``), and prints, per kernel function, its instruction
count and every loop: a backward branch and the instructions between its
target and itself, with the loop's opcode histogram. The per-term costs in
PERF.md are read from these loops (instructions of a loop body over the
terms one trip computes). Needs the CUDA toolkit; runs on the GPU machine.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[0-9T]+\s+")
_TARGET = re.compile(r"\b(?:BRA|BRX)\b.*?0x([0-9a-f]+)")


def parse(listing: str) -> dict[str, list[tuple[int, str, str]]]:
    """cuobjdump -sass text -> {function: [(address, opcode, text), ...]}."""
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    cur = None
    for line in listing.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            cur = s.split(":", 1)[1].strip()
            funcs[cur] = []
            continue
        m = _LINE.search(line)
        if cur is None or m is None:
            continue
        text = _PRED.sub("", m.group(2).strip())
        if not text:
            continue
        funcs[cur].append((int(m.group(1), 16), text.split()[0], text))
    return funcs


def loops(ins: list[tuple[int, str, str]]) -> list[tuple[int, int, collections.Counter]]:
    """Every backward branch as (start address, end address, opcode counts)."""
    out = []
    for addr, op, text in ins:
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(text)
        if m is None:
            continue
        tgt = int(m.group(1), 16)
        if tgt <= addr:
            body = collections.Counter(o for a, o, _ in ins if tgt <= a <= addr)
            out.append((tgt, addr, body))
    return out


def report(source: str, out_dir: Path) -> None:
    kern = next(k for k in _build.KERNELS.values() if k.source == source)
    kern.lib()
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    listing = subprocess.run([cuobjdump, "-sass", str(kern.library_path)], capture_output=True,
                             text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{Path(source).stem}.sass").write_text(listing)
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")
    for fn, ins in parse(listing).items():
        print(f"{source} :: {fn}: {len(ins)} instructions")
        for a, z, body in sorted(loops(ins), key=lambda t: t[0]):
            n = sum(body.values())
            top = ", ".join(f"{o} {c}" for o, c in body.most_common(14))
            print(f"  loop 0x{a:x}-0x{z:x}: {n} instructions: {top}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", help="csrc file names (default: every source)")
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "sass"),
                    help="where the listings go")
    args = ap.parse_args(argv)
    sources = args.sources or sorted({k.source for k in _build.KERNELS.values()})
    for s in sources:
        report(s, Path(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
