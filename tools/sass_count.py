#!/usr/bin/env python3
"""Count the SASS instructions of a kernel's loops, from ``cuobjdump -sass``.

    python3 tools/sass_count.py SRC.cu KERNEL [--cells-per-iter N] [--label L]

Compiles ``SRC.cu`` to a cubin for ``sm_90a`` with the port's flags
(``kernels/_build.py``: ``-O3``, no fast math), disassembles it, and
prints one JSON line for each function whose mangled name contains
``KERNEL``: its instruction count, and for each loop (a branch back to an
earlier address) the instructions from that address to the branch, their
opcodes, the subroutines it calls and their lengths, and the count per
cell (the loop's count over ``--cells-per-iter``). ``--sass`` reads a
saved ``cuobjdump -sass`` listing instead of compiling. This is a static count
of the loop body as compiled, both sides of a branch included, not of
the instructions a run issues. Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit), not a device.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\b(BRA|CALL\S*)\s+(?:`\()?(0x[0-9a-f]+)")


def disassemble(src: Path) -> str:
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                              "-v")]
        subprocess.run([_build.nvcc(), *flags, "-cubin", "-o", str(cubin),
                        str(src)], check=True, capture_output=True)
        return subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout


def functions(sass: str) -> dict[str, list[str]]:
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def parse(lines: list[str]):
    """[(address, opcode, text)] of a function's instructions."""
    insns = []
    for line in lines:
        m = _INSN.search(line)
        if m:
            text = m.group(2)
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            insns.append((int(m.group(1), 16), op, text))
    return insns


def target(text: str) -> int | None:
    m = _TARGET.search(text)
    return int(m.group(2), 16) if m else None


def subroutine_length(insns, addr: int) -> int | None:
    """Instructions from a called address to its RET."""
    start = next((i for i, x in enumerate(insns) if x[0] == addr), None)
    if start is None:
        return None
    for i in range(start, len(insns)):
        if insns[i][1].startswith("RET"):
            return i - start + 1
    return None


def loops(insns, cells_per_iter: float):
    """Each branch back to an earlier address: the instructions from that
    address to the branch."""
    index = {a: i for i, (a, _, _) in enumerate(insns)}
    found = []
    for i, (addr, op, text) in enumerate(insns):
        to = target(text)
        if not op.startswith("BRA") or to is None or to > addr \
                or to not in index:
            continue
        body = insns[index[to]:i + 1]
        calls = {hex(c): subroutine_length(insns, c) for _, bop, btext in body
                 if bop.startswith("CALL") and (c := target(btext)) is not None}
        ops = collections.Counter(bop.split(".")[0] for _, bop, _ in body)
        found.append({"from": hex(to), "to": hex(addr),
                      "instructions": len(body),
                      "per_cell": len(body) / cells_per_iter,
                      "opcodes": dict(ops.most_common()), "calls": calls})
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", type=Path,
                    help="a .cu source, or with --sass a saved disassembly")
    ap.add_argument("kernel")
    ap.add_argument("--cells-per-iter", type=float, default=1.0)
    ap.add_argument("--label", default=None)
    ap.add_argument("--sass", action="store_true",
                    help="src is the output of cuobjdump -sass")
    args = ap.parse_args(argv)
    sass = args.src.read_text() if args.sass else disassemble(args.src)
    funcs = {n: body for n, body in functions(sass).items()
             if args.kernel in n}
    if not funcs:
        raise SystemExit(f"no function matching {args.kernel} in {args.src}")
    for name, body in funcs.items():
        insns = parse(body)
        print(json.dumps({"label": args.label or str(args.src),
                          "function": name, "instructions": len(insns),
                          "loops": loops(insns, args.cells_per_iter)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
