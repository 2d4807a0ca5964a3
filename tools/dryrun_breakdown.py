#!/usr/bin/env python3
"""The dry run's per-device FLOPs of some steps, op by op and by the line
of the model that issued each op, under this process's torch; and the
difference between two such files (two torches).

    PYTHONPATH=src python tools/dryrun_breakdown.py \\
        --cases smollm-360m/train_4k@16x16,llama3.2-3b:2/train_4k@2x16 \\
        --out chiprun_out/breakdown.json
    python tools/dryrun_breakdown.py --diff a.json b.json [--top 25]

A case is ``launch.dryrun.case_parts``' (``arch/shape@DxM``, the full
config on D × M; ``arch:L/...``, cut to L layers; ``arch/shape``, the
reduced config on 2×2): the record of ``launch.dryrun.spmd_record``
(fake process group, meta tensors, ``tp_fsdp``; the runs at 2 and 3
layers, extrapolated over depth) with its whole ``flops_by_op`` and
``bytes_by_op``, each entry keyed ``op @ site``.
The site is the innermost frame in ``repro_torch/models`` of the op's
Python stack (the forward pass; ``re`` where remat recomputes it in the
backward pass), else, in the backward pass, the autograd node that ran it
and the model line that made that node (autograd's anomaly mode records
each node's forward stack), else the innermost frame of the port (the
optimizer, the step). No device is used: the dry run needs none.
``--diff`` prints, per case of both files, each torch's total and the
entries whose FLOPs (``--what bytes``: moved bytes) differ most, summed
over the sites and op by op.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = os.sep + "repro_torch" + os.sep
MODELS = PORT + "models" + os.sep
MATMULS = ("mm", "bmm", "addmm", "baddbmm")
# model functions that only place a tensor: the site is their caller
PLACERS = ("maybe_shard", "as_dtensor", "_like", "summed")
# frames of the counting machinery itself, never a site
SKIP = (os.path.join("launch", "dryrun.py"), os.path.join("kernels",
                                                           "_shards.py"))


def _frame_site(f):
    return (f"{Path(f.f_code.co_filename).name}:{f.f_lineno} "
            f"{f.f_code.co_name}")


def _forward_site(lines):
    """The innermost model line of a formatted stack (anomaly mode's)."""
    for line in reversed(lines):
        if MODELS in line:
            head = line.strip().splitlines()[0]   # File "...", line n, in f
            path, _, rest = head.partition('", line ')
            num, _, fn = rest.partition(", in ")
            if fn.strip() in PLACERS:
                continue
            return f"{Path(path.split('File ')[-1].strip(chr(34))).name}:" \
                   f"{num} {fn}"
    return "?"


def site_key(name, ins, outs):
    """``name @ site`` for the op being counted now (see the module); a
    matmul's name carries its operands' shapes."""
    import torch
    if name in MATMULS:
        name += "[" + ",".join("x".join(map(str, t.shape))
                               for t in ins) + "]"
    node = torch._C._current_autograd_node()
    f, port = sys._getframe(1), None
    while f is not None:
        fn = f.f_code.co_filename
        if PORT in fn and not fn.endswith(SKIP):
            if MODELS in fn and f.f_code.co_name not in PLACERS:
                return f"{name} @ {'re ' if node else ''}{_frame_site(f)}"
            port = port or f
        f = f.f_back
    if node is not None:
        made = _forward_site(node.metadata.get("traceback_", ()))
        return f"{name} @ bwd {node.name()} of {made}"
    return f"{name} @ {_frame_site(port) if port else '?'}"


def record(cases, sites=True):
    import torch

    from repro_torch.launch import dryrun
    out = {"torch": torch.__version__, "cases": {}}
    for case in cases:
        cfg, shape, mesh = dryrun.case_config(case)
        t = time.perf_counter()
        try:
            with torch.autograd.set_detect_anomaly(sites, check_nan=False):
                rec = dryrun.spmd_record(cfg, shape, mesh, "tp_fsdp",
                                         top=None,
                                         op_key=site_key if sites else None)
        except Exception:  # a case that fails is recorded as its error
            out["cases"][case] = {"error": traceback.format_exc()[-3000:]}
            print(f"[breakdown] {case}: FAILED\n"
                  f"{out['cases'][case]['error']}", flush=True)
            continue
        out["cases"][case] = {
            k: rec[k] for k in (
                "spmd_ok", "flops_per_device", "matmul_flops_per_device",
                "flops_by_op", "bytes_per_device", "bytes_by_op",
                "collective_bytes")}
        out["cases"][case]["s"] = time.perf_counter() - t
        print(f"[breakdown] {case}: flops/dev "
              f"{rec['flops_per_device']:.4e} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    return out


def _by_op(by):
    ops = defaultdict(int)
    for k, v in by.items():
        ops[k.split(" @ ")[0].split("[")[0]] += v
    return ops


def diff(a, b, top=25, what="flops"):
    """Lines that compare two files of :func:`record`, case by case, by
    ``what``: "flops" or "bytes"."""
    lines = [f"A: torch {a['torch']}, B: torch {b['torch']}; {what}"]
    for case in a["cases"]:
        if "error" in a["cases"][case] or "error" in b["cases"].get(
                case, {"error": 1}):
            continue
        ra, rb = a["cases"][case], b["cases"][case]
        fa, fb = ra[f"{what}_per_device"], rb[f"{what}_per_device"]
        lines.append(f"\n== {case}: A {fa:.6e}  B {fb:.6e}  A/B {fa / fb:.4f}"
                     f"  (A - B {fa - fb:.4e})")
        by = f"{what}_by_op"
        for title, ba, bb in (("by op", _by_op(ra[by]), _by_op(rb[by])),
                              ("by op and site", ra[by], rb[by])):
            keys = set(ba) | set(bb)
            ranked = sorted(keys, key=lambda k: -abs(ba.get(k, 0)
                                                     - bb.get(k, 0)))
            lines.append(f"  -- {title}: A - B, A, B")
            for k in ranked[:top]:
                d = ba.get(k, 0) - bb.get(k, 0)
                if d:
                    lines.append(f"  {d:+.4e}  {ba.get(k, 0):.4e}  "
                                 f"{bb.get(k, 0):.4e}  {k}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="")
    ap.add_argument("--out")
    ap.add_argument("--no-sites", action="store_true",
                    help="key the breakdown by op alone (faster)")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--what", choices=("flops", "bytes"), default="flops")
    args = ap.parse_args(argv)
    if args.diff:
        a, b = (json.loads(Path(p).read_text()) for p in args.diff)
        print("\n".join(diff(a, b, args.top, args.what)))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    out = record([c for c in args.cases.split(",") if c],
                 sites=not args.no_sites)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(r.get("spmd_ok") for r in out["cases"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
