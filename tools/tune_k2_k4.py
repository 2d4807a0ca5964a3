#!/usr/bin/env python3
"""Time variants of K2 (``forecast_z``) and K4 (``rwkv_scan``) against each
other, in turns, in one run.

    python3 tools/tune_k2_k4.py [--variants NAME,...] [--rounds N]
                                [--tree NAME=DIR ...]

Each variant is a copy of ``src/`` and ``chip_smoke.py`` under
``build/tune_k2_k4/<name>/`` (git-ignored) with a line of
``csrc/counter_hash.cu`` or ``csrc/rwkv_scan.cu`` replaced; ``--tree
NAME=DIR`` adds the variant NAME, the tree at DIR as it is (an unpacked
earlier commit, ``git archive``). Each tree builds its own libraries, all
at once. Then every round runs the variants in order and again in
reverse, each in a process of its own: K2 at 2^20 × 64 and at the main path's commonest
forecast shapes (chip_smoke.py's ``K2_MAIN_SHAPES``), held to its plain
version with ``torch.equal``; K4 at the rwkv6-1.6b prefill shape (B 4,
S 2048, H 32, dh 64) with float32 r/k/v and, where the tree's wrapper takes
them, bf16, and at batch 1 in bf16, with its ``err_over_limit`` against
the plain version (``K4_TOL``). One JSON line per variant, case and run;
ms are medians over CUDA events. Needs a CUDA device, as chip_smoke.py
does.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from plant_faults import ROOT, copy_tree

# name -> (file, ((the sound line, the variant's line), ...))
VARIANTS = {
    "as_is": (None, ()),
    # one group a stream (the serial chunk walk), or 2 or 4 times the
    # groups that fill the SMs
    "k4_one_group": ("src/repro_torch/csrc/rwkv_scan.cu", (
        ("max(1LL, n_sm / streams)", "1LL"),)),
    "k4_groups_2x": ("src/repro_torch/csrc/rwkv_scan.cu", (
        ("max(1LL, n_sm / streams)", "max(1LL, 2 * n_sm / streams)"),)),
    "k4_groups_4x": ("src/repro_torch/csrc/rwkv_scan.cu", (
        ("max(1LL, n_sm / streams)", "max(1LL, 4 * n_sm / streams)"),)),
    # 2^x by exp2f (its range handling around the MUFU's ex2.approx)
    "k4_exp2f": ("src/repro_torch/csrc/rwkv_scan.cu", (
        ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
         "  return y;",
         "  y = exp2f(x);\n  return y;"),)),
    # one tf32 product per k-step, no split (wrong results, timing only)
    "k4_one_product": ("src/repro_torch/csrc/rwkv_scan.cu", (
        ("    mma_tf32(lo.c[n], al, bh0, bh1);\n"
         "    mma_tf32(hi.c[n], ah, bh0, bh1);\n"
         "    if (!kExactB) mma_tf32(lo2.c[n], ah, bl0, bl1);",
         "    mma_tf32(hi.c[n], ah, bh0, bh1);"),)),
    # what the diagonal costs: K4 without it (wrong results, timing only)
    "k4_skip_diagonal": ("src/repro_torch/csrc/rwkv_scan.cu", (
        ("for (int task = tid; task < kNSub * 128; task += kThreads) {",
         "for (int task = tid; task < 0; task += kThreads) {"),)),
}
K4_TOL = (1e-4, 1e-4)


def variant_tree(name: str, trees: dict) -> Path:
    if name in trees:
        return trees[name]
    path, edits = VARIANTS[name]
    return copy_tree(ROOT / "build" / "tune_k2_k4" / name,
                     path or "chip_smoke.py", tuple(e[0] for e in edits),
                     tuple(e[1] for e in edits))


def child(build_only: bool) -> int:
    """In a variant's tree (the working directory): build K2 and K4, or
    time them."""
    sys.path.insert(0, "src")
    import torch

    from repro_torch.kernels import counter_hash as ch
    from repro_torch.kernels import rwkv_scan as k4

    ch.load_library()
    k4.load_library()
    if build_only:
        return 0
    sys.path.insert(0, str(ROOT))
    from chip_smoke import K2_MAIN_SHAPES, cuda_ms

    dev = torch.device("cuda:0")
    gen = torch.Generator(dev).manual_seed(5)
    fold = 0x9E3779B97F4A7C15
    for R, W in ((1 << 20, 64), *K2_MAIN_SHAPES):
        rows = torch.arange(R, dtype=torch.int64, device=dev)
        lead = torch.arange(1, W + 1, dtype=torch.float32, device=dev)
        std = 0.05 + 0.20 * torch.clamp(lead / 1440.0, max=1.0)
        got = ch.forecast_z(fold, rows, 777, std)
        equal = bool(torch.equal(got, ch.forecast_z_plain(fold, rows, 777,
                                                          std)))
        ms = cuda_ms(torch, lambda: ch.forecast_z(fold, rows, 777, std), 50)
        print(json.dumps({"kernel": "forecast_z", "R": R, "W": W, "ms": ms,
                          "equal_plain": equal}), flush=True)
    B, S, H, dh = 4, 2048, 32, 64
    r, k, v = (torch.randn((B, S, H, dh), generator=gen, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(-0.5 + 0.6 * torch.randn(
        (B, S, H, dh), generator=gen, device=dev)))
    u = torch.randn((H, dh), generator=gen, device=dev) / dh ** 0.5
    atol, rtol = K4_TOL
    cases = [(4, torch.float32)]
    if hasattr(k4, "RKV_DTYPES"):
        cases += [(4, torch.bfloat16), (1, torch.bfloat16)]
    for nb, dtype in cases:
        rr, kk, vv = (x[:nb].to(dtype) for x in (r, k, v))
        ww = w[:nb]
        ref = k4.rwkv_scan_plain(rr.float(), kk.float(), vv.float(), ww,
                                 u)[0]
        out = k4.rwkv_scan(rr, kk, vv, ww, u)
        ratio = float(((out - ref).abs() / (atol + rtol * ref.abs())).max())
        ms = cuda_ms(torch, lambda: k4.rwkv_scan(rr, kk, vv, ww, u,
                                                 return_state=True), 20)
        print(json.dumps({"kernel": "rwkv_scan", "B": nb,
                          "dtype": str(dtype), "ms": ms,
                          "err_over_limit": ratio}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--child", choices=("build", "time"))
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child == "build")
    given = {n: Path(d) for n, d in (t.split("=", 1) for t in args.tree)}
    names = list(given) + args.variants.split(",")
    trees = {n: variant_tree(n, given) for n in names}
    me = str(Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--child", "build"],
                               cwd=trees[n]) for n in names]
    if any([b.wait() != 0 for b in builds]):  # waits for every build
        return 1
    ok = True
    for r in range(args.rounds):
        for n in names + names[::-1]:
            proc = subprocess.run([sys.executable, me, "--child", "time"],
                                  cwd=trees[n], capture_output=True,
                                  text=True, timeout=600)
            ok = ok and proc.returncode == 0
            for line in proc.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                print(json.dumps({"variant": n, "round": r,
                                  **json.loads(line)}), flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
