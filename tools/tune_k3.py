#!/usr/bin/env python3
"""Time variants of K3's bf16 kernel against each other and against SDPA,
in turns, in one run.

    python3 tools/tune_k3.py [--variants NAME,...] [--rounds N]

Each variant is a copy of ``src/`` and ``chip_smoke.py`` under
``build/tune_k3/<name>/`` (git-ignored) with a few lines of
``csrc/flash_attention.cu`` replaced; each copy builds its own library,
all copies at once. Then every round runs the variants in order and again
in reverse, each in a process of its own, at chip_smoke.py's timed K3
shapes (``K3_TIMED``): K3's and ``scaled_dot_product_attention``'s ms over
CUDA events and K3's ``err_over_limit`` against the plain version
(``ATTN_TOL``), one JSON line per variant, shape and run. Needs a CUDA
device, as chip_smoke.py does.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from plant_faults import ROOT, copy_tree

SRC = "src/repro_torch/csrc/flash_attention.cu"
# name -> ((the sound line, the variant's line), ...)
VARIANTS = {
    "as_is": (),
    "stages_2": (("constexpr int kMaxStages = 4;",
                  "constexpr int kMaxStages = 2;"),),
    "keys_64": (("constexpr int kTK = 128;", "constexpr int kTK = 64;"),),
    # hi = bf16(P) rounded to nearest (a conversion and an unpack a pair
    # more), lo = bf16(P - hi)
    "split_round": (
        ("  const uint32_t xb = __float_as_uint(x) & 0xFFFF0000u;\n"
         "  const uint32_t yb = __float_as_uint(y) & 0xFFFF0000u;\n"
         "  hi = __byte_perm(xb, yb, 0x7632);\n"
         "  lo = pack_bf16(x - __uint_as_float(xb), y - __uint_as_float(yb));",
         "  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);\n"
         "  const float2 hf = __bfloat1622float2(h);\n"
         "  hi = *reinterpret_cast<const uint32_t*>(&h);\n"
         "  lo = pack_bf16(x - hf.x, y - hf.y);"),),
}


def variant_tree(name: str) -> Path:
    edits = VARIANTS[name]
    return copy_tree(ROOT / "build" / "tune_k3" / name, SRC,
                     tuple(e[0] for e in edits), tuple(e[1] for e in edits))


def child(build_only: bool) -> int:
    """In a variant's tree (the working directory): build K3, or time it."""
    sys.path.insert(0, "src")
    sys.path.insert(0, ".")
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    fa.load_library()
    if build_only:
        return 0
    gen = torch.Generator(torch.device("cuda:0")).manual_seed(3)
    atol, rtol = cs.ATTN_TOL["torch.bfloat16"]
    for name, B, H, KV, S, Sk, dh, causal, window in cs.K3_CASES:
        if name not in cs.K3_TIMED:
            continue
        q, k, v = cs.attn_case(torch, gen, B, H, KV, S, Sk, dh, torch.bfloat16)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        ratio = float(((out.float() - want.float()).abs()
                       / (atol + rtol * want.float().abs())).max())
        ms = cs.cuda_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), 20)
        lib = cs.cuda_ms(torch, lambda: cs.sdpa(torch, q, k, v, causal,
                                                window), 20)
        print(json.dumps({"case": name, "ms": ms, "library_ms": lib,
                          "k3_over_library": ms / lib,
                          "err_over_limit": ratio}), flush=True)
        del q, k, v, out, want
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", choices=("build", "time"))
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child == "build")
    names = args.variants.split(",")
    trees = {n: variant_tree(n) for n in names}
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
                print(json.dumps({"variant": n, "round": r,
                                  **json.loads(line)}), flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
