#!/usr/bin/env python3
"""Where the time goes in a full-width DecoderLM train step, on one GPU.

    python3 tools/profile_torch_launch.py [--arch smollm-360m] [--batch 8]
        [--seq 2048] [--steps 3]

The step of chip_smoke.py's ``launch`` phase (``make_train_step``: the
reference's route, remat, the default AdamW; bf16 weights made from seed
0 on ``cuda:0``, TF32 off) on the driver's synthetic batches. It warms up
with two steps, times ``--steps`` steps (host clock, each ending in
reading the loss), and times the loss's forward alone, the forward and
backward (``torch.autograd.grad``), and the AdamW update alone. Then it
traces one step under ``torch.profiler`` (device activity only): wall
time, the device's busy time, its idle share, the device launches, the
busy time by kind of kernel (GEMMs, softmax, the rest) and the kernels
that took the most device time. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def kind(name: str) -> str:
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "gemm"
    if "softmax" in low:
        return "softmax"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import nvidia_smi
    from tools.profile_torch_train import device_summary
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import synthetic_lm_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda:0")
    cfg = get_config(args.arch)
    model, opt, step = make_train_step(cfg, device=dev)
    model.init(torch.Generator(dev).manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    state = opt.init(params)
    rng = np.random.default_rng(0)

    def batch():
        return synthetic_lm_batch(rng, args.batch, args.seq, cfg.vocab, dev)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    for _ in range(2):  # warm-up
        params, state, loss = step(params, state, batch())
    float(loss)
    step_ms = []
    for _ in range(args.steps):
        b = batch()
        (params, state, loss), ms = timed(lambda: step(params, state, b))
        step_ms.append(ms)
    b = batch()
    with torch.no_grad():
        _, fwd_ms = timed(lambda: torch.func.functional_call(
            model, params, (b,)))
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}

    def fwd_bwd():
        loss = torch.func.functional_call(model, leaves, (b,))
        return torch.autograd.grad(loss, list(leaves.values()))
    grads, fwd_bwd_ms = timed(fwd_bwd)
    grads = dict(zip(leaves, grads))
    del leaves
    with torch.no_grad():
        _, opt_ms = timed(lambda: opt.update(grads, state, params))
    del grads
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        t = time.perf_counter()
        params, state, loss = step(params, state, b)
        float(loss)
        wall = time.perf_counter() - t
    trace = device_summary(tp, wall, top=15)
    by_kind = {}
    for e in tp.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) + us / 1e3
    print(json.dumps({
        "card": nvidia_smi(), "arch": cfg.name, "batch": args.batch,
        "seq": args.seq, "n_layers": cfg.n_layers, "remat": model.remat,
        "optimizer": opt.name,
        "params": sum(p.numel() for p in params.values()),
        "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
        "forward_ms": fwd_ms, "forward_backward_ms": fwd_bwd_ms,
        "optimizer_ms": opt_ms, "traced_step": trace,
        "device_ms_by_kind": by_kind,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
        "loss": float(loss)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
