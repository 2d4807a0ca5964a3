#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one GPU.

    python3 tools/profile_torch_main_path.py [--backend cuda|torch|numpy]
        [--clients N] [--until-step N] [--trace-steps N]

Builds the 1M-client sparse, exact uncapped greedy FedZero configuration
of ``chip_smoke.py`` and runs its round loop to ``--until-step`` under
``cProfile``: host time per backend op (cumulative seconds and calls of
each ``ArrayBackend`` method) beside the loop total. It then runs
``--trace-steps`` more steps of the same simulation under
``torch.profiler`` and reports the device's busy time (the sum of CUDA
kernel and copy times), its idle share of that window's wall time, and
the kernels that took the most device time. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def op_breakdown(prof: cProfile.Profile):
    """Cumulative seconds and calls of every backend-class method."""
    from repro_torch.backend.base import ArrayBackend

    names = {n for n in dir(ArrayBackend) if not n.startswith("__")}
    out = {}
    for (path, _line, fn), (cc, _nc, _tt, ct, _callers) in \
            pstats.Stats(prof).stats.items():
        if "repro_torch/backend/" in path and fn in names:
            prev = out.get(fn)
            # a subclass override calling super() is counted once, at
            # its outermost (largest) cumulative time
            if prev is None or ct > prev["s"]:
                out[fn] = {"s": ct, "calls": cc}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["s"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--clients", type=int, default=1_000_000)
    ap.add_argument("--until-step", type=int, default=200)
    ap.add_argument("--trace-steps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import main_path_config, nvidia_smi
    from repro_torch.core import build_experiment

    cfg = main_path_config(args.clients, args.until_step, args.backend)
    t = time.perf_counter()
    sim = build_experiment(cfg)
    setup = time.perf_counter() - t
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t = time.perf_counter()
    prof.enable()
    sim.run(until_step=args.until_step)
    torch.cuda.synchronize()
    prof.disable()
    loop = time.perf_counter() - t
    rounds = len(sim.results)

    # device activity only: recording every host-side op of a round
    # (tens of thousands of small ones) costs far more than the round
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        t = time.perf_counter()
        sim.run(until_step=args.until_step + args.trace_steps)
        torch.cuda.synchronize()
        window = time.perf_counter() - t
    dev = [e for e in tp.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({
        "card": nvidia_smi(), "backend": args.backend,
        "clients": args.clients, "until_step": args.until_step,
        "rounds": rounds, "setup_s": setup, "loop_s": loop,
        "ms_per_round": 1e3 * loop / max(rounds, 1),
        "ops": op_breakdown(prof),
        "trace": {"steps": args.trace_steps,
                  "rounds": len(sim.results) - rounds,
                  "wall_s": window, "device_busy_s": busy_us / 1e6,
                  "device_idle_share": 1.0 - busy_us / 1e6 / window,
                  "top_device": [[e.key, e.self_device_time_total / 1e3,
                                  e.count] for e in top]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
