#!/usr/bin/env python3
"""Where the time goes in the port's always-on service, on one GPU.

    python3 tools/profile_torch_service.py [--backend cuda|torch|numpy]
        [--clients N] [--steps N] [--trace-steps N]

Builds ``chip_smoke.py``'s ``1m_service`` configuration (the reference's
service-load settings: sparse, greedy, one million clients, in-process),
warms it up as ``chip_smoke.py`` does (the clock into daylight, one
admission), and drives ``--steps`` steps of the synthetic churn and
quote/admit mix under ``cProfile``: host time per backend op (cumulative
seconds and calls of each ``ArrayBackend`` method) and in the service's
own entry points (``quote``, ``admit``, ``register``/``deregister``,
``advance``) beside the window's wall time. It then drives
``--trace-steps`` more steps under ``torch.profiler`` and reports the
device's busy time (the sum of CUDA kernel and copy times), its idle
share of that window's wall time, and the kernels that took the most
device time. Prints one JSON object.
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
ENTRY = ("quote", "admit", "register", "deregister", "advance",
         "report_round", "_eligible_now")


def entry_breakdown(prof: cProfile.Profile):
    """Cumulative seconds and calls of the service's entry points."""
    out = {}
    for (path, _line, fn), (cc, _nc, _tt, ct, _callers) in \
            pstats.Stats(prof).stats.items():
        if path.endswith("repro_torch/service/engine.py") and fn in ENTRY:
            out[fn] = {"s": ct, "calls": cc}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["s"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--clients", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--trace-steps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke
    from chip_smoke import nvidia_smi, service_config
    from profile_torch_main_path import op_breakdown
    from repro_torch.service import build_service, run_synthetic

    sv = chip_smoke.SERVICE
    sv["clients"] = args.clients
    svc = build_service(service_config(args.backend), trainer=None)
    t = time.perf_counter()
    svc.advance(sv["warmup_steps"])
    svc.admit()
    torch.cuda.synchronize()
    warmup = time.perf_counter() - t
    mix = dict(churn=sv["churn"], admits_per_step=sv["admits_per_step"],
               quotes_per_step=sv["quotes_per_step"])

    svc.metrics.reset()
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    snap = run_synthetic(svc, steps=args.steps, seed=sv["seed"] + 1, **mix)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t

    # device activity only, as tools/profile_torch_main_path.py records it
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        t = time.perf_counter()
        run_synthetic(svc, steps=args.trace_steps, seed=sv["seed"] + 2,
                      **mix)
        torch.cuda.synchronize()
        window = time.perf_counter() - t
    dev = [e for e in tp.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({
        "card": nvidia_smi(), "backend": args.backend,
        "clients": args.clients, "warmup_s": warmup,
        "steps": args.steps, "wall_s": wall,
        "decisions_per_sec": snap["decisions_per_sec"],
        "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
        "entry": entry_breakdown(prof), "ops": op_breakdown(prof),
        "trace": {"steps": args.trace_steps, "wall_s": window,
                  "device_busy_s": busy_us / 1e6,
                  "device_idle_share": 1.0 - busy_us / 1e6 / window,
                  "top_device": [[e.key, e.self_device_time_total / 1e3,
                                  e.count] for e in top]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
