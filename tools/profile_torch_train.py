#!/usr/bin/env python3
"""Where the time goes in the port's federated training, on one GPU.

    python3 tools/profile_torch_train.py [--models convnet,kwt,lstm]
        [--steps 30] [--clients 10]

For each paper model at its published widths, on the synthetic task and
with the trainer settings of chip_smoke.py's ``train`` phase
(``paper_data``, ``paper_trainer``: FedProx, SGD, batch 10, on
``cuda:0``), it warms up with one short local update, then times what a
FedZero round asks of the trainer: ``--clients`` local updates of
``--steps`` steps, their ``aggregate`` and one ``evaluate`` (host clock,
each part ending in a synchronise). Then it traces one more local update
under ``torch.profiler`` (device activity only): wall time, the device's
busy time (the sum of kernel and copy times), its idle share of the wall
time, the device launches a step, and the kernels that took the most
device time. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_summary(tp, wall_s: float, top: int = 10) -> dict:
    dev = [e for e in tp.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": 1e3 * wall_s, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "device_launches": sum(e.count for e in dev),
            "top_device": [[e.key[:90], e.self_device_time_total / 1e3,
                            e.count] for e in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="convnet,kwt,lstm")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--clients", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import TRAIN, nvidia_smi, paper_data, paper_trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda:0")
    act = [torch.profiler.ProfilerActivity.CUDA]
    names = [f"client_{i}" for i in range(TRAIN["clients"])]
    out = {"card": nvidia_smi(), "steps": args.steps,
           "clients": args.clients, "batch": TRAIN["batch"], "models": {}}
    for name in args.models.split(","):
        data = paper_data(name, names)
        tr = paper_trainer(name, data, dev)
        tr.local_update(0, 5)  # warm-up
        tr.evaluate()
        torch.cuda.synchronize()
        parts = {}
        t = time.perf_counter()
        ups = [tr.local_update(row, args.steps)
               for row in range(args.clients)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = sum(len(u["losses"]) for u in ups)
        parts["local_updates_ms"] = 1e3 * wall
        parts["ms_per_step"] = 1e3 * wall / steps
        for part, fn in (("aggregate_ms", lambda: tr.aggregate(ups)),
                         ("evaluate_ms", tr.evaluate)):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            parts[part] = 1e3 * (time.perf_counter() - t)
        with torch.profiler.profile(activities=act) as tp:
            t = time.perf_counter()
            upd = tr.local_update(0, args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        n = len(upd["losses"])
        trace = device_summary(tp, wall)
        parts["traced_update"] = {**trace, "local_steps": n,
                                  "ms_per_step": 1e3 * wall / n,
                                  "launches_per_step":
                                      trace["device_launches"] / n}
        out["models"][name] = parts
        del tr, data, ups
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
