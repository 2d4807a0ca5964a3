#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the CUDA devices it asks for.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are the files ``BENCHMARK.json`` names; its driver
(``gpubench/drivers/<driver>.py``, the traffic file's ``driver``) makes
the set-up from the seed, measures the window (``--trace 0``: the cell's
end-to-end metrics) or traces a fixed number of units under
``torch.profiler`` (``--trace 1``: its per-layer metrics, each read by
``gpubench/metrics/<metric>.py``), then judges what the timed path
produced against the plain reference. The numbers judged are printed
beside their limits as the last lines of standard error; the last line of
standard output is the result, one JSON object.

Without the CUDA devices the cell asks for, or with the JAX package
loaded once the window has closed, it prints no result and exits with 2.
Build and kernel caches stay inside the checkout (``build/``).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    build = ROOT / "build" / "gpubench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))


def metrics_of(cell, out: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` off) or its per-layer
    metrics that found something to read (``trace`` on)."""
    from gpubench.core import spec
    from gpubench.counts import peaks
    if not trace:
        values = dict(out["e2e"], setup_s=out["setup_s"],
                      peak_mem_gib=out["device"]["memory_peak_bytes"] / 2**30)
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    ctx = {"trace": out["trace"], "units": out["units"], "peaks": peaks()}
    found = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            found[m["name"]] = {"value": value, "unit": m["unit"]}
    return found


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """Run ``cell`` on ``device``; returns the result line (a dict)."""
    from gpubench.check import judge
    driver = importlib.import_module(f"gpubench.drivers.{cell.driver}")
    out = driver.run(cell, seed, seconds, trace, device, started)
    correct, checks = judge(out["readings"], cell.limits)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics_of(cell, out, trace),
            "device": out["device"]}
    if trace:
        t = out["trace"]
        line["device"] = dict(line["device"], busy_s=t["busy_s"],
                              window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["readings"] = out["readings"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    try:
        from gpubench.core import card, spec
        started = card.process_start()
        cell = spec.cell(args.workload)
        import torch
        card.require(cell.workload["chips"])
        importlib.import_module("repro_torch")
    except Exception as e:  # no card, no program, no such cell
        print(f"gpubench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # the host only dispatches: one thread
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda:0"), started)
    loaded = card.forbidden_loaded()
    if loaded:
        print(f"gpubench: the process loaded {', '.join(loaded)}: the run "
              "measures repro_torch alone", file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
