#!/usr/bin/env python3
"""How well the port's own spans (``repro_torch.spans``) sit on the
profiler's clock, in a traced run of a benchmark cell on the card.

    python3 tools/span_clock.py --workload mixtral-8x22b.prefill \\
        --seed 3100000021 [--out span_clock.json]

Runs the cell once with ``--trace 1``'s path (``gpubench.run.run_cell``,
with ``run.py``'s settings) and keeps the profiler's host events. Each
span is matched with the profiler's ``record_function`` event of its
name (the k-th span of a name with the k-th event, by start), and the
distances between their starts and between their ends are summarised
(median and largest, in microseconds). Prints one JSON object: those
distances, the spans and counters by name, the traced window per unit,
the cell's per-layer metrics and, for a training cell, the four phases'
sum against the step. Needs the card, as ``run.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def distances(spans: list, host: list) -> dict:
    """|span - event| of starts and ends, in microseconds, over the spans
    matched by name and order of start."""
    events = defaultdict(list)
    for name, s, e in host:
        events[name].append((s, e))
    mine = defaultdict(list)
    for s in spans:
        mine[s["name"]].append((s["start_ns"], s["end_ns"]))
    starts, ends, unmatched = [], [], 0
    for name, got in mine.items():
        theirs = sorted(events.get(name, []))
        if len(theirs) != len(got):
            unmatched += len(got)
            continue
        for (s0, s1), (e0, e1) in zip(sorted(got), theirs):
            starts.append(abs(s0 - e0) / 1e3)
            ends.append(abs(s1 - e1) / 1e3)
    both = starts + ends

    def summary(v):
        return {"median_us": statistics.median(v), "max_us": max(v)} \
            if v else None

    return {"matched": len(starts), "unmatched": unmatched,
            "start": summary(starts), "end": summary(ends),
            "both": summary(both)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gpubench.core import card, spec
    from gpubench.core import trace as tr
    from gpubench.run import _paths, run_cell
    from repro_torch import spans as sp
    _paths()
    started = card.process_start()
    cell = spec.cell(args.workload)
    card.require(cell.workload["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    kept = {}
    summarize = tr.summarize

    def keeping(prof):
        kept["host"] = tr._raw(prof)[0]
        return summarize(prof)

    tr.summarize = keeping
    try:
        line = run_cell(cell, args.seed, 1.0, True, torch.device("cuda:0"),
                        started)
    finally:
        tr.summarize = summarize
    rec = sp.collected()
    units = cell.traffic["trace_steps" if cell.driver == "train"
                         else "trace_batches"]
    by_name = defaultdict(lambda: [0, 0.0])
    for s in rec["spans"]:
        by_name[s["name"]][0] += 1
        by_name[s["name"]][1] += s["device_ms"]
    out = {"workload": args.workload, "seed": args.seed,
           "correct": line["correct"], "device": line["device"],
           "clock": distances(rec["spans"], kept["host"]),
           "spans": {n: {"count": c, "device_ms": t}
                     for n, (c, t) in sorted(by_name.items())},
           "counters": rec["counters"],
           "window_s_per_unit": line["device"]["window_s"] / units,
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "idle_gaps": line["breakdown"]["idle_gaps"]}
    if cell.driver == "train":
        phases = sum(by_name[f"repro_torch.train.{p}"][1]
                     for p in ("forward", "backward", "reduce", "update"))
        out["phases_over_step"] = phases / by_name["repro_torch.train.step"][1]
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
