#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 gpubench/control.py --workload <name> --seeds 1,2,3 \\
        [--program-seconds 5] [--control] [--faults [name ...]]

One process, seed after seed. For each seed it prints one JSON line:

* ``program``: a run of the cell as ``run.py`` makes it (a window of
  ``--program-seconds``), with its readings: the lower readings;
* ``control`` (``--control``): the reference computed in fp8 put in the
  program's place and judged by the same numbers: the upper readings;
* ``faults`` (``--faults [name ...]``): for a prefill cell, a run of the
  program with each fault of :data:`PREFILL_FAULTS` named (all where
  none is) planted where its logits are produced (a window of
  ``--program-seconds``); for a training cell,
  half of each batch left out, the loss a mean over the rest, in the
  reference put in the program's place (a state left unchanged reads 1
  by ``grad_gap`` and ``change_gap`` and needs no run).

The control runs the cell's family's reference (``reference/<family>.py``)
in fp8. A driver has a control only where :data:`READINGS` names it;
asked for the control or the faults of another, it exits with 2.

The benchmark's own runs never run this. Needs the card, as ``run.py``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def half_batch(logits):
    """Rows B // 2 on left out of the batch: each takes the logits of a
    row that was computed."""
    B = logits.shape[0]
    logits[B // 2:] = logits[: B - B // 2]
    return logits


def altered_token(logits):
    """Every prompt's first token moved to another one, where the logits
    that pick it are produced."""
    top = logits[:, -1].argmax(-1)
    other = (top + logits.shape[-1] // 2) % logits.shape[-1]
    rows = range(logits.shape[0])
    logits[rows, -1, other] = logits[rows, -1, top] + 1.0
    return logits


PREFILL_FAULTS = {"half_batch": half_batch, "altered_token": altered_token}


@contextlib.contextmanager
def planted(fault):
    """``DecoderLM.prefill`` with ``fault`` applied to the logits it
    returns."""
    from repro_torch.models.transformer import DecoderLM
    real = DecoderLM.prefill

    def prefill(self, tokens, cache_len, frontend_embeds=None):
        logits, cache = real(self, tokens, cache_len, frontend_embeds)
        return fault(logits.clone()), cache

    DecoderLM.prefill = prefill
    try:
        yield
    finally:
        DecoderLM.prefill = real


def prefill_faults(cell, seed: int, device, seconds: float,
                   names=tuple(PREFILL_FAULTS)) -> dict:
    from gpubench.run import run_cell
    out = {}
    for name in names:
        with planted(PREFILL_FAULTS[name]):
            line = run_cell(cell, seed, seconds, False, device, time.time())
        out[name] = line["readings"]
    return out


def prefill_control(cell, seed: int, device) -> dict:
    """The fp8 reference's first tokens and logits, judged against the
    float32 reference's, on the sample a window would draw from the
    seed's pool."""
    from gpubench.check import prefill as check
    from gpubench.core.traffic import prefill_pool
    from gpubench.drivers.prefill import sample
    reference = cell.family.reference
    a = cell.family.arch.sizes(cell.config)
    pool = prefill_pool(cell.traffic, a.vocab, seed, device)
    picks = sample([(j, *b.shape) for j, b in enumerate(pool)],
                   cell.traffic["check_per_slot"], seed)
    prompts = [pool[j][r] for j, r in picks]
    refs = reference.prefill_logits(a, seed, prompts, device)
    low = reference.prefill_logits(a, seed, prompts, device, "fp8")
    return check.readings(low, [int(x.argmax()) for x in low], refs,
                          [len(t) for t in prompts])


def train_control(cell, seed: int, device, faults: bool) -> dict:
    from gpubench.check import train as check
    from gpubench.core.traffic import train_pool
    reference = cell.family.reference
    a = cell.family.arch.sizes(cell.config)
    o, mix = cell.config["optimizer"], cell.traffic
    pool = train_pool(mix, a.vocab, seed, device)
    batches = [pool[i % len(pool)] for i in range(mix["checked_steps"])]
    ref = reference.train(a, seed, batches, o, device,
                          chunk_tokens=mix["chunk_tokens"])
    out = {"control": check.readings(
        reference.train(a, seed, batches, o, device, "fp8",
                        mix["chunk_tokens"]), ref)}
    if faults:
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        out["half_batch"] = check.readings(
            reference.train(a, seed, half, o, device,
                            chunk_tokens=mix["chunk_tokens"]), ref)
    return out


def prefill_readings(cell, seed: int, device, control: bool, faults,
                     seconds: float) -> dict:
    row = {}
    if control:
        row["control"] = prefill_control(cell, seed, device)
    if faults is not None:
        row["faults"] = prefill_faults(cell, seed, device, seconds or 5.0,
                                       faults or tuple(PREFILL_FAULTS))
    return row


def train_readings(cell, seed: int, device, control: bool, faults,
                   seconds: float) -> dict:
    return train_control(cell, seed, device, faults is not None)


# the upper readings of each driver's cells, by the driver's name
READINGS = {"prefill": prefill_readings, "train": train_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=None,
                    help="plant faults: of a prefill cell those named "
                    "(all where none is named)")
    args = ap.parse_args(argv)
    import torch
    from gpubench.core import card, spec
    from gpubench.run import run_cell
    cell = spec.cell(args.workload)
    upper = args.control or args.faults is not None
    if upper and cell.driver not in READINGS:
        print(f"gpubench: control.py has no control for the driver "
              f"{cell.driver!r} of {cell.name} (it has "
              f"{', '.join(sorted(READINGS))})", file=sys.stderr)
        return 2
    card.require(cell.workload["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"workload": cell.name, "seed": seed}
        if args.program_seconds > 0:
            line = run_cell(cell, seed, args.program_seconds, False, device,
                            time.time())
            row["program"] = {"correct": line["correct"],
                              "readings": line["readings"],
                              "metrics": line["metrics"]}
        t = time.perf_counter()
        if upper:
            row.update(READINGS[cell.driver](
                cell, seed, device, args.control, args.faults,
                args.program_seconds))
        row["control_s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
