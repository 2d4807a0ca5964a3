"""Closed-loop prefill: one client sends a batch of prompts, waits for
each prompt's first token on the host, and sends the next.

Set-up builds the model (``repro_torch.models.build_model`` with the
kernels on: K3 attention, K5 expert products), fills it with the seed's
weights, makes the pool of prompt batches and serves each shape of the
mix ``warmup_cycles`` times. A batch is ``DecoderLM.prefill`` with a cache
of the prompt's length plus ``cache_extra``, then the argmax of the last
logits, copied to the host. Its latency runs from its submission to that
copy; the window ends with the first batch to finish at or after
``seconds``, and its throughput is every prompt token of the window's
batches over the window's length.

Once the window has closed and the memory's peak is read, the model is
freed and a sample of the finished requests, drawn from the seed with
every row slot of every shape in it, is run through the plain
reference: their served tokens and logits are judged against its
logits.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from gpubench.check import prefill as check
from gpubench.core import card, trace as tr
from gpubench.core.traffic import prefill_pool, shape_order
from gpubench.core.weights import load_port

# the traffic's keys that cut it to a CPU test's size
TINY = dict(shapes=[[8, 16], [4, 32], [2, 64]], pool_batches=6,
            trace_batches=3, warmup_cycles=1)


def p90(values: list) -> float:
    """The 90th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def sample(batches: list, per_slot: int, seed: int) -> list:
    """(batch, row) of the finished ``batches`` ([(index, B, S)]), drawn
    from the seed: for every shape and every row slot of it, ``per_slot``
    requests from distinct batches of that shape (all, where fewer
    finished). The longest prompts are among them."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 11])
    by_shape: dict = {}
    for i, B, S in batches:
        by_shape.setdefault((B, S), []).append(i)
    picks = []
    for (B, S), index in sorted(by_shape.items()):
        for r in range(B):
            drawn = rng.choice(len(index), size=min(per_slot, len(index)),
                               replace=False)
            picks += [(index[k], r) for k in drawn]
    return picks


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    from repro_torch.models import build_model

    fam = cell.family
    a = fam.arch.sizes(cell.config)
    mix = cell.traffic
    model = build_model(fam.port.model_config(cell.config),
                        use_kernels=True, device=device)
    load_port({n: p for n, p in model.named_parameters()}, fam.arch, a,
              seed, device)
    pool = prefill_pool(mix, a.vocab, seed, device)
    cycle = len(shape_order(mix, seed))

    def serve(tokens):
        with torch.inference_mode():
            logits, _ = model.prefill(tokens,
                                      tokens.shape[1] + mix["cache_extra"])
            last = logits[:, -1, : a.vocab]
            first = torch.argmax(last, dim=-1).cpu()
        return last, first

    for i in range(cycle * mix["warmup_cycles"]):
        serve(pool[i % cycle])
    card.sync(device)
    out = {"setup_s": time.time() - started}

    served, lat = [], []
    if trace:
        n = mix["trace_batches"]
        with tr.profiled() as prof:
            with torch.profiler.record_function(tr.WINDOW):
                for i in range(n):
                    served.append((i, *serve(pool[i % len(pool)])))
                card.sync(device)
        out["trace"] = tr.summarize(prof)
        del prof
    else:
        t0 = time.perf_counter()
        t_end, i, done = t0 + seconds, 0, t0
        while done < t_end:
            sent = time.perf_counter()
            served.append((i, *serve(pool[i % len(pool)])))
            done = time.perf_counter()
            lat.append(done - sent)
            i += 1
        tokens = sum(pool[j % len(pool)].numel() for j, _, _ in served)
        out["e2e"] = {"prefill_tokens_per_s": tokens / (done - t0),
                      "prefill_p90_ms": 1e3 * p90(lat)}
    shapes = [tuple(pool[j % len(pool)].shape) for j, _, _ in served]
    counts = fam.counts
    out["units"] = [{"flops": counts.prefill_flops(a, B, S),
                     "k5": counts.k5_launches(a, B, S),
                     "k3": counts.k3_launches(a, B, S)} for B, S in shapes]
    out["attempted"] = sum(B for B, _ in shapes)
    out["failed"] = 0
    out["device"] = card.device_line(device, cell.workload["chips"])

    # the window has closed: free the program, then judge a sample
    picks = sample([(j, B, S) for (j, _, _), (B, S) in zip(served, shapes)],
                   mix["check_per_slot"], seed)
    by_index = {j: (last, first) for j, last, first in served}
    logits = [by_index[j][0][r].float().cpu() for j, r in picks]
    firsts = [int(by_index[j][1][r]) for j, r in picks]
    prompts = [pool[j % len(pool)][r] for j, r in picks]
    del model, served, by_index
    card.free(device)
    refs = fam.reference.prefill_logits(a, seed, prompts, device)
    out["readings"] = check.readings(logits, firsts, refs,
                                     [len(t) for t in prompts])
    return out
