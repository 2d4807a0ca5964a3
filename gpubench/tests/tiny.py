"""The benchmark's cells cut to sizes a CPU test can run: the same
drivers, references, checks and limits, on tiny widths in float32."""
from __future__ import annotations

import copy

from gpubench.core import spec

MOE = dict(hidden_size=64, intermediate_size=64, num_attention_heads=4,
           num_key_value_heads=2, num_hidden_layers=2, num_local_experts=4,
           vocab_size=128, torch_dtype="float32")
DENSE = dict(hidden_size=64, intermediate_size=64, num_attention_heads=3,
             num_key_value_heads=1, num_hidden_layers=2, vocab_size=128,
             torch_dtype="float32")


def cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a tiny size."""
    c = copy.deepcopy(spec.cell(name))
    if c.driver == "prefill":
        c.config.update(MOE)
        c.traffic.update(shapes=[[8, 16], [4, 32], [2, 64]],
                         pool_batches=6, trace_batches=3, warmup_cycles=1)
    else:
        c.config.update(DENSE, hidden_size=96)
        c.traffic.update(batch=4, seq=16, pool_batches=4, chunk_tokens=32)
    return c
