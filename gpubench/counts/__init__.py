"""The benchmark's own counts of the work its inputs need, from the
configuration's sizes alone, and the card's published peaks. They describe
the work, not how the program does it: no padded head, no recomputation,
no capacity slot.

``counts/<family>.py`` counts a family's work: ``prefill_flops(a, B, S)``
and ``train_flops(a, B, S)`` (model FLOPs of a prefill of [B, S] and of a
training step), ``k5_launches(a, B, S)`` and ``k3_launches(a, B, S)``
((operations, bytes) of each expert product and each attention a prefill
launches; an empty list where the family has none). ``counts/work.py``
holds what the families share."""
from __future__ import annotations

import json
from pathlib import Path


def peaks() -> dict:
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)
