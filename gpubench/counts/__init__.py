"""The benchmark's own counts of the work its inputs need, from the
configuration's sizes alone, and the card's published peaks. They describe
the work, not how the program does it: no padded head, no recomputation,
no capacity slot."""
from __future__ import annotations

import json
from pathlib import Path


def peaks() -> dict:
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)
