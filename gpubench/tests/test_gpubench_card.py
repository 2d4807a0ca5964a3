"""On the card: each driver's whole run at a tiny size, on the kernels, is
correct and names the card. Skips where there is no CUDA device."""
import time

import pytest

from gpubench.run import run_cell
from gpubench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name,trace", [
    ("mixtral-8x22b.prefill", False), ("mixtral-8x22b.prefill", True),
    ("smollm-360m.train-s2048", False), ("smollm-360m.train-s2048", True)])
def test_tiny_cell_on_the_card(card, name, trace):
    cell = tiny.cell(name)
    if cell.driver == "prefill":
        # K3 takes head dims of 32 and more; bf16 as the cell runs (at
        # this size a bf16 step's leaves would read past the training
        # limits, so training stays float32)
        cell.config.update(hidden_size=128, torch_dtype="bfloat16")
    line = run_cell(cell, 2 ** 31 + 7, 0.5, trace, card, time.time())
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
