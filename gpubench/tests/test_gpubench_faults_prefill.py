"""The prefill cell's whole run at a tiny size on the CPU, past the look
for a card: sound, it is correct; with a served token altered, or half of
a batch left out, it is not. The faults are ``control.py``'s, planted in
the program's ``DecoderLM.prefill``."""
import time

import torch

from gpubench import control
from gpubench.run import run_cell
from gpubench.tests import tiny

CELL = "mixtral-8x22b.prefill"


def _run(trace=False, seed=2 ** 31 + 11):
    return run_cell(tiny.cell(CELL), seed, 0.3, trace, torch.device("cpu"),
                    time.time())


def test_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "prefill_p90_ms",
                                    "peak_mem_gib", "setup_s"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    # every row slot of every shape, twice
    assert line["readings"]["requests"] == 2 * sum(
        B for B, _ in tiny.cell(CELL).traffic["shapes"])
    assert list(line)[-1] == "checks"


def test_traced_run_reports_per_layer_metrics():
    line = _run(trace=True)
    assert line["correct"]
    assert "mfu.prefill" in line["metrics"]
    assert line["attempted"] == sum(
        b for b, _ in tiny.cell(CELL).traffic["shapes"])


def test_altered_token_is_caught():
    with control.planted(control.altered_token):
        assert not _run()["correct"]


def test_half_the_batch_left_out_is_caught():
    # every batch, the longest too, keeps half its rows sound
    assert min(B for B, _ in tiny.cell(CELL).traffic["shapes"]) >= 2
    with control.planted(control.half_batch):
        line = _run()
    assert not line["correct"], line["checks"]
