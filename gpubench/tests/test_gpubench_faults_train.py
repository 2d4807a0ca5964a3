"""A training cell's whole run at a tiny size on the CPU, past the look for
a card: sound, it is correct; with the timed path broken underneath, it is
not. The faults are planted in the program's train step."""
import time

import pytest
import torch

from gpubench.run import run_cell
from gpubench.tests import tiny

CELLS = ["smollm-360m.train-s2048"]


def _run(name, seed=2 ** 31 + 3, trace=False):
    return run_cell(tiny.cell(name), seed, 0.3, trace, torch.device("cpu"),
                    time.time())


def _plant(monkeypatch, wrap):
    import repro_torch.launch.steps as steps
    real = steps.make_train_step

    def make(*args, **kw):
        model, opt, step = real(*args, **kw)
        return model, opt, wrap(step)

    monkeypatch.setattr(steps, "make_train_step", make)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert list(line)[-1] == "checks"


def test_traced_run_reports_per_layer_metrics():
    line = _run(CELLS[0], trace=True)
    assert line["correct"]
    assert "mfu.train" in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_state_left_unchanged_is_caught(monkeypatch):
    def wrap(step):
        def stuck(params, state, batch):
            _, _, loss = step(params, state, batch)
            return params, state, loss
        return stuck
    _plant(monkeypatch, wrap)
    line = _run(CELLS[0])
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def wrap(step):
        def half(params, state, batch):
            return step(params, state, {k: v[: v.shape[0] // 2]
                                        for k, v in batch.items()})
        return half
    _plant(monkeypatch, wrap)
    line = _run(CELLS[0])
    assert not line["correct"], line["readings"]
