"""The control at a tiny size on the CPU: the reference computed in fp8, put
in the program's place, fails each cell's limits, where the sound program
passes them by far. (On the card, at the cells' sizes, ``control.py``
reads the same; PERF.md gives those readings.)"""
import pytest
import torch

from gpubench import control
from gpubench.check import judge
from gpubench.core import spec
from gpubench.tests import tiny

SEEDS = [2 ** 31 + 21, 2 ** 31 + 22]


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_fails_the_prefill_limits(seed):
    cell = tiny.cell("mixtral-8x22b.prefill")
    # fp8's error grows with depth and with the vocabulary its widest gap
    # is taken over: at 4 layers and 128 tokens it reads 0.48-0.58, at
    # 4096 tokens 0.61-0.72 (1.60-1.88 at the cell's size on the card)
    cell.config.update(num_hidden_layers=4, hidden_size=128, vocab_size=4096)
    cell.traffic.update(check_per_slot=3)
    readings = control.prefill_control(cell, seed, torch.device("cpu"))
    correct, checks = judge(readings, cell.limits)
    assert not correct, checks


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_and_half_batch_fail_the_train_limits(seed):
    cell = tiny.cell("smollm-360m.train-s2048")
    out = control.train_control(cell, seed, torch.device("cpu"), True)
    for kind in ("control", "half_batch"):
        correct, checks = judge(out[kind], cell.limits)
        assert not correct, (kind, checks)


def test_control_refuses_a_driver_it_has_none_for(monkeypatch, capsys):
    cell = tiny.cell("mixtral-8x22b.prefill")
    cell.traffic["driver"] = "decode"
    # refused before the look for a card, with a message and exit code 2
    monkeypatch.setattr(spec, "cell", lambda name: cell)
    assert control.main(["--workload", cell.name, "--seeds", "1",
                         "--control"]) == 2
    assert "no control for the driver 'decode'" in capsys.readouterr().err
    assert sorted(control.READINGS) == ["prefill", "train"]
