"""The readers of the program's own spans and counters
(``gpubench/metrics/_spans.py`` and the metrics that use it): a traced
tiny run of each cell reports them, with the training step's four phases
summing to the step; an untraced run records nothing; each reader
returns None where the program has no ``repro_torch.spans`` (an older
checkout) or recorded nothing; a record made by hand reads as worked
out."""
import sys
import time

import pytest
import torch

from gpubench.core import spec
from gpubench.run import run_cell
from gpubench.tests import tiny

PREFILL = "mixtral-8x22b.prefill"
TRAIN = "smollm-360m.train-s2048"
NEW = {PREFILL: ["k5_row_fill.prefill", "moe_dispatch_ms.prefill",
                 "attention_ms.prefill"],
       TRAIN: ["forward_ms.train", "backward_ms.train", "reduce_ms.train",
               "update_ms.train"]}
READERS = sorted(m for ms in NEW.values() for m in ms)


@pytest.fixture
def spans():
    from repro_torch import spans
    spans.clear()
    yield spans
    spans.clear()


def _run(name, trace):
    return run_cell(tiny.cell(name), 2 ** 31 + 19, 0.3, trace,
                    torch.device("cpu"), time.time())


@pytest.mark.parametrize("name", [PREFILL, TRAIN])
def test_traced_tiny_run_reports_the_programs_metrics(spans, name):
    line = _run(name, trace=True)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for m in NEW[name]:
        assert m in got and got[m]["value"] >= 0, m
        assert got[m]["unit"] == next(x["unit"] for x in
                                      spec.benchmark()["per_layer"]
                                      if x["name"] == m)
    mix = tiny.cell(name).traffic
    units = mix["trace_batches"] if name == PREFILL else mix["trace_steps"]
    rec = spans.collected()
    if name == PREFILL:
        # dropless: capacity 4 = experts / top_k, so 1 row in 4 is filled
        assert got["k5_row_fill.prefill"]["value"] == 25.0
        assert got["attention_ms.prefill"]["value"] > 0
        assert got["moe_dispatch_ms.prefill"]["value"] > 0
        tops = [s for s in rec["spans"] if s["parent"] is None]
        assert [s["name"] for s in tops] == ["repro_torch.prefill"] * units
    else:
        steps = [s for s in rec["spans"]
                 if s["name"] == "repro_torch.train.step"]
        assert len(steps) == units
        phases = sum(got[m]["value"] for m in NEW[TRAIN])
        step = sum(s["device_ms"] for s in steps) / len(steps)
        assert phases == pytest.approx(step, rel=0.05)


def test_untraced_tiny_run_records_nothing(spans):
    _run(PREFILL, trace=False)
    assert spans.collected() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("metric", READERS)
def test_reader_without_the_programs_spans(monkeypatch, spans, metric):
    read = spec.metric_reader(metric)
    ctx = {"units": [{}]}
    assert read(ctx) is None  # nothing recorded
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(ctx) is None  # no such module


def test_readers_on_a_hand_made_record(spans):
    """Two prefill batches, each a MoE layer whose products take part of
    it, and an older call outside them: the readers take the last two
    calls and divide by two."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for rows in (999, 64, 64):
            with spans.span("repro_torch.prefill"):
                with spans.span("repro_torch.attention"):
                    time.sleep(0.002)
                with spans.span("repro_torch.moe"):
                    spans.count("moe.rows", rows)
                    spans.count("moe.kept", torch.tensor(16))
                    with spans.span("repro_torch.moe.experts"):
                        time.sleep(0.003)
    ctx = {"units": [{}, {}]}
    rec = spans.collected()["spans"]
    last = rec[4:]
    want = {"repro_torch.attention": 0.0, "repro_torch.moe": 0.0,
            "repro_torch.moe.experts": 0.0}
    for s in last:
        if s["name"] in want:
            want[s["name"]] += s["device_ms"] / 2
    assert spec.metric_reader("k5_row_fill.prefill")(ctx) == 25.0
    assert spec.metric_reader("attention_ms.prefill")(ctx) == \
        pytest.approx(want["repro_torch.attention"])
    assert spec.metric_reader("moe_dispatch_ms.prefill")(ctx) == \
        pytest.approx(want["repro_torch.moe"]
                      - want["repro_torch.moe.experts"])
    # more units than calls: nothing to read
    assert spec.metric_reader("attention_ms.prefill")(
        {"units": [{}] * 4}) is None
    # the training readers find no step
    assert spec.metric_reader("forward_ms.train")(ctx) is None
