"""The prefill check's sample and its numbers, by hand."""
import collections

import pytest
import torch

from gpubench.check import prefill as check
from gpubench.drivers.prefill import sample

SHAPES = [(8, 1024), (4, 2048), (2, 4096)]


@pytest.mark.parametrize("per_slot,finished", [(2, 9), (2, 40), (3, 12)])
def test_sample_takes_every_row_slot_of_every_shape(per_slot, finished):
    batches = [(i, *SHAPES[i % 3]) for i in range(finished)]
    picks = sample(batches, per_slot, 2 ** 33 + 5)
    assert picks == sample(batches, per_slot, 2 ** 33 + 5)
    shape_of = {i: (B, S) for i, B, S in batches}
    slots = collections.Counter((shape_of[i], r) for i, r in picks)
    assert set(slots) == {(s, r) for s in SHAPES for r in range(s[0])}
    assert set(slots.values()) == {per_slot}
    # a slot's requests come from distinct batches
    assert len(set(picks)) == len(picks)


def test_miss_is_the_logit_error_or_half_the_served_gap():
    ref = torch.tensor([3.0, 1.0, 0.0, 0.0])          # rms 1.5811
    rms = float(ref.pow(2).mean().sqrt())
    prog = ref + torch.tensor([0.0, 0.2, 0.0, 0.0])
    gap, miss = check.per_request(prog, 0, ref)      # its own best served
    assert gap == 0.0 and miss == pytest.approx(0.2 / rms)
    gap, miss = check.per_request(ref, 1, ref)       # a token altered
    assert gap == 2.0 and miss == pytest.approx(1.0 / rms)


def test_half_the_sample_off_moves_the_median_and_fewer_do_not():
    ref = torch.tensor([2.0, 1.0, 0.0, -1.0])
    good, bad = ref + 0.01, ref + torch.tensor([0.0, 3.0, 0.0, 0.0])

    def median(n_bad):
        got = [bad] * n_bad + [good] * (8 - n_bad)
        r = check.readings(got, [0] * 8, [ref] * 8, [4] * 8)
        assert len(r["misses"]) == 8
        return r["miss_median"]
    assert median(3) == pytest.approx(median(0))
    assert median(4) > 50 * median(0)
