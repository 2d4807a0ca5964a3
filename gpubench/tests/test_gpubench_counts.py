"""The benchmark's counts against values worked by hand at small shapes:
the decoder family's (``counts/decoder.py``) and the shared ones
(``counts/work.py``)."""
import dataclasses

import pytest

from gpubench.arch.decoder import Arch
from gpubench.counts import decoder, peaks, work

DENSE = Arch(name="d", family="dense", n_layers=2, d_model=8, n_heads=3,
             n_kv_heads=2, d_head=4, d_ff=16, vocab=10)
MOE = Arch(name="m", family="moe", n_layers=1, d_model=8, n_heads=2,
           n_kv_heads=1, d_head=4, d_ff=16, vocab=10,
           n_experts=4, top_k=2)


@pytest.mark.parametrize("S,window,pairs", [
    (1, 0, 1), (4, 0, 10), (5, 0, 15),          # 1 + 2 + ... + S
    (5, 2, 9),                                  # 1 + 2 + 2 + 2 + 2
    (6, 3, 15),                                 # 1 + 2 + 3 + 3 + 3 + 3
    (4, 4, 10), (4, 9, 10)])                    # a window >= S is causal
def test_kept_pairs(S, window, pairs):
    assert work.kept_pairs(S, window) == pairs


def test_dense_layer_flops_by_hand():
    # B 2, S 3: T 6. q 2*6*8*12, k and v 2*2*6*8*8, o 2*6*12*8,
    # scores and values 4*4*3*(2*6 pairs), FFN 3*2*6*8*16
    want = 1152 + 1536 + 1152 + 576 + 4608
    assert decoder.layer_flops(DENSE, 2, 3) == want


def test_padded_heads_do_no_work():
    padded = dataclasses.replace(DENSE, n_heads=4)
    flops = decoder.layer_flops
    assert flops(padded, 2, 3) > flops(DENSE, 2, 3)
    # a fourth head adds its projections and its pairs, nothing else
    extra = 2 * 6 * 8 * 4 + 2 * 6 * 4 * 8 + 4 * 4 * 2 * 6
    assert flops(padded, 2, 3) - flops(DENSE, 2, 3) == extra


def test_prefill_and_train_flops():
    layers = 2 * decoder.layer_flops(DENSE, 2, 3)
    assert decoder.prefill_flops(DENSE, 2, 3) == layers + 2 * 2 * 8 * 10
    assert decoder.train_flops(DENSE, 2, 3) == 3 * (layers + 2 * 6 * 8 * 10)


def test_moe_flops_count_top_k_experts():
    # T 4: router 2*4*8*4, experts 3 products * 2*(4*2 routed)*8*16
    attn = 2 * 4 * 8 * (8 + 8) + 2 * 4 * 8 * 8 + 4 * 4 * 2 * 10
    assert decoder.layer_flops(MOE, 1, 4) == attn + 256 + 6144


@pytest.mark.parametrize("per_expert", [(8, 0, 0, 0), (5, 1, 1, 1),
                                        (2, 2, 2, 2)])
def test_k5_counts_routed_rows_however_uneven(per_expert):
    # 4 tokens top-2: 8 routed rows, however the router spreads them; a
    # capacity slot left empty is not work
    launches = decoder.k5_launches(MOE, 1, 4)
    assert len(launches) == 3 * MOE.n_layers
    ops = sum(2 * n * 8 * 16 for n in per_expert)
    byts = 4 * 8 * 16 * 2 + sum(per_expert) * (8 + 16) * 2
    assert launches[0] == (ops, byts)


def test_k3_counts():
    (ops, byts), = decoder.k3_launches(dataclasses.replace(MOE), 2, 3)
    assert ops == 4 * 4 * 2 * 2 * 6
    assert byts == 2 * 3 * 4 * (2 * 2 + 2 * 1) * 2


def test_least_seconds_takes_the_larger_bound():
    p = {"bf16_flops": 100.0, "hbm_bytes_per_s": 10.0}
    assert work.least_seconds([(200, 10), (100, 50)], p) == 2.0 + 5.0


def test_peaks_are_the_published_h100_rates():
    p = peaks()
    assert p["bf16_flops"] == 989.4e12 and p["hbm_bytes_per_s"] == 3.35e12

