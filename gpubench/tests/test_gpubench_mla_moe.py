"""The mla_moe family (Kimi-K2-Instruct) in the benchmark: its counts
against values worked by hand, its reference against the plain reference
of the tests (``tests/plain_mla_moe.py``), and its cell's whole run at a
tiny size on the CPU, past the look for a card: sound it is correct, with
``control.py``'s planted faults it is not, and a traced run reads the
latent attention's metric from the program's spans."""
import time

import pytest
import torch

from gpubench import control
from gpubench.arch import mla_moe as arch
from gpubench.arch.mla_moe import Arch
from gpubench.core import spec
from gpubench.core import weights as W
from gpubench.counts import mla_moe as counts
from gpubench.port import mla_moe as port
from gpubench.reference import mla_moe as ref
from gpubench.run import run_cell
from gpubench.tests import tiny
from tests import plain_mla_moe as plain

CELL = "kimi-k2-instruct.prefill"
SEED = 2 ** 31 + 23

# d 8, 2 heads, q_lora 4, kv_lora 4, q/k 4 + 2, v 3; a dense layer of 16,
# an expert layer of 8 experts (2 held) of 6, top 2, one shared expert
SMALL = Arch(name="s", n_layers=2, d_model=8, n_heads=2, q_lora=4, kv_lora=4,
             d_nope=4, d_rope=2, d_v=3, vocab=10, first_dense=1, d_ff=16,
             d_expert=6, n_experts=8, n_held=2, held_first=0, top_k=2,
             n_shared=1, routed_scale=2.827, rope_theta=50000.0,
             yarn=(32.0, 4096, 1.0, 1.0, 1.0, 1.0), norm_eps=1e-6)


def test_counts_by_hand():
    # B 1, S 4: T 4, 10 kept pairs. MLA's products a token: 8*4 + 4*2*6 +
    # 8*(4+2) + 4*2*(4+3) + 2*3*8 = 232, times 2 * 4; K3 2*(6+3)*2*10
    assert counts.mla_flops(SMALL, 1, 4) == 1856 + 360
    # dense FFN 3*2*4*8*16; router 2*4*8*8, shared 3*2*4*8*6, the held
    # share's 4*2*2/8 = 2 rows through 3 products of 2*8*6
    assert counts.layer_flops(SMALL, 0, 1, 4) == 2216 + 3072
    assert counts.layer_flops(SMALL, 1, 1, 4) == 2216 + 512 + 1152 + 576
    assert counts.prefill_flops(SMALL, 1, 4) == 5288 + 4456 + 2 * 8 * 10
    assert counts.train_flops(SMALL, 1, 4) == 3 * (5288 + 4456
                                                   + 2 * 4 * 8 * 10)
    # K5: 3 launches of the one expert layer; bytes the 2 held experts'
    # weights and the 2 rows in and out, bf16
    assert counts.k5_launches(SMALL, 1, 4) == [(192, 192 + 56)] * 3
    # K3: one a layer; q, k 6 wide, v and the output 3 wide, bf16
    assert counts.k3_launches(SMALL, 1, 4) == [(360, 4 * 2 * 18 * 2)] * 2


def test_counts_at_the_cell_match_its_why():
    """MLA does 53-68 % of a batch's model FLOPs, K3's contraction
    16-43 %; the configuration is 20.94e9 parameters."""
    c = spec.cell(CELL)
    a = c.family.arch.sizes(c.config)
    shares = []
    for B, S in c.traffic["shapes"]:
        f = counts.prefill_flops(a, B, S)
        k3 = sum(o for o, _ in counts.k3_launches(a, B, S))
        shares.append((a.n_layers * counts.mla_flops(a, B, S) / f, k3 / f))
    assert [round(m, 2) for m, _ in shares] == [0.53, 0.6, 0.68]
    assert [round(k, 2) for _, k in shares] == [0.16, 0.27, 0.43]
    n = sum(torch.Size(s).numel() for _, (s, _, _) in
            arch.global_shapes(a).items())
    n += sum(torch.Size(s).numel() for i in range(a.n_layers)
             for _, (s, _, _) in arch.layer_shapes(a, i).items())
    assert n == 20_941_203_456


def _plain_sizes(a: Arch) -> plain.Sizes:
    f, om, bf, bs, m, mall = a.yarn
    return plain.Sizes(
        d=a.d_model, n_heads=a.n_heads, q_lora=a.q_lora, kv_lora=a.kv_lora,
        d_nope=a.d_nope, d_rope=a.d_rope, d_v=a.d_v, vocab=a.vocab,
        n_layers=a.n_layers, first_dense=a.first_dense, d_ff=a.d_ff,
        d_expert=a.d_expert, n_experts=a.n_experts, top_k=a.top_k,
        n_shared=a.n_shared, routed_scale=a.routed_scale,
        rope_theta=a.rope_theta, yarn_factor=f, yarn_original_max=om,
        yarn_beta_fast=bf, yarn_beta_slow=bs, yarn_mscale=m,
        yarn_mscale_all_dim=mall, eps=a.norm_eps)


@pytest.mark.parametrize("block", [512, 5])  # one block; blocks of 5
def test_reference_is_the_plain_reference(monkeypatch, block):
    monkeypatch.setattr(ref, "BLOCK", block)
    c = tiny.cell(CELL)
    a = c.family.arch.sizes(c.config)
    prompts = [torch.randint(0, a.vocab, (n,), generator=torch.Generator()
                             .manual_seed(n)) for n in (17, 40)]
    got = ref.prefill_logits(a, SEED, prompts, "cpu")
    outer = dict(W.outer(arch, a, SEED, "cpu"))
    layers = [dict(W.layer(arch, a, SEED, i, "cpu"))
              for i in range(a.n_layers)]
    held = range(a.held_first, a.held_first + a.n_held)
    for t, g in zip(prompts, got):
        want = plain.forward(_plain_sizes(a), outer, layers, t, held)[-1]
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


def test_reference_matches_the_port_and_fp8_does_not():
    from repro_torch.models import build_model
    c = tiny.cell(CELL)
    a = c.family.arch.sizes(c.config)
    model = build_model(port.model_config(c.config), use_kernels=True,
                        device="cpu")
    W.load_port(dict(model.named_parameters()), arch, a, SEED, "cpu")
    tokens = torch.randint(0, a.vocab, (2, 48), generator=torch.Generator()
                           .manual_seed(1))
    with torch.no_grad():
        logits, cache = model.prefill(tokens, 49)
    assert cache.ckv.shape == (a.n_layers, 2, 49, a.kv_lora + a.d_rope)
    want = ref.prefill_logits(a, SEED, list(tokens), "cpu")
    low = ref.prefill_logits(a, SEED, list(tokens), "cpu", "fp8")
    for r in range(2):
        torch.testing.assert_close(logits[r, -1], want[r], rtol=1e-4,
                                   atol=1e-4)
        assert (low[r] - want[r]).abs().max() > 1e-2 * want[r].abs().max()


def test_port_refuses_what_the_family_does_not_describe():
    c = spec.cell(CELL)
    cfg = port.model_config(c.config)
    assert (cfg.n_experts, cfg.experts_held, cfg.experts_first) == (384, 48, 0)
    assert (cfg.d_head + cfg.qk_rope_dim, cfg.v_head_dim) == (192, 128)
    assert cfg.first_dense_layers == 1 and cfg.router_score == "sigmoid"
    with pytest.raises(ValueError, match="drops tokens"):
        port.model_config(dict(c.config, port=dict(c.config["port"],
                                                   capacity_factor=8.0)))
    with pytest.raises(ValueError, match="scoring_func"):
        port.model_config(dict(c.config, scoring_func="softmax"))
    with pytest.raises(ValueError, match="share"):
        port.model_config(dict(c.config, held_experts_first=360))
    with pytest.raises(NotImplementedError):
        c.family.reference.train(None, 1, [], {}, "cpu")


def _run(trace=False, seed=SEED):
    return run_cell(tiny.cell(CELL), seed, 0.3, trace, torch.device("cpu"),
                    time.time())


def test_sound_tiny_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "prefill_p90_ms",
                                    "peak_mem_gib", "setup_s"}
    # one request of every row slot of every shape
    assert line["readings"]["requests"] == sum(
        B for B, _ in tiny.cell(CELL).traffic["shapes"])
    assert line["readings"]["miss_median"] < 1e-3


@pytest.mark.parametrize("fault", sorted(control.PREFILL_FAULTS))
def test_planted_faults_are_caught(fault):
    with control.planted(control.PREFILL_FAULTS[fault]):
        line = _run()
    assert not line["correct"], line["checks"]


def test_traced_tiny_run_reads_the_latent_attention():
    from repro_torch import spans
    spans.clear()
    try:
        line = _run(trace=True)
        rec = spans.collected()
    finally:
        spans.clear()
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for m in ("mfu.prefill", "mla_latent_ms.prefill", "attention_ms.prefill",
              "moe_dispatch_ms.prefill", "k5_row_fill.prefill",
              "idle_share.prefill"):
        assert m in got and got[m]["value"] >= 0, m
    assert 0 < got["mla_latent_ms.prefill"]["value"] < \
        got["attention_ms.prefill"]["value"]
    # one contraction span a layer, inside its attention span
    names = [s["name"] for s in rec["spans"]]
    units = tiny.cell(CELL).traffic["trace_batches"]
    n_layers = tiny.cell(CELL).config["num_hidden_layers"]
    assert names.count("repro_torch.attention.core") == units * n_layers
    for s in rec["spans"]:
        if s["name"] == "repro_torch.attention.core":
            assert rec["spans"][s["parent"]]["name"] == "repro_torch.attention"


def test_latent_reader_without_the_contraction_span(monkeypatch):
    """An older program records ``repro_torch.attention`` alone: the
    reader returns None, not the whole attention."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("repro_torch.prefill"):
            with spans.span("repro_torch.attention"):
                time.sleep(0.001)
    try:
        read = spec.metric_reader("mla_latent_ms.prefill")
        assert read({"units": [{}]}) is None
        assert spec.metric_reader("attention_ms.prefill")(
            {"units": [{}]}) > 0
    finally:
        spans.clear()
