"""The port's own spans and counters (``repro_torch.spans``) and the MoE
layer's counters (``repro_torch.models.moe``).

* Off (no profiler recording): ``span`` is one shared null context,
  ``count`` does nothing, the record stays empty; a plain Python thread
  started under the profiler sees tracing off.
* On (``torch.profiler`` with CPU activity): names, the top-level call's
  id, same-thread parents and self time; a span inside a backward through
  ``torch.utils.checkpoint`` (remat's recompute) belongs to the call that
  runs the backward; each span's host start and end agree with the
  profiler's ``record_function`` event of that name within 1 ms; tensors
  given to ``count`` are summed when read.
* The MoE dispatch, grouped and flat: ``moe.rows`` = E·G·C (E·C flat),
  ``moe.kept`` = the kept assignments, ``moe.assigned`` = T·K; at
  mixtral's prefill batch (8192 tokens, 32 groups, capacity 4) exactly
  one row in four holds a token; at capacity 1.25 fewer are kept than
  assigned. With K5 on (``use_kernels``) where the dispatch packs routed
  rows (on K5's device, for which the CPU stands in here), ``moe.rows`` is each expert's kept rows rounded up to 128, summed
  (from the dispatch's own route and slots), and mixtral's prefill batch
  fills at least 94 % of them.
* On the card: the device interval comes from CUDA events; the routed
  dispatch at mixtral's batch shape never waits for the device (CUDA's
  sync debug mode set to raise) and gives the einsum route's output.
"""
import dataclasses
import threading
import time

import pytest
import torch
import torch.utils.checkpoint
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.models import moe as M


@pytest.fixture(autouse=True)
def empty_record():
    spans.clear()
    yield
    spans.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_is_one_null_context_and_records_nothing():
    assert not spans.enabled()
    a, b = spans.span("a"), spans.span("b")
    assert a is b
    with a:
        spans.count("n", 3)
        spans.count("t", torch.tensor(2))
    assert spans.collected() == {"spans": [], "counters": {}}


def test_on_records_names_calls_parents_and_self_time():
    with _profiled():
        for _ in range(2):
            with spans.span("top"):
                with spans.span("a"):
                    with spans.span("a.inner"):
                        time.sleep(0.002)
                    time.sleep(0.001)
                with spans.span("b"):
                    time.sleep(0.001)
    rec = spans.collected()
    got = rec["spans"]
    assert [s["name"] for s in got] == ["top", "a", "a.inner", "b"] * 2
    first, second = ({s["call"] for s in got[k:k + 4]} for k in (0, 4))
    assert len(first) == len(second) == 1 and first != second
    for k in (0, 4):
        top, a, inner, b = got[k:k + 4]
        assert top["parent"] is None
        assert a["parent"] == k and b["parent"] == k
        assert inner["parent"] == k + 1
        # off the card the device interval is the host one
        for s in (top, a, inner, b):
            assert s["device_ms"] == s["host_ms"] > 0
            assert s["start_ns"] < s["end_ns"]
        assert inner["self_ms"] == inner["device_ms"] >= 2.0
        assert a["self_ms"] == pytest.approx(
            a["device_ms"] - inner["device_ms"])
        assert top["self_ms"] == pytest.approx(
            top["device_ms"] - a["device_ms"] - b["device_ms"])
        assert 0 <= top["self_ms"] < top["device_ms"]
    assert spans.collected([got[4]["call"]])["spans"] == [
        dict(s, parent=None if s["parent"] is None else s["parent"] - 4)
        for s in got[4:]]


def test_span_inside_checkpointed_backward_belongs_to_the_step():
    w = torch.randn(16, 16, requires_grad=True)

    def block(x):
        with spans.span("inner"):
            return torch.tanh(x @ w)

    x = torch.randn(4, 16)
    with _profiled():
        with spans.span("step"):
            with spans.span("forward"):
                y = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            with spans.span("backward"):
                y.sum().backward()
    got = spans.collected()["spans"]
    names = [s["name"] for s in got]
    assert names.count("inner") == 2  # the forward and the recompute
    step = names.index("step")
    assert {s["call"] for s in got} == {got[step]["call"]}
    fwd_inner, re_inner = [s for s in got if s["name"] == "inner"]
    assert got[fwd_inner["parent"]]["name"] == "forward"
    # the recompute runs on the thread that runs the backward: the
    # caller's off the card (its parent, the backward's span), autograd's
    # device thread on the card (no parent of its own thread)
    assert re_inner["parent"] is None or \
        got[re_inner["parent"]]["name"] == "backward"
    bwd = got[names.index("backward")]
    assert bwd["start_ns"] <= re_inner["start_ns"] <= bwd["end_ns"]
    assert w.grad is not None


def test_a_plain_thread_sees_tracing_off():
    seen = []

    def work():
        seen.append((spans.enabled(), spans.span("t")))
        with spans.span("t"):
            spans.count("n", 1)

    with _profiled():
        assert spans.enabled()
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert seen == [(False, spans.span("t"))]
    assert spans.collected() == {"spans": [], "counters": {}}


def test_host_clock_agrees_with_the_profilers_events():
    with _profiled() as prof:
        # the profiler's own first range pays its one-time set-up
        with torch.profiler.record_function("warm-up"):
            pass
        for i in range(20):
            with spans.span(f"s{i}"):
                torch.ones(256).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    worst = 0
    for s in spans.collected()["spans"]:
        e = events[s["name"]]
        start = e.start_ns()
        end = start + e.duration_ns()
        worst = max(worst, abs(start - s["start_ns"]), abs(end - s["end_ns"]))
    assert worst < 1_000_000, worst


def test_counted_tensors_are_summed_when_read():
    t = torch.tensor(3)
    with _profiled():
        spans.count("n", 2)
        spans.count("n", t)
        spans.count("m", torch.tensor([5]).sum())
        t += 10  # counted, not yet read: the read sees its value then
    assert spans.collected()["counters"] == {"n": 15, "m": 5}


def _moe(capacity_factor, d=16, experts=4):
    cfg = dataclasses.replace(get_config("mixtral-8x22b", reduced=True),
                              d_model=d, moe_d_ff=d, n_experts=experts,
                              capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(0)
    params = {n: torch.empty(s, dtype=dt)
              for n, (s, dt) in M.moe_param_shapes(cfg).items()}
    M.init_moe_params(g, cfg, params)
    return cfg, params


def _kept(x, cfg, params, groups, per_expert=False):
    """The kept assignments, from the dispatch's own route and slots (each
    expert's, where ``per_expert``)."""
    T, K = x.shape[0] * x.shape[1], cfg.top_k
    xt = x.reshape(groups, T // groups, x.shape[-1])
    _, _, idx = M._route(xt, params["router"], K)
    C = M.expert_capacity(T // groups, cfg)
    _, sorted_e, _, keep = M._slots(idx.reshape(groups, T // groups * K), C)
    if per_expert:
        return torch.bincount(sorted_e[keep], minlength=cfg.n_experts), C
    return int(keep.sum()), C


@pytest.mark.parametrize("fn,B,S,cf", [
    ("moe_ffn_grouped", 2, 64, 1.25),
    ("moe_ffn_grouped", 2, 64, 0.5),
    ("moe_ffn_flat", 3, 1, 1.25),
    ("moe_ffn_flat", 2, 40, 0.5),
])
def test_moe_counts_rows_kept_and_assigned(fn, B, S, cf):
    cfg, params = _moe(cf)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    G = M._pick_groups(T) if fn == "moe_ffn_grouped" else 1
    kept, C = _kept(x, cfg, params, G)
    with torch.no_grad(), _profiled():
        _, aux = getattr(M, fn)(params, x, cfg)
    assert spans.collected()["counters"] == {
        "moe.rows": E * G * C, "moe.kept": kept, "moe.assigned": T * K}
    assert kept == pytest.approx((1 - float(aux["dropped"])) * T * K)


def test_mixtrals_prefill_batch_fills_one_row_in_four():
    """8192 tokens in 32 groups of 256 at capacity 4 = experts / top_k:
    C = 256 * 2 * 4 / 8 = 256 slots an expert a group, 8 * 32 * 256 =
    65,536 rows, and every one of the 16,384 assignments kept."""
    cfg, params = _moe(4.0)
    x = torch.randn(8, 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), _profiled():
        M.moe_ffn(params, x, cfg)
    c = spans.collected()["counters"]
    assert c == {"moe.rows": 65536, "moe.kept": 16384,
                 "moe.assigned": 16384}
    assert 100.0 * c["moe.kept"] / c["moe.rows"] == 25.0


@pytest.mark.parametrize("B,S,cf", [(2, 64, 1.25), (4, 512, 1.25),
                                    (4, 512, 4.0), (8, 100, 2.0)])
def test_routed_rows_are_each_experts_kept_rows_rounded_up(B, S, cf,
                                                          monkeypatch):
    monkeypatch.setattr(M, "_KERNEL_DEVICE", "cpu")  # K5 as its plain version
    cfg, params = _moe(cf)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    T, K, G = B * S, cfg.top_k, M._pick_groups(B * S)
    n, C = _kept(x, cfg, params, G, per_expert=True)
    assert M._routed(x, T * K, cfg.n_experts, G * C, True)
    with torch.no_grad(), _profiled():
        M.moe_ffn(params, x, cfg, use_kernels=True)
    assert spans.collected()["counters"] == {
        "moe.rows": int((-(-n // 128) * 128).sum()),
        "moe.kept": int(n.sum()), "moe.assigned": T * K}


def test_mixtrals_prefill_batch_on_k5_fills_94_percent(monkeypatch):
    """The same batch with K5 on, 8 experts: routed rows, at most 127
    padding rows an expert (16,384 of at most 17,400)."""
    monkeypatch.setattr(M, "_KERNEL_DEVICE", "cpu")  # K5 as its plain version
    cfg, params = _moe(4.0, experts=8)
    x = torch.randn(8, 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), _profiled():
        M.moe_ffn(params, x, cfg, use_kernels=True)
    c = spans.collected()["counters"]
    assert c["moe.kept"] == c["moe.assigned"] == 16384
    assert 100.0 * c["moe.kept"] / c["moe.rows"] >= 94.0


def test_capacity_125_keeps_fewer_than_it_assigns():
    cfg, params = _moe(1.25)
    x = torch.randn(4, 512, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), _profiled():
        M.moe_ffn(params, x, cfg)
    c = spans.collected()["counters"]
    assert c["moe.assigned"] == 4 * 512 * 2
    assert 0 < c["moe.kept"] < c["moe.assigned"]


def test_moe_spans_split_the_dispatch_from_the_products():
    cfg, params = _moe(1.25)
    x = torch.randn(2, 64, cfg.d_model)
    with torch.no_grad(), _profiled():
        M.moe_ffn(params, x, cfg)
    got = spans.collected()["spans"]
    assert [s["name"] for s in got] == ["repro_torch.moe",
                                        "repro_torch.moe.experts"]
    assert got[1]["parent"] == 0
    assert 0 < got[1]["device_ms"] < got[0]["device_ms"]


@pytest.mark.cuda
def test_device_interval_from_cuda_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda:0")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with spans.span("products"):
            for _ in range(20):
                a = a @ a / 2048
        with spans.span("nothing"):
            pass
    (prod, nothing) = spans.collected()["spans"]
    # the products run on after the host has left the span
    assert prod["device_ms"] > prod["host_ms"]
    assert 0 <= nothing["device_ms"] < prod["device_ms"]
    pool = len(spans.RECORD._pool)
    spans.clear()
    assert len(spans.RECORD._pool) == pool + 4


@pytest.mark.cuda
def test_routed_dispatch_never_waits_for_the_card():
    """mixtral's prefill batch shape (8192 tokens, 8 experts top-2,
    capacity 4) at d 256 in bf16 on the card: with K5 on, the dispatch
    takes routed rows and runs under ``torch.cuda.set_sync_debug_mode``
    set to raise on any wait for the device; it agrees with the einsum
    route over capacity slots within 1 % of the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params = _moe(4.0, d=256, experts=8)
    dev = torch.device("cuda:0")
    params = {n: p.to(dev, torch.float32 if n == "router" else
                      torch.bfloat16) for n, p in params.items()}
    x = torch.randn(8, 1024, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6)).to(dev, torch.bfloat16)
    with torch.no_grad():
        M.moe_ffn(params, x, cfg, use_kernels=True)   # builds K5
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, _ = M.moe_ffn(params, x, cfg, use_kernels=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want, _ = M.moe_ffn(params, x, cfg, use_kernels=False)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) < 0.01
