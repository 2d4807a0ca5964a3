"""The decoder family's plain reference against repro_torch's plain route
(no kernels) at the reduced sizes of both its kinds (experts and dense),
in float32 on the CPU: the same
weights and inputs give the same logits, no expert row dropped, the same
losses and the same first steps."""
import dataclasses

import pytest
import torch

from gpubench.arch import decoder as arch
from gpubench.arch.decoder import Arch
from gpubench.core import weights as W
from gpubench.port import decoder as port
from gpubench.reference import decoder as ref
from gpubench.tests import tiny

TOL = dict(rtol=1e-4, atol=1e-4)


def _model(name, **kw):
    from repro_torch.models import build_model
    cell = tiny.cell(name)
    a = Arch.from_config(cell.config)
    model = build_model(port.model_config(cell.config), use_kernels=False,
                        device="cpu", **kw)
    return cell, a, model


def test_prefill_logits_match_the_port():
    cell, a, model = _model("mixtral-8x22b.prefill")
    W.load_port(dict(model.named_parameters()), arch, a, 3, "cpu")
    tokens = torch.randint(0, a.vocab, (2, 64), generator=torch.Generator()
                           .manual_seed(0))
    with torch.no_grad():
        logits, _ = model.prefill(tokens, 65)
    want = ref.prefill_logits(a, 3, list(tokens), "cpu")
    for r in range(2):
        torch.testing.assert_close(logits[r, -1, : a.vocab], want[r], **TOL)


def test_port_drops_no_token_at_the_configured_capacity():
    from repro_torch.models import moe as moe_mod
    cell, a, model = _model("mixtral-8x22b.prefill")
    g = torch.Generator().manual_seed(1)
    p = {k: v for k, v in W.layer(arch, a, 5, 0, "cpu")}
    # every token leans to expert 0: at the port's default capacity
    # (1.25) its groups overflow
    p["moe.router"][:, 0] += 0.5
    x = torch.randn(2, 1024, a.d_model, generator=g) + 0.5
    params = {k.split(".", 1)[1]: v for k, v in p.items()
              if k.startswith("moe.")}
    with torch.no_grad():
        got, aux = moe_mod.moe_ffn(params, x, model.cfg, use_kernels=False)
        _, lossy = moe_mod.moe_ffn(params, x, dataclasses.replace(
            model.cfg, capacity_factor=1.25), use_kernels=False)
    assert float(lossy["dropped"]) > 0.1
    assert float(aux["dropped"]) == 0.0
    torch.testing.assert_close(got, ref.experts(x, p, a, "f32"), **TOL)


def test_port_config_refuses_a_capacity_that_drops():
    cell = tiny.cell("mixtral-8x22b.prefill")
    cell.config["port"]["capacity_factor"] = 1.25
    with pytest.raises(ValueError, match="dropless"):
        port.model_config(cell.config)


def test_training_steps_match_the_port():
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from gpubench.core.traffic import train_pool
    from gpubench.check import train as check
    cell = tiny.cell("smollm-360m.train-s2048")
    a = Arch.from_config(cell.config)
    o = cell.config["optimizer"]
    model, opt, step = make_train_step(
        port.model_config(cell.config),
        optimizer=adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                        weight_decay=o["weight_decay"]),
        remat=False, device="cpu")
    params = {n: p.detach() for n, p in model.named_parameters()}
    W.load_port(params, arch, a, 9, "cpu")
    p0 = {n: t.clone() for n, t in params.items()}
    state = opt.init(params)
    pool = train_pool(cell.traffic, a.vocab, 9, "cpu")
    losses = []
    for i in range(3):
        params, state, loss = step(params, state, pool[i])
        losses.append(float(loss))
        if i == 0:
            grad = {n: float(torch.linalg.vector_norm(m)) / (1 - o["b1"])
                    for n, m in state["m"].items()}
    prog = {"loss": losses, "grad_norm": grad,
            "change": {n: float(torch.linalg.vector_norm(params[n] - p0[n]))
                       for n in params}}
    want = ref.train(a, 9, pool[:3], o, "cpu", chunk_tokens=32)
    r = check.readings(prog, want)
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4
    assert r["change_gap"] < 1e-3 and r["moved_leaves"] == r["leaves"]
