"""Functional optimizers over a dict of tensors (the reference's
``repro/optim/optimizers.py`` with tensors in place of pytrees).

``opt = sgd(...)``; ``state = opt.init(params)``; ``params, state =
opt.update(grads, state, params)``, where ``params`` and ``grads`` are
dicts of tensors keyed by parameter name (a module's ``named_parameters``)
and every result is a new tensor. The update equations are the
reference's, term for term, not ``torch.optim``'s: the same float32 casts
and order of operations, the bias corrections in float32 and an int32
step counter on the parameters' device, so that a step stays within
float32 rounding of the JAX package's. Fused ops (``addcmul_``,
``_foreach_*``) are kept off this path for the same reason.

``state_dtype`` keeps the moments in another dtype (bf16) as the
reference's does. Call ``update`` without autograd recording it (under
``torch.no_grad()``): the trainers do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple]
    name: str = "optimizer"


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step_f32(step).device)


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.1):
    def sched(step):
        step = _step_f32(step)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return sched


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: JAX gives a Python scalar the dtype of
    the array it meets (bf16 0.9 is 0.8984375), where torch would multiply
    a bf16 tensor by the float32 scalar."""
    return torch.tensor(x, dtype=dtype).item()


def _resolve(lr):
    return lr if callable(lr) else constant_schedule(lr)


def _step0(params: Params) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        state_dtype=None) -> Optimizer:
    """SGD with optional (heavy-ball) momentum and decoupled weight decay."""
    sched = _resolve(lr)

    def init(params):
        step = _step0(params)
        if momentum == 0.0:
            return {"step": step}
        return {"step": step,
                "mu": {n: torch.zeros_like(p, dtype=state_dtype or p.dtype)
                       for n, p in params.items()}}

    def update(grads, state, params):
        lr_t = sched(state["step"])  # float32: each step is computed in it

        def decayed(d, p):
            return d + _weak(weight_decay, p.dtype) * p

        if momentum == 0.0:
            new = {n: (p.float() - lr_t * decayed(grads[n], p).float()
                       ).to(p.dtype) for n, p in params.items()}
            return new, {"step": state["step"] + 1}
        mu = {n: (_weak(momentum, m.dtype) * m + grads[n]).to(m.dtype)
              for n, m in state["mu"].items()}
        new = {n: (p.float() - lr_t * decayed(mu[n].float(), p)).to(p.dtype)
               for n, p in params.items()}
        return new, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init=init, update=update, name="sgd")


def _adam_core(lr, b1, b2, eps, weight_decay, decoupled, state_dtype, name):
    sched = _resolve(lr)

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=state_dtype or torch.float32)

        return {"step": _step0(params),
                "m": {n: z(p) for n, p in params.items()},
                "v": {n: z(p) for n, p in params.items()}}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(state["step"])
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())

        def upd(p, g, m, v):
            g32 = g.float()
            if weight_decay and not decoupled:
                g32 = g32 + weight_decay * p.float()
            m_new = b1 * m.float() + (1 - b1) * g32
            v_new = b2 * v.float() + (1 - b2) * g32 * g32
            upd_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if weight_decay and decoupled:
                upd_ = upd_ + weight_decay * p.float()
            p_new = (p.float() - lr_t * upd_).to(p.dtype)
            return p_new, m_new.to(m.dtype), v_new.to(v.dtype)

        out = {n: upd(p, grads[n], state["m"][n], state["v"][n])
               for n, p in params.items()}
        return ({n: o[0] for n, o in out.items()},
                {"step": step, "m": {n: o[1] for n, o in out.items()},
                 "v": {n: o[2] for n, o in out.items()}})

    return Optimizer(init=init, update=update, name=name)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, state_dtype=None):
    return _adam_core(lr, b1, b2, eps, weight_decay, False, state_dtype, "adam")


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, state_dtype=None):
    return _adam_core(lr, b1, b2, eps, weight_decay, True, state_dtype, "adamw")


def fedprox_loss(loss_fn, mu: float):
    """FedProx [34]: adds (μ/2)·||w − w_global||² to the local objective.
    ``loss_fn(params, batch)``; the squares are summed parameter by
    parameter in sorted name order (the reference's leaf order)."""
    def wrapped(params, batch, global_params):
        base = loss_fn(params, batch)
        prox = sum(torch.sum(torch.square(params[n].float()
                                          - global_params[n].float()))
                   for n in sorted(params))
        return base + 0.5 * mu * prox
    return wrapped
