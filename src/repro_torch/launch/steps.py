"""Step factories: train, prefill and decode per architecture.

The port of ``repro/launch/steps.py``. ``make_train_step`` trains on the
reference's route (``use_kernels=False``): the reference's
``block_train`` reaches no Pallas kernel and none of its kernels has a
backward, and the port's K3-K5 have none either (their wrappers refuse a
gradient); a hybrid's Mamba branch runs its per-token loop under
autograd there. Prefill and decode run on the kernels (K3 attention, K4
rwkv scan, K5 expert products; a hybrid's Mamba branch is torch ops); an
encoder-decoder's prefill is its encoder (K3 over the encoder's window)
and the cross attention's K/V. Every step runs on the model's device,
``cuda:0`` unless the caller names another.

Given a ``mesh`` (a ``DeviceMesh`` over ``("data", "model")``, with
``"pod"`` in front on the multi-pod mesh), a step is a DTensor program,
the port of the reference's ``jax.jit`` with ``in_shardings`` and
``out_shardings`` under ``with mesh``: it runs under the ambient mesh
(:func:`repro_torch.models.common.use_mesh`), so that the model's
activation constraints apply, on DTensor inputs placed as
:func:`repro_torch.sharding.step_placements` gives them for ``strategy``,
and returns its outputs on the out-placements: the train step's new
parameters and state as its inputs (the gradients reduced onto the
parameters' placements) and its loss replicated; the prefill's
last-position logits and its cache as ``cache_specs`` places them; the
decode step's logits and the cache it was given. The layers are a Python
loop, unrolled or not: ``unroll`` is accepted for the reference's
signature and changes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.models import (ModelConfig, build_model,
                                shape_for_long_context)
from repro_torch.models.api import shape_spec
from repro_torch.models.common import as_dtensor, use_mesh
from repro_torch.optim import adamw, sgd
from repro_torch.sharding import step_placements
from repro_torch.spans import span

# parameter-count threshold above which training uses SGD-momentum with
# bf16 state instead of AdamW fp32 state (memory fit for the giant MoEs)
BIG_MODEL_PARAMS = 30e9


def default_optimizer(cfg: ModelConfig):
    if cfg.param_count() > BIG_MODEL_PARAMS:
        return sgd(3e-4, momentum=0.9, state_dtype=torch.bfloat16)
    return adamw(3e-4, weight_decay=0.1)


def reduce_grad(grad, placements):
    """A gradient on its parameter's placements: its partial sums over the
    data axes (and the model axis) reduced, as GSPMD reduces them for the
    reference's ``out_shardings``."""
    return grad.redistribute(grad.device_mesh, placements)


def _replicated(t, mesh):
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)


def make_train_step(cfg: ModelConfig, optimizer=None, remat: bool = True,
                    device=None, mesh=None, unroll: bool = False):
    """Returns (model, opt, train_step(params, opt_state, batch)).

    ``params`` is a dict of the model's parameter names to tensors,
    ``opt_state`` the optimizer's state over them and ``batch`` a dict of
    tensors (``tokens``, ``labels``, optionally ``mask``, and a vlm's or an
    encoder-decoder's ``frontend_embeds``); ``train_step``
    returns the new parameters, the new state and the loss before the
    update, as the reference's does. The loss is the model's at ``params``
    (``torch.func.functional_call``; the model's own weights are not
    read), its gradients come from ``torch.autograd.grad`` and the update
    runs under ``torch.no_grad()``. On a ``mesh`` the inputs are DTensors
    (:func:`repro_torch.sharding.step_placements`): each gradient is
    reduced onto its parameter's placements before the update, and the
    loss comes out replicated. While a profiler records, the step and its
    phases are spans of :mod:`repro_torch.spans`:
    ``repro_torch.train.step`` over ``.forward`` (the leaves and the
    loss), ``.backward`` (remat's recompute included), ``.reduce`` and
    ``.update``."""
    model = build_model(cfg, use_kernels=False, device=device, remat=remat,
                        unroll=unroll)
    opt = optimizer or default_optimizer(cfg)

    def train_step(params, opt_state, batch):
        with span("repro_torch.train.step"), use_mesh(mesh):
            with span("repro_torch.train.forward"):
                leaves = {n: p.detach().requires_grad_()
                          for n, p in params.items()}
                loss = torch.func.functional_call(model, leaves, (batch,))
            with span("repro_torch.train.backward"):
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True,
                                            materialize_grads=True)
            with span("repro_torch.train.reduce"):
                if mesh is not None:
                    grads = [reduce_grad(g, p.placements)
                             for g, p in zip(grads, leaves.values())]
                    loss = _replicated(loss, mesh)
            with torch.no_grad(), span("repro_torch.train.update"):
                new_params, new_state = opt.update(dict(zip(leaves, grads)),
                                                   opt_state, params)
        return new_params, new_state, loss.detach()

    return model, opt, train_step


def _no_autograd(mesh):
    """``torch.inference_mode()``, or ``torch.no_grad()`` on a mesh: a
    DTensor's views under inference mode fail ("Cannot set
    version_counter for inference tensor")."""
    return torch.inference_mode() if mesh is None else torch.no_grad()


def distribute_model(model, mesh, strategy: str = "tp_fsdp"):
    """Each of ``model``'s weights (the same on every rank) replaced by a
    DTensor parameter of ``mesh`` under ``strategy``'s placements, each
    rank keeping its shard; returns the model."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    params = {n: p.detach() for n, p in model.named_parameters()}
    placements = step_placements("prefill", mesh, strategy,
                                 params=params)["in"][0]
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            distribute_tensor(t, mesh, placements[name], src_data_rank=None),
            requires_grad=False))
    return model


def make_prefill_step(cfg: ModelConfig, shape_name: str, device=None,
                      mesh=None, strategy: str = "tp_fsdp",
                      unroll: bool = False):
    """Returns (model, prefill_step) on the kernel route, under
    ``torch.inference_mode()`` (``torch.no_grad()`` on a mesh), on the
    model's weights (fill them with
    ``init`` or ``load_state_dict``). A decoder-only model's
    ``prefill_step(tokens, cache_len=None, frontend_embeds=None)`` gives
    ``(last-position logits, cache)`` of ``tokens`` [B, S] (after a vlm's
    ``frontend_embeds`` [B, N, d]), the cache ``cache_len`` long (default:
    the shape's ``seq``, as the reference's; a sliding window's ring
    buffer holds at most its window; a hybrid's cache is (KVCache,
    MambaState)). An encoder-decoder's
    ``prefill_step(frames)`` encodes ``frames`` [B, Se, d] and returns
    the decoder's cross-attention (k, v) of them (``precompute_enc_kv``).
    On a ``mesh`` the model's weights are DTensors (``distribute_model``
    places them) and so are the tokens, a vlm's ``frontend_embeds`` and
    an encoder-decoder's ``frames`` (``batch_specs``); the logits come
    out replicated and the cache as ``cache_specs`` places it (the
    strategy's ``seq_over_model``, default on); an encoder-decoder's
    (k, v) as its decode step takes them (``cache_specs`` over the batch
    only)."""
    model = build_model(cfg, device=device, unroll=unroll)
    if cfg.encoder_layers > 0:
        def encode_step(frames):
            with _no_autograd(mesh), use_mesh(mesh):
                enc_kv = model.precompute_enc_kv(model.encode(frames))
                if mesh is not None:
                    enc_kv = _place(enc_kv, step_placements(
                        "prefill", mesh, strategy, frames=frames,
                        enc_kv=enc_kv)["out"], mesh)
            return enc_kv

        return model, encode_step

    default_len = shape_spec(shape_name)["seq"]

    def prefill_step(tokens, cache_len=None, frontend_embeds=None):
        with _no_autograd(mesh), use_mesh(mesh):
            logits, cache = model.prefill(tokens, cache_len or default_len,
                                          frontend_embeds=frontend_embeds)
            if mesh is not None:
                logits = _replicated(logits, mesh)
                cache = place_cache(cache, mesh, strategy)
        return logits, cache

    return model, prefill_step


def place_cache(cache, mesh, strategy: str = "tp_fsdp"):
    """A decode cache (a named tuple of tensors, or a tuple of them)
    redistributed as ``cache_specs`` places it on ``mesh`` under
    ``strategy`` (its sequence over ``model`` unless the strategy says
    otherwise, as the reference's dry run's decode)."""
    return _place(cache, step_placements("decode", mesh, strategy,
                                         cache=cache)["in"][1], mesh)


def _place(tree, placements, mesh):
    """Each tensor of ``tree`` (tuples, named tuples too) redistributed to
    its placements on ``mesh``; a plain tensor counts as replicated."""
    if isinstance(tree, tuple):
        parts = [_place(t, p, mesh) for t, p in zip(tree, placements)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return as_dtensor(tree, mesh).redistribute(mesh, placements)


def make_decode_step(cfg: ModelConfig, shape_name: str, device=None,
                     mesh=None, unroll: bool = False):
    """Returns (model, decode_step(cache, tokens)) on the kernel route, for
    ``shape_for_long_context(cfg)`` (full attention becomes a sliding
    window of 8192, as the reference's long-context decode does; a cache
    shorter than the window decodes as full attention). One token [B, 1]
    against ``cache``, which is updated in place; returns (logits
    [B, 1, V], cache), under ``torch.inference_mode()`` (``no_grad`` on a
    mesh). An
    encoder-decoder's step is ``decode_step(cache, tokens, enc_kv)``, with
    the cross attention's (k, v) of ``make_prefill_step``. On a ``mesh``
    the weights, the cache (:func:`place_cache`), the tokens and an
    encoder-decoder's (k, v) are DTensors; the logits come out
    replicated, the cache on its own placements."""
    model = build_model(shape_for_long_context(cfg), device=device,
                        unroll=unroll)

    def decode_step(cache, tokens, *enc_kv):
        with _no_autograd(mesh), use_mesh(mesh):
            logits, cache = model.decode_step(cache, tokens, *enc_kv)
            if mesh is not None:
                logits = _replicated(logits, mesh)
        return logits, cache

    return model, decode_step
