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
"""
from __future__ import annotations

import torch

from repro_torch.models import (SHAPES, ModelConfig, build_model,
                                shape_for_long_context)
from repro_torch.optim import adamw, sgd

# parameter-count threshold above which training uses SGD-momentum with
# bf16 state instead of AdamW fp32 state (memory fit for the giant MoEs)
BIG_MODEL_PARAMS = 30e9


def default_optimizer(cfg: ModelConfig):
    if cfg.param_count() > BIG_MODEL_PARAMS:
        return sgd(3e-4, momentum=0.9, state_dtype=torch.bfloat16)
    return adamw(3e-4, weight_decay=0.1)


def make_train_step(cfg: ModelConfig, optimizer=None, remat: bool = True,
                    device=None):
    """Returns (model, opt, train_step(params, opt_state, batch)).

    ``params`` is a dict of the model's parameter names to tensors,
    ``opt_state`` the optimizer's state over them and ``batch`` a dict of
    tensors (``tokens``, ``labels``, optionally ``mask``, and a vlm's or an
    encoder-decoder's ``frontend_embeds``); ``train_step``
    returns the new parameters, the new state and the loss before the
    update, as the reference's does. The loss is the model's at ``params``
    (``torch.func.functional_call``; the model's own weights are not
    read), its gradients come from ``torch.autograd.grad`` and the update
    runs under ``torch.no_grad()``."""
    model = build_model(cfg, use_kernels=False, device=device, remat=remat)
    opt = optimizer or default_optimizer(cfg)

    def train_step(params, opt_state, batch):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = torch.func.functional_call(model, leaves, (batch,))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            new_params, new_state = opt.update(dict(zip(leaves, grads)),
                                               opt_state, params)
        return new_params, new_state, loss.detach()

    return model, opt, train_step


def make_prefill_step(cfg: ModelConfig, shape_name: str, device=None):
    """Returns (model, prefill_step) on the kernel route, under
    ``torch.inference_mode()``, on the model's weights (fill them with
    ``init`` or ``load_state_dict``). A decoder-only model's
    ``prefill_step(tokens, cache_len=None, frontend_embeds=None)`` gives
    ``(last-position logits, cache)`` of ``tokens`` [B, S] (after a vlm's
    ``frontend_embeds`` [B, N, d]), the cache ``cache_len`` long (default:
    the shape's ``seq``, as the reference's; a sliding window's ring
    buffer holds at most its window; a hybrid's cache is (KVCache,
    MambaState)). An encoder-decoder's
    ``prefill_step(frames)`` encodes ``frames`` [B, Se, d] and returns
    the decoder's cross-attention (k, v) of them (``precompute_enc_kv``)."""
    model = build_model(cfg, device=device)
    if cfg.encoder_layers > 0:
        @torch.inference_mode()
        def encode_step(frames):
            return model.precompute_enc_kv(model.encode(frames))

        return model, encode_step

    default_len = SHAPES[shape_name]["seq"]

    @torch.inference_mode()
    def prefill_step(tokens, cache_len=None, frontend_embeds=None):
        return model.prefill(tokens, cache_len or default_len,
                             frontend_embeds=frontend_embeds)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, shape_name: str, device=None):
    """Returns (model, decode_step(cache, tokens)) on the kernel route, for
    ``shape_for_long_context(cfg)`` (full attention becomes a sliding
    window of 8192, as the reference's long-context decode does; a cache
    shorter than the window decodes as full attention). One token [B, 1]
    against ``cache``, which is updated in place; returns (logits
    [B, 1, V], cache), under ``torch.inference_mode()``. An
    encoder-decoder's step is ``decode_step(cache, tokens, enc_kv)``, with
    the cross attention's (k, v) of ``make_prefill_step``."""
    model = build_model(shape_for_long_context(cfg), device=device)
    if cfg.encoder_layers > 0:
        @torch.inference_mode()
        def encdec_decode_step(cache, tokens, enc_kv):
            return model.decode_step(cache, tokens, enc_kv)

        return model, encdec_decode_step

    @torch.inference_mode()
    def decode_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return model, decode_step
