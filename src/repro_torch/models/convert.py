"""Carry a reference model's configuration and weights into the port.

No function here imports jax: the reference's dtypes are mapped by name
(``np.dtype(x).name``), and its parameter tree comes in as NumPy arrays
(``jax.device_get`` of ``DecoderLM.init``'s output, or any tree of the
same layout). A bfloat16 array (the ``ml_dtypes`` type NumPy holds it
in) crosses by its 16-bit pattern, so every bit is kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import ModelConfig

_DTYPE_FIELDS = ("dtype", "param_dtype", "cache_dtype")


def torch_dtype(x) -> torch.dtype:
    """The torch dtype of the same name as NumPy/jnp dtype ``x``."""
    return getattr(torch, np.dtype(x).name)


def model_config_from_reference(ref_cfg) -> ModelConfig:
    """The port's ``ModelConfig`` with every field of ``ref_cfg`` (a
    reference ``repro.models.ModelConfig``), dtypes mapped by name: the
    MoE fields (``n_experts``, ``top_k``, ``moe_d_ff``,
    ``n_shared_experts``, ``capacity_factor``, ``moe_dispatch``) too."""
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    for name in _DTYPE_FIELDS:
        if kw[name] is not None:
            kw[name] = torch_dtype(kw[name])
    return ModelConfig(**kw)


def to_tensor(a) -> torch.Tensor:
    """A NumPy array as a tensor with the same bits (bfloat16 included).
    A read-only array (as ``np.asarray`` of a jax array is) is copied."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree) -> dict:
    """The port's ``DecoderLM`` state dict from the reference's
    ``DecoderLM.init`` tree: ``embed``, stacked ``blocks`` [L, ...],
    ``final_norm`` and (untied) ``lm_head``. Each block carries ``ln1`` and
    ``ln2`` and its groups as they are, each array in its own dtype:
    ``attn.{wq,wk,wv,wo}`` and ``ffn.{w1,w3,w2}`` (dense) or
    ``moe.{router,w1,w3,w2}`` and, with shared experts,
    ``moe.{shared_w1,shared_w3,shared_w2}`` (moe; the router stays
    float32), or ``tm.{mu, shift_lora_a, shift_lora_b, wr, wk, wv, wg, wo,
    w0, w_lora_a, w_lora_b, u, ln_out}`` and ``cm.{mu_k, wk, wv}`` (ssm)."""
    sd = {"embed": to_tensor(tree["embed"]),
          "final_norm": to_tensor(tree["final_norm"])}
    if "lm_head" in tree:
        sd["lm_head"] = to_tensor(tree["lm_head"])
    blocks = tree["blocks"]
    L = np.asarray(blocks["ln1"]).shape[0]
    for i in range(L):
        for key, val in blocks.items():
            if isinstance(val, dict):  # a group of the block
                for name, a in val.items():
                    sd[f"blocks.{i}.{key}.{name}"] = to_tensor(
                        np.asarray(a)[i])
            else:
                sd[f"blocks.{i}.{key}"] = to_tensor(np.asarray(val)[i])
    return sd


def _flatten(tree, prefix=""):
    """``(dotted name, array)`` for every leaf of a tree of dicts and
    lists: ``{"cells": [{"wx": a}]}`` gives ``("cells.0.wx", a)``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}{key}.")


def paper_params_from_reference(model, tree) -> dict:
    """The state dict of ``model`` (a port ``LSTMModel``, ``KWTModel`` or
    ``ConvNet``) from the reference model's ``init`` tree: the same names
    (list indices and dict keys joined by dots) and shapes, each array as a
    CPU tensor with its bits (``model.load_state_dict`` copies it to the
    model's device). A name or shape that ``model`` does not have raises
    ``ValueError``."""
    sd = {name: to_tensor(np.asarray(a)) for name, a in _flatten(tree)}
    want = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    got = {n: tuple(t.shape) for n, t in sd.items()}
    if got != want:
        raise ValueError(f"the reference tree does not fit "
                         f"{type(model).__name__}: {sorted(got.items())} "
                         f"against {sorted(want.items())}")
    return sd
