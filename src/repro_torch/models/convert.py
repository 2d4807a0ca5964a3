"""Carry a reference model's configuration and weights into the port.

No function here imports jax: the reference's dtypes are mapped by name
(``np.dtype(x).name``), and its parameter tree comes in as NumPy arrays
(``jax.device_get`` of ``DecoderLM.init``'s or ``EncDecLM.init``'s
output, or any tree of the same layout). A bfloat16 array (the ``ml_dtypes`` type NumPy holds it
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
    A read-only array (as ``np.asarray`` of a jax array is) or one not in C
    order is copied; a 0-d array stays 0-d (``np.ascontiguousarray`` would
    give it a dim)."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else to_tensor(np.asarray(a))


# the reference's stacked layer groups ([L, ...] leaves): DecoderLM's
# blocks, EncDecLM's encoder and decoder blocks
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def layer_counts(names) -> dict:
    """``{group: layers}`` of the stacked groups among the port's parameter
    names (``blocks.{i}.…``, ``enc_blocks.{i}.…``, ``dec_blocks.{i}.…``)."""
    out = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head in STACKED:
            i = int(rest.partition(".")[0])
            out[head] = max(out.get(head, 0), i + 1)
    return out


def from_reference_layout(tree, n_layers: dict, take) -> dict:
    """``{port name: take(leaf, i)}`` for the leaves of a tree in the
    reference's ``DecoderLM`` or ``EncDecLM`` layout: ``take(leaf, None)``
    for each unstacked leaf (``embed``, ``final_norm``, ``lm_head``,
    ``enc_norm``), and ``take(leaf, i)`` for layer ``i`` < ``n_layers[g]``
    of each leaf of a stacked group ``g`` (``{g}.{i}.{key}`` or
    ``{g}.{i}.{group}.{name}``). A leaf may be anything, a tuple too."""
    out = {n: take(a, None) for n, a in tree.items() if n not in STACKED}
    for stack, L in n_layers.items():
        for i in range(L):
            for key, val in tree[stack].items():
                group = val.items() if isinstance(val, dict) else [(None, val)]
                for name, a in group:
                    out[".".join(filter(None, (stack, str(i), key, name)))] = (
                        take(a, i))
    return out


def params_from_reference(tree) -> dict:
    """The port's ``DecoderLM`` or ``EncDecLM`` state dict from the
    reference's ``init`` tree (NumPy arrays, or tensors as
    :func:`params_to_reference` gives them): ``embed``, stacked ``blocks``
    [L, ...], ``final_norm`` and (untied) ``lm_head``; or ``embed``,
    ``enc_blocks``, ``enc_norm``, ``dec_blocks``, ``final_norm`` and
    ``lm_head``. Each block carries ``ln1`` and ``ln2`` and its groups as
    they are, each array in its own dtype: ``attn.{wq,wk,wv,wo}`` and
    ``ffn.{w1,w3,w2}`` (dense, vlm, an encoder block), with
    ``xattn.{wq,wk,wv,wo}`` and ``ln_x`` (a decoder block of an
    encoder-decoder), or ``moe.{router,w1,w3,w2}`` and, with shared
    experts, ``moe.{shared_w1,shared_w3,shared_w2}`` (moe; the router stays
    float32), or ``tm.{mu, shift_lora_a, shift_lora_b, wr, wk, wv, wg, wo,
    w0, w_lora_a, w_lora_b, u, ln_out}`` and ``cm.{mu_k, wk, wv}`` (ssm);
    a hybrid block adds ``mamba.{in_proj, conv, w_bc, w_dt, dt_bias, logA,
    D, out_proj}`` to the dense groups (``logA`` stays float32 in a bf16
    model, as the reference builds it)."""
    def take(a, i):
        if isinstance(a, torch.Tensor):
            return a if i is None else a[i]
        return to_tensor(np.asarray(a) if i is None else np.asarray(a)[i])
    n_layers = {g: np.shape(tree[g]["ln1"])[0] for g in STACKED if g in tree}
    return from_reference_layout(tree, n_layers, take)


def params_to_reference(sd: dict) -> dict:
    """The inverse of :func:`params_from_reference`: the reference's tree
    of ``DecoderLM`` or ``EncDecLM`` parameters from a dict of the port's
    names (a state dict, or the dicts of an optimizer state), each
    layer's ``{group}.{i}.…`` tensors stacked into one ``[L, ...]`` tensor
    on their device (``blocks.attn.wq`` [L, d, H, dh], ``moe.w1``
    [L, E, d, f], ``dec_blocks.xattn.wq``, …)."""
    tree, layers = {}, {}
    for name, t in sd.items():
        head, _, rest = name.partition(".")
        if head not in STACKED:
            tree[name] = t
            continue
        i, _, leaf = rest.partition(".")
        layers.setdefault(head, {}).setdefault(leaf, {})[int(i)] = t
    for stack, per_leaf in layers.items():
        blocks = tree[stack] = {}
        for leaf, per in per_leaf.items():
            group, _, name = leaf.rpartition(".")
            node = blocks.setdefault(group, {}) if group else blocks
            node[name] = torch.stack([per[i] for i in range(len(per))])
    return tree


def opt_state_to_reference(state: dict) -> dict:
    """An optimizer state of :mod:`repro_torch.optim` (``{"step", "m",
    "v"}`` for adam/adamw, ``{"step", "mu"}`` for momentum SGD, each
    moment a dict of the port's names) in the reference's layout: each
    moment as :func:`params_to_reference` stacks it, ``step`` as it is."""
    return {k: params_to_reference(v) if isinstance(v, dict) else v
            for k, v in state.items()}


def opt_state_from_reference(tree: dict) -> dict:
    """The inverse of :func:`opt_state_to_reference`: the reference's
    optimizer state (NumPy arrays or tensors) with each moment as a dict of
    the port's names and ``step`` as a tensor."""
    return {k: params_from_reference(v) if isinstance(v, dict)
            else _as_tensor(v) for k, v in tree.items()}


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
