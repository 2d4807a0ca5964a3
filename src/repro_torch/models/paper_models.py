"""The models from FedZero's own evaluation (Section 5.1), in PyTorch.

* ``LSTMModel``  — 2-layer LSTM, 100 hidden units, 8-d embedding, next-char
  prediction (Shakespeare; footnote 7 of the paper / FedProx setup).
* ``KWTModel``   — Keyword Transformer KWT-1 (Berg et al. 2021): 12 layers,
  d=64, 1 head, MLP 256, on precomputed MFCC patch embeddings.
* ``ConvNet``    — small densely-connected conv classifier standing in for
  DenseNet-121 / EfficientNet-B1 (the paper's image workloads), used with
  the synthetic image task in the FL simulation.

Copies of the reference's ``repro/models/paper_models.py`` as
``nn.Module``\\ s. Each holds its weights in the reference's shapes and
names (ConvNet ``convs.{i}.w`` [3, 3, Cin, Cout] HWIO, KWT ``blocks.*``
stacked [L, ...], LSTM ``cells.{i}.{wx,wh,b}``), so a reference tree
carries across as a plain copy
(:func:`repro_torch.models.convert.paper_params_from_reference`). The
weights are allocated on ``device`` (``None``: ``cuda:0``, which raises
without CUDA) and filled by :meth:`init` from a ``torch.Generator`` with
the reference's init laws. ``logits_fn(batch)`` and ``loss(batch)`` take
the reference's batch dicts of tensors on the model's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import cross_entropy_loss, dense_init, embed_init, rmsnorm

F32 = torch.float32


def _empty(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=F32, device=device))


# ---------------------------------------------------------------------------
# LSTM (Shakespeare)


class LSTMModel(nn.Module):
    """The cell is the reference's, not ``nn.LSTM``'s: gates split i, f,
    g, o from one ``x @ wx + h @ wh + b`` (a single bias), and the forget
    gate is ``sigmoid(f + 1)``. It steps token by token, as the reference's
    ``lax.scan``; the input products of all tokens are one matmul."""

    def __init__(self, vocab=90, embed=8, hidden=100, layers=2, device=None):
        super().__init__()
        device = resolve_device(device)
        self.vocab, self.d_embed, self.hidden = vocab, embed, hidden
        self.layers = layers
        self.embed = _empty((vocab, embed), device)
        self.head = _empty((hidden, vocab), device)
        d_in, cells = embed, []
        for _ in range(layers):
            cells.append(nn.ParameterDict({
                "wx": _empty((d_in, 4 * hidden), device),
                "wh": _empty((hidden, 4 * hidden), device),
                "b": _empty((4 * hidden,), device)}))
            d_in = hidden
        self.cells = nn.ModuleList(cells)

    @torch.no_grad()
    def init(self, gen: torch.Generator):
        self.embed.copy_(embed_init(gen, self.vocab, self.d_embed, F32))
        self.head.copy_(dense_init(gen, self.hidden,
                                   (self.hidden, self.vocab), F32))
        for cell in self.cells:
            d_in = cell["wx"].shape[0]
            cell["wx"].copy_(dense_init(gen, d_in, cell["wx"].shape, F32))
            cell["wh"].copy_(dense_init(gen, self.hidden, cell["wh"].shape,
                                        F32))
            cell["b"].zero_()
        return self

    @staticmethod
    def _lstm_layer(cell, x):
        B, S, _ = x.shape
        H = cell["wh"].shape[0]
        xw = x @ cell["wx"]
        h = x.new_zeros((B, H))
        c = x.new_zeros((B, H))
        hs = []
        for t in range(S):
            gates = xw[:, t] + h @ cell["wh"] + cell["b"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    def logits_fn(self, batch):
        x = self.embed[batch["tokens"]]
        for cell in self.cells:
            x = self._lstm_layer(cell, x)
        return x @ self.head

    def loss(self, batch):
        return cross_entropy_loss(self.logits_fn(batch), batch["labels"],
                                  batch.get("mask"))


# ---------------------------------------------------------------------------
# KWT-1 (Google Speech) — tiny ViT over MFCC patches


class KWTModel(nn.Module):
    """Pre-norm blocks with the port's ``rmsnorm`` (the reference's norm),
    scores divided by ``sqrt(dh)``, and the tanh GELU (``jax.nn.gelu``'s
    default)."""

    def __init__(self, n_classes=35, d=64, layers=12, heads=1, mlp=256,
                 n_patches=98, device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_classes, self.d, self.layers = n_classes, d, layers
        self.heads, self.mlp, self.n_patches = heads, mlp, n_patches
        L, m = layers, mlp
        self.patch_proj = _empty((40, d), device)
        self.pos = _empty((n_patches + 1, d), device)
        self.cls = _empty((d,), device)
        self.blocks = nn.ParameterDict({
            "ln1": _empty((L, d), device), "ln2": _empty((L, d), device),
            "wqkv": _empty((L, d, 3 * d), device),
            "wo": _empty((L, d, d), device),
            "w1": _empty((L, d, m), device),
            "w2": _empty((L, m, d), device)})
        self.head = _empty((d, n_classes), device)

    @torch.no_grad()
    def init(self, gen: torch.Generator):
        d, m = self.d, self.mlp
        self.patch_proj.copy_(dense_init(gen, 40, (40, d), F32))
        self.pos.copy_(0.02 * torch.randn(self.pos.shape, generator=gen,
                                          device=gen.device))
        self.cls.zero_()
        blk = self.blocks
        blk["ln1"].fill_(1.0)
        blk["ln2"].fill_(1.0)
        for name, fan_in in (("wqkv", d), ("wo", d), ("w1", d), ("w2", m)):
            blk[name].copy_(dense_init(gen, fan_in, blk[name].shape, F32))
        self.head.copy_(dense_init(gen, d, (d, self.n_classes), F32))
        return self

    def logits_fn(self, batch):
        """batch["mfcc"]: [B, n_patches, 40]."""
        x = batch["mfcc"] @ self.patch_proj
        B = x.shape[0]
        cls = self.cls.expand(B, 1, self.d)
        x = torch.cat([cls, x], dim=1) + self.pos[None]
        H, dh = self.heads, self.d // self.heads
        for layer in range(self.layers):
            p = {k: v[layer] for k, v in self.blocks.items()}
            hn = rmsnorm(x, p["ln1"])
            q, k, v = (hn @ p["wqkv"]).chunk(3, dim=-1)
            S = q.shape[1]
            q = q.reshape(B, S, H, dh)
            k = k.reshape(B, S, H, dh)
            v = v.reshape(B, S, H, dh)
            s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(dh)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhst,bthd->bshd", a, v).reshape(B, S, self.d)
            x = x + o @ p["wo"]
            hn = rmsnorm(x, p["ln2"])
            x = x + F.gelu(hn @ p["w1"], approximate="tanh") @ p["w2"]
        return x[:, 0] @ self.head

    def loss(self, batch):
        return cross_entropy_loss(self.logits_fn(batch), batch["labels"])


# ---------------------------------------------------------------------------
# Small conv classifier (CIFAR-style stand-in for DenseNet/EfficientNet)


class ConvNet(nn.Module):
    """The reference is NHWC with HWIO weights; here each conv runs on an
    NCHW view with the weight permuted to OIHW, and the head's rows stay
    in NHWC flatten order."""

    def __init__(self, n_classes=100, channels=(32, 64, 128), in_ch=3, hw=32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_classes, self.channels, self.in_ch, self.hw = (
            n_classes, channels, in_ch, hw)
        convs, c_in = [], in_ch
        for c_out in channels:
            convs.append(nn.ParameterDict({
                "w": _empty((3, 3, c_in, c_out), device),
                "b": _empty((c_out,), device),
                "scale": _empty((c_out,), device)}))
            c_in = c_out + c_in  # dense connectivity: concat input
        self.convs = nn.ModuleList(convs)
        final_hw = hw // (2 ** len(channels))
        self.d_feat = c_in * final_hw * final_hw
        self.head = _empty((self.d_feat, n_classes), device)

    @torch.no_grad()
    def init(self, gen: torch.Generator):
        for conv in self.convs:
            w = conv["w"]
            w.copy_(dense_init(gen, 9 * w.shape[2], w.shape, F32))
            conv["b"].zero_()
            conv["scale"].fill_(1.0)
        self.head.copy_(dense_init(gen, self.d_feat,
                                   (self.d_feat, self.n_classes), F32))
        return self

    def logits_fn(self, batch):
        x = batch["image"].permute(0, 3, 1, 2)  # NHWC -> NCHW view
        for conv in self.convs:
            # "SAME" for a 3x3 stride-1 window: one row and column a side
            y = F.conv2d(x, conv["w"].permute(3, 2, 0, 1), padding=1)
            y = F.relu(y * conv["scale"][:, None, None]
                       + conv["b"][:, None, None])
            x = torch.cat([x, y], dim=1)  # dense block
            x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return x @ self.head

    def loss(self, batch):
        return cross_entropy_loss(self.logits_fn(batch), batch["labels"])
