"""The one generator of every traffic mix: a mix is a data file of
parameters (``gpubench/traffic/<name>.json``) and this reads it.

Two kinds of mix, by the file's ``driver``:

* ``prefill``: batches of prompts, each batch ``[B, S]`` from the file's
  ``shapes``. Every cycle holds each shape once, in one order shuffled by
  the seed and repeated. Token ids are uniform over the vocabulary. The
  first ``pool_batches`` batches are made in set-up, on the device, from
  a generator seeded by the run's seed; batch ``i`` of the window is
  ``i % pool_batches`` of them.
* ``train``: a pool of ``pool_batches`` batches ``[batch, seq]`` of a
  bigram stream (the rule of ``repro_torch.launch.train.
  synthetic_lm_batch``: next = (3 * token + noise) % vocab, noise uniform
  on 0..6, the first token uniform), cycled; the labels are the stream
  shifted by one.

The same seed gives the same inputs in the same order.
"""
from __future__ import annotations

import numpy as np
import torch


def _gen(seed: int, part: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(
        (int(seed) * 2_654_435_761 + part * 40_503 + 5) % (2 ** 63))


def shape_order(traffic: dict, seed: int) -> list:
    """The shapes of one cycle, in the seed's order."""
    shapes = [tuple(s) for s in traffic["shapes"]]
    perm = np.random.default_rng([int(seed) % (2 ** 63), 1]).permutation(
        len(shapes))
    return [shapes[i] for i in perm]


def prefill_pool(traffic: dict, vocab: int, seed: int, device) -> list:
    """``pool_batches`` token batches [B, S] int64, in window order."""
    order = shape_order(traffic, seed)
    gen = _gen(seed, 2, device)
    return [torch.randint(0, vocab, order[i % len(order)], generator=gen,
                          device=device)
            for i in range(traffic["pool_batches"])]


def bigram(x0: torch.Tensor, noise: torch.Tensor, vocab: int) -> torch.Tensor:
    """The stream [B, S + 1] of first tokens ``x0`` [B] and ``noise``
    [B, S]: x[t + 1] = (3 x[t] + noise[t]) % vocab, as a scan of affine maps
    (x -> a x + c mod vocab) composed in log2(S) steps."""
    B, S = noise.shape
    a = torch.full_like(noise, 3)
    c = noise.clone()
    off = 1
    while off < S:
        # map t after map t - off: (a_t, c_t) . (a_s, c_s)
        a_new, c_new = a.clone(), c.clone()
        a_new[:, off:] = (a[:, off:] * a[:, :-off]) % vocab
        c_new[:, off:] = (a[:, off:] * c[:, :-off] + c[:, off:]) % vocab
        a, c = a_new, c_new
        off *= 2
    rest = (a * x0[:, None] + c) % vocab
    return torch.cat([x0[:, None], rest], dim=1)


def train_pool(traffic: dict, vocab: int, seed: int, device) -> list:
    """``pool_batches`` batches {"tokens", "labels"} [batch, seq] int32."""
    gen = _gen(seed, 3, device)
    B, S = traffic["batch"], traffic["seq"]
    out = []
    for _ in range(traffic["pool_batches"]):
        x0 = torch.randint(0, vocab, (B,), generator=gen, device=device)
        noise = torch.randint(0, 7, (B, S), generator=gen, device=device)
        toks = bigram(x0, noise, vocab).to(torch.int32)
        out.append({"tokens": toks[:, :-1].contiguous(),
                    "labels": toks[:, 1:].contiguous()})
    return out
