"""Batched **LLM inference** demo on PyTorch: prefill, then greedy decode.

This serves *language models*, not scheduling decisions. The port of
``repro.launch.inference_demo`` with the same flags and printed lines,
plus ``--device`` (default ``cuda``; it raises without a CUDA device,
so the CPU runs only when asked for):

    PYTHONPATH=src python -m repro_torch.launch.inference_demo \\
        --arch llama3.2-3b --batch 4 --prompt-len 2048 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.inference_demo \\
        --arch rwkv6-1.6b --batch 4 --prompt-len 2048 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.inference_demo \\
        --arch smollm-360m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.inference_demo \\
        --arch mixtral-8x22b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.inference_demo \\
        --arch llava-next-34b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.inference_demo \\
        --arch hymba-1.5b --batch 4 --prompt-len 2048 --gen 16

The weights are initialised on the device from
``torch.Generator(device).manual_seed(seed)``, the prompts from
``np.random.default_rng(seed)`` and, for a vlm, the random frontend
embeddings (the stubbed vision tower's patches) from the same generator
after them, as the reference's demo draws them. As there, the cache is
``prompt_len + gen`` long, which a vlm's prefill (N frontend positions
and the prompt) overfills: its decode steps then overwrite the oldest
slots. An encoder-decoder arch exits, as the reference's demo does. The
model runs on the hand-written
kernels: prefill attention through K3 (dense, vlm, moe and hybrid archs;
hymba-1.5b's within its window of 1024, whose ring buffer a prompt longer
than the window wraps), the RWKV6 scan through K4 (rwkv6-1.6b, whose
prefill ignores the cache length, as the reference's does), and the
expert products of the moe archs through K5 in prefill and decode; the
rest, hymba's Mamba branch and decode among it, is plain torch ops, as in
the reference. Full-width mixtral-8x22b (281 GB) does not fit one card;
a caller that cuts its depth passes the cut config to :func:`load_model`.
Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, build_model


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_model(arch, reduced: bool, seed: int, device: torch.device,
               use_kernels: bool = True):
    """(cfg, model) with the weights made on ``device`` from ``seed``.
    ``arch`` is an arch id of the registry or a ``ModelConfig`` (then
    ``reduced`` is not read)."""
    cfg = (arch if isinstance(arch, ModelConfig)
           else get_config(arch, reduced=reduced))
    model = build_model(cfg, use_kernels=use_kernels, device=device)
    model.init(torch.Generator(device).manual_seed(seed))
    return cfg, model


def make_prompts(cfg, batch: int, prompt_len: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    return make_inputs(cfg, batch, prompt_len, seed, device)[0]


def make_inputs(cfg, batch: int, prompt_len: int, seed: int,
                device: torch.device):
    """(prompts [B, P] int64, frontend_embeds [B, N, d] in ``cfg.dtype``
    or None): the prompts from ``np.random.default_rng(seed)``, then, for
    a vlm, N(0, 0.02) embeddings from the same generator."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
    fe = None
    if cfg.n_frontend_embeds:
        fe = torch.as_tensor(rng.normal(
            0, 0.02, (batch, cfg.n_frontend_embeds, cfg.d_model)),
            device=device).to(cfg.dtype)
    return torch.as_tensor(prompts, dtype=torch.int64, device=device), fe


def greedy_decode(model, logits, cache, gen: int):
    """``gen`` greedy tokens: the first from the prefill's ``logits``, then
    ``gen - 1`` decode steps. Returns ([B, gen] int64 tokens, cache)."""
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    generated = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        generated.append(tok)
    return torch.cat(generated, dim=1), cache


def generate(model, prompts: torch.Tensor, gen: int, frontend_embeds=None,
             cache_len=None) -> dict:
    """Prefill (after a vlm's ``frontend_embeds``) then greedy decode,
    timed apart on the host clock (each part ends in a device
    synchronise). The cache is ``cache_len`` long, by default
    ``prompt_len + gen`` as in the reference's demo. Returns the tokens
    and the times."""
    device = prompts.device
    if cache_len is None:
        cache_len = prompts.shape[1] + gen
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, cache_len,
                                  frontend_embeds=frontend_embeds)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens, cache = greedy_decode(model, logits, cache, gen)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": decode_s,
            "logits": logits}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device,
                            "pass --device cpu to run on the CPU")
    if get_config(args.arch, reduced=args.reduced).encoder_layers > 0:
        raise SystemExit("use a decoder-only arch for this demo")
    with torch.inference_mode():
        cfg, model = load_model(args.arch, args.reduced, args.seed, device)
        prompts, fe = make_inputs(cfg, args.batch, args.prompt_len,
                                  args.seed, device)
        out = generate(model, prompts, args.gen, frontend_embeds=fe)
    print(f"prefill {args.batch}×{args.prompt_len} in {out['prefill_s']:.2f}s")
    dt = out["decode_s"]
    print(f"decoded {args.gen-1} steps × {args.batch} seqs in {dt:.2f}s "
          f"({(args.gen-1)*args.batch/max(dt,1e-9):.1f} tok/s)")
    print("sample:", out["tokens"][0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
