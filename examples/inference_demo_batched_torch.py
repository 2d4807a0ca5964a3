"""Batched **LLM inference** demo on the PyTorch/CUDA port (prefill +
greedy decode) through the step factories of ``repro_torch.launch.steps``:
``make_prefill_step`` (prefill attention on K3, the rwkv6 scan on K4, the
expert products on K5; a vlm's random frontend embeddings before the
prompt; an encoder-decoder's P random frames encoded, its encoder on K3,
and the cross attention's K/V) and ``make_decode_step`` (its
long-context config: a cache shorter than the window decodes as full
attention; an encoder-decoder decodes from token 0 against the encoded
frames). The port of ``examples/inference_demo_batched.py``, on the
reduced configs as there.
This is a *model-serving* example, not the FedZero scheduler service
(``examples/serve_scheduler.py``).

Run from a checkout:

    PYTHONPATH=src python examples/inference_demo_batched_torch.py \\
        --arch rwkv6-1.6b                                       # GPU
    python examples/inference_demo_batched_torch.py --arch mixtral-8x22b \\
        --device cpu
    python examples/inference_demo_batched_torch.py \\
        --arch seamless-m4t-large-v2 --device cpu

Runs on ``cuda:0`` unless ``--device`` names another device; without a
CUDA device and without ``--device cpu`` it raises.
"""
import argparse
import os
import sys
import time

try:
    import repro_torch  # noqa: F401
except ImportError:  # run from a checkout without PYTHONPATH=src
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import all_archs, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=all_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch, reduced=True)
    model, prefill = make_prefill_step(cfg, "prefill_32k", device=device)
    model.init(torch.Generator(device).manual_seed(0))
    dec_model, decode = make_decode_step(cfg, "decode_32k", device=device)
    dec_model.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    B, P = args.batch, args.prompt_len
    cache_len = P + args.gen

    if cfg.encoder_layers:  # audio enc-dec: decode conditioned on frames
        frames = torch.as_tensor(rng.normal(0, 0.1, (B, P, cfg.d_model)),
                                 dtype=torch.float32, device=device)
        enc_kv = prefill(frames)
        cache = dec_model.init_cache(B, cache_len)
        tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
        _sync(device)
        t0 = time.time()
        outs = []
        for _ in range(args.gen):
            logits, cache = decode(cache, tok, enc_kv)
            tok = torch.argmax(logits[:, -1:], -1).reshape(B, 1)
            outs.append(tok)
    else:
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                                  device=device)
        fe = None
        if cfg.n_frontend_embeds:
            fe = torch.as_tensor(
                rng.normal(0, 0.02, (B, cfg.n_frontend_embeds, cfg.d_model)),
                dtype=torch.float32, device=device)
        _sync(device)
        t0 = time.time()
        logits, cache = prefill(prompts, cache_len, frontend_embeds=fe)
        _sync(device)
        print(f"prefill {B}×{P}: {time.time() - t0:.2f}s")
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        outs = [tok]
        t0 = time.time()
        for _ in range(args.gen - 1):
            logits, cache = decode(cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            outs.append(tok)
    _sync(device)
    dt = time.time() - t0
    gen = torch.cat(outs, dim=1).cpu().numpy()
    print(f"decoded {gen.shape[1]} tokens × {B} seqs in {dt:.2f}s "
          f"({gen.shape[1] * B / max(dt, 1e-9):.1f} tok/s, {device}, "
          f"reduced cfg)")
    for i in range(min(B, 2)):
        print(f"  seq{i}: {gen[i][:12]}")
    return gen


if __name__ == "__main__":
    main()
