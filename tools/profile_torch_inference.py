#!/usr/bin/env python3
"""Where the time goes in the port's LLM inference, on one GPU.

    python3 tools/profile_torch_inference.py [--arch llama3.2-3b]
        [--batch 4] [--prompt-len 2048] [--gen 16]
    python3 tools/profile_torch_inference.py --arch rwkv6-1.6b
    python3 tools/profile_torch_inference.py --arch mixtral-8x22b
    python3 tools/profile_torch_inference.py --arch llava-next-34b
    python3 tools/profile_torch_inference.py --arch seamless-m4t-large-v2 \\
        --prompt-len 4096
    python3 tools/profile_torch_inference.py --arch hymba-1.5b

Loads the model as the inference demo does (random weights from a seed,
on ``cuda:0``), at the depth chip_smoke.py runs it (``smoke_config``:
mixtral-8x22b 8 of its 56 layers, which is what one card holds,
llava-next-34b 8 of its 60; the others whole), warms up, then traces one
prefill and, apart, the greedy decode steps after it under
``torch.profiler`` (device activity only). A vlm's prefill takes its
random frontend embeddings (``make_inputs``) before the prompt, its cache
holding every position; an encoder-decoder's "prefill" is ``encode`` of
``--prompt-len`` random frames and ``precompute_enc_kv``, and its decode
steps start from token 0.
For each part: wall time, the device's busy time (the sum of kernel and
copy times), its idle share of the wall time, the time and share of the
busy time of each hand-written kernel (K3 ``flash_attention``, K4
``rwkv_scan``, K5 ``moe_gemm``), and the kernels that took the most
device time; and the peak device memory of the two. For a hybrid
(hymba-1.5b), the Mamba scan's loop (``models.ssm._selective_scan``)
apart: its host seconds in one more prefill, each call timed between two
device synchronisations, against that prefill's wall time; and the
kernels one call launches at the prefill's shape (a layer's), traced
alone. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


HAND_KERNELS = ("flash_attention", "rwkv_scan", "moe_gemm")


def mamba_scan_share(torch, prefill, cfg, batch, seq) -> dict:
    """The Mamba scan's loop in a prefill: host seconds of its calls (each
    between two synchronisations) against the wall time of the same
    prefill, and its device kernels a call, traced alone on random inputs
    of the prefill's shape."""
    from repro_torch.models import ssm
    scan, spent = ssm._selective_scan, []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = scan(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    ssm._selective_scan = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        ssm._selective_scan = scan
    dev, d, n = torch.device("cuda:0"), cfg.d_model, cfg.ssm_state
    gen = torch.Generator(dev).manual_seed(0)
    x, dt = (torch.rand((batch, seq, d), device=dev, generator=gen)
             for _ in range(2))
    Bm, Cm = (torch.randn((batch, seq, n), device=dev, generator=gen)
              for _ in range(2))
    A = -torch.rand((d, n), device=dev, generator=gen)
    h = torch.zeros((batch, d, n), device=dev)
    act = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as tp:
        t = time.perf_counter()
        scan(x, dt, Bm, Cm, A, h)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
    ev = [e for e in tp.key_averages()
          if getattr(e, "self_device_time_total", 0) > 0]
    launches = sum(e.count for e in ev)
    return {"calls": len(spent), "host_s": sum(spent),
            "prefill_wall_s": wall, "share_of_prefill": sum(spent) / wall,
            "one_call_s": one_s, "launches_per_call": launches,
            "launches_per_prefill": launches * len(spent),
            "device_ms_per_call": sum(e.self_device_time_total
                                      for e in ev) / 1e3,
            "top_device_per_call": [
                [e.key[:90], e.self_device_time_total / 1e3, e.count]
                for e in sorted(ev, key=lambda e: -e.self_device_time_total)
                [:4]]}


def device_summary(tp, wall_s: float, top: int = 12) -> dict:
    dev = [e for e in tp.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    hand = {}
    for name in HAND_KERNELS:
        us = sum(e.self_device_time_total for e in dev if name in e.key)
        hand[name] = {"ms": us / 1e3, "share_of_busy": us / max(busy_us, 1),
                      "calls": sum(e.count for e in dev if name in e.key)}
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": 1e3 * wall_s, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "hand_kernels": hand,
            "top_device": [[e.key[:90], e.self_device_time_total / 1e3,
                            e.count] for e in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import nvidia_smi, smoke_config
    from repro_torch.launch import inference_demo as demo

    dev = torch.device("cuda:0")
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        cfg, model = demo.load_model(smoke_config(args.arch), False, 0, dev)
        if cfg.encoder_layers:
            frames = torch.randn(
                (args.batch, args.prompt_len, cfg.d_model), device=dev,
                generator=torch.Generator(dev).manual_seed(0)).mul_(0.1)
            frames = frames.to(cfg.dtype)

            def prefill():
                return model.precompute_enc_kv(model.encode(frames)), None

            def decode(enc_kv, _):
                cache = model.init_cache(args.batch, args.gen)
                tok = torch.zeros((args.batch, 1), dtype=torch.int64,
                                  device=dev)
                for _ in range(args.gen - 1):
                    out, cache = model.decode_step(cache, tok, enc_kv)
                    tok = torch.argmax(out[:, -1], -1)[:, None]
        else:
            prompts, fe = demo.make_inputs(cfg, args.batch, args.prompt_len,
                                           0, dev)
            n_fe = 0 if fe is None else fe.shape[1]
            cache_len = n_fe + args.prompt_len + args.gen

            def prefill():
                return model.prefill(prompts, cache_len, frontend_embeds=fe)

            def decode(logits, cache):
                demo.greedy_decode(model, logits, cache, args.gen)
        decode(*prefill())  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=act) as tp:
            t = time.perf_counter()
            first = prefill()
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
        with torch.profiler.profile(activities=act) as td:
            t = time.perf_counter()
            decode(*first)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        scan = (mamba_scan_share(torch, prefill, cfg, args.batch,
                                 args.prompt_len) if cfg.hybrid else None)
    print(json.dumps({
        "card": nvidia_smi(), "arch": cfg.name, "n_layers": cfg.n_layers,
        "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "max_memory_allocated_mb": peak / 2**20,
        "prefill": device_summary(tp, prefill_s),
        "decode": {**device_summary(td, decode_s),
                   "steps": args.gen - 1,
                   "tok_per_s": (args.gen - 1) * args.batch / decode_s},
        "mamba_scan": scan,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
