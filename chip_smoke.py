#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--until-step N] [--clients N] [--phases P,...]

Run from the root of a checkout on a host with a CUDA device. It builds
the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all started together) and then runs nineteen phases, each
printing JSON lines:

1. ``env`` — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the kernels' build time and the compiler's register
   report (a kernel that spills registers fails the run).
2. ``kernel`` — K1 ``piece_window`` and K2 ``forecast_z`` on the card at
   the main path's full window (2^20 rows × 64 steps), a ragged 70 000 ×
   12 and 1 × 1, held to their plain PyTorch versions on the card and to
   the NumPy reference on the host with ``torch.equal`` /
   ``array_equal`` (tolerance 0: the contract is bit-exact); then K2
   alone at ``K2_CASES`` against its row tiling and column walk (W 60,
   the main path's d_max; W 61; R off the row tile; row keys >= 2^63;
   ``now`` near 2^44), and checked and timed at the main path's commonest
   forecast shapes (``K2_MAIN_SHAPES``; the largest is K2's entry in the
   ``kernels`` line). Median kernel time over CUDA events, the
   byte bound at 3.35 TB/s, the plain version's time, and the
   upload/download time of a host-NumPy call as the backend makes it.
3. ``ops`` — every op the device backend overrides, on the card,
   against the NumPy backend bit for bit (``top_m`` with forced ties,
   int64 multiplies that wrap).
4. ``main_path`` — the sparse-utilisation, exact uncapped greedy
   FedZero configuration of the 1M-client gate, built with
   ``build_experiment`` and run with ``FLSimulation.run`` (what
   ``run_experiment`` does, with set-up and round loop timed apart), at
   one million clients on ``backend="cuda"`` for at least 20 rounds,
   then the same on the NumPy backend: round results and total energy
   must be identical, and both kernels must have launched on the
   ``cuda`` run.
5. ``service`` — the always-on scheduling service (``repro_torch.service``)
   at the reference's service-load settings (``SERVICE``, from
   ``benchmarks/service_load.py``): ``1m_service``, one million clients,
   in-process, on ``cuda`` with the launch counts and the dispatch ledger
   set to 0 just before and read just after, then on NumPy; then
   ``1m_service_faults``, the same mix through two spawned worker
   processes under ``SERVICE_FAULTS``, on ``cuda`` and then on NumPy.
   Admission histories and counters must be identical across backends;
   K1 and K2 must launch on the ``cuda`` runs, the faulted run must see a
   worker crash and as many restarts, and each worker must report
   ``cuda:0`` and K1 launches of its own. Per backend: set-up, warm-up and
   window seconds, decisions/s, p50/p99/max ms, the dispatch counts,
   peak device memory, and peak RSS of the service process and of its
   workers (sampled from ``/proc`` while the run lasts).
6. ``kernel`` for K3 ``flash_attention`` — against its plain PyTorch
   version on the card, element by element within ``ATTN_TOL`` (below),
   at the llama3.2-3b prefill shape (B 4, H 32, KV 8, S = Sk = 2048,
   dh 128, in the [B, S, H, dh] layout the model passes, bf16 and f32),
   GQA 2:1 at dh 64, dh 80 with KV = H, a sliding window of 1024, S < Sk,
   a ragged S = 1000, non-causal, the mixtral-8x22b prefill shape (H 48,
   KV 8, window 4096), the kimi-k2 prefill shape (H 64, KV 8, dh 112), a
   ragged S 1000 at dh 112, dh 32, dh 80 non-causal at S 513, three
   small ragged cases (a non-causal 33 × 77, S = Sk = 1, a window of 16 at
   S = 70), the llava-next-34b prefill shape at batch 1 (H 64, KV 8, S =
   Sk = 4928, dh 128), the seamless-m4t encoder shape (B 4, H = KV = 16,
   S = Sk = 4096, dh 64, window 1024), the hymba-1.5b prefill shape (B 4,
   H 32, KV 8, S = Sk = 2048, dh 64, window 1024), and two cases in which
   K3's producer runs stages ahead of its consumers (two key tiles an
   item, Sk 256, over 2048 items reading one L2-resident kv head; dh 128
   and 64). At the llama, mixtral, kimi, llava, seamless and hymba shapes
   (``K3_TIMED``): K3, plain and ``scaled_dot_product_attention`` ms over
   CUDA events (SDPA given the window as a boolean mask where it is
   narrower than the keys), the bound (the pairs the mask keeps), TFLOP/s,
   and in bf16 the floor of the work K3 issues (P V on both parts of P,
   the diagonal tiles whole). Then, in bf16, latent attention's q/k 192
   against v 128 at kimi-k2-instruct's three prefill shapes (``K3_MLA``:
   64 heads, 32,768 tokens a batch, q, k and v laid out as
   ``mla_train`` passes them, the YaRN scale): K3 against its plain
   version on batch row 0's first 4 heads (the plain version's float32
   scores of a whole batch do not fit), and K3 and SDPA ms over CUDA
   events.
7. ``model`` — llama3.2-3b at full width in bf16 on ``cuda:0`` through
   ``build_model`` and the inference demo's functions: batch 4, prompt
   2048, 16 greedy tokens. The launch counts are set to 0 just before
   this run and read just after (K3 must launch once per layer of the
   prefill: 28). Then, on the same weights: the prefill's last-position
   logits on the K3 route against the einsum route, and ``decode_step``
   after ``prefill(S - 1)`` against the last logits of ``prefill(S)``,
   each within ``LOGIT_TOL`` (max abs difference, relative to the largest
   logit) and with each row's greedy token within that tolerance of the
   other side's maximum; and the K/V cache that ``decode_step`` leaves
   against the one ``prefill(S)`` builds, within ``CACHE_TOL`` at the
   slot the step wrote and at the slots before it.
8. ``kernel`` for K4 ``rwkv_scan`` — against its plain PyTorch version on
   the card, element by element within ``K4_TOL`` (below), for the output
   and the final state, each finite, with inputs made as the model makes
   them (w = exp(-exp(logit)), logit around -0.5 ± 0.6) at ``K4_CASES``:
   the rwkv6-1.6b prefill shape (B 4, S 2048, H 32, dh 64) with float32
   and with bf16 r/k/v, a strong and a weak decay (logit around +2 and
   -4) at S 2048, the prefill at batch 1 (at both decays; its 32 streams
   take four groups each), a ragged S 2047, S 1, 17 and 33 (against the
   32-token chunk), S 129 and 300 (several groups, at the weak decay), and
   dh 32 and 16 with small B and H. At the prefill shape, in both dtypes,
   and at batch 1: K4 and plain ms over CUDA events, and the bound.
9. ``rwkv`` — rwkv6-1.6b at full width in bf16 on ``cuda:0`` through
   ``build_model`` and the inference demo's functions: batch 4, prompt
   2048, 16 greedy tokens. K4's count is set to 0 just before this run and
   read just after (one launch per prefill layer: 24, one group a stream).
   Then, on the same
   weights: the last-position logits of the K4 route against the plain
   route (the per-token recurrence), and ``decode_step`` after
   ``prefill(S - 1)`` against ``prefill(S)``, each within
   ``RWKV_LOGIT_TOL`` (as in phase 7); and every state tensor that the
   decode step leaves (``S``, ``shift``, ``shift_cm``, per layer) against
   prefill(S)'s, within ``RWKV_STATE_TOL``.
10. ``kernel`` for K5 ``moe_gemm`` — against its plain version on the card,
   element by element within ``K5_TOL`` (below): mixtral-8x22b's prefill
   expert products in bf16 ([8, 2560, 6144]·[8, 6144, 16384] and
   [8, 2560, 16384]·[8, 16384, 6144]: 32 groups of 256 tokens at capacity
   80), its decode shapes ([8, 8, 6144]·[8, 6144, 16384] and
   [8, 8, 16384]·[8, 16384, 6144]), kimi-k2's expert widths with E cut
   from 384 to 64 ([64, 256, 7168]·[64, 7168, 2048]), the first prefill
   shape in float32, a ragged C of 37, C 64 and 65 (the two sides of the
   ``wide``/``narrow`` crossover), d 1000 (not a multiple of a stage), f
   1032 (a ragged last f tile) and E 1, each of the last three on both
   kernels. Each case: the variant ``pick_variant`` chose (and that it
   counted), K5, plain and ``torch.bmm`` ms over CUDA events, the bound
   and its share of K5's time, TFLOP/s and GB/s, and whether K5's output
   equals ``torch.bmm``'s bit for bit. Every case runs and reports before a
   failing one stops the phase. Then ``k5_crossover`` lines: both bf16
   kernels, named, at C 8–64 at mixtral's two expert shapes, each held to
   the plain version, with ``torch.bmm``'s ms beside them. Then
   ``k5_routed`` lines: the routed product (``moe_gemm_routed``) at
   mixtral's dropless prefill, 16,384 routed rows in 8 segments of 128-row
   tiles at both expert shapes, in bf16, held to the plain version, its
   real rows equal bit for bit to the dense ``wide`` kernel's over the
   capacity buffer that holds the same rows ([8, 8192, d]), and with NaN
   in its padding rows; the ms of both, the bound over the routed rows and
   its share.
11. ``moe`` — mixtral-8x22b at full width and 8 of its 56 layers in bf16 on
   ``cuda:0`` through the inference demo's ``load_model`` and
   ``generate``: batch 4, prompt 2048, 16 greedy tokens. K3's and K5's
   counts are set to 0 just before this run and read just after (K5: three
   launches per layer in the prefill, all ``wide``, and in each decode
   step, all ``narrow``; K3: one per prefill layer). Then, on the same
   weights: per layer, the MoE layer's K5 route against its einsum route
   on the layer's own input (routing
   identical), within ``MOE_ROUTE_TOL``, and, at capacity factor
   ``n_experts / top_k`` (no token dropped), against a float32 oracle that
   runs each expert on the tokens routed to it, within ``MOE_ORACLE_TOL``;
   the router's dropped share at the published capacity factor; at that
   same no-drop capacity, ``decode_step`` after ``prefill(S - 1)`` against
   ``prefill(S)`` and its cache (``LOGIT_TOL``, ``CACHE_TOL``: at the
   published factor the two prefills group, and so drop, differently);
   and the K5 route against the einsum route, whole model, in float32 on
   a 2-layer full-width copy of the same weights, within ``MOE_F32_TOL``.
12. ``kimi`` — kimi-k2-1t-a32b at full width and 1 of its 61 layers in bf16
   on ``cuda:0`` through ``load_model`` and ``generate``: batch 4, prompt
   2048, 4 greedy tokens. K3's and K5's counts are set to 0 just before
   this run and read just after (K3 at dh 112: one launch per prefill
   layer; K5 three per layer and step). Then the last-position logits of
   the K3/K5 route against the einsum route on the same weights, within
   ``LOGIT_TOL``.
13. ``train`` — federated training of the paper's models (``TRAIN_RUNS``:
   ConvNet, KWT-1 and the LSTM at their published widths) with TF32 off.
   First the guard of the kernels without a backward: K3, K4 and K5, and
   ``DecoderLM.loss`` of a reduced dense config on the kernel route, must
   raise on CUDA inputs that require grad; on the reference's route the
   loss's gradients must equal the CPU's within ``GRAD_TOL``. Then per
   model: its synthetic task is built once for 100 clients; a
   ``TorchTrainer`` on ``cuda:0`` and one on the CPU from the same weights
   and seed run 3 local updates of 30 steps, ``aggregate`` and
   ``evaluate``, and must agree within ``TRAIN_TOL`` (the global model's
   logits, every step's loss, the probes' per-sample losses, every
   aggregated parameter) and ``TRAIN_ACC_TOL``; then the paper's loop on
   the card, ``build_experiment`` + ``FLSimulation.run`` on
   ``backend="cuda"`` (``global``, 100 clients, FedZero, n 10, d_max 60,
   30 steps a round at most, evaluated every round) with the
   ``TorchTrainer`` in the trainer section and the fleet retuned to the
   shard sizes. K1/K2's counts are set to 0 just before the run and read
   just after. Per run: seconds a round, split into scheduling and
   training, local steps/s and samples/s, train loss and accuracy per
   round, peak device memory; every loss and accuracy must be finite, the
   last round's train loss below the first's, and the model on
   ``cuda:0``.
14. ``launch`` — a ``DecoderLM`` trained through ``repro_torch.launch``
   (``LAUNCH``), TF32 off. (a) ``make_train_step`` (the default AdamW,
   remat, the reference's route) on ``cuda:0`` against the CPU on
   smollm-360m at full width cut to 2 layers in float32, batch 2 x seq
   256, same weights and batches: the first step's gradients within
   ``GRAD_TOL`` of each tensor's largest, 3 steps' losses within
   ``LAUNCH_LOSS_TOL`` and parameters within ``LAUNCH_PARAM_RHO`` of the
   distance they moved (``launch_parity`` line). (b) The train driver,
   ``repro_torch.launch.train.main``, on the full smollm-360m (32 layers,
   bf16, remat; the step a DTensor program on the 1×1 mesh of
   ``fit_mesh``): batch 8 x seq 2048,
   10 steps, a checkpoint every 5 into a temporary directory; every loss
   finite and the last below the first; median step ms, tokens/s and peak
   device memory; then ``--steps 12`` in the same directory, which must
   print ``resumed from step 10`` and take 2 steps. (c) The step-10
   checkpoint, loaded, equals the first run's final parameters and AdamW
   state bit for bit. (d) The step-12 checkpoint served through
   ``make_prefill_step``/``make_decode_step`` (K3): batch 4, prompt 2048,
   16 greedy tokens, K3's count from zero just before the prefill and read
   just after (32, one per layer), the prefill's logits against the plain
   route within ``LOGIT_TOL``; prefill ms and decode tokens/s (``launch``
   line).
15. ``vlm`` — llava-next-34b at full width and 8 of its 60 layers in bf16
   on ``cuda:0`` through the inference demo's ``load_model``,
   ``make_inputs`` and ``generate`` (``LLAVA``): batch 4, 2880 random
   frontend embeddings (the reference's stubbed anyres vision tower)
   before a prompt of 2048, 16 greedy tokens, a cache of 2880 + 2048 + 16.
   K3's count is set to 0 just before this run and read just after (one
   launch per prefill layer: 8). Then, on the same weights: the
   last-position logits of the K3 route against the einsum route at batch
   1 (the einsum route's float32 scores at batch 4 are 24.9 GB a layer),
   and ``decode_step`` after ``prefill(S - 1)`` against ``prefill(S)``,
   within ``LOGIT_TOL``; the cache against prefill(S)'s within
   ``CACHE_TOL``.
16. ``encdec`` — seamless-m4t-large-v2 whole (24 + 24 layers) in bf16 on
   ``cuda:0`` through ``load_model`` (``SEAMLESS``): batch 4, 4096 random
   frames encoded (causal within the encoder's window of 1024, on K3),
   ``precompute_enc_kv``, 16 greedy tokens from token 0. K3's count is set
   to 0 just before this run and read just after (one launch per encoder
   layer: 24). Then, on the same weights: the encoder's output, K3 route
   against einsum route, within ``ENC_TOL`` of its largest value; the
   decode steps' logits on the two routes' cross K/V, and against the
   decoder's teacher-forced logits over the same tokens (``logits_fn``,
   what ``loss`` scores), each within ``LOGIT_TOL``.
17. ``hybrid`` — hymba-1.5b whole (32 layers, parallel attention and
   Mamba heads) in bf16 on ``cuda:0`` through ``load_model``,
   ``make_inputs`` and ``generate`` (``HYMBA``): batch 4, a prompt of
   2048 over its sliding window of 1024 (the KV ring buffer of 1024 slots
   wraps), 16 greedy tokens. K3's count is set to 0 just before this run
   and read just after (one launch per prefill layer, within the window:
   32). Then, on the same weights: the K3 route against the einsum route
   within ``HYBRID_ROUTE_TOL`` (the padded vocab's columns sliced off);
   ``decode_step`` after ``prefill(S - 1)`` against ``prefill(S)``: the
   logits within ``LOGIT_TOL``, the ring buffer at the new slot
   ``(S - 1) % 1024`` and at every other slot within ``CACHE_TOL``, each
   layer's Mamba conv and h within ``HYBRID_STATE_TOL``. The same seed's
   weights in float32, whole: the two routes, and decode against prefill,
   within ``HYBRID_F32_TOL``. The card against the CPU in float32 (the
   same width cut to 2 layers, batch 1, a prompt of 256, one decode step:
   logits, K/V, Mamba state) within ``HYBRID_F32_TOL`` (the Mamba scan
   has no kernel to hold to a plain version).
18. ``spmd`` — the sharded step (``repro_torch.launch`` with a mesh: each
   step a DTensor program) on the 1×1 mesh of ``launch.train.fit_mesh``,
   which starts NCCL at world size 1 (``SPMD``). smollm-360m's train step
   at full width (bf16, remat, the default AdamW, batch 8 x seq 2048)
   against the plain step from the same weights and batches, TF32 off:
   the first step's gradients within ``GRAD_TOL``, 3 steps' losses within
   ``LAUNCH_LOSS_TOL`` and parameters within ``LAUNCH_PARAM_RHO``; each
   step's ms on both; the same for hymba-1.5b's train step, 2 layers at
   full width, batch 4 x seq 512, 2 AdamW steps (its Mamba scan per rank
   under autograd, A's gradient partial over the batch split). Then
   llama3.2-3b and rwkv6-1.6b cut to 8 layers, mixtral-8x22b to 2,
   llava-next-34b to 2 (2880 frontend embeddings before the prompt),
   seamless-m4t-large-v2 to 4 + 4 (4096 frames encoded, then 16 tokens
   from token 0) and hymba-1.5b to 4 (the prompt over its window of 1024)
   through ``make_prefill_step`` and ``make_decode_step``: batch 4,
   prompt 2048, 16 greedy tokens without a mesh, then on the mesh route
   (the weights, tokens, frontend embeddings and frames DTensors; K3, K4
   and K5 run per rank in ``local_map``, hymba's Mamba scan too) fed the
   same tokens; every position's logits within ``LOGIT_TOL``, seamless's
   (k, v) within ``ENC_TOL``; K3, K4 and K5's counts set to 0 just before
   the mesh route's prefill and read after it (K3 once a layer: llama 8,
   llava 2, seamless's encoder 4, hymba 4) and after its decode steps;
   prefill ms and decode tokens/s of both routes (``spmd`` line).
   First, before NCCL starts, the dry run's prediction of smollm-360m's
   train step (``launch.dryrun.step_cost``: batch 8 x seq 2048, the 1×1
   mesh, ``tp_fsdp``; meta tensors on a fake process group), and after the
   train cases the card's own reading of that step (``spmd_memory``: the
   bytes of its parameters, AdamW state and batch, and the most bytes
   allocated over one step with the stats reset once they are resident):
   the ``cost`` line, its matmul FLOPs equal to the unsharded step's
   ``step_flops`` (``launch.dryrun.step_record``) and its FLOP count over
   989.4 TFLOP/s no more than the
   median step, ``argument_size`` and ``peak_size`` within ``COST_TOL``,
   the byte count over 3.35 TB/s beside the step (an H100 80GB HBM3's
   dense bf16 peak and memory rate at a 700 W power limit,
   ``core.profiles``).
19. ``sites`` — first the dry run under this torch against the
   reference (``sites_reference`` line): the steps of ``XLA_FLOPS`` (the
   reduced configs on 2×2, llama3.2-3b's full width cut to 2 layers on
   2×16) as DTensor programs on the fake group, each one's FLOPs a
   device within ``FLOP_RATIO`` of XLA's count of repro's step. Then
   FedZero scheduling sites of H100 cards profiled from the
   dry run (``SITES``): ``train_4k`` × ``single_pod`` records of
   smollm-360m, llama3.2-3b and kimi-k2-1t-a32b (full configs on meta
   tensors over the fake 16×16 mesh, ``dryrun_one``), their FLOPs a
   device within ``SITES_TOL`` of torch 2.13's (``SITES_2_13``), three
   sites of 64 cards each (``core.registry_from_roofline``), and
   tests/test_pod_sites.py's FedZero set-up (``global``, n 5, d_max 60,
   20 hours) on ``cuda``, K1/K2's counts set to 0 just before and read
   just after, then on NumPy: rounds and total energy identical, kimi's δ
   and smollm's capacity each more than 5× the other's and within
   ``SITES_TOL`` of the ratios 2.13's records give, a kernel
   launched (the dense store: K2); the phase's seconds.
20. ``mla`` — the benchmark's kimi-k2-instruct (``gpubench``'s
   configuration and seeded weights: 9 of 61 layers at full width, 48 of
   384 experts held) through ``build_model`` with the kernels on: a
   prefill of [2, 4096] (K3 at q/k 192, v 128, once a layer), then 8
   ``decode_step``s through the latent cache; the logits of every one of
   the 9 positions against the benchmark's float32 reference over the
   prompt and the tokens fed so far, by the cell's ``miss``, the median
   within its ``miss_median`` limit (``MLA``). Not in the default run:
   run it by name (``NAMED_PHASES``).

Every logit, state and oracle output these phases compare must be
finite, on each route, and a NaN in any layer's comparison fails it.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before the last line. Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.

``--phases`` runs only the named phases of ``kernels`` (2), ``ops`` (3),
``main_path`` (4), ``service`` (5), ``k3`` (6), ``model`` (7), ``k4`` (8),
``rwkv`` (9), ``k5`` (10), ``moe`` (11), ``kimi`` (12), ``train`` (13),
``launch`` (14), ``vlm`` (15), ``encdec`` (16), ``hybrid`` (17),
``spmd`` (18), ``sites`` (19) and ``mla`` (20), after ``env``, and then
stops without
the closing lines: ``--phases k3``, ``k4`` or ``k5`` is
the quick check of a new K3, K4 or K5 build, ``--phases service`` runs the
service alone, ``--phases train`` the federated training alone,
``--phases launch`` the DecoderLM training, checkpoint and serving alone,
``--phases vlm``, ``--phases encdec`` and ``--phases hybrid`` llava,
seamless and hymba alone, ``--phases spmd`` the sharded step alone,
``--phases sites`` the pod sites alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12              # H100 SXM tf32 tensor cores, dense
SOURCES = {"piece_window": "src/repro_torch/csrc/counter_hash.cu",
           "forecast_z": "src/repro_torch/csrc/counter_hash.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "rwkv_scan": "src/repro_torch/csrc/rwkv_scan.cu",
           "moe_gemm": "src/repro_torch/csrc/moe_gemm.cu"}
REPLACES = {"piece_window": "src/repro/kernels/counter_hash.py:102",
            "forecast_z": "src/repro/kernels/counter_hash.py:138",
            "flash_attention": "src/repro/kernels/flash_attention.py:80",
            "rwkv_scan": "src/repro/kernels/rwkv_scan.py:74",
            "moe_gemm": "src/repro/kernels/moe_gemm.py:41"}
# K3 against its plain version, element by element: |out - want| <= atol +
# rtol * |want|. Both compute in float32 and differ by summation order
# only (K3 carries bf16 P as two bf16 parts); a bf16 output then differs by
# at most one rounding step, at most 2^-7 of |want|.
ATTN_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (1e-4, 1e-2)}
# llama3.2-3b bf16 logits, route against route: max |a - b| <= LOGIT_TOL *
# max |b|. The routes round at other places through 28 layers: sound runs
# read 0.023-0.028 of the largest logit; planted faults read 0.049 (the new
# token's K/V slot left unwritten in decode) and 0.95-0.97 (K3 with its
# last key tile masked, or with a window) (PERF.md, PR 12).
LOGIT_TOL = 0.04
# decode_step's K/V cache against prefill's, per tensor: max |a - b| <=
# CACHE_TOL * max |b|, at the slot the step wrote and at the others. Sound
# runs read 0.020 (K) and 0.028 (V) at the new slot and 0 at the others; a
# slot left unwritten reads 1 (PERF.md, PR 12).
CACHE_TOL = 0.25
LLAMA = dict(arch="llama3.2-3b", batch=4, prompt=2048, gen=16)
K3_CASES = [  # name, B, H, KV, S, Sk, dh, causal, window
    ("llama3.2-3b prefill", 4, 32, 8, 2048, 2048, 128, True, 0),
    ("GQA 2:1, dh 64", 2, 16, 8, 1024, 1024, 64, True, 0),
    ("dh 80, KV = H", 2, 32, 32, 512, 512, 80, True, 0),
    ("sliding window 1024", 2, 32, 8, 2048, 2048, 128, True, 1024),
    ("S < Sk", 2, 32, 8, 512, 2048, 128, True, 0),
    ("ragged S", 2, 32, 8, 1000, 1000, 128, True, 0),
    ("non-causal", 2, 16, 8, 1024, 1024, 64, False, 0),
    ("mixtral-8x22b prefill", 4, 48, 8, 2048, 2048, 128, True, 4096),
    ("kimi-k2 prefill", 4, 64, 8, 2048, 2048, 112, True, 0),
    ("ragged S 1000, dh 112", 2, 64, 8, 1000, 1000, 112, True, 0),
    ("dh 32", 2, 4, 4, 300, 300, 32, True, 0),
    ("dh 80 non-causal, S 513", 2, 32, 32, 513, 513, 80, False, 0),
    ("non-causal 33 x 77, dh 80", 1, 4, 2, 33, 77, 80, False, 0),
    ("S = Sk = 1", 1, 4, 2, 1, 1, 64, True, 0),
    ("window 16, S 70", 3, 6, 3, 70, 70, 80, True, 16),
    # llava's prefill (2880 frontend positions + a 2048 prompt, not a
    # multiple of 128) at batch 1: the plain version's float32 scores are
    # 6.2 GB here, 24.9 GB at the phase's batch 4
    ("llava-next-34b prefill", 1, 64, 8, 4928, 4928, 128, True, 0),
    # seamless-m4t's encoder: 4096 frames, causal within a window of 1024
    ("seamless-m4t encoder", 4, 16, 16, 4096, 4096, 64, True, 1024),
    # hymba-1.5b's prefill: GQA 4:1 of dh 64 within a window of 1024
    ("hymba-1.5b prefill", 4, 32, 8, 2048, 2048, 64, True, 1024),
    # two key tiles an item over many small items, K and V of one kv head
    # (L2-resident): the producer runs stages ahead of the consumers, so a
    # stage freed before its P V has read it is refilled under the read
    ("producer ahead, dh 128", 32, 64, 1, 128, 256, 128, False, 0),
    ("producer ahead, dh 64", 32, 64, 1, 128, 256, 64, False, 0),
]
# latent attention on K3 (bf16, q/k 192 = 128 + 64 rope, v 128, MLA's kv
# heads = heads): kimi-k2-instruct's prefill shapes, the scale YaRN's
# 192^-0.5 (0.1 ln 32 + 1)^2. name, B, H, S
K3_MLA = [("kimi-k2-instruct 8x4096", 8, 64, 4096),
          ("kimi-k2-instruct 4x8192", 4, 64, 8192),
          ("kimi-k2-instruct 2x16384", 2, 64, 16384)]
K3_MLA_SCALE = 0.1308608
# the K3 cases timed against SDPA (the attention shapes of the six
# prefills and the encoder the script runs); the first is the kernels line's
K3_TIMED = ("llama3.2-3b prefill", "mixtral-8x22b prefill", "kimi-k2 prefill",
            "llava-next-34b prefill", "seamless-m4t encoder",
            "hymba-1.5b prefill")
# K4 against its plain version, element by element, for the output and the
# final state: |got - want| <= atol + rtol * |want|. Both compute in
# float32: K4 in chunks with every product split into three TF32 parts
# (~6 digits), the plain version token by token; they differ by summation
# order and rounding. Each output sums 64 terms of up to ~100 in size, so
# the plain version alone is ~1.5e-5 off a float64 scan at 512 steps: atol
# 1e-4. One TF32 product per term misses it by two orders (PERF.md §6).
K4_TOL = (1e-4, 1e-4)
# rwkv6-1.6b, relative to the largest value as LOGIT_TOL: decode_step
# against prefill(S), its logits within RWKV_LOGIT_TOL and each state tensor
# per layer within RWKV_STATE_TOL; the K4 route against the plain route,
# logits within RWKV_ROUTE_TOL in bf16, and logits and every state tensor
# within RWKV_F32_TOL in float32 on the same weights (PERF.md, PR 13).
RWKV_LOGIT_TOL = 0.04
RWKV_STATE_TOL = 0.1
RWKV_ROUTE_TOL = 0.5
RWKV_F32_TOL = 1e-3
RWKV = dict(arch="rwkv6-1.6b", batch=4, prompt=2048, gen=16)
# K5 against its plain version, element by element: |got - want| <= atol +
# rtol * |want|. Both accumulate in float32 and differ by summation order
# only; a bf16 output then differs by at most one rounding step, 2^-7 of
# |want|. Inputs are unit normal, weights at the fan-in scale (outputs ~1).
K5_TOL = {"torch.float32": (1e-4, 1e-4), "torch.bfloat16": (1e-4, 1e-2)}
# mixtral-8x22b, relative to the largest value as LOGIT_TOL: per layer, the
# MoE layer's K5 route against its einsum route (MOE_ROUTE_TOL) and, with
# no token dropped, against a float32 per-expert oracle (MOE_ORACLE_TOL);
# the whole model's logits, K5 route against einsum route, in float32
# (MOE_F32_TOL). Sound runs read 0.0 (K5 equals torch.bmm bit for bit),
# <= 0.0096 and 4.8e-6; planted faults 0.12-0.21 (K5 skips its last d
# tile or k stage), 1.04-1.40 (K5's wide kernel frees a stage early or
# drops a tile), 0.118-1.35 (a fault in the MoE layer's dispatch or
# combine) and 0.76 (K5's float32 loop skips its last 16 of d) (PERF.md,
# the planted-fault tables).
MOE_ROUTE_TOL = 0.02
MOE_ORACLE_TOL = 0.05
MOE_F32_TOL = 1e-3
MIXTRAL = dict(arch="mixtral-8x22b", n_layers=8, batch=4, prompt=2048,
               gen=16)
# kimi-k2-1t-a32b at full width, 1 of its 61 layers: 384 experts are 33.8
# GB a layer, the embedding and head 4.7 GB
KIMI = dict(arch="kimi-k2-1t-a32b", n_layers=1, batch=4, prompt=2048, gen=4)
# llava-next-34b at full width, 8 of its 60 layers (9.2 GB of layers and
# 1.8 GB of embedding and head; the 60 would be ~70.5 GB): the reference's
# 2880 frontend positions (its stubbed anyres vision tower) before a prompt
# of 2048, a cache that holds every position. The K3 route is held to the
# einsum route at batch 1: the einsum route's float32 scores at batch 4 are
# 24.9 GB a layer
LLAVA = dict(arch="llava-next-34b", n_layers=8, batch=4, prompt=2048, gen=16,
             route_batch=1)
# seamless-m4t-large-v2 whole (24 + 24 layers): batch 4, the reference's
# ENC_CTX_DECODE of 4096 frames encoded (causal within its window of 1024,
# on K3), then 16 greedy tokens from token 0
SEAMLESS = dict(arch="seamless-m4t-large-v2", batch=4, frames=4096, gen=16)
# seamless's encoder output, K3 route against the einsum route: max |a - b|
# over max |b|, set between sound runs and a K3 call that drops the window
# (tools/plant_faults.py k3_call_drops_window; PERF.md §6)
ENC_TOL = 0.05
# hymba-1.5b whole (32 layers, bf16): batch 4, a prompt of 2048 over its
# window of 1024 (the KV ring buffer wraps), 16 greedy tokens. The card
# against the CPU runs the same width cut to 2 layers in float32, batch 1,
# a prompt of 256, and one decode step
HYMBA = dict(arch="hymba-1.5b", batch=4, prompt=2048, gen=16,
             f32_layers=2, f32_batch=1, f32_prompt=256)
# hymba-1.5b, relative to the largest value as LOGIT_TOL: decode_step after
# prefill(S - 1) against prefill(S), each layer's Mamba conv and h within
# HYBRID_STATE_TOL (sound runs read 0.047 and 0.051; a decode that starts
# from a zeroed state, tools/plant_faults.py hybrid_mamba_state_not_carried,
# reads 1.45 and 1.06); the K3 route against the einsum route in bf16
# within HYBRID_ROUTE_TOL: the routes round at other places, and 32 layers
# of attention beside the Mamba recurrence carry it further than llama's 28
# (sound runs read 0.065, over LOGIT_TOL; the same weights in float32 read
# 1.1e-5; K3 called without its window, tools/plant_faults.py
# k3_call_drops_window, reads 0.948); the same weights in float32 at full
# depth, routes and decode against prefill, and the card against the CPU
# (logits, K/V, Mamba state), within HYBRID_F32_TOL (PERF.md §6)
HYBRID_STATE_TOL = 0.1
HYBRID_ROUTE_TOL = 0.15
HYBRID_F32_TOL = 1e-3
# the always-on service at the reference's service-load settings
# (benchmarks/service_load.py:78-93, run_service_load at :111-131): the
# sparse, greedy FedZero service over the "global" scenario, one day,
# seed 0, no trainer, no event log; the clock advanced WARMUP_STEPS into
# daylight and one admission priced before the measured window. The
# window was cut from 15 steps to 8 to keep the whole script inside its
# time on the slower hosts (PERF.md §4); the faulted run's first crash
# (round 4, worker 0) still falls in it
SERVICE = dict(clients=1_000_000, steps=8, churn=0.01, admits_per_step=1,
               quotes_per_step=250, n=10, d_max=30, seed=0, warmup_steps=240)
SERVICE_FAULTS = ("crash=0.005,dropout=0.05,straggler=0.05,delay=0.2,"
                  "loss=0.05,seed=64")
# federated training of the paper's models at their published widths (the
# reference's __init__ defaults, src/repro/models/paper_models.py:28, 82,
# 143), each on the synthetic task it stands in for: name -> (FedZero
# rounds, SGD learning rate). examples/train_federated.py's lr 0.05 trains
# the LSTM; the reference's own JaxTrainer diverges at it on the full-width
# ConvNet and KWT-1 (whose loss turns NaN), and trains them at 0.001 and
# 0.005 (PERF.md §4). The rounds were cut from 10, 5 and 5, then KWT-1's and
# the LSTM's from 3, to keep the whole script inside its time (PERF.md §4);
# each run's loss still falls by its last round (PERF.md §6)
TRAIN_RUNS = {"convnet": (5, 0.001), "kwt": (2, 0.005), "lstm": (2, 0.05)}
# the paper's loop as examples/train_federated.py runs it (FedProx, SGD),
# scheduled by FedZero over 100 clients; the parity check's local updates
TRAIN = dict(clients=100, n=10, d_max=60, max_steps=30, batch=10,
             prox_mu=0.1, seed=0, parity_updates=3)
# the trainer on the card against the same trainer on the CPU, from the same
# weights and batches (TF32 off), relative to the largest value of each
# (per-step losses: to each loss): the global model's logits before
# training, every step's loss, the probes' per-sample losses and every
# aggregated parameter after 3 local updates of 30 steps; the accuracies
# may differ by TRAIN_ACC_TOL. Float32 rounding grows over the steps: sound
# runs read at most 8.7e-7, 1.9e-5, 4.7e-5 and 3.0e-4 (ConvNet's params),
# about a tenth of each limit (PERF.md §6)
TRAIN_TOL = {"logits": 1e-5, "losses": 2e-4, "sample_losses": 5e-4,
             "params": 3e-3}
TRAIN_ACC_TOL = 0.01
# DecoderLM.loss on the reference's route: the card's gradients against the
# CPU's, each relative to its largest value
GRAD_TOL = 1e-4
# training a DecoderLM through repro_torch.launch: smollm-360m at full width
# and depth (remat, the default AdamW), batch 8 x seq 2048, 10 steps with a
# checkpoint every 5, then resumed to 12 (cut from 20 and 24 to keep the
# script inside its time, PERF.md §4); served from the step-12
# checkpoint at batch 4, prompt 2048, 16 greedy tokens on K3. The card
# against the CPU runs 3 steps of the same width cut to 2 layers in
# float32, batch 2 x seq 256
LAUNCH = dict(arch="smollm-360m", batch=8, seq=2048, steps=10, ckpt_every=5,
              resume_steps=12, serve_batch=4, prompt=2048, gen=16, seed=0,
              parity_layers=2, parity_batch=2, parity_seq=256,
              parity_steps=3)
# the card against the CPU, same weights and batches, TF32 off: the first
# step's gradients within GRAD_TOL of each tensor's largest; each step's loss
# within LAUNCH_LOSS_TOL of the CPU's (relative); after the steps, per tensor
# |p_card - p_cpu| / |p_cpu - p_0| within LAUNCH_PARAM_RHO: AdamW turns
# float32 rounding in a near-zero gradient into a step of up to lr either
# way, so elementwise limits do not hold (tests/test_torch_launch.py: the
# port against the JAX package on the CPU reads at most 0.018 by this
# measure, a tensor left out of the update reads 1)
LAUNCH_LOSS_TOL = 1e-4
LAUNCH_PARAM_RHO = 0.05
# the sharded step (repro_torch.launch with a mesh: DTensor programs) on
# the 1×1 mesh of fit_mesh over NCCL: smollm-360m's train step at full
# width (bf16, remat, the default AdamW), batch 8 x seq 2048, 3 steps, and
# hymba-1.5b's, 2 layers at full width, batch 4 x seq 512, 2 steps, each
# against the plain step from the same weights and batches (the first
# step's gradients within GRAD_TOL, losses within LAUNCH_LOSS_TOL, the
# parameters within LAUNCH_PARAM_RHO); prefill and 16 greedy tokens on the
# mesh route (K3, K4, K5 in local_map) against the route without a mesh,
# fed the same tokens, within LOGIT_TOL (seamless's (k, v) within
# ENC_TOL): (arch, layers) at full width, batch 4, prompt 2048 (llava's
# 2880 frontend embeddings before it; seamless's 4096 frames, its
# encoder cut alike). llama3.2-3b and rwkv6-1.6b were whole before the
# vlm, encoder-decoder and hybrid cases came; their whole models run in
# the model and rwkv phases (PERF.md §4)
SPMD = dict(train=(dict(arch="smollm-360m", n_layers=None, batch=8,
                        seq=2048, steps=3),
                   dict(arch="hymba-1.5b", n_layers=2, batch=4, seq=512,
                        steps=2)),
            seed=0,
            infer=(("llama3.2-3b", 8), ("mixtral-8x22b", 2),
                   ("rwkv6-1.6b", 8), ("llava-next-34b", 2),
                   ("seamless-m4t-large-v2", 4), ("hymba-1.5b", 4)),
            infer_batch=4, prompt=2048, gen=16, frames=4096)
# the dry run's per-device cost of smollm-360m's train step on the 1×1
# mesh (launch.dryrun.step_cost at SPMD["train"][0]'s batch and seq)
# against the card: the FLOP count over the card's dense bf16 peak no
# more than the measured median step; the predicted argument_size within
# COST_TOL of the bytes the card holds for the parameters, AdamW state and
# batch; the predicted peak_size within COST_TOL of the most bytes the
# card allocates over one step (stats reset once the arguments are
# resident, those bytes counted in)
COST_TOL = {"argument_size": 0.01, "peak_size": 0.15}
# FedZero scheduling sites of H100 cards profiled from the dry run:
# train_4k × single_pod records of three archs (full configs, meta tensors,
# the fake 16×16 mesh), 3 sites each of 64 cards
# (core.registry_from_roofline), then tests/test_pod_sites.py's FedZero
# set-up (global, n 5, d_max 60, 20 hours, evaluated every round) with the
# grid sized for 64 cards of 700 W, on cuda and on NumPy
SITES = dict(archs=("smollm-360m", "llama3.2-3b", "kimi-k2-1t-a32b"),
             shape="train_4k", n_sites_per_arch=3, chips_per_site=64,
             hours=20, n=5, d_max=60, k=0.01, ratio=5)
# the reference's per-device FLOPs of the steps of launch.dryrun.case_parts
# (tests/test_torch_dryrun_cost.py's CASES, which holds these to its live
# count): XLA's cost analysis of repro's step, every layer unrolled, on
# forced host devices. The dry run under this torch holds each within
# FLOP_RATIO of its count (its 2×16 case, model 16 as on the production
# mesh, shows a backward product done whole on every rank; the 2×2
# cases' attention leaves a projection's share small)
XLA_FLOPS = {"smollm-360m/train_4k": 11531501699072,
             "smollm-360m/decode_32k": 634456512,
             "mixtral-8x22b/train_4k": 14220820217856,
             "mixtral-8x22b/decode_32k": 443479840,
             "llama3.2-3b:2/train_4k@2x16": 150512196386816}
FLOP_RATIO = 0.25
# SITES' train_4k × single_pod records under torch 2.13 (the CPU tests';
# tests/test_torch_spmd_dryrun_train.py holds smollm-360m's to its live
# record): (flops_per_device, bytes_per_device). This torch's records
# hold their FLOPs within SITES_TOL of these, and the sites' δ and
# capacity ratios (kimi over smollm, smollm over kimi) within SITES_TOL of
# the ones these give
SITES_2_13 = {"smollm-360m": (20377931570215, 2508592940592),
              "llama3.2-3b": (133845532033059, 5630359261592),
              "kimi-k2-1t-a32b": (1423046336959328, 67266965183472)}
SITES_TOL = 0.10
PHASES = ("kernels", "ops", "main_path", "service", "k3", "model", "k4",
          "rwkv", "k5", "moe", "kimi", "train", "launch", "vlm", "encdec",
          "hybrid", "spmd", "sites")
# run only where named (``--phases``): not part of the default run
NAMED_PHASES = ("mla",)
FULL_R, FULL_W, FULL_S = 1 << 20, 64, 4


def smoke_config(arch):
    """``arch``'s full-width config at the depth this script runs it: the
    registry's, cut where its run (LLAMA, RWKV, MIXTRAL, KIMI, LLAVA,
    SEAMLESS, HYMBA) names a depth."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    run = {r["arch"]: r for r in (LLAMA, RWKV, MIXTRAL, KIMI, LLAVA,
                                  SEAMLESS, HYMBA)}.get(arch, {})
    return dataclasses.replace(cfg,
                               n_layers=run.get("n_layers", cfg.n_layers))


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=2):
    """Median device time of ``fn`` in ms over CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(torch, fn, iters=3):
    """Median host time of ``fn`` (ending in a synchronise) in ms."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def all_finite(torch, *tensors):
    """Whether every value of every tensor is finite."""
    return all(bool(torch.isfinite(x).all()) for x in tensors)


# --------------------------------------------------------------------------
# phase 2: the kernels


def window_case(rng, R, S, W):
    levels = rng.random((R, S), dtype=np.float32)
    slot = rng.integers(0, S, (R, W)).astype(np.int64)
    rows = np.arange(R, dtype=np.int64)
    return levels, slot, rows


def std_lead(W):
    lead = np.arange(1, W + 1, dtype=np.float32)
    return 0.05 + 0.20 * np.minimum(lead / 1440.0, 1.0)


def check_kernels(torch, bk, host):
    from repro_torch.data.traces import _SparseUtil
    from repro_torch.kernels import counter_hash as ch

    amp = _SparseUtil._NOISE_AMP
    rng = np.random.default_rng(0)
    fold = np.uint64(rng.integers(0, 2 ** 63))
    results = {}
    for R, S, W in ((FULL_R, FULL_S, FULL_W), (70_000, 6, 12), (1, 1, 1)):
        full = R == FULL_R
        levels, slot, rows = window_case(rng, R, S, W)
        std = std_lead(W)
        lv, sl, rw = bk._window_args(levels, slot, rows)
        rw2, sd = bk._forecast_args(rows, W, std)
        n1, n2 = ch.piece_window.launches, ch.forecast_z.launches
        k1 = ch.piece_window(lv, sl, fold, rw, 10_000, amp)
        k2 = ch.forecast_z(fold, rw2, 777, sd)
        torch.cuda.synchronize()
        require(ch.piece_window.launches == n1 + 1, "K1 did not count")
        require(ch.forecast_z.launches == n2 + 1, "K2 did not count")
        p1 = ch.piece_window_plain(lv, sl, fold, rw, 10_000, amp)
        p2 = ch.forecast_z_plain(fold, rw2, 777, sd)
        h1 = host.synth_window(levels.copy(), slot, fold, rows, 10_000, amp)
        h2 = host.forecast_noise_z(fold, rows, 777, W, std)
        eq_plain = [bool(torch.equal(k1, p1)), bool(torch.equal(k2, p2))]
        eq_numpy = [bool(np.array_equal(k1.cpu().numpy(), h1)),
                    bool(np.array_equal(k2.cpu().numpy(), h2))]
        err1 = float((k1 - p1).abs().max())
        err2 = float((k2 - p2).abs().max())
        line = {"R": R, "W": W, "S": S, "equal_plain": eq_plain,
                "equal_numpy": eq_numpy, "max_abs_err": [err1, err2]}
        emit("kernel_case", **line)
        for i, name in enumerate(("K1", "K2")):
            require(eq_plain[i], f"{name} != plain at {R}x{W}")
            require(eq_numpy[i], f"{name} != numpy at {R}x{W}")
        if full:
            b1 = (R * S * 4 + R * W * 8 + R * 8 + R * W * 4)
            b2 = (R * 8 + W * 4 + R * W * 4)
            # float32 ops per cell: K1 sub, mul, add, 2 compares; K2 sub,
            # 2 muls. The 64-bit hashing has no peak rate in the table
            f1, f2 = 5 * R * W, 3 * R * W
            t = {
                "piece_window": dict(
                    ms=cuda_ms(torch, lambda: ch.piece_window(
                        lv, sl, fold, rw, 10_000, amp), 20),
                    plain_ms=cuda_ms(torch, lambda: ch.piece_window_plain(
                        lv, sl, fold, rw, 10_000, amp), 5),
                    bytes=b1, flops=f1, max_abs_err=err1,
                    upload_ms=host_ms(torch, lambda: bk._window_args(
                        levels, slot, rows)),
                    download_ms=host_ms(torch, lambda: bk._np(k1)),
                    backend_call_ms=host_ms(torch, lambda: bk.synth_window(
                        levels, slot, fold, rows, 10_000, amp))),
                "forecast_z": dict(
                    ms=cuda_ms(torch, lambda: ch.forecast_z(
                        fold, rw2, 777, sd), 20),
                    plain_ms=cuda_ms(torch, lambda: ch.forecast_z_plain(
                        fold, rw2, 777, sd), 5),
                    bytes=b2, flops=f2, max_abs_err=err2,
                    upload_ms=host_ms(torch, lambda: bk._forecast_args(
                        rows, W, std)),
                    download_ms=host_ms(torch, lambda: bk._np(k2)),
                    backend_call_ms=host_ms(torch, lambda: bk.forecast_noise_z(
                        fold, rows, 777, W, std))),
            }
            for name, m in t.items():
                byte_ms = 1e3 * m["bytes"] / HBM_BYTES_PER_S
                op_ms = 1e3 * m["flops"] / FP32_FLOPS
                m["bound_ms"] = max(byte_ms, op_ms)
                m["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
                m["launches_phase2"] = getattr(ch, name).launches
                emit("kernel", name=name, R=R, W=W, S=S, **m)
            results = dict(t)
        del lv, sl, rw, rw2, sd, k1, k2, p1, p2
        torch.cuda.empty_cache()
    # K2's kernels line: the main path's largest forecast shape (2^20 x 64
    # above is a correctness and throughput case)
    results["forecast_z"] = check_forecast_cases(torch, bk, host, fold)
    return results


# K2 cases against its tiling and walk: name, R, W, first row key, now
K2_CASES = [
    ("W 60, the main path's d_max", FULL_R, 60, 0, 777),
    ("W 61", 100_003, 61, 0, 777),
    ("R off the row tile", 1001, 64, 0, 777),
    ("row keys >= 2^63", 4099, 60, 2 ** 63 + 12_345, 777),
    ("now near 2^44", 4096, 60, 0, 2 ** 44 - 3),
]


# the main path's commonest forecast shapes (R, W), read once from the
# main_path phase's window_top_shapes (PERF.md §6): a tie of
# forecast_noise_z at 10 x 60 and at 1024 x 60, 34 of its 395 calls each
K2_MAIN_SHAPES = ((10, 60), (1024, 60))


def check_forecast_cases(torch, bk, host, fold):
    """K2 at K2_CASES, each equal to its plain version on the card and to
    the NumPy reference on the host (tolerance 0); then checked and timed
    at K2_MAIN_SHAPES. Returns the largest of those shapes' lines."""
    from repro_torch.kernels import counter_hash as ch

    for name, R, W, row0, now in K2_CASES:
        rows = (np.uint64(row0) + np.arange(R, dtype=np.uint64))
        std = std_lead(W)
        rw, sd = bk._forecast_args(rows, W, std)
        n0 = ch.forecast_z.launches
        got = ch.forecast_z(fold, rw, now, sd)
        torch.cuda.synchronize()
        require(ch.forecast_z.launches == n0 + 1, "K2 did not count")
        plain = ch.forecast_z_plain(fold, rw, now, sd)
        want = host.forecast_noise_z(fold, rows, now, W, std)
        eq_plain = bool(torch.equal(got, plain))
        eq_numpy = bool(np.array_equal(got.cpu().numpy(), want))
        emit("kernel_case", name="forecast_z", case=name, R=R, W=W,
             row0=row0, now=now, equal_plain=eq_plain, equal_numpy=eq_numpy,
             max_abs_err=float((got - plain).abs().max()))
        require(eq_plain and eq_numpy, f"K2 != plain or numpy: {name}")
        del rw, sd, got, plain
    torch.cuda.empty_cache()
    line = None
    for R, W in sorted(K2_MAIN_SHAPES, key=lambda rw: rw[0] * rw[1]):
        rows = np.arange(R, dtype=np.uint64)
        rw, sd = bk._forecast_args(rows, W, std_lead(W))
        got = ch.forecast_z(fold, rw, 777, sd)
        plain = ch.forecast_z_plain(fold, rw, 777, sd)
        require(torch.equal(got, plain), f"K2 != plain at {R}x{W}")
        nbytes = R * 8 + W * 4 + R * W * 4
        line = dict(
            ms=cuda_ms(torch, lambda: ch.forecast_z(fold, rw, 777, sd), 50),
            plain_ms=cuda_ms(torch, lambda: ch.forecast_z_plain(
                fold, rw, 777, sd), 20),
            max_abs_err=float((got - plain).abs().max()), bytes=nbytes,
            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")
        emit("kernel", name="forecast_z", case="main path shape", R=R, W=W,
             **line)
    return line


# --------------------------------------------------------------------------
# phase 3: backend ops


def check_ops(torch, bk, host):
    from repro_torch.kernels.counter_hash import i64

    eq = np.testing.assert_array_equal
    rng = np.random.default_rng(1)
    # int64 multiplies wrap on the card exactly as uint64 does on the host
    a = rng.integers(0, 2 ** 63, 4096, dtype=np.int64).astype(np.uint64)
    a[0] = np.uint64(2 ** 64 - 1)
    m = np.uint64(0xFF51AFD7ED558CCD)
    with np.errstate(over="ignore"):
        want = (a * m).view(np.int64)
    got = (torch.from_numpy(a.view(np.int64)).to(bk.device) * i64(m)).cpu()
    eq(want, got.numpy())

    x = rng.integers(0, 2 ** 63, 70_000, dtype=np.int64).astype(np.uint64)
    fold = np.uint64(0x9E3779B97F4A7C15)
    eq(host.sm64(x), bk.sm64(x))
    eq(host.u01(x), bk.u01(x))
    eq(host.cheap_u01(fold, x), bk.cheap_u01(fold, x))
    keys = rng.integers(0, 10 ** 9, (257, 3)).astype(np.uint64)
    eq(host.hash64(42, 201, keys, keys[::-1]), bk.hash64(42, 201, keys,
                                                         keys[::-1]))
    R, W = 5000, 64
    rows = np.sort(rng.choice(10 ** 6, R, replace=False)).astype(np.int64)
    t_grid = 10_000 + np.arange(W)
    eq(host.cell_noise(fold, rows, t_grid), bk.cell_noise(fold, rows, t_grid))
    levels, slot, _ = window_case(rng, R, 5, W)
    eq(host.synth_window(levels.copy(), slot, fold, rows, 10_000, 0.1732),
       bk.synth_window(levels.copy(), slot, fold, rows, 10_000, 0.1732))
    std = std_lead(W)
    eq(host.forecast_noise_z(fold, rows, 777, W, std),
       bk.forecast_noise_z(fold, rows, 777, W, std))

    B, d, P = 6000, 60, 10
    spare = rng.random((B, d)) * 5
    budgets = rng.random((P, d)) * 300
    dom = rng.integers(0, P, B)
    delta = 0.5 + rng.random(B) * 3
    eq(host.take_matrix(spare, budgets[dom], delta),
       bk.take_matrix(spare, budgets[dom], delta))
    eq(host.take_reach(spare, budgets[dom], delta),
       bk.take_reach(spare, budgets[dom], delta))
    sigma, reach = rng.random(B), rng.random(B) * 100
    m_min, m_max = rng.random(B) * 20, 20 + rng.random(B) * 80
    for u, v in zip(host.greedy_scores(sigma, reach, m_min, m_max),
                    bk.greedy_scores(sigma, reach, m_min, m_max)):
        eq(u, v)

    K, M = 9000, 256
    cols = dict(delta=0.5 + rng.random(K) * 3, m_min=rng.random(K) * 12,
                m_max=30 + rng.random(K) * 50, sigma=rng.random(K),
                spare_ub=rng.random(K) * 4, dom=rng.integers(0, P, K))
    excess = rng.random(P) * 400
    excess[0] = 0.0
    for dd in (1.0, 17.0, 60.0):
        ua, na = host.score_ub(host.fleet_cols(**cols), excess, dd)
        hb, nb = bk.score_ub(bk.fleet_cols(**cols), excess, dd)
        require(na == nb, "score_ub viable count")
        eq(ua, bk.asnumpy(hb))
        eq(host.viable_positions(ua), bk.viable_positions(hb))
        ia, ba = host.top_m(ua, M)
        ib, bb = bk.top_m(hb, M)
        eq(np.sort(ia), np.sort(ib))
        require(ba == bb, "top_m bound")
    # forced ties straddling M, and a wall-to-wall plateau
    for ub in (np.where(rng.random(2000) < 0.5, 3.5, 1.25),
               np.full(20000, 36.75)):
        ub[rng.integers(0, ub.size, 64)] = -np.inf
        for M in (1, 40, 512):
            ia, ba = host.top_m(host.adopt_scores(ub), M)
            ib, bb = bk.top_m(bk.adopt_scores(ub), M)
            eq(np.sort(ia), np.sort(ib))
            require(ba == bb, "top_m tie bound")

    drain = rng.random((5000, 32)) * 2
    dsel = np.sort(rng.integers(0, 8, 5000))
    bud = rng.random((8, 32)) * drain.sum(0).mean() * 0.1
    bud[3, 5] = -1e-12
    eq(host.margin_prefix_ok(drain, dsel, bud),
       bk.margin_prefix_ok(drain, dsel, bud))
    m_max2 = m_min + rng.random(B) * 60
    fa, oa, ca = host.admit_domains(spare, budgets / 20, dom, delta, m_min,
                                    m_max2)
    fb, ob, cb = bk.admit_domains(spare, budgets / 20, dom, delta, m_min,
                                  m_max2)
    eq(fa, fb)
    eq(oa[fa], ob[fa])
    eq(ca, cb)

    Pr, H, N = 8, 60, 9000
    r_ex = rng.integers(0, 64, size=(Pr, H)) / 8.0
    r_ex[3, :10] = r_ex[3, 10]
    ta, tb = host.reach_tables(r_ex), bk.reach_tables(r_ex)
    sdom = rng.integers(0, Pr, N)
    sa = rng.integers(0, H + 1, N)
    sb = np.minimum(sa + rng.integers(0, H + 1, N), H)
    w = rng.integers(0, 80, N) / 8.0
    eq(host.segment_reach(ta, sdom, sa, sb, w),
       bk.segment_reach(tb, sdom, sa, sb, w))
    Kk = 5000
    lens = rng.integers(1, 4, size=Kk)
    owner = np.repeat(np.arange(Kk), lens)
    S = owner.size
    a0 = rng.integers(0, 24, size=S)
    seg = {"a": a0, "b": np.minimum(a0 + rng.integers(1, 24, size=S), 24),
           "x": rng.random(S), "owner": owner,
           "dom": rng.integers(0, 3, size=Kk)[owner],
           "capd": 1.0 + rng.random(S)}
    kept = {"delta": 1.0 + rng.random(Kk), "m_min": 1.0 + rng.random(Kk),
            "m_max": 5.0 + rng.random(Kk), "sigma": rng.random(Kk) + 0.1,
            "dom": rng.integers(0, 3, size=Kk)}
    rx = rng.random((3, 24)) * 100
    nu = 1.0 + 0.1 * rng.random(24)
    st_a = host.reach_state(rx, seg=seg, kept=kept, noise_mult_ub=nu)
    st_b = bk.reach_state(rx, seg=seg, kept=kept, noise_mult_ub=nu)
    keep = rng.random(Kk) > 0.4
    pairs = [(st_a, st_b), (host.reach_state_subset(st_a, keep),
                            bk.reach_state_subset(st_b, keep))]
    for dd in (1, 12, 24):
        for u, v in pairs:
            ua, na = host.probe_scores(u, dd, rx[:, dd - 1])
            ub_, nb = bk.probe_scores(v, dd, rx[:, dd - 1])
            require(na == nb, "probe viable count")
            eq(ua, ub_)


# --------------------------------------------------------------------------
# phase 6: K3 flash attention


def attn_case(torch, gen, B, H, KV, S, Sk, dh, dtype):
    """q, k, v as the model passes them: [B, S, H, dh] activations seen as
    [B, H, S, dh] through a transpose (no copy)."""
    dev = gen.device

    def one(n, heads):
        x = torch.randn((B, n, heads, dh), generator=gen, device=dev)
        return x.to(dtype).transpose(1, 2)
    return one(S, H), one(Sk, KV), one(Sk, KV)


def check_flash_attention(torch):
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(torch.device("cuda:0")).manual_seed(3)
    timed, bad = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = ATTN_TOL[str(dtype)]
        for name, B, H, KV, S, Sk, dh, causal, window in K3_CASES:
            q, k, v = attn_case(torch, gen, B, H, KV, S, Sk, dh, dtype)
            n0 = fa.flash_attention.launches
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            require(fa.flash_attention.launches == n0 + 1, "K3 did not count")
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            # the largest error in units of its limit: <= 1 passes
            ratio = float((diff / (atol + rtol * want.float().abs())).max())
            line = dict(name="flash_attention", case=name, dtype=str(dtype),
                        B=B, H=H, KV=KV, S=S, Sk=Sk, dh=dh, causal=causal,
                        window=window, max_abs_err=err, atol=atol, rtol=rtol,
                        err_over_limit=ratio,
                        rms_out=float(want.float().pow(2).mean().sqrt()))
            ok = ratio <= 1.0
            if name in K3_TIMED:
                flops = 4 * B * H * attn_pairs(S, Sk, causal, window) * dh
                nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
                    * q.element_size()
                peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
                op_ms = 1e3 * flops / peak
                byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
                lib = sdpa(torch, q, k, v, causal, window)
                line.update(
                    ms=cuda_ms(torch, lambda: fa.flash_attention(
                        q, k, v, causal=causal, window=window), 10),
                    plain_ms=cuda_ms(torch, lambda: fa.flash_attention_plain(
                        q, k, v, causal=causal, window=window), 3),
                    library_ms=cuda_ms(torch, lambda: sdpa(
                        torch, q, k, v, causal, window), 10),
                    library_max_abs_err=float(
                        (lib.float() - want.float()).abs().max()),
                    flops=flops, bytes=nbytes, bound_ms=max(op_ms, byte_ms),
                    bound_by="operations" if op_ms >= byte_ms else "bytes")
                line["tflops"] = flops / line["ms"] / 1e9
                line["bound_share"] = line["bound_ms"] / line["ms"]
                line["k3_over_library"] = line["ms"] / line["library_ms"]
                if dtype == torch.bfloat16:
                    # what the bf16 kernel issues: Q K^T and P V on both
                    # parts of P over every key tile it visits
                    issued = k3_issued_flops(B, H, S, Sk, dh, causal, window)
                    line.update(issued_flops=issued,
                                issued_floor_ms=1e3 * issued / BF16_FLOPS,
                                issued_tflops=issued / line["ms"] / 1e9)
                timed[(name, str(dtype))] = line
                del lib
            emit("kernel", **line)
            if not ok:  # NaN fails too
                bad.append(f"{name} {dtype}: max_abs_err {err}, {ratio} x "
                           "the limit")
            del q, k, v, out, want, diff
            torch.cuda.empty_cache()
    bad += check_k3_mla(torch, gen, timed)
    # every case runs and reports before a failure stops the phase
    require(not bad, f"K3 != plain: {bad}")
    return timed


def mla_case(torch, gen, B, H, S):
    """q [B, S, H, 192]; k = [k_nope | the one k_pe broadcast] made whole;
    v a view of the [k_nope | v] product's last 128 columns; each seen as
    [B, H, S, .] through a transpose, as ``mla_train`` passes them."""
    dev = gen.device
    q = torch.randn((B, S, H, 192), generator=gen, device=dev).bfloat16()
    kv = torch.randn((B, S, H, 256), generator=gen, device=dev).bfloat16()
    pe = torch.randn((B, S, 1, 64), generator=gen, device=dev).bfloat16()
    k = torch.cat([kv[..., :128], pe.expand(B, S, H, 64)], dim=-1)
    return q.transpose(1, 2), k.transpose(1, 2), kv[..., 128:].transpose(1, 2)


def check_k3_mla(torch, gen, timed):
    """K3 at q/k 192, v 128 (``K3_MLA``): against the plain version on
    batch row 0's first 4 heads, then timed with SDPA beside it (where
    SDPA takes q/k and v of two widths). Returns the failures."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    atol, rtol = ATTN_TOL["torch.bfloat16"]
    bad = []
    for name, B, H, S in K3_MLA:
        q, k, v = mla_case(torch, gen, B, H, S)
        out = fa.flash_attention(q, k, v, causal=True, scale=K3_MLA_SCALE)
        part = [t[:1, :4] for t in (q, k, v)]
        want = fa.flash_attention_plain(*part, causal=True,
                                        scale=K3_MLA_SCALE).float()
        diff = (out[:1, :4].float() - want).abs()
        ratio = float((diff / (atol + rtol * want.abs())).max())
        pairs = attn_pairs(S, S, True, 0)
        flops = 2 * (192 + 128) * B * H * pairs
        nbytes = 2 * B * H * S * (2 * 192 + 2 * 128)
        ms = cuda_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, scale=K3_MLA_SCALE), 10)
        try:
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=K3_MLA_SCALE), 10)
        except RuntimeError as e:  # no SDPA backend for these widths
            lib_ms = f"{type(e).__name__}: {str(e)[:120]}"
        op_ms = 1e3 * flops / BF16_FLOPS
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        line = dict(name="flash_attention", case=name, dtype="torch.bfloat16",
                    B=B, H=H, KV=H, S=S, Sk=S, dh=192, dv=128, causal=True,
                    window=0, max_abs_err=float(diff.max()), atol=atol,
                    rtol=rtol, err_over_limit=ratio, checked="b 0, h 0-3",
                    ms=ms, library_ms=lib_ms, flops=flops, bytes=nbytes,
                    bound_ms=max(op_ms, byte_ms),
                    bound_by="operations" if op_ms >= byte_ms else "bytes",
                    tflops=flops / ms / 1e9,
                    bound_share=max(op_ms, byte_ms) / ms)
        timed[(name, "torch.bfloat16")] = line
        emit("kernel", **line)
        if not ratio <= 1.0:
            bad.append(f"{name}: max_abs_err {float(diff.max())}, {ratio} x "
                       "the limit")
        del q, k, v, out, part, want, diff
        torch.cuda.empty_cache()
    return bad


def attn_pairs(S, Sk, causal, window) -> int:
    """The (query, key) pairs that attention keeps: every pair, or up to
    each query's key-aligned position (Sk - S + i), within ``window`` keys
    of it when one is given."""
    if not causal:
        return S * Sk
    kept = np.arange(Sk - S, Sk, dtype=np.int64) + 1
    if window > 0:
        kept = np.minimum(kept, window)
    return int(kept.sum())


def sdpa(torch, q, k, v, causal, window):
    """``scaled_dot_product_attention`` of the same function as K3: a
    window narrower than the keys goes in as a boolean mask (SDPA has no
    window argument), the queries aligned to the end of the keys."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    S, Sk = q.shape[2], k.shape[2]
    if causal and (window > 0 and window < Sk or S != Sk):
        keep = fa._keep(S, Sk, causal, window, q.device)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def k3_issued_flops(B, H, S, Sk, dh, causal, window, tile=128):
    """Tensor-core FLOPs the bf16 K3 issues: per visited tile of 128
    queries x 128 keys, Q K^T over dh and P V twice (P's hi and lo parts).
    The tiles it visits are those of its walk (csrc/flash_attention.cu,
    Item): up to the causal frontier, from the window's first key."""
    tiles = 0
    for q0 in range(0, S, tile):
        first, last = 0, (Sk - 1) // tile
        if causal:
            q_lo = q0 + Sk - S
            last = min(last, (min(q0 + tile, S) - 1 + Sk - S) // tile)
            if window > 0 and q_lo - window + 1 > 0:
                first = (q_lo - window + 1) // tile
        tiles += last - first + 1
    return 3 * 2 * B * H * tiles * tile * tile * dh


# --------------------------------------------------------------------------
# phase 7: llama3.2-3b inference


def logits_agree(torch, a, b, rel_tol=LOGIT_TOL):
    """max |a - b|, that over max |b|, and the greedy gap: how far below
    b's largest logit b puts a's greedy token (or a puts b's), at most
    over the rows. Both must be within rel_tol * max |b|."""
    a, b = a.float()[:, -1], b.float()[:, -1]
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    tol = rel_tol * scale
    ia, ib = a.argmax(-1), b.argmax(-1)
    gap = torch.maximum(b.max(-1).values - b.gather(-1, ia[:, None])[:, 0],
                        a.max(-1).values - a.gather(-1, ib[:, None])[:, 0])
    gap = float(gap.max())
    return {"max_abs_diff": diff, "rel_diff": diff / scale, "tol": tol,
            "greedy_equal": int((ia == ib).sum()), "greedy_gap": gap,
            "rows": int(a.shape[0]), "ok": diff <= tol and gap <= tol}


def cache_agree(torch, a, b, slot, rel_tol=CACHE_TOL):
    """K and V of cache ``a`` against ``b`` ([L, B, C, KV, dh]): max |a - b|
    over max |b| at ``slot`` and over every other slot (those before it,
    and in a ring buffer that has wrapped those after it), each within
    ``rel_tol``, and whether the lengths are equal."""
    out = {"length_equal": bool(torch.equal(a.length, b.length))}
    C = a.k.shape[2]
    for name in ("k", "v"):
        x, y = getattr(a, name), getattr(b, name)
        for part, sls in (("new_slot", [slice(slot, slot + 1)]),
                          ("old_slots", [slice(0, slot),
                                         slice(slot + 1, C)])):
            diff, scale = [], []
            for sl in sls:
                if sl.stop > sl.start:
                    xs, ys = x[:, :, sl].float(), y[:, :, sl].float()
                    diff.append((xs - ys).abs().max())
                    scale.append(ys.abs().max())
                    del xs, ys
            # torch's max, not Python's, so that a NaN carries through
            out[f"{name}_{part}"] = float(torch.stack(diff).max()
                                          / torch.stack(scale).max())
    out["ok"] = out["length_equal"] and all(
        v <= rel_tol for k, v in out.items() if k.endswith("slot")
        or k.endswith("slots"))
    return out


def run_model(torch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import inference_demo as demo

    dev = torch.device("cuda:0")
    B, P, gen = LLAMA["batch"], LLAMA["prompt"], LLAMA["gen"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(LLAMA["arch"], False, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        require(model.use_kernels, "the demo's model is not on K3")
        prompts = demo.make_prompts(cfg, B, P, 0, dev)
        demo.generate(model, prompts[:, :256], 2)       # warm-up

        # the main path: counts from zero, driven once, read right after
        fa.flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = demo.generate(model, prompts, gen)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tokens = out["tokens"].cpu().numpy()
        finite = bool(torch.isfinite(out["logits"]).all())

        # the same weights on the einsum route
        model.use_kernels = False
        t_e = host_ms(torch, lambda: model.prefill(prompts, P + gen), 1)
        ein, _ = model.prefill(prompts, P + gen)
        model.use_kernels = True
        t_k = host_ms(torch, lambda: model.prefill(prompts, P + gen), 1)
        route = logits_agree(torch, out["logits"], ein)
        finite_einsum = all_finite(torch, ein)
        del ein
        # the cache: decode_step after prefill(S - 1) against prefill(S)
        _, cache = model.prefill(prompts[:, :-1], P)
        dec, cache = model.decode_step(cache, prompts[:, -1:])
        decode = logits_agree(torch, dec, out["logits"])
        _, full = model.prefill(prompts, P)
        kv = cache_agree(torch, cache, full, P - 1)
        del cache, full
    n_params = sum(p.numel() for p in model.parameters())
    result = dict(
        arch=cfg.name, batch=B, prompt=P, gen=gen, n_layers=cfg.n_layers,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_heads_padded,
                                    cfg.n_kv_heads_padded],
        d_head=cfg.d_head, vocab=cfg.vocab, dtype=str(cfg.dtype),
        params=n_params, init_s=init_s, prefill_ms=1e3 * out["prefill_s"],
        decode_s=out["decode_s"],
        decode_tok_per_s=(gen - 1) * B / out["decode_s"],
        prefill_ms_k3_route=t_k, prefill_ms_einsum_route=t_e,
        k3_launches=launches, max_memory_allocated=peak,
        logits_finite=finite, logits_finite_einsum=finite_einsum,
        k3_vs_einsum=route, decode_vs_prefill=decode,
        cache_vs_prefill=kv,
        sample=tokens[0].tolist())
    emit("model", **result)
    require(finite and finite_einsum, "non-finite logits")
    require(tokens.shape == (B, gen), f"generated {tokens.shape}")
    require(launches == cfg.n_layers,
            f"K3 launched {launches} times in one prefill, want "
            f"{cfg.n_layers}")
    require(route["ok"], f"K3 route != einsum route: {route}")
    require(decode["ok"], f"decode_step != prefill: {decode}")
    require(kv["ok"], f"decode_step's cache != prefill's: {kv}")
    del model
    torch.cuda.empty_cache()
    return result


# --------------------------------------------------------------------------
# phase 8: K4 rwkv scan


def scan_case(torch, gen, B, S, H, dh, logit_mean=-0.5):
    """r, k, v, w [B, S, H, dh] and u [H, dh] in float32, as the model makes
    them: unit-scale projections, w = exp(-exp(logit)) with logit around
    ``logit_mean`` +- 0.6 (the model's init: -0.5), u at the fan-in scale
    of its init."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k, v = (randn(B, S, H, dh) for _ in range(3))
    w = torch.exp(-torch.exp(logit_mean + 0.6 * randn(B, S, H, dh)))
    return r, k, v, w, randn(H, dh) / dh ** 0.5


# K4 cases: name, B, S, H, dh, dtype of r/k/v, decay logit mean. Logit
# mean +2 is a trained model's strong decay: w ~ 6e-4 a step, 2^-340 over
# a chunk; -4 a weak one (w ~ 0.98, ~0.5 over a chunk), where the state
# carried across chunks and groups matters (at -0.5 a chunk forgets it,
# ~2^-33). The B H streams of the B 4 cases fill the card (one group a
# stream, the serial chunk walk); the others take several groups a stream.
# K4_TIMED are timed; the first, in the model's dtype, is the kernels
# line's.
K4_CASES = [
    ("rwkv6-1.6b prefill", 4, 2048, 32, 64, "float32", -0.5),
    ("rwkv6-1.6b prefill, bf16 r/k/v", 4, 2048, 32, 64, "bfloat16", -0.5),
    ("strong decay", 4, 2048, 32, 64, "float32", 2.0),
    ("weak decay", 4, 2048, 32, 64, "float32", -4.0),
    ("rwkv6-1.6b prefill, batch 1", 1, 2048, 32, 64, "bfloat16", -0.5),
    ("weak decay, batch 1", 1, 2048, 32, 64, "bfloat16", -4.0),
    ("ragged S 2047", 4, 2047, 32, 64, "float32", -0.5),
    ("S 1", 4, 1, 32, 64, "float32", -0.5),
    ("S 17", 2, 17, 4, 64, "float32", -0.5),
    ("S 33", 2, 33, 4, 64, "bfloat16", -0.5),
    ("S 129, weak decay", 2, 129, 4, 64, "float32", -4.0),
    ("S 300, weak decay", 2, 300, 3, 64, "bfloat16", -4.0),
    ("dh 32", 2, 300, 4, 32, "float32", -0.5),
    ("dh 16", 2, 77, 3, 16, "float32", -0.5),
]
K4_TIMED = ("rwkv6-1.6b prefill, bf16 r/k/v", "rwkv6-1.6b prefill",
            "rwkv6-1.6b prefill, batch 1")


def check_rwkv_scan(torch):
    from repro_torch.kernels import rwkv_scan as k4

    gen = torch.Generator(torch.device("cuda:0")).manual_seed(4)
    atol, rtol = K4_TOL
    full = None
    for name, B, S, H, dh, dtype, mean in K4_CASES:
        r, k, v, w, u = scan_case(torch, gen, B, S, H, dh, mean)
        r, k, v = (x.to(getattr(torch, dtype)) for x in (r, k, v))
        args = (r, k, v, w, u)
        n0 = k4.rwkv_scan.launches
        out, state = k4.rwkv_scan(*args, return_state=True)
        torch.cuda.synchronize()
        require(k4.rwkv_scan.launches == n0 + k4.kernel_launches(B, H, S),
                "K4 did not count")
        want, want_state = k4.rwkv_scan_plain(r.float(), k.float(),
                                              v.float(), w, u)
        line = dict(name="rwkv_scan", case=name, B=B, S=S, H=H, dh=dh,
                    dtype=dtype, logit_mean=mean, atol=atol, rtol=rtol,
                    groups=k4.groups(B, H, S),
                    finite=all_finite(torch, out, state))
        ratio = 0.0
        for part, got, ref in (("out", out, want), ("state", state,
                                                    want_state)):
            diff = (got - ref).abs()
            r_ = float((diff / (atol + rtol * ref.abs())).max())
            line.update({f"max_abs_err_{part}": float(diff.max()),
                         f"err_over_limit_{part}": r_,
                         f"rms_{part}": float(ref.pow(2).mean().sqrt())})
            ratio = r_ if not r_ <= ratio else ratio  # NaN is kept
        line["max_abs_err"] = max(line["max_abs_err_out"],
                                  line["max_abs_err_state"])
        if name in K4_TIMED:
            # each input read once, the output and the final state written
            # once; about 6 dh^2 operations per token and stream, on the
            # tensor cores as three TF32 products each
            nbytes = (sum(x.numel() * x.element_size() for x in args)
                      + (out.numel() + state.numel()) * 4)
            flops = 6 * B * S * H * dh * dh
            op_ms = 1e3 * 3 * flops / TF32_FLOPS
            byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            line.update(
                ms=cuda_ms(torch, lambda: k4.rwkv_scan(
                    *args, return_state=True), 10),
                plain_ms=cuda_ms(torch, lambda: k4.rwkv_scan_plain(
                    r.float(), k.float(), v.float(), w, u), 3, warmup=1),
                library_ms=None, flops=flops, bytes=nbytes,
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")
            if name == K4_TIMED[0]:
                full = line
        emit("kernel", **line)
        require(line["finite"], f"K4 output or state not finite: {name}")
        require(ratio <= 1.0, f"K4 != plain: {name}, max_abs_err "
                f"{line['max_abs_err']}, {ratio} x the limit")
        del args, r, k, v, w, u, out, state, want, want_state
        torch.cuda.empty_cache()
    return full


# --------------------------------------------------------------------------
# phase 9: rwkv6-1.6b inference


def both_routes(torch, model, prompts, cache_len):
    """prefill on the plain route, then on the K4 route: ((logits, state)
    of each) and the host ms of each."""
    model.use_kernels = False
    t_p = host_ms(torch, lambda: model.prefill(prompts, cache_len), 1)
    plain = model.prefill(prompts, cache_len)
    model.use_kernels = True
    t_k = host_ms(torch, lambda: model.prefill(prompts, cache_len), 1)
    return plain, model.prefill(prompts, cache_len), t_p, t_k


def state_agree(torch, a, b, rel_tol):
    """Each tensor of RWKVState ``a`` against ``b`` ([L, ...] stacked), layer
    by layer: max |a - b| over max |b|; the largest over the layers must be
    within ``rel_tol`` (None: reported only)."""
    out = {}
    for name in ("S", "shift", "shift_cm"):
        x, y = getattr(a, name).float(), getattr(b, name).float()
        per_layer = [float((x[i] - y[i]).abs().max() / y[i].abs().max())
                     for i in range(x.shape[0])]
        out[name] = {"max": float(np.max(per_layer)),  # a NaN is kept
                     "per_layer": per_layer}
    out["ok"] = rel_tol is None or all(out[n]["max"] <= rel_tol
                                       for n in ("S", "shift", "shift_cm"))
    return out


def run_rwkv(torch):
    from repro_torch.kernels import rwkv_scan as k4
    from repro_torch.launch import inference_demo as demo
    from repro_torch.models import build_model

    dev = torch.device("cuda:0")
    B, P, gen = RWKV["batch"], RWKV["prompt"], RWKV["gen"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(RWKV["arch"], False, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        require(model.use_kernels, "the demo's model is not on K4")
        prompts = demo.make_prompts(cfg, B, P, 0, dev)
        demo.generate(model, prompts[:, :256], 2)       # warm-up

        # the main path: counts from zero, driven once, read right after
        k4.rwkv_scan.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = demo.generate(model, prompts, gen)
        launches = k4.rwkv_scan.launches
        peak = torch.cuda.max_memory_allocated()
        tokens = out["tokens"].cpu().numpy()
        finite = bool(torch.isfinite(out["logits"]).all())

        # the same weights on the plain route (the per-token recurrence)
        (plain, plain_st), (kern, kern_st), t_p, t_k = both_routes(
            torch, model, prompts, P + gen)
        route = logits_agree(torch, kern, plain, RWKV_ROUTE_TOL)
        route_state = state_agree(torch, kern_st, plain_st, None)
        # both routes' logits and final states
        finite_routes = all_finite(torch, kern, plain, *kern_st, *plain_st)
        del plain, plain_st, kern, kern_st
        # the state: decode_step after prefill(S - 1) against prefill(S)
        _, state = model.prefill(prompts[:, :-1], P)
        dec, state = model.decode_step(state, prompts[:, -1:])
        decode = logits_agree(torch, dec, out["logits"], RWKV_LOGIT_TOL)
        _, full = model.prefill(prompts, P)
        st = state_agree(torch, state, full, RWKV_STATE_TOL)
        del state, full
        # the routes again in float32, on the same weights
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                    param_dtype=torch.float32)
        m32 = build_model(cfg32, device=dev)
        m32.load_state_dict({k: v.float()
                             for k, v in model.state_dict().items()})
        (plain, plain_st), (kern, kern_st), t_p32, t_k32 = both_routes(
            torch, m32, prompts, P + gen)
        route32 = logits_agree(torch, kern, plain, RWKV_F32_TOL)
        route32_state = state_agree(torch, kern_st, plain_st, RWKV_F32_TOL)
        finite_routes32 = all_finite(torch, kern, plain, *kern_st, *plain_st)
        del m32, plain, plain_st, kern, kern_st
    n_params = sum(p.numel() for p in model.parameters())
    result = dict(
        arch=cfg.name, batch=B, prompt=P, gen=gen, n_layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, d_head=cfg.d_head,
        d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=str(cfg.dtype),
        params=n_params, init_s=init_s, prefill_ms=1e3 * out["prefill_s"],
        decode_s=out["decode_s"],
        decode_tok_per_s=(gen - 1) * B / out["decode_s"],
        prefill_ms_k4_route=t_k, prefill_ms_plain_route=t_p,
        k4_launches=launches, max_memory_allocated=peak,
        logits_finite=finite, routes_finite=[finite_routes, finite_routes32],
        k4_vs_plain=route,
        k4_vs_plain_state=route_state, decode_vs_prefill=decode,
        state_vs_prefill=st, f32_prefill_ms_k4_route=t_k32,
        f32_prefill_ms_plain_route=t_p32, f32_k4_vs_plain=route32,
        f32_k4_vs_plain_state=route32_state, sample=tokens[0].tolist())
    emit("rwkv", **result)
    require(finite, "non-finite logits")
    require(finite_routes and finite_routes32,
            "non-finite logits or final state on the K4 or plain route")
    require(tokens.shape == (B, gen), f"generated {tokens.shape}")
    want_launches = cfg.n_layers * k4.kernel_launches(B, cfg.n_heads, P)
    require(launches == want_launches,
            f"K4 launched {launches} times in one prefill, want "
            f"{want_launches}")
    require(route["ok"], f"K4 route != plain route: {route}")
    require(decode["ok"], f"decode_step != prefill: {decode}")
    require(st["ok"], f"decode_step's state != prefill's: {st}")
    require(route32["ok"] and route32_state["ok"],
            f"K4 route != plain route in float32: {route32}, "
            f"{route32_state}")
    del model
    torch.cuda.empty_cache()
    return result


# --------------------------------------------------------------------------
# phase 10: K5 moe_gemm


def check_moe_gemm(torch):
    from repro_torch.kernels import moe_gemm as k5

    gen = torch.Generator(torch.device("cuda:0")).manual_seed(5)
    dev = gen.device
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, E, C, d, f, dtype
        ("mixtral-8x22b prefill w1/w3", 8, 2560, 6144, 16384, bf16),
        ("mixtral-8x22b prefill w2", 8, 2560, 16384, 6144, bf16),
        ("mixtral-8x22b decode w1/w3", 8, 8, 6144, 16384, bf16),
        ("mixtral-8x22b decode w2", 8, 8, 16384, 6144, bf16),
        ("kimi-k2 widths, E 64", 64, 256, 7168, 2048, bf16),
        ("mixtral-8x22b prefill w1/w3 f32", 8, 2560, 6144, 16384, f32),
        ("ragged C 37", 8, 37, 6144, 1024, bf16),
        ("C 64, the largest narrow", 8, 64, 6144, 16384, bf16),
        ("C 65, the smallest wide", 8, 65, 6144, 16384, bf16),
        ("d 1000, not a multiple of a stage, wide", 8, 300, 1000, 2048, bf16),
        ("d 1000, narrow", 8, 8, 1000, 2048, bf16),
        ("f 1032, a ragged last f tile, wide", 8, 300, 2048, 1032, bf16),
        ("f 1032, narrow", 8, 8, 2048, 1032, bf16),
        ("E 1, wide", 1, 2560, 6144, 16384, bf16),
        ("E 1, narrow", 1, 8, 16384, 6144, bf16),
    ]
    first, bad = None, []
    for name, E, C, d, f, dtype in cases:
        atol, rtol = K5_TOL[str(dtype)]
        variant = k5.pick_variant(C) if dtype == bf16 else "f32"
        x = torch.randn((E, C, d), generator=gen, device=dev).to(dtype)
        w = (torch.randn((E, d, f), generator=gen, device=dev)
             / d ** 0.5).to(dtype)
        n0 = k5.moe_gemm.launches
        v0 = k5.moe_gemm.variant_launches[variant]
        out = k5.moe_gemm(x, w)
        torch.cuda.synchronize()
        require(k5.moe_gemm.launches == n0 + 1
                and k5.moe_gemm.variant_launches[variant] == v0 + 1,
                f"K5 did not count a {variant} launch")
        want = k5.moe_gemm_plain(x, w)
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        ratio = float((diff / (atol + rtol * want.float().abs())).max())
        del diff
        lib = torch.bmm(x, w)
        lib_err = float((lib.float() - want.float()).abs().max())
        k5_vs_lib = float((out.float() - lib.float()).abs().max())
        k5_equals_lib = bool(torch.equal(out, lib))
        del lib
        flops = 2 * E * C * d * f
        nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size()
        peak = BF16_FLOPS if dtype == bf16 else FP32_FLOPS
        op_ms = 1e3 * flops / peak
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        iters = 3 if dtype == f32 else 10
        line = dict(
            name="moe_gemm", case=name, variant=variant, dtype=str(dtype),
            E=E, C=C, d=d, f=f,
            max_abs_err=err, atol=atol, rtol=rtol, err_over_limit=ratio,
            rms_out=float(want.float().pow(2).mean().sqrt()),
            ms=cuda_ms(torch, lambda: k5.moe_gemm(x, w), iters),
            plain_ms=cuda_ms(torch, lambda: k5.moe_gemm_plain(x, w), 3,
                             warmup=1),
            library_ms=cuda_ms(torch, lambda: torch.bmm(x, w), iters),
            library_max_abs_err=lib_err, k5_vs_library_max_abs_err=k5_vs_lib,
            k5_equals_library=k5_equals_lib, flops=flops, bytes=nbytes,
            bound_ms=max(op_ms, byte_ms),
            bound_by="operations" if op_ms >= byte_ms else "bytes")
        line["bound_share"] = line["bound_ms"] / line["ms"]
        line["k5_over_library"] = line["ms"] / line["library_ms"]
        line["tflops"] = flops / line["ms"] / 1e9
        line["gb_per_s"] = nbytes / line["ms"] / 1e6
        emit("kernel", **line)
        if not ratio <= 1.0:  # NaN fails too
            bad.append(f"{name}: max_abs_err {err}, {ratio} x the limit")
        if first is None:
            first = line
        del x, w, out, want
        torch.cuda.empty_cache()
    # every case runs and reports before a failure stops the phase
    require(not bad, f"K5 != plain: {bad}")
    check_k5_crossover(torch, k5, gen)
    check_k5_routed(torch, k5, gen)
    return first


def check_k5_crossover(torch, k5, gen):
    """Both bf16 kernels, named, at the C that either takes, at mixtral's
    two expert shapes: ms of each and of ``torch.bmm``, each kernel held to
    the plain version within K5_TOL. Where ``narrow`` stops being faster
    is the crossover that ``pick_variant`` encodes."""
    atol, rtol = K5_TOL["torch.bfloat16"]
    for d, f in ((6144, 16384), (16384, 6144)):
        w = (torch.randn((8, d, f), generator=gen, device=gen.device)
             / d ** 0.5).bfloat16()
        for C in (8, 16, 32, 48, 64):
            x = torch.randn((8, C, d), generator=gen,
                            device=gen.device).bfloat16()
            want = k5.moe_gemm_plain(x, w).float()
            line = dict(E=8, C=C, d=d, f=f, picked=k5.pick_variant(C))
            for variant in ("narrow", "wide"):
                got = k5.launch(x, w, variant).float()
                ratio = float(((got - want).abs()
                               / (atol + rtol * want.abs())).max())
                require(ratio <= 1.0, f"K5 {variant} at C {C}, d {d}: "
                        f"{ratio} x the limit")
                line[f"{variant}_err_over_limit"] = ratio
                line[f"{variant}_ms"] = cuda_ms(
                    torch, lambda v=variant: k5.launch(x, w, v), 10)
            line["library_ms"] = cuda_ms(torch, lambda: torch.bmm(x, w), 10)
            emit("k5_crossover", **line)
            del x, want, got
        del w
        torch.cuda.empty_cache()


def check_k5_routed(torch, k5, gen):
    """The routed product at mixtral's dropless prefill (8192 tokens top-2
    over 8 experts, uniformly routed): against the plain version, and on
    the same rows against the dense ``wide`` kernel over the capacity
    buffer [8, 8192, d] (C 256 in each of 32 groups), bit for bit; NaN in
    the padding rows reaches no real row."""
    atol, rtol = K5_TOL["torch.bfloat16"]
    dev, E, T = gen.device, 8, 16384
    n = torch.bincount(torch.randint(0, E, (T,), generator=gen, device=dev),
                       minlength=E)
    seg = (n + k5.ROUTE_ROWS - 1) // k5.ROUTE_ROWS * k5.ROUTE_ROWS
    end = torch.cumsum(seg, 0)
    tiles = torch.cat([end.new_zeros(1), end // k5.ROUTE_ROWS]).int()
    R = T + E * k5.ROUTE_ROWS
    starts, counts = (end - seg).tolist(), n.tolist()
    for d, f in ((6144, 16384), (16384, 6144)):
        w = (torch.randn((E, d, f), generator=gen, device=dev)
             / d ** 0.5).bfloat16()
        dense = torch.zeros((E, 8192, d), dtype=torch.bfloat16, device=dev)
        xr = torch.full((R, d), float("nan"), dtype=torch.bfloat16,
                        device=dev)
        for e in range(E):
            rows = torch.randn((counts[e], d), generator=gen,
                               device=dev).bfloat16()
            dense[e, :counts[e]] = rows
            xr[starts[e]:starts[e] + counts[e]] = rows
        got = k5.moe_gemm_routed(xr, w, tiles)
        ref = k5.launch(dense, w, "wide")
        want = k5.moe_gemm_routed_plain(torch.nan_to_num(xr, nan=0.0), w,
                                        tiles)
        torch.cuda.synchronize()
        ratio, equal, finite = 0.0, True, True
        for e in range(E):
            a, b = starts[e], starts[e] + counts[e]
            g, wt = got[a:b].float(), want[a:b].float()
            ratio = max(ratio, float(((g - wt).abs()
                                      / (atol + rtol * wt.abs())).max()))
            equal = equal and bool(torch.equal(got[a:b],
                                               ref[e, :counts[e]]))
            finite = finite and bool(torch.isfinite(g).all())
        del want, ref
        flops = 2 * T * d * f
        nbytes = (E * d * f + T * (d + f)) * 2
        line = dict(E=E, routed_rows=T, rows=int(end[-1]), d=d, f=f,
                    segments=counts, err_over_limit=ratio,
                    equals_dense_wide=equal, real_rows_finite=finite,
                    ms=cuda_ms(torch, lambda: k5.moe_gemm_routed(xr, w, tiles),
                               10),
                    dense_capacity_ms=cuda_ms(
                        torch, lambda: k5.launch(dense, w, "wide"), 5),
                    bound_ms=1e3 * max(flops / BF16_FLOPS,
                                       nbytes / HBM_BYTES_PER_S))
        line["bound_share"] = line["bound_ms"] / line["ms"]
        emit("k5_routed", **line)
        require(ratio <= 1.0 and equal and finite,
                f"K5 routed at d {d}: {ratio} x the limit, equal to dense "
                f"wide {equal}, real rows finite {finite}")
        del w, dense, xr, got
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 11: mixtral-8x22b inference


def rel_max(a, b):
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def record_moe_inputs(model, prompts, cache_len):
    """One prefill with the MoE layer wrapped: each layer's input and aux."""
    from repro_torch.models import moe as moe_mod
    seen = []
    moe_ffn = moe_mod.moe_ffn

    def recording(params, x, cfg, use_kernels=False):
        y, aux = moe_ffn(params, x, cfg, use_kernels)
        seen.append((x, aux))
        return y, aux
    moe_mod.moe_ffn = recording
    try:
        model.prefill(prompts, cache_len)
    finally:
        moe_mod.moe_ffn = moe_ffn
    return seen


def moe_oracle(torch, p, x, cfg):
    """The MoE layer with no capacity, in float32: each expert's SwiGLU on
    the tokens routed to it (a gather per expert, as a GPU-style dispatch
    does), weighted by the gates and summed per token. The routing is the
    model's (``_route`` on the same grouping): the oracle holds the
    dispatch, the expert products and the combine."""
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_mod
    B, S, d = x.shape
    T = B * S
    G = moe_mod._pick_groups(T)
    _, gate, idx = moe_mod._route(x.reshape(G, T // G, d), p["router"],
                                  cfg.top_k)
    gate, idx = gate.reshape(T, -1), idx.reshape(T, -1)
    xt = x.reshape(T, d).float()
    y = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        xe = xt[tok]
        he = F.silu(xe @ p["w1"][e].float()) * (xe @ p["w3"][e].float())
        y.index_add_(0, tok, (he @ p["w2"][e].float())
                     * gate[tok, slot, None])
    return y.reshape(B, S, d)


def run_moe(torch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as k5
    from repro_torch.launch import inference_demo as demo
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    dev = torch.device("cuda:0")
    B, P, gen = MIXTRAL["batch"], MIXTRAL["prompt"], MIXTRAL["gen"]
    cfg = smoke_config(MIXTRAL["arch"])
    L = cfg.n_layers
    # no token dropped: every expert can take every token of its group
    cfg_all = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(cfg, False, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        require(model.use_kernels, "the demo's model is not on K3/K5")
        prompts = demo.make_prompts(cfg, B, P, 0, dev)
        demo.generate(model, prompts[:, :256], 2)       # warm-up

        # the main path: counts from zero, driven once, read right after
        fa.flash_attention.launches = 0
        k5.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out = demo.generate(model, prompts, gen)
        launches = {"moe_gemm": k5.moe_gemm.launches,
                    "flash_attention": fa.flash_attention.launches}
        k5_variants = dict(k5.moe_gemm.variant_launches)
        peak = torch.cuda.max_memory_allocated()
        tokens = out["tokens"].cpu().numpy()
        finite = bool(torch.isfinite(out["logits"]).all())

        # the launches of one prefill and of one decode step apart
        k5.reset_counts()
        fa.flash_attention.launches = 0
        _, cache = model.prefill(prompts, P + gen)
        per = {"k5_prefill": k5.moe_gemm.launches,
               "k5_prefill_variants": dict(k5.moe_gemm.variant_launches),
               "k3_prefill": fa.flash_attention.launches}
        k5.reset_counts()
        model.decode_step(cache, out["tokens"][:, :1])
        per["k5_decode_step"] = k5.moe_gemm.launches
        per["k5_decode_step_variants"] = dict(k5.moe_gemm.variant_launches)
        del cache

        # per layer, on the layer's own input: the two routes, and (no
        # token dropped) the K5 route against the float32 oracle
        layers = record_moe_inputs(model, prompts, P + gen)
        per_layer = []
        for blk, (h, aux) in zip(model.blocks, layers):
            yk, _ = moe_mod.moe_ffn(blk.moe, h, cfg, use_kernels=True)
            ye, _ = moe_mod.moe_ffn(blk.moe, h, cfg, use_kernels=False)
            route = rel_max(yk, ye)
            del yk, ye
            ya, aux_all = moe_mod.moe_ffn(blk.moe, h, cfg_all,
                                          use_kernels=True)
            want = moe_oracle(torch, blk.moe, h, cfg)
            oracle = rel_max(ya, want)
            per_layer.append({"route": route, "oracle": oracle,
                              "oracle_finite": all_finite(torch, want),
                              "dropped": float(aux["dropped"]),
                              "lb_loss": float(aux["lb_loss"]),
                              "dropped_no_drop_cf": float(aux_all["dropped"])})
            del ya
        del layers
        torch.cuda.empty_cache()

        # the whole model on the einsum route in bf16: reported (a rounding
        # flip can change a router's choice after layer 0)
        model.use_kernels = False
        t_e = host_ms(torch, lambda: model.prefill(prompts, P + gen), 1)
        ein, _ = model.prefill(prompts, P + gen)
        model.use_kernels = True
        t_k = host_ms(torch, lambda: model.prefill(prompts, P + gen), 1)
        route_bf16 = logits_agree(torch, out["logits"], ein, float("inf"))
        finite_einsum = all_finite(torch, ein)
        del ein

        # decode_step after prefill(S - 1) against prefill(S), and its
        # cache, where no token drops (at the published factor prefill(S)
        # runs 32 groups at C 80, prefill(S - 1) 4 groups at C 640)
        model.cfg = cfg_all
        want, full = model.prefill(prompts, P)
        _, cache = model.prefill(prompts[:, :-1], P)
        dec, cache = model.decode_step(cache, prompts[:, -1:])
        decode = logits_agree(torch, dec, want)
        kv = cache_agree(torch, cache, full, P - 1)
        model.cfg = cfg
        del want, full, cache, dec
        n_params = sum(p.numel() for p in model.parameters())

        # float32: a 2-layer full-width copy of the same weights, then the
        # bf16 model freed
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                                    param_dtype=torch.float32)
        m32 = build_model(cfg32, device=dev)
        src = dict(model.named_parameters())
        for name, p in m32.named_parameters():
            p.copy_(src[name])
        del src, model
        torch.cuda.empty_cache()
        m32.use_kernels = False
        t_e32 = host_ms(torch, lambda: m32.prefill(prompts, P + gen), 1)
        ein32, _ = m32.prefill(prompts, P + gen)
        m32.use_kernels = True
        t_k32 = host_ms(torch, lambda: m32.prefill(prompts, P + gen), 1)
        k32, _ = m32.prefill(prompts, P + gen)
        route32 = logits_agree(torch, k32, ein32, MOE_F32_TOL)
        finite32 = all_finite(torch, k32, ein32)
        del m32, ein32, k32
        torch.cuda.empty_cache()

    worst = {k: float(np.max([layer[k] for layer in per_layer]))  # NaN kept
             for k in ("route", "oracle", "dropped_no_drop_cf")}
    oracle_finite = all(layer["oracle_finite"] for layer in per_layer)
    result = dict(
        arch=cfg.name, n_layers=L, n_layers_published=56, batch=B, prompt=P,
        gen=gen, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        d_head=cfg.d_head, window=cfg.window,
        experts=[cfg.n_experts, cfg.top_k], moe_d_ff=cfg.moe_d_ff,
        vocab=cfg.vocab, dtype=str(cfg.dtype), params=n_params,
        init_s=init_s, prefill_ms=1e3 * out["prefill_s"],
        decode_s=out["decode_s"],
        decode_tok_per_s=(gen - 1) * B / out["decode_s"],
        prefill_ms_k5_route=t_k, prefill_ms_einsum_route=t_e,
        k5_over_einsum_prefill=t_k / t_e,
        k5_launches=launches["moe_gemm"], k5_variant_launches=k5_variants,
        k3_launches=launches["flash_attention"], **per,
        max_memory_allocated=peak, logits_finite=finite,
        logits_finite_einsum_f32=[finite_einsum, finite32],
        oracle_finite=oracle_finite,
        dropped_share_published_cf=sum(x["dropped"] for x in per_layer) / L,
        capacity_factor=cfg.capacity_factor,
        no_drop_capacity_factor=cfg_all.capacity_factor,
        per_layer=per_layer, worst=worst, route_tol=MOE_ROUTE_TOL,
        oracle_tol=MOE_ORACLE_TOL, k5_vs_einsum_bf16_model=route_bf16,
        decode_vs_prefill=decode, cache_vs_prefill=kv,
        f32_prefill_ms_k5_route=t_k32, f32_prefill_ms_einsum_route=t_e32,
        f32_k5_vs_einsum=route32, sample=tokens[0].tolist())
    emit("moe", **result)
    require(finite and finite_einsum and finite32,
            "non-finite logits on the K5 or einsum route")
    require(oracle_finite, "non-finite float32 oracle output")
    require(tokens.shape == (B, gen), f"generated {tokens.shape}")
    require(launches["moe_gemm"] == 3 * L * gen,
            f"K5 launched {launches['moe_gemm']} times in one generate, "
            f"want {3 * L * gen}")
    require(per["k5_prefill"] == 3 * L and per["k5_decode_step"] == 3 * L,
            f"K5 launches per prefill / decode step: {per}, want {3 * L}")
    # prefill (C 80 a group) on the wide kernel, decode (C 8) on the narrow
    require(k5_variants == {"f32": 0, "wide": 3 * L,
                            "narrow": 3 * L * (gen - 1)}
            and per["k5_prefill_variants"]["wide"] == 3 * L
            and per["k5_decode_step_variants"]["narrow"] == 3 * L,
            f"K5 variants: {k5_variants}, {per}: want every prefill launch "
            "wide and every decode launch narrow")
    require(launches["flash_attention"] == L and per["k3_prefill"] == L,
            f"K3 launches: {launches}, {per}, want {L} per prefill")
    require(worst["route"] <= MOE_ROUTE_TOL,
            f"MoE K5 route != einsum route: {worst}")
    require(worst["oracle"] <= MOE_ORACLE_TOL,
            f"MoE layer != float32 oracle: {worst}")
    require(worst["dropped_no_drop_cf"] == 0.0,
            f"tokens dropped at the no-drop capacity: {worst}")
    require(decode["ok"], f"decode_step != prefill: {decode}")
    require(kv["ok"], f"decode_step's cache != prefill's: {kv}")
    require(route32["ok"], f"K5 route != einsum route in float32: {route32}")
    return result


# --------------------------------------------------------------------------
# phase 12: kimi-k2-1t-a32b inference (d_head 112 on K3)


def run_kimi(torch):
    """kimi-k2-1t-a32b at full width, cut to KIMI's depth, on the demo's
    ``load_model`` and ``generate``; K3 (dh 112, GQA 8:1) once per prefill
    layer; the K3/K5 route against the einsum route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as k5
    from repro_torch.launch import inference_demo as demo

    dev = torch.device("cuda:0")
    B, P, gen = KIMI["batch"], KIMI["prompt"], KIMI["gen"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(smoke_config(KIMI["arch"]), False, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        L = cfg.n_layers
        require(model.use_kernels, "the demo's model is not on K3/K5")
        prompts = demo.make_prompts(cfg, B, P, 0, dev)
        demo.generate(model, prompts[:, :256], 2)       # warm-up

        # the main path: counts from zero, driven once, read right after
        fa.flash_attention.launches = 0
        k5.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out = demo.generate(model, prompts, gen)
        launches = {"flash_attention": fa.flash_attention.launches,
                    "moe_gemm": k5.moe_gemm.launches}
        peak = torch.cuda.max_memory_allocated()
        tokens = out["tokens"].cpu().numpy()
        finite = all_finite(torch, out["logits"])

        # the same weights on the einsum route
        model.use_kernels = False
        t_e = host_ms(torch, lambda: model.prefill(prompts, P + gen), 1)
        ein, _ = model.prefill(prompts, P + gen)
        model.use_kernels = True
        t_k = host_ms(torch, lambda: model.prefill(prompts, P + gen), 1)
        route = logits_agree(torch, out["logits"], ein)
        finite_einsum = all_finite(torch, ein)
        del ein
    n_params = sum(p.numel() for p in model.parameters())
    result = dict(
        arch=cfg.name, n_layers=L, n_layers_published=61, batch=B, prompt=P,
        gen=gen, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        d_head=cfg.d_head, experts=[cfg.n_experts, cfg.top_k,
                                    cfg.n_shared_experts],
        moe_d_ff=cfg.moe_d_ff, vocab=cfg.vocab, dtype=str(cfg.dtype),
        params=n_params, init_s=init_s, prefill_ms=1e3 * out["prefill_s"],
        decode_s=out["decode_s"],
        decode_tok_per_s=(gen - 1) * B / out["decode_s"],
        prefill_ms_kernel_route=t_k, prefill_ms_einsum_route=t_e,
        k3_launches=launches["flash_attention"],
        k5_launches=launches["moe_gemm"], max_memory_allocated=peak,
        logits_finite=[finite, finite_einsum], k3_vs_einsum=route,
        sample=tokens[0].tolist())
    emit("kimi", **result)
    del model
    torch.cuda.empty_cache()
    require(finite and finite_einsum, "non-finite logits")
    require(tokens.shape == (B, gen), f"generated {tokens.shape}")
    require(launches["flash_attention"] == L,
            f"K3 launched {launches['flash_attention']} times in one "
            f"prefill, want {L}")
    require(launches["moe_gemm"] == 3 * L * gen,
            f"K5 launched {launches['moe_gemm']} times, want {3 * L * gen}")
    require(route["ok"], f"K3/K5 route != einsum route: {route}")
    return result


# --------------------------------------------------------------------------
# phase 20: kimi-k2-instruct's decode through the latent cache

# the benchmark's kimi-k2-instruct (9 of 61 layers at full width, 48 of
# 384 experts held): a prefill of [2, 4096], then 8 decode steps, each
# step's logits against the benchmark's float32 reference over the prompt
# and the tokens fed so far, by the cell's ``miss`` (gpubench/check)
MLA = dict(cell="kimi-k2-instruct.prefill", batch=2, prompt=4096, gen=8,
           seed=2 ** 31 + 77)


def run_mla(torch):
    """kimi-k2-instruct through ``build_model`` on the card (MLA on K3 at
    192/128, K5 over the held experts): prefill, then ``decode_step``
    through the latent cache in the absorbed form; every position's
    logits against the reference's full forward, the median ``miss``
    within the cell's ``miss_median`` limit."""
    sys.path.insert(0, str(ROOT))
    from gpubench.check.prefill import per_request
    from gpubench.core import card, spec
    from gpubench.core import weights as W
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cell = spec.cell(MLA["cell"])
    fam = cell.family
    a = fam.arch.sizes(cell.config)
    B, P, n, seed = MLA["batch"], MLA["prompt"], MLA["gen"], MLA["seed"]
    dev = torch.device("cuda:0")
    model = build_model(fam.port.model_config(cell.config), use_kernels=True,
                        device=dev)
    W.load_port(dict(model.named_parameters()), fam.arch, a, seed, dev)
    toks = torch.randint(0, a.vocab, (B, P + n), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
    with torch.inference_mode():
        fa.flash_attention.launches = 0
        logits, cache = model.prefill(toks[:, :P], P + n)
        k3 = fa.flash_attention.launches
        got = [logits[:, -1, : a.vocab].float().cpu()]
        t = time.perf_counter()
        for j in range(n):
            step, cache = model.decode_step(cache, toks[:, P + j:P + j + 1])
            got.append(step[:, 0, : a.vocab].float().cpu())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
    cache_shape = list(cache.ckv.shape)
    del model, cache, logits, step
    card.free(dev)
    prompts = [toks[b, : P + j] for j in range(n + 1) for b in range(B)]
    refs = fam.reference.prefill_logits(a, seed, prompts, dev)
    misses = [per_request(got[j][b], int(got[j][b].argmax()),
                          refs[j * B + b])[1]
              for j in range(n + 1) for b in range(B)]
    limit = cell.limits["numbers"]["miss_median"]["limit"]
    result = dict(cell=MLA["cell"], batch=B, prompt=P, gen=n,
                  latent_cache=cache_shape, k3_launches=k3,
                  decode_ms_per_step=1e3 * decode_s / n,
                  miss=[round(m, 5) for m in misses],
                  miss_prefill=[round(m, 5) for m in misses[:B]],
                  miss_decode_median=statistics.median(misses[B:]),
                  miss_median=statistics.median(misses), limit=limit)
    emit("mla", **result)
    require(k3 == a.n_layers, f"K3 launched {k3} times, want {a.n_layers}")
    require(result["miss_median"] <= limit,
            f"decode against the reference: {result}")
    return result


# --------------------------------------------------------------------------
# phase 15: llava-next-34b inference (the vlm family)


def run_vlm(torch):
    """llava-next-34b at full width, cut to LLAVA's depth, on the demo's
    ``load_model``, ``make_inputs`` and ``generate``: K3 once per prefill
    layer over the frontend positions and the prompt; the K3 route against
    the einsum route at batch 1; decode after prefill(S - 1) against
    prefill(S), logits and cache."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import inference_demo as demo

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    B, P, gen = LLAVA["batch"], LLAVA["prompt"], LLAVA["gen"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(smoke_config(LLAVA["arch"]), False, 0,
                                     dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        L, N = cfg.n_layers, cfg.n_frontend_embeds
        C = N + P + gen  # a cache that holds every position
        require(model.use_kernels, "the demo's model is not on K3")
        prompts, fe = demo.make_inputs(cfg, B, P, 0, dev)
        demo.generate(model, prompts[:, :128], 2,
                      frontend_embeds=fe[:, :128])      # warm-up

        # the main path: counts from zero, driven once, read right after
        fa.flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = demo.generate(model, prompts, gen, frontend_embeds=fe,
                            cache_len=C)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tokens = out["tokens"].cpu().numpy()
        finite = all_finite(torch, out["logits"])

        # the same weights, K3 route against einsum route, at batch 1
        b1 = slice(0, LLAVA["route_batch"])

        def prefill_b1():
            return model.prefill(prompts[b1], C, frontend_embeds=fe[b1])[0]
        t_k = host_ms(torch, prefill_b1, 1)
        k3 = prefill_b1()
        model.use_kernels = False
        t_e = host_ms(torch, prefill_b1, 1)
        ein = prefill_b1()
        model.use_kernels = True
        route = logits_agree(torch, k3, ein)
        finite_route = all_finite(torch, k3, ein)
        del k3, ein
        # the cache: decode_step after prefill(S - 1) against prefill(S)
        _, cache = model.prefill(prompts[:, :-1], C, frontend_embeds=fe)
        dec, cache = model.decode_step(cache, prompts[:, -1:])
        decode = logits_agree(torch, dec, out["logits"])
        _, full = model.prefill(prompts, C, frontend_embeds=fe)
        kv = cache_agree(torch, cache, full, N + P - 1)
        del cache, full
    n_params = sum(p.numel() for p in model.parameters())
    result = dict(
        arch=cfg.name, n_layers=L, n_layers_published=60, batch=B,
        frontend_positions=N, prompt=P, gen=gen, cache_len=C,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_heads_padded,
                                    cfg.n_kv_heads_padded],
        d_head=cfg.d_head, d_ff=cfg.d_ff, vocab=cfg.vocab,
        dtype=str(cfg.dtype), params=n_params, init_s=init_s,
        prefill_ms=1e3 * out["prefill_s"], decode_s=out["decode_s"],
        decode_tok_per_s=(gen - 1) * B / out["decode_s"],
        route_batch=LLAVA["route_batch"], prefill_ms_k3_route_b1=t_k,
        prefill_ms_einsum_route_b1=t_e, k3_launches=launches,
        max_memory_allocated=peak, logits_finite=[finite, finite_route],
        k3_vs_einsum=route, decode_vs_prefill=decode, cache_vs_prefill=kv,
        sample=tokens[0].tolist(), s=time.perf_counter() - t0)
    emit("vlm", **result)
    del model
    torch.cuda.empty_cache()
    require(finite and finite_route, "non-finite logits")
    require(tokens.shape == (B, gen), f"generated {tokens.shape}")
    require(launches == L,
            f"K3 launched {launches} times in one prefill, want {L}")
    require(route["ok"], f"K3 route != einsum route: {route}")
    require(decode["ok"], f"decode_step != prefill: {decode}")
    require(kv["ok"], f"decode_step's cache != prefill's: {kv}")
    return result


# --------------------------------------------------------------------------
# phase 16: seamless-m4t-large-v2 (the encoder-decoder family)


def encode_decode(torch, model, frames, gen):
    """The encoder-decoder's serving path: ``encode``, ``precompute_enc_kv``,
    then ``gen`` greedy decode steps from token 0, the two parts timed
    apart on the host clock. Returns the encoder's output, its cross K/V,
    the tokens fed to the steps [B, gen] and their logits [B, gen, V]."""
    B = frames.shape[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc = model.encode(frames)
    enc_kv = model.precompute_enc_kv(enc)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    t = time.perf_counter()
    cache = model.init_cache(B, gen)
    tok = torch.zeros((B, 1), dtype=torch.int64, device=frames.device)
    fed, logits = [], []
    for _ in range(gen):
        fed.append(tok)
        out, cache = model.decode_step(cache, tok, enc_kv)
        logits.append(out)
        tok = torch.argmax(out[:, -1], -1)[:, None]
    torch.cuda.synchronize()
    return {"enc": enc, "enc_kv": enc_kv, "fed": torch.cat(fed, 1),
            "logits": torch.cat(logits, 1), "encode_s": encode_s,
            "decode_s": time.perf_counter() - t}


def replay_decode(torch, model, enc_kv, fed):
    """The decode steps of ``fed`` [B, T] (each step's input token)
    against ``enc_kv``: their logits [B, T, V]."""
    cache = model.init_cache(fed.shape[0], fed.shape[1])
    logits = []
    for i in range(fed.shape[1]):
        out, cache = model.decode_step(cache, fed[:, i:i + 1], enc_kv)
        logits.append(out)
    return torch.cat(logits, 1)


def position_rows(x):
    """[B, T, V] logits as B * T rows of one position, as
    :func:`logits_agree` reads them (``x`` holds no masked column: its
    -1e30 would be the largest value)."""
    return x.reshape(-1, 1, x.shape[-1])


def run_encdec(torch):
    """seamless-m4t-large-v2 whole on the demo's ``load_model``: SEAMLESS's
    frames encoded (K3, 24 launches), the cross K/V, 16 greedy tokens; the
    encoder's K3 route against its einsum route, the decode logits on
    each route's cross K/V, and the decode logits against the decoder's
    teacher-forced logits (``logits_fn``, what ``loss`` scores)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import inference_demo as demo

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    B, Se, gen = SEAMLESS["batch"], SEAMLESS["frames"], SEAMLESS["gen"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(smoke_config(SEAMLESS["arch"]), False, 0,
                                     dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        require(model.use_kernels, "the model is not on K3")
        frames = torch.as_tensor(np.random.default_rng(0).normal(
            0, 0.1, (B, Se, cfg.d_model)), device=dev).to(cfg.dtype)
        encode_decode(torch, model, frames[:, :256], 2)  # warm-up

        # the main path: counts from zero, driven once, read right after
        fa.flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = encode_decode(torch, model, frames, gen)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tokens = out["fed"][:, 1:].cpu().numpy()
        finite = all_finite(torch, out["enc"], out["logits"])

        # the same weights: the encoder on the einsum route
        model.use_kernels = False
        t_e = host_ms(torch, lambda: model.encode(frames), 1)
        enc_e = model.encode(frames)
        model.use_kernels = True
        t_k = host_ms(torch, lambda: model.encode(frames), 1)
        enc_diff = float((out["enc"].float() - enc_e.float()).abs().max())
        enc_scale = float(enc_e.float().abs().max())
        encode = {"max_abs_diff": enc_diff, "rel_diff": enc_diff / enc_scale,
                  "tol": ENC_TOL, "ok": enc_diff / enc_scale <= ENC_TOL}
        # the decode steps on the einsum route's cross K/V, same tokens
        dec_e = replay_decode(torch, model, model.precompute_enc_kv(enc_e),
                              out["fed"])
        V = cfg.vocab  # the padded head's columns are masked to -1e30
        logits = position_rows(out["logits"][..., :V])
        routes = logits_agree(torch, logits, position_rows(dec_e[..., :V]))
        # the decoder teacher-forced over the tokens the steps took
        forced = model.logits_fn({"frontend_embeds": frames,
                                  "tokens": out["fed"]})
        teacher = logits_agree(torch, logits, position_rows(forced[..., :V]))
        finite_other = all_finite(torch, enc_e, dec_e, forced)
        del enc_e, dec_e, forced
    n_params = sum(p.numel() for p in model.parameters())
    result = dict(
        arch=cfg.name, encoder_layers=cfg.encoder_layers,
        decoder_layers=cfg.n_layers, encoder_window=cfg.encoder_window,
        batch=B, frames=Se, gen=gen, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], d_head=cfg.d_head,
        d_ff=cfg.d_ff, vocab=[cfg.vocab, cfg.vocab_padded],
        dtype=str(cfg.dtype), params=n_params, init_s=init_s,
        encode_ms=1e3 * out["encode_s"], decode_s=out["decode_s"],
        decode_tok_per_s=gen * B / out["decode_s"],
        encode_ms_k3_route=t_k, encode_ms_einsum_route=t_e,
        k3_launches=launches, max_memory_allocated=peak,
        finite=[finite, finite_other], encode_k3_vs_einsum=encode,
        decode_k3_vs_einsum_enc_kv=routes, decode_vs_teacher_forced=teacher,
        sample=tokens[0].tolist(), s=time.perf_counter() - t0)
    emit("encdec", **result)
    del model
    torch.cuda.empty_cache()
    require(finite and finite_other, "non-finite encoder output or logits")
    require(tokens.shape == (B, gen - 1), f"generated {tokens.shape}")
    require(launches == cfg.encoder_layers,
            f"K3 launched {launches} times in one encode, want "
            f"{cfg.encoder_layers}")
    require(encode["ok"], f"encoder K3 route != einsum route: {encode}")
    require(routes["ok"], f"decode on the two routes' enc_kv: {routes}")
    require(teacher["ok"], f"decode_step != teacher-forced: {teacher}")
    return result


# --------------------------------------------------------------------------
# phase 17: hymba-1.5b (the hybrid family)


def mamba_agree(torch, a, b, rel_tol=HYBRID_STATE_TOL):
    """The Mamba conv and h of ``MambaState`` ``a`` against ``b`` ([L, ...]
    stacked): per layer max |a - b| over max |b|, the worst layer's of
    each, and of both (``worst``), which must be within ``rel_tol``."""
    out = {}
    for name in ("conv", "h"):
        x, y = getattr(a, name).float(), getattr(b, name).float()
        L = x.shape[0]
        per = ((x - y).abs().reshape(L, -1).max(1).values
               / y.abs().reshape(L, -1).max(1).values)
        out[name] = float(per.max())
        out[f"{name}_per_layer"] = per.tolist()
    out["worst"] = float(torch.tensor([out["conv"], out["h"]]).max())
    out["tol"] = rel_tol
    out["ok"] = out["worst"] <= rel_tol
    return out


def hybrid_decode_vs_prefill(torch, model, prompts, cache_len,
                             rel_tol=LOGIT_TOL):
    """``decode_step`` after ``prefill(S - 1)`` against ``prefill(S)`` of a
    hybrid model: the logits (the padded vocab's -1e30 columns sliced off),
    the KV ring buffer at the new slot ``(S - 1) % C`` and at every other
    slot, and each layer's Mamba conv and h; whether every logit and state
    of both is finite."""
    V = model.cfg.vocab
    S = prompts.shape[1]
    logits, full = model.prefill(prompts, cache_len)
    _, cache = model.prefill(prompts[:, :-1], cache_len)
    dec, cache = model.decode_step(cache, prompts[:, -1:])
    C = cache[0].k.shape[2]
    finite = all_finite(torch, logits, dec, *full[0][:2], *full[1],
                        *cache[0][:2], *cache[1])
    return {"logits": logits_agree(torch, dec[..., :V], logits[..., :V],
                                   rel_tol),
            "kv": cache_agree(torch, cache[0], full[0], (S - 1) % C),
            "mamba": mamba_agree(torch, cache[1], full[1]),
            "slot": (S - 1) % C, "slots": C, "finite": finite}


def hybrid_f32(torch, cfg, prompts, cache_len):
    """hymba-1.5b whole in float32, the same seed: the K3 route against
    the einsum route, and decode after prefill(S - 1) against prefill(S),
    the logits within HYBRID_F32_TOL (in float32 the routes compute the
    same function up to summation order, where bf16 rounding parts them)."""
    from repro_torch.launch import inference_demo as demo

    f32 = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    V = cfg.vocab
    _, model = demo.load_model(f32, False, 0, torch.device("cuda:0"))
    k3, _ = model.prefill(prompts, cache_len)
    model.use_kernels = False
    ein, _ = model.prefill(prompts, cache_len)
    model.use_kernels = True
    out = {"k3_vs_einsum": logits_agree(torch, k3[..., :V], ein[..., :V],
                                        HYBRID_F32_TOL),
           "decode": hybrid_decode_vs_prefill(torch, model, prompts,
                                              cache_len, HYBRID_F32_TOL)}
    out["finite"] = all_finite(torch, k3, ein) and out["decode"]["finite"]
    out["ok"] = (out["k3_vs_einsum"]["ok"] and out["finite"]
                 and all(out["decode"][k]["ok"]
                         for k in ("logits", "kv", "mamba")))
    return out


def hybrid_card_vs_cpu(torch, cfg):
    """hymba-1.5b at full width, cut to HYMBA's f32_layers, in float32:
    the same weights on the card (K3, the Mamba branch in torch ops) and
    on the CPU (K3's plain version), a prefill of HYMBA's f32_prompt at
    f32_batch and one decode step; the logits, the K/V and the Mamba state
    of each, relative to the largest value, within HYBRID_F32_TOL."""
    from repro_torch.launch import inference_demo as demo
    from repro_torch.models import build_model

    f32 = dataclasses.replace(cfg, n_layers=HYMBA["f32_layers"],
                              dtype=torch.float32, param_dtype=torch.float32)
    V, P = cfg.vocab, HYMBA["f32_prompt"]
    _, card = demo.load_model(f32, False, 0, torch.device("cuda:0"))
    cpu = build_model(f32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    prompts = demo.make_prompts(f32, HYMBA["f32_batch"], P, 0,
                                torch.device("cpu"))
    lg, cg = card.prefill(prompts.cuda(), P + 1)
    lh, ch = cpu.prefill(prompts, P + 1)
    out = {"prefill": logits_agree(torch, lg[..., :V].cpu(), lh[..., :V],
                                   HYBRID_F32_TOL)}
    tok = torch.argmax(lh[:, -1, :V], -1)[:, None]
    dg, cg = card.decode_step(cg, tok.cuda())
    dh, ch = cpu.decode_step(ch, tok)
    out["decode"] = logits_agree(torch, dg[..., :V].cpu(), dh[..., :V],
                                 HYBRID_F32_TOL)
    cg = tuple(type(t)(*(x.cpu() for x in t)) for t in cg)
    out["kv"] = cache_agree(torch, cg[0], ch[0], P, HYBRID_F32_TOL)
    out["mamba"] = mamba_agree(torch, cg[1], ch[1], HYBRID_F32_TOL)
    out["finite"] = all_finite(torch, lg, dg, *cg[1], lh, dh, *ch[1])
    out["ok"] = all(out[k]["ok"] for k in ("prefill", "decode", "kv",
                                          "mamba")) and out["finite"]
    return out


def run_hybrid(torch):
    """hymba-1.5b whole on the demo's ``load_model``, ``make_inputs`` and
    ``generate``: K3 once per prefill layer within the window of 1024, the
    Mamba branch in torch ops, the KV ring buffer wrapped (a prompt of 2048
    over 1024 slots); the K3 route against the einsum route, decode after
    prefill(S - 1) against prefill(S) (logits, KV slots, Mamba state),
    and the card against the CPU in float32."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import inference_demo as demo

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    B, P, gen = HYMBA["batch"], HYMBA["prompt"], HYMBA["gen"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cfg, model = demo.load_model(smoke_config(HYMBA["arch"]), False, 0,
                                     dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        require(model.use_kernels, "the demo's model is not on K3")
        L, V, C = cfg.n_layers, cfg.vocab, P + gen
        prompts, _ = demo.make_inputs(cfg, B, P, 0, dev)
        demo.generate(model, prompts[:, :256], 2)       # warm-up

        # the main path: counts from zero, driven once, read right after
        fa.flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = demo.generate(model, prompts, gen)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tokens = out["tokens"].cpu().numpy()
        finite = all_finite(torch, out["logits"])

        # the same weights on the einsum route
        t_k = host_ms(torch, lambda: model.prefill(prompts, C), 1)
        model.use_kernels = False
        t_e = host_ms(torch, lambda: model.prefill(prompts, C), 1)
        ein, _ = model.prefill(prompts, C)
        model.use_kernels = True
        route = logits_agree(torch, out["logits"][..., :V], ein[..., :V],
                             HYBRID_ROUTE_TOL)
        finite_route = all_finite(torch, ein)
        del ein
        decode = hybrid_decode_vs_prefill(torch, model, prompts, C)
        n_params = sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        f32 = hybrid_f32(torch, cfg, prompts, C)
        torch.cuda.empty_cache()
        card_cpu = hybrid_card_vs_cpu(torch, cfg)
    torch.cuda.empty_cache()
    result = dict(
        arch=cfg.name, n_layers=L, batch=B, prompt=P, gen=gen,
        window=cfg.window, cache_slots=decode["slots"],
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_heads_padded,
                                    cfg.n_kv_heads, cfg.n_kv_heads_padded],
        d_head=cfg.d_head, d_ff=cfg.d_ff, ssm_state=cfg.ssm_state,
        vocab=[cfg.vocab, cfg.vocab_padded], dtype=str(cfg.dtype),
        params=n_params, init_s=init_s,
        prefill_ms=1e3 * out["prefill_s"], decode_s=out["decode_s"],
        decode_tok_per_s=(gen - 1) * B / out["decode_s"],
        prefill_ms_k3_route=t_k, prefill_ms_einsum_route=t_e,
        k3_launches=launches, max_memory_allocated=peak,
        finite=[finite, finite_route, decode["finite"], f32["finite"],
                card_cpu["finite"]],
        k3_vs_einsum=route, decode_vs_prefill=decode["logits"],
        cache_vs_prefill=decode["kv"], new_slot=decode["slot"],
        mamba_vs_prefill=decode["mamba"],
        f32_k3_vs_einsum=f32["k3_vs_einsum"],
        f32_decode_vs_prefill={k: f32["decode"][k]
                               for k in ("logits", "kv", "mamba")},
        f32_card_vs_cpu=card_cpu,
        sample=tokens[0].tolist(), s=time.perf_counter() - t0)
    emit("hybrid", **result)
    require(finite and finite_route and decode["finite"] and f32["finite"]
            and card_cpu["finite"], "non-finite logits or state")
    require(tokens.shape == (B, gen), f"generated {tokens.shape}")
    require(launches == L,
            f"K3 launched {launches} times in one prefill, want {L}")
    require(route["ok"], f"K3 route != einsum route: {route}")
    require(decode["logits"]["ok"], f"decode_step != prefill: {decode}")
    require(decode["kv"]["ok"], f"decode_step's KV != prefill's: {decode}")
    require(decode["mamba"]["ok"],
            f"decode_step's Mamba state != prefill's: {decode['mamba']}")
    require(f32["ok"], f"float32 routes or decode != prefill: {f32}")
    require(card_cpu["ok"], f"card != CPU in float32: {card_cpu}")
    return result


# --------------------------------------------------------------------------
# phase 4: the main path


def main_path_config(n_clients, until_step, backend):
    from repro_torch.core import (ExperimentConfig, FleetSection, RunSection,
                                  ScenarioSection, StrategySection,
                                  TrainerSection)
    return ExperimentConfig(
        scenario=ScenarioSection(name="global", days=1, seed=0,
                                 util_mode="sparse"),
        fleet=FleetSection(n_clients=n_clients, seed=0),
        strategy=StrategySection(name="fedzero", n=10, d_max=60, seed=0,
                                 options={"solver": "greedy"}),
        trainer=TrainerSection(k=0.0004, seed=0),
        run=RunSection(until_step=until_step, eval_every=5, seed=0,
                       backend=backend))


def window_histogram(window_shapes):
    """Per op: calls by power-of-two row bucket (``"<=R"``) and by window
    width W, the number of distinct (R, W) shapes, and the commonest."""
    rows, width = {}, {}
    for (op, R, W), n in window_shapes.items():
        rb = f"<={1 << max(R - 1, 0).bit_length()}"
        rows.setdefault(op, {}).setdefault(rb, 0)
        rows[op][rb] += n
        width.setdefault(op, {}).setdefault(W, 0)
        width[op][W] += n
    top = sorted(([op, R, W, n] for (op, R, W), n in window_shapes.items()),
                 key=lambda v: -v[3])[:12]
    by_bound = {op: dict(sorted(h.items(), key=lambda kv: int(kv[0][2:])))
                for op, h in rows.items()}
    return {"window_rows_hist": by_bound,
            "window_w_hist": {op: dict(sorted(h.items()))
                              for op, h in width.items()},
            "window_distinct_shapes": len(window_shapes),
            "window_top_shapes": top}


def run_main(torch, cfg):
    """Build the experiment and run its round loop (what
    ``run_experiment`` does), timing set-up and loop apart."""
    from repro_torch.core import build_experiment
    torch.cuda.synchronize()
    t = time.perf_counter()
    sim = build_experiment(cfg)
    setup = time.perf_counter() - t
    t = time.perf_counter()
    summary = sim.run(until_step=cfg.run.until_step)
    torch.cuda.synchronize()
    loop = time.perf_counter() - t
    rounds = [(r.start_step, r.duration, r.contributor_idx.tolist(),
               r.energy_used) for r in sim.results]
    return summary, rounds, {"setup_s": setup, "loop_s": loop,
                             "ms_per_round": 1e3 * loop / max(len(rounds), 1)}


def run_scheduler(torch, cuda_bk, args):
    """The 1M-client main path on ``cuda`` (counts from zero, driven once,
    read right after), then on NumPy; returns K1/K2's launches."""
    from repro_torch.kernels import counter_hash as ch
    cfg = main_path_config(args.clients, args.until_step, "cuda")
    cuda_bk.reset_dispatch_counts()
    cuda_bk.window_shapes.clear()
    ch.piece_window.launches = 0
    ch.forecast_z.launches = 0
    torch.cuda.reset_peak_memory_stats()
    s_cuda, r_cuda, t_cuda = run_main(torch, cfg)
    launches = {"piece_window": ch.piece_window.launches,
                "forecast_z": ch.forecast_z.launches}
    peak = torch.cuda.max_memory_allocated()
    dispatch = dict(sorted(cuda_bk.dispatch_counts.items()))
    shapes = window_histogram(cuda_bk.window_shapes)
    s_np, r_np, t_np = run_main(
        torch, main_path_config(args.clients, args.until_step, "numpy"))
    n_rounds = len(r_cuda)
    emit("main_path", clients=args.clients, until_step=args.until_step,
         rounds=n_rounds, total_energy_wh=s_cuda["total_energy_wh"],
         total_energy_wh_numpy=s_np["total_energy_wh"],
         cuda=t_cuda, numpy=t_np,
         kernel_launches=launches, dispatch_counts=dispatch,
         max_memory_allocated=peak, **shapes)
    require(n_rounds >= 20, f"only {n_rounds} rounds; raise --until-step")
    require(r_cuda == r_np, "cuda rounds differ from numpy rounds")
    require(s_cuda["total_energy_wh"] == s_np["total_energy_wh"],
            "total energy differs")
    require(launches["piece_window"] > 0 and launches["forecast_z"] > 0,
            f"a kernel never launched on the main path: {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 5: the service, 1m_service and 1m_service_faults


def service_config(backend, executor="inprocess", workers=1, faults=""):
    from repro_torch.core import (ExperimentConfig, FleetSection, RunSection,
                                  ScenarioSection, ServiceSection,
                                  StrategySection)
    from repro_torch.service import FaultPlan
    sv = SERVICE
    return ExperimentConfig(
        scenario=ScenarioSection(name="global", days=1, seed=sv["seed"],
                                 util_mode="sparse"),
        fleet=FleetSection(n_clients=sv["clients"], seed=sv["seed"]),
        strategy=StrategySection(name="fedzero", n=sv["n"],
                                 d_max=sv["d_max"], seed=sv["seed"],
                                 options={"solver": "greedy"}),
        run=RunSection(backend=backend),
        service=ServiceSection(seed=sv["seed"], record_log=False,
                               executor=executor, workers=workers,
                               faults=FaultPlan.parse(faults) if faults
                               else None))


class RssPeak:
    """Resident memory, in MB, of this process (at the start and at its
    peak) and the peak of its child processes' sum (the service's
    workers), sampled from ``/proc`` every ``period`` seconds while the
    ``with`` block runs. Some kernels list a child's threads beside it
    among the children: only thread-group leaders are counted."""

    def __init__(self, period=0.05):
        self.period = period
        self.start_mb = self.parent_mb = self.children_mb = 0.0

    @staticmethod
    def _status(pid):
        try:
            lines = Path(f"/proc/{pid}/status").read_text().splitlines()
        except OSError:
            return {}
        return dict(ln.split(":", 1) for ln in lines if ":" in ln)

    @staticmethod
    def _rss_mb(status):
        return int(status.get("VmRSS", "0 kB").split()[0]) / 1024.0

    def _sample(self):
        me = os.getpid()
        kids = set()
        for f in Path(f"/proc/{me}/task").glob("*/children"):
            try:
                kids.update(int(p) for p in f.read_text().split())
            except OSError:
                pass
        mine = self._rss_mb(self._status(me))
        self.start_mb = self.start_mb or mine
        self.parent_mb = max(self.parent_mb, mine)
        status = {k: self._status(k) for k in kids}
        self.children_mb = max(self.children_mb, sum(
            self._rss_mb(st) for k, st in status.items()
            if st.get("Tgid", "").strip() == str(k)))

    def _loop(self):
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self._stop = threading.Event()
        self._sample()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def run_service_load(torch, cfg):
    """``benchmarks/service_load.py``'s ``run_service_load`` on the port:
    build the service, advance into daylight and price one admission
    (warm-up), then drive the measured window with ``run_synthetic``.
    Returns the service (closed), the window's snapshot and its times."""
    from repro_torch.service import build_service, run_synthetic
    sv = SERVICE
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t = time.perf_counter()
        svc = build_service(cfg, trainer=None)
        setup = time.perf_counter() - t
        try:
            t = time.perf_counter()
            svc.advance(sv["warmup_steps"])
            svc.admit()
            warmup = time.perf_counter() - t
            svc.metrics.reset()
            t = time.perf_counter()
            snap = run_synthetic(svc, steps=sv["steps"], churn=sv["churn"],
                                 admits_per_step=sv["admits_per_step"],
                                 quotes_per_step=sv["quotes_per_step"],
                                 seed=sv["seed"] + 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            svc.close()
    return svc, snap, {
        "setup_s": setup, "warmup_s": warmup, "wall_s": wall,
        "decisions": snap["admit_requests"] + snap["quote_requests"],
        "decisions_per_sec": snap["decisions_per_sec"],
        "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
        "max_ms": snap["max_ms"], "admitted": snap["admitted"],
        "rejected": snap["rejected"],
        "backend_dispatches": snap.get("backend_dispatches"),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "rss_start_mb": rss.start_mb, "peak_rss_mb": rss.parent_mb,
        "workers_peak_rss_mb": rss.children_mb}


def same_service_run(a, b):
    """Identical admission histories and identical counters (every
    counter of the metrics reads no clock)."""
    return (len(a.history) == len(b.history)
            and all((x is None and y is None)
                    or (x is not None and y is not None
                        and np.array_equal(x, y))
                    for x, y in zip(a.history, b.history))
            and a.metrics.counters == b.metrics.counters)


def run_service(torch, cuda_bk, host):
    """1m_service in-process on ``cuda`` (counts from zero, read right
    after), then on NumPy; then 1m_service_faults through two spawned
    workers on ``cuda`` (each on ``cuda:0``, reporting its device and
    K1/K2 launches), then on NumPy. Histories and counters must be
    identical across the backends; K1 and K2 must launch on the ``cuda``
    runs, and K1 in each worker."""
    from repro_torch.kernels import counter_hash as ch
    t0 = time.perf_counter()
    out = {}
    for name, kw in (("1m_service", {}),
                     ("1m_service_faults", dict(executor="multiprocess",
                                                workers=2,
                                                faults=SERVICE_FAULTS))):
        runs = {}
        for backend, bk in (("cuda", cuda_bk), ("numpy", host)):
            bk.reset_dispatch_counts()
            ch.piece_window.launches = 0
            ch.forecast_z.launches = 0
            svc, snap, row = run_service_load(torch,
                                              service_config(backend, **kw))
            row["kernel_launches"] = {"piece_window": ch.piece_window.launches,
                                      "forecast_z": ch.forecast_z.launches}
            for k in ("worker_crashes", "worker_restarts", "shard_retries",
                      "client_dropouts", "stragglers_injected",
                      "reports_delayed", "reports_lost", "rounds_degraded",
                      "engine_builds", "engine_reuses", "engine_memo_hits",
                      "engine_deactivations", "engine_compactions"):
                row[k] = snap[k]
            for k in ("worker_devices", "worker_kernel_launches"):
                if k in snap:
                    row[k] = snap[k]
            runs[backend] = (svc, row)
        (c_svc, c_row), (n_svc, n_row) = runs["cuda"], runs["numpy"]
        same = same_service_run(c_svc, n_svc)
        emit("service", config=name, settings={**SERVICE, **kw},
             identical=same, cuda=c_row, numpy=n_row,
             ratio_decisions_per_sec=(c_row["decisions_per_sec"]
                                      / n_row["decisions_per_sec"]))
        require(same, f"{name}: cuda history or counters differ from numpy")
        require(c_row["admitted"] > 0, f"{name}: nothing admitted")
        launches = c_row["kernel_launches"]
        require(launches["forecast_z"] > 0,
                f"{name}: K2 never launched on cuda: {launches}")
        if not kw:
            require(launches["piece_window"] > 0,
                    f"{name}: K1 never launched on cuda: {launches}")
        else:
            require(c_row["worker_crashes"] >= 1
                    and c_row["worker_restarts"] == c_row["worker_crashes"],
                    f"{name}: crashes/restarts {c_row['worker_crashes']}/"
                    f"{c_row['worker_restarts']}")
            devs = c_row.get("worker_devices", {})
            k1 = c_row.get("worker_kernel_launches", {})
            require(sorted(devs) == [0, 1]
                    and all(d == "cuda:0" for d in devs.values()),
                    f"{name}: worker devices {devs}")
            require(all(k1[w]["piece_window"] > 0 for w in devs),
                    f"{name}: K1 never launched in a worker: {k1}")
        out[name] = c_row
    out["s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# phase 13: federated training of the paper's models


def paper_data(name, client_names):
    """The synthetic task the paper model ``name`` trains on, at the
    reference's default sizes, over ``client_names``."""
    from repro_torch.data import federated as fd
    n = len(client_names)
    if name == "convnet":
        return fd.synthetic_classification(n, client_names, n_classes=100,
                                           hw=32, seed=TRAIN["seed"])
    if name == "kwt":
        return fd.synthetic_speech(n, client_names, n_classes=35,
                                   n_patches=98, seed=TRAIN["seed"])
    return fd.synthetic_chars(n, client_names, vocab=90, seed=TRAIN["seed"])


def paper_trainer(name, data, device):
    """A ``TorchTrainer`` of the paper model ``name`` at its published
    widths on ``device``, with ``TRAIN``'s settings."""
    from repro_torch.core import TorchTrainer
    from repro_torch.models import ConvNet, KWTModel, LSTMModel
    model = {"convnet": ConvNet, "kwt": KWTModel,
             "lstm": LSTMModel}[name](device=device)
    return TorchTrainer(model, data, lr=TRAIN_RUNS[name][1],
                        batch_size=TRAIN["batch"], prox_mu=TRAIN["prox_mu"],
                        seed=TRAIN["seed"],
                        max_steps_per_round=TRAIN["max_steps"], device=device)


def train_parity(torch, name, data):
    """The trainer on ``cuda:0`` against the same trainer on the CPU, from
    the card model's weights and the same NumPy seed: the global model's
    logits, then ``parity_updates`` local updates, ``aggregate`` and
    ``evaluate`` on each side."""
    dev = torch.device("cuda:0")
    card = paper_trainer(name, data, dev)
    cpu = paper_trainer(name, data, "cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    take = min(card.eval_batch, len(data.test_data["labels"]))

    def first(device):  # the evaluation batch
        return {k: torch.from_numpy(v[:take]).to(device)
                for k, v in data.test_data.items()}

    with torch.no_grad():
        logits = rel_max(card.model.logits_fn(first(dev)).cpu(),
                         cpu.model.logits_fn(first("cpu")))
    side = {}
    for key, tr in (("card", card), ("cpu", cpu)):
        t = time.perf_counter()
        ups = [tr.local_update(row, TRAIN["max_steps"])
               for row in range(TRAIN["parity_updates"])]
        tr.aggregate(ups)
        acc = tr.evaluate()
        side[key] = (ups, acc, time.perf_counter() - t)
    (cu, cacc, cs), (hu, hacc, hs) = side["card"], side["cpu"]
    losses = np.max([np.abs(np.subtract(a["losses"], b["losses"]))
                     / np.abs(b["losses"]) for a, b in zip(cu, hu)])
    got = {"logits": logits, "losses": float(losses),
           "sample_losses": float(np.max([
               rel_max(torch.from_numpy(a["sample_losses"]),
                       torch.from_numpy(b["sample_losses"]))
               for a, b in zip(cu, hu)])),
           "params": float(np.max([rel_max(p.cpu(), cpu.params[n])
                                   for n, p in card.params.items()]))}
    over = {k: v / TRAIN_TOL[k] for k, v in got.items()}
    ok = (all(v <= 1.0 for v in over.values())
          and abs(cacc - hacc) <= TRAIN_ACC_TOL)
    emit("train_parity", model=name, steps=[len(u["losses"]) for u in cu],
         **got, accuracy_card=cacc, accuracy_cpu=hacc,
         err_over_limit=over, first_losses_card=cu[0]["losses"][:3],
         card_s=cs, cpu_s=hs, ok=ok)
    for k, v in over.items():
        require(not v > 1.0 and v == v,
                f"{name}: trainer on the card against the CPU, {k} "
                f"{got[k]} > {TRAIN_TOL[k]}")
    require(not abs(cacc - hacc) > TRAIN_ACC_TOL,
            f"{name}: accuracy {cacc} on the card, {hacc} on the CPU")


def check_grad_refused(torch):
    """K3, K4 and K5 have no backward: on CUDA tensors that require grad,
    each wrapper and ``DecoderLM.loss`` on the kernel route raise; on the
    reference's route (``use_kernels=False``) the loss's gradients equal
    the CPU's within ``GRAD_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as k5
    from repro_torch.kernels import rwkv_scan as k4
    from repro_torch.models import DecoderLM
    dev = torch.device("cuda:0")

    def t(*shape):
        return torch.zeros(shape, device=dev, requires_grad=True)

    calls = {"flash_attention": lambda: fa.flash_attention(
                 t(1, 4, 16, 64), t(1, 2, 16, 64), t(1, 2, 16, 64)),
             "rwkv_scan": lambda: k4.rwkv_scan(*(t(1, 16, 2, 64),) * 4,
                                               t(2, 64)),
             "moe_gemm": lambda: k5.moe_gemm(t(2, 80, 64), t(2, 64, 32))}
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "no backward" in str(e)
    cfg = get_config("smollm-360m", reduced=True)
    cpu = DecoderLM(cfg, use_kernels=False, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = DecoderLM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
    try:
        card.loss(batch)
        refused["DecoderLM.loss"] = False
    except RuntimeError as e:
        refused["DecoderLM.loss"] = "use_kernels=False" in str(e)
    card.use_kernels = False
    card.loss(batch).backward()
    cpu.loss({"tokens": toks, "labels": toks}).backward()
    grads = float(np.max([rel_max(a.grad.cpu(), b.grad)
                          for a, b in zip(card.parameters(),
                                          cpu.parameters())]))
    emit("train_grad_guard", arch=cfg.name, refused=refused,
         plain_route_grad_vs_cpu=grads, tol=GRAD_TOL)
    require(all(refused.values()), f"a kernel ran under grad: {refused}")
    require(not grads > GRAD_TOL and grads == grads,
            f"plain-route gradients {grads} > {GRAD_TOL} of the CPU's")


class TimedTrainer:
    """A trainer whose calls are timed (each ending in a synchronise) and
    whose local steps are counted."""

    def __init__(self, torch, inner):
        self.torch, self.inner = torch, inner
        self.s, self.steps = 0.0, 0

    def _timed(self, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        self.torch.cuda.synchronize()
        self.s += time.perf_counter() - t
        return out

    def local_update(self, row, n_batches):
        upd = self._timed(self.inner.local_update, row, n_batches)
        self.steps += len(upd["losses"])
        return upd

    def aggregate(self, updates):
        return self._timed(self.inner.aggregate, updates)

    def evaluate(self):
        return self._timed(self.inner.evaluate)


def train_config(factory, rounds):
    from repro_torch.core import (ExperimentConfig, FleetSection, RunSection,
                                  ScenarioSection, StrategySection,
                                  TrainerSection)
    tr = TRAIN
    return ExperimentConfig(
        scenario=ScenarioSection(name="global", days=7, seed=tr["seed"]),
        fleet=FleetSection(n_clients=tr["clients"], seed=tr["seed"]),
        strategy=StrategySection(name="fedzero", n=tr["n"],
                                 d_max=tr["d_max"], seed=tr["seed"]),
        trainer=TrainerSection(factory=factory),
        run=RunSection(max_rounds=rounds, eval_every=1, seed=tr["seed"],
                       backend="cuda"))


def run_fedzero_training(torch, name, rounds):
    """The paper's loop on the card for one model: ``build_experiment`` +
    ``FLSimulation.run`` on ``backend="cuda"`` with a ``TorchTrainer`` on
    ``cuda:0`` in the trainer section, the fleet retuned to the data's
    shard sizes (examples/train_federated.py). The trainer's parity with
    the CPU is checked first, on the same data."""
    from repro_torch.core import (build_experiment, build_registry,
                                  build_scenario)
    from repro_torch.kernels import counter_hash as ch
    dev = torch.device("cuda:0")
    timed = {}

    def factory(reg):
        timed["t"] = TimedTrainer(torch, paper_trainer(name, data, dev))
        return timed["t"]

    cfg = train_config(factory, rounds)
    t = time.perf_counter()
    sc = build_scenario(cfg)
    reg = build_registry(cfg, sc)
    data = paper_data(name, reg.client_names)
    for c in reg.client_names:  # retune the fleet to the shard sizes
        reg.clients[c].n_samples = data.n_samples(c)
        reg.clients[c].batches_per_epoch = max(1, data.n_samples(c) // 10)
    reg.refresh_arrays()
    data_s = time.perf_counter() - t
    train_parity(torch, name, data)
    sim = build_experiment(cfg, scenario=sc, registry=reg)
    trainer = timed["t"]
    # the main path: counts from zero, driven once, read right after
    ch.piece_window.launches = 0
    ch.forecast_z.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    summary = sim.run(max_rounds=rounds)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = {"piece_window": ch.piece_window.launches,
                "forecast_z": ch.forecast_z.launches}
    n_rounds = len(sim.results)
    losses = [r.train_loss for r in sim.results]
    accs = [r.eval_metric for r in sim.results]
    train_s = trainer.s
    emit("train", model=name, rounds=n_rounds,
         params=sum(p.numel() for p in trainer.inner.model.parameters()),
         data_s=data_s, loop_s=loop_s,
         s_per_round=loop_s / max(n_rounds, 1),
         scheduling_s_per_round=(loop_s - train_s) / max(n_rounds, 1),
         training_s_per_round=train_s / max(n_rounds, 1),
         local_steps=trainer.steps, steps_per_s=trainer.steps / train_s,
         samples_per_s=trainer.steps * TRAIN["batch"] / train_s,
         train_loss=losses, accuracy=accs,
         contributors=[len(r.contributors) for r in sim.results],
         best_metric=summary["best_metric"],
         total_energy_wh=summary["total_energy_wh"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         kernel_launches=launches)
    require(n_rounds == rounds, f"{name}: {n_rounds} of {rounds} rounds ran")
    require(all(np.isfinite(losses)) and all(np.isfinite(accs)),
            f"{name}: a loss or an accuracy is not finite: {losses} {accs}")
    require(losses[-1] < losses[0],
            f"{name}: the last round's train loss {losses[-1]} is not below "
            f"the first's {losses[0]}")
    require(all(p.device == dev
                for p in trainer.inner.model.parameters()),
            f"{name}: the model is not on {dev}")
    return launches


def run_train(torch):
    """Phase 13: the no-grad guard of K3-K5, then for each paper model the
    trainer's parity with the CPU and the FedZero loop on the card."""
    t0 = time.perf_counter()
    check_grad_refused(torch)
    for name, (rounds, _) in TRAIN_RUNS.items():
        run_fedzero_training(torch, name, rounds)
    emit("train_phase", s=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# phase 14: training a DecoderLM through repro_torch.launch


def launch_parity(torch):
    """``make_train_step`` on ``cuda:0`` against the CPU from the same
    weights and batches: the first step's gradients, then
    ``parity_steps`` steps of the default AdamW (TF32 off, set by
    ``main``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim import Optimizer
    L = LAUNCH
    cfg = dataclasses.replace(get_config(L["arch"]),
                              n_layers=L["parity_layers"],
                              dtype=torch.float32, param_dtype=torch.float32)
    # an "optimizer" whose update returns the gradients
    grads_opt = Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s))
    model = build_model(cfg, use_kernels=False, device="cpu").init(
        torch.Generator().manual_seed(L["seed"]))
    p0 = {n: t.detach() for n, t in model.named_parameters()}
    del model
    rng = np.random.default_rng(L["seed"])
    batches = [synthetic_lm_batch(rng, L["parity_batch"], L["parity_seq"],
                                  cfg.vocab)
               for _ in range(L["parity_steps"])]
    side = {}
    for dev in (torch.device("cuda:0"), torch.device("cpu")):
        def on(b, dev=dev):
            return {k: v.to(dev) for k, v in b.items()}
        _, _, grad_step = steps.make_train_step(cfg, grads_opt, device=dev)
        _, opt, step = steps.make_train_step(cfg, device=dev)
        p = {n: t.to(dev) for n, t in p0.items()}
        g, _, _ = grad_step(p, {}, on(batches[0]))
        s, losses = opt.init(p), []
        t = time.perf_counter()
        for b in batches:
            p, s, loss = step(p, s, on(b))
            losses.append(float(loss))
        side[dev.type] = (g, p, losses, time.perf_counter() - t, opt.name)
    (gc, pc, lc, sc, opt_name), (gh, ph, lh, sh, _) = side["cuda"], side["cpu"]
    grads = {n: rel_max(gc[n].cpu(), gh[n]) for n in gh}
    rho = {n: float((pc[n].cpu() - ph[n]).norm() / (ph[n] - p0[n]).norm())
           for n in ph}
    losses = float(np.max(np.abs(np.subtract(lc, lh)) / np.abs(lh)))
    worst_g = max(grads, key=lambda n: grads[n])
    worst_p = max(rho, key=lambda n: rho[n])
    got = {"grads": grads[worst_g], "losses": losses, "params": rho[worst_p]}
    limits = {"grads": GRAD_TOL, "losses": LAUNCH_LOSS_TOL,
              "params": LAUNCH_PARAM_RHO}
    over = {k: v / limits[k] for k, v in got.items()}
    emit("launch_parity", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=str(cfg.dtype), batch=L["parity_batch"], seq=L["parity_seq"],
         steps=len(batches), optimizer=opt_name, **got,
         worst_grad=worst_g, worst_param=worst_p, limits=limits,
         err_over_limit=over, losses_card=lc, losses_cpu=lh,
         card_s=sc, cpu_s=sh,
         finite=bool(all(np.isfinite(lc)) and all_finite(
             torch, *gc.values(), *pc.values())))
    for k, v in over.items():
        require(not v > 1.0 and v == v,
                f"launch: the train step on the card against the CPU, {k} "
                f"{got[k]} > {limits[k]}")


def run_driver(argv):
    """``repro_torch.launch.train.main(argv)`` with its printed lines
    captured; returns (its result, the lines)."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train.main(argv)
    return out, buf.getvalue().splitlines()


def same_bits(torch, a, b):
    """Whether two tensors are equal bit for bit (dtype, shape, bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def serve_trained(torch, cfg, params):
    """The trained ``params`` on the kernel route through
    ``make_prefill_step``/``make_decode_step``: batch 4, prompt 2048, 16
    greedy tokens, K3's count from zero; then the prefill's logits against
    the plain route on the same weights."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch.inference_demo import make_prompts
    L, dev = LAUNCH, torch.device("cuda:0")
    B, P, gen = L["serve_batch"], L["prompt"], L["gen"]
    model, prefill = steps.make_prefill_step(cfg, "prefill_32k", device=dev)
    model.load_state_dict(params)
    dec_model, decode = steps.make_decode_step(cfg, "decode_32k", device=dev)
    dec_model.load_state_dict(params)
    require(model.use_kernels and dec_model.use_kernels,
            "the serving steps are not on the kernel route")
    prompts = make_prompts(cfg, B, P, L["seed"], dev)
    prefill(prompts[:, :256], 258)      # warm-up
    # the main path: counts from zero, driven once, read right after
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(prompts, P + gen)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    launches = fa.flash_attention.launches
    t = time.perf_counter()
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    toks, dec_logits = [tok], []
    for _ in range(gen - 1):
        out, cache = decode(cache, tok)
        dec_logits.append(out)
        tok = torch.argmax(out[:, -1], -1)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    tokens = torch.cat(toks, 1).cpu().numpy()
    model.use_kernels = False
    plain, _ = prefill(prompts, P + gen)
    route = logits_agree(torch, logits, plain)
    finite = all_finite(torch, logits, plain, *dec_logits)
    return {"k3_launches": launches, "prefill_ms": 1e3 * prefill_s,
            "decode_tok_per_s": (gen - 1) * B / decode_s,
            "k3_vs_plain": route, "logits_finite": finite,
            "tokens_shape": list(tokens.shape), "sample": tokens[0].tolist()}


def run_launch(torch):
    """Phase 14: (a) the train step on the card against the CPU; (b)
    smollm-360m trained at full width by the train driver, 10 steps with
    checkpoints, then resumed to 12; (c) the step-10 checkpoint against the
    first run's final state, bit for bit; (d) the step-12 checkpoint served
    on K3."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    L, dev = LAUNCH, torch.device("cuda:0")
    t0 = time.perf_counter()
    launch_parity(torch)
    parity_s = time.perf_counter() - t0
    cfg = get_config(L["arch"])
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", L["arch"], "--batch", str(L["batch"]), "--seq",
                str(L["seq"]), "--ckpt-every", str(L["ckpt_every"]),
                "--ckpt-dir", ckpt, "--log-every", "5", "--seed",
                str(L["seed"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        first, lines1 = run_driver(argv + ["--steps", str(L["steps"])])
        run_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        files = sorted(os.listdir(ckpt))
        ckpt_bytes = os.path.getsize(os.path.join(
            ckpt, f"ckpt_{L['steps']:08d}.npz"))
        # (c) the checkpoint of the last step against the run's final state
        t = time.perf_counter()
        p, o, extra = train.load_state(ckpt, first["params"],
                                       first["opt_state"], dev,
                                       step=L["steps"])
        load_s = time.perf_counter() - t
        reload_equal = (
            all(same_bits(torch, p[n], first["params"][n]) for n in p)
            and all(same_bits(torch, o[k][n], first["opt_state"][k][n])
                    for k in ("m", "v") for n in p)
            and same_bits(torch, o["step"], first["opt_state"]["step"]))
        del p, o
        t = time.perf_counter()
        second, lines2 = run_driver(argv + ["--steps",
                                            str(L["resume_steps"])])
        resume_s = time.perf_counter() - t
        served_params, _, _ = train.load_state(
            ckpt, first["params"], first["opt_state"], dev,
            step=L["resume_steps"])
    losses, step_s = first["losses"], first["step_s"]
    step_ms = 1e3 * statistics.median(step_s)
    del first
    serve = serve_trained(torch, cfg, served_params)
    result = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=str(cfg.dtype), params=sum(t.numel() for t in
                                         served_params.values()),
        batch=L["batch"], seq=L["seq"], steps=L["steps"],
        remat=True, optimizer="adamw", parity_s=parity_s, run_s=run_s,
        step_ms_median=step_ms,
        step_ms=[1e3 * s for s in step_s],
        tok_per_s=L["batch"] * L["seq"] / (step_ms / 1e3),
        max_memory_allocated_mb=peak / 2**20, losses=losses,
        first_loss=losses[0], last_loss=losses[-1],
        checkpoint_files=files, checkpoint_mb=ckpt_bytes / 2**20,
        reload_s=load_s, reload_bit_equal=reload_equal,
        resume_start=second["start"], resume_losses=second["losses"],
        resume_s=resume_s, driver_lines=lines1 + lines2, **serve,
        s=time.perf_counter() - t0)
    emit("launch", **result)
    require(all(np.isfinite(losses)) and all(np.isfinite(second["losses"])),
            f"launch: a loss is not finite: {losses} {second['losses']}")
    require(losses[-1] < losses[0],
            f"launch: the last loss {losses[-1]} is not below the first "
            f"{losses[0]}")
    require(f"ckpt_{L['steps']:08d}.npz" in files and
            f"ckpt_{L['ckpt_every']:08d}.npz" in files,
            f"launch: checkpoints {files}")
    require(reload_equal, "launch: the reloaded checkpoint differs from the "
            "run's final state")
    require(f"resumed from step {L['steps']}" in lines2
            and second["start"] == L["steps"]
            and len(second["losses"]) == L["resume_steps"] - L["steps"],
            f"launch: the resumed run {lines2}")
    require(serve["logits_finite"], "launch: non-finite serving logits")
    require(serve["tokens_shape"] == [L["serve_batch"], L["gen"]],
            f"launch: generated {serve['tokens_shape']}")
    require(serve["k3_launches"] == cfg.n_layers,
            f"launch: K3 launched {serve['k3_launches']} times in the "
            f"prefill, want {cfg.n_layers}")
    require(serve["k3_vs_plain"]["ok"],
            f"launch: K3 route != plain route: {serve['k3_vs_plain']}")
    return result


# --------------------------------------------------------------------------
# phase 18: the sharded step on a 1×1 mesh over NCCL


def spmd_train(torch, mesh, spec):
    """``spec``'s train step (its arch, cut to its layers) as a DTensor
    program on ``mesh`` against the plain step: the first step's gradients
    (a step whose "optimizer" returns them), then ``spec["steps"]`` AdamW
    steps, each side timed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim import Optimizer
    from repro_torch.sharding import step_placements
    dev = torch.device("cuda:0")
    cfg = get_config(spec["arch"])
    if spec["n_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    grads_opt = Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s))
    model = build_model(cfg, use_kernels=False, device=dev).init(
        torch.Generator(dev).manual_seed(SPMD["seed"]))
    p0 = {n: t.detach() for n, t in model.named_parameters()}
    del model
    rng = np.random.default_rng(SPMD["seed"])
    batches = [synthetic_lm_batch(rng, spec["batch"], spec["seq"], cfg.vocab,
                                  dev) for _ in range(spec["steps"])]
    side = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        _, _, grad_step = steps.make_train_step(cfg, grads_opt, device=dev,
                                                mesh=m)
        _, opt, step = steps.make_train_step(cfg, device=dev, mesh=m)
        p, s, bs = dict(p0), opt.init(p0), list(batches)
        if m is not None:
            pl, ol, bpl = step_placements("train", m, params=p, opt_state=s,
                                          batch=bs[0])["in"]
            p, s = train.distribute(p, pl, m), train.distribute(s, ol, m)
            bs = [train.distribute(b, bpl, m) for b in bs]
        g, _, _ = grad_step(p, {}, bs[0])
        g = train.gather(g) if m is not None else g
        losses, ms = [], []
        for b in bs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, s, loss = step(p, s, b)
            loss = loss.full_tensor() if m is not None else loss
            losses.append(float(loss))
            ms.append(1e3 * (time.perf_counter() - t))
        p = train.gather(p) if m is not None else p
        side[name] = (g, p, losses, ms)
        del s
    (gm, pm, lm, tm), (gp, pp, lp, tp) = side["mesh"], side["plain"]
    grads = {n: rel_max(gm[n].float(), gp[n].float()) for n in gp}
    # a tensor equal on both sides reads 0, whether or not the steps moved
    # it (a bf16 norm weight of 1.0 stays 1.0 under AdamW's 3e-4): 0 / 0
    # would be NaN; a difference over no movement is inf, and a NaN stays
    rho = {}
    for n in pp:
        num = float((pm[n].float() - pp[n].float()).norm())
        den = float((pp[n].float() - p0[n].float()).norm())
        rho[n] = 0.0 if num == 0 else (num / den if den else float("inf"))
    losses = float(np.max(np.abs(np.subtract(lm, lp)) / np.abs(lp)))
    worst_g = max(grads, key=lambda n: grads[n])
    worst_p = max(rho, key=lambda n: rho[n])
    got = {"grads": float(np.max(list(grads.values()))), "losses": losses,
           "params": float(np.max(list(rho.values())))}
    limits = {"grads": GRAD_TOL, "losses": LAUNCH_LOSS_TOL,
              "params": LAUNCH_PARAM_RHO}
    return dict(arch=cfg.name, n_layers=cfg.n_layers, dtype=str(cfg.dtype),
                batch=spec["batch"], seq=spec["seq"], steps=spec["steps"],
                remat=True, **got, worst_grad=worst_g, worst_param=worst_p,
                limits=limits,
                err_over_limit={k: v / limits[k] for k, v in got.items()},
                losses_mesh=lm, losses_plain=lp, step_ms_mesh=tm,
                step_ms_plain=tp,
                finite=bool(all(np.isfinite(lm)) and all_finite(
                    torch, *gm.values(), *pm.values())))


def spmd_infer(torch, mesh, arch, n_layers):
    """``arch`` (cut to ``n_layers``, an encoder-decoder's encoder too)
    through ``make_prefill_step`` and ``make_decode_step``: without a
    mesh, then on the mesh route, fed the same tokens: a decoder-only
    model's prompt (after a vlm's frontend embeddings) and 15 greedy
    steps, or an encoder-decoder's frames encoded and 16 greedy steps from
    token 0. The launch counts of K3, K4 and K5 are set to 0 just before
    the mesh route's prefill and read after it and after its decode
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.launch import steps, train
    from repro_torch.launch.inference_demo import make_inputs
    from repro_torch.sharding import step_placements
    S, dev = SPMD, torch.device("cuda:0")
    cfg = get_config(arch)
    encdec = cfg.encoder_layers > 0
    cfg = dataclasses.replace(cfg, n_layers=n_layers, **(
        {"encoder_layers": n_layers} if encdec else {}))
    B, P, gen, V = S["infer_batch"], S["prompt"], S["gen"], cfg.vocab
    N = cfg.n_frontend_embeds
    runs = {}
    for route, m in (("plain", None), ("mesh", mesh)):
        model, prefill = steps.make_prefill_step(cfg, "prefill_32k",
                                                 device=dev, mesh=m)
        model.init(torch.Generator(dev).manual_seed(S["seed"]))
        dmodel, decode = steps.make_decode_step(cfg, "decode_32k",
                                                device="meta", mesh=m)
        dmodel.load_state_dict(model.state_dict(), assign=True)
        prompts, fe = make_inputs(cfg, B, P, S["seed"], dev)
        frames = torch.as_tensor(np.random.default_rng(S["seed"]).normal(
            0, 0.1, (B, S["frames"], cfg.d_model)), device=dev).to(
                cfg.dtype) if encdec else None

        def put(t, kind="tokens", m=m):
            if m is None or t is None:
                return t
            at = 2 if kind == "frontend_embeds" else 1
            return train.distribute(t, step_placements(
                "prefill", m, **{kind: t})["in"][at], m)

        def run_prefill(n):
            """The prefill of the first ``n`` prompt tokens (frames)."""
            if encdec:
                return prefill(put(frames[:, :n], "frames")), None
            return prefill(put(prompts[:, :n]), N + n + gen,
                           frontend_embeds=put(fe, "frontend_embeds"))

        if m is not None:
            steps.distribute_model(model, m)
            steps.distribute_model(dmodel, m)
            fed = runs["plain"]["fed"]
        run_prefill(256)   # warm-up
        fa.flash_attention.launches = 0
        rs.rwkv_scan.launches = 0
        mg.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        first, cache = run_prefill(S["frames"] if encdec else P)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t)
        k3, k4, k5 = (fa.flash_attention.launches, rs.rwkv_scan.launches,
                      mg.moe_gemm.launches)
        enc_kv, out = (first, []) if encdec else ((), [first])
        if encdec:
            cache = dmodel.init_cache(B, gen)
            cache = cache if m is None else steps.place_cache(cache, m)
        whole = [t.full_tensor() if m is not None else t for t in out]
        if m is None:
            fed = [torch.argmax(whole[0][:, -1], -1)[:, None] if whole
                   else torch.zeros((B, 1), dtype=torch.int64, device=dev)]
        n_steps = gen - len(whole)
        t = time.perf_counter()
        for i in range(n_steps):
            logits, cache = decode(cache, put(fed[i]),
                                   *((enc_kv,) if encdec else ()))
            whole.append(logits.full_tensor() if m is not None else logits)
            if m is None:
                fed.append(torch.argmax(whole[-1][:, -1], -1)[:, None])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        runs[route] = dict(
            fed=fed, logits=[o[:, -1:, :V].float() for o in whole],
            enc_kv=[t.full_tensor() if m is not None else t
                    for t in enc_kv],
            prefill_ms=prefill_ms, decode_tok_per_s=n_steps * B / decode_s,
            k3_launches=k3, k4_launches=k4, k5_launches_prefill=k5,
            k5_launches=mg.moe_gemm.launches)
        del model, dmodel, cache, first, whole, enc_kv
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["plain"]
    agree = [logits_agree(torch, x, y) for x, y in zip(a["logits"],
                                                      b["logits"])]
    worst = max(agree, key=lambda r: r["rel_diff"])
    enc = float(np.max([rel_max(x, y) for x, y in zip(a["enc_kv"],
                                                        b["enc_kv"])]
                       or [0.0]))
    return dict(arch=cfg.name, n_layers=cfg.n_layers,
                encoder_layers=cfg.encoder_layers, batch=B,
                prompt=S["frames"] if encdec else P, frontend_embeds=N,
                gen=gen, mesh_vs_plain=worst,
                enc_kv_mesh_vs_plain=enc if encdec else None,
                prefill_ms_mesh=a["prefill_ms"],
                prefill_ms_plain=b["prefill_ms"],
                decode_tok_per_s_mesh=a["decode_tok_per_s"],
                decode_tok_per_s_plain=b["decode_tok_per_s"],
                **{k: a[k] for k in ("k3_launches", "k4_launches",
                                     "k5_launches_prefill", "k5_launches")},
                finite=all_finite(torch, *a["logits"], *a["enc_kv"]))


def spmd_memory(torch, mesh, spec):
    """The bytes the card holds for ``spec``'s train step's arguments
    (parameters, AdamW state and batch, as DTensors on ``mesh``) and the
    most bytes allocated over one step: the step's model is built on the
    meta device (its weights are the arguments alone, as in the dry run),
    the stats are reset once the arguments are resident, and the peak is
    counted above what was resident then, the arguments' bytes added."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import step_placements
    dev = torch.device("cuda:0")
    cfg = get_config(spec["arch"])
    model = build_model(cfg, use_kernels=False, device=dev).init(
        torch.Generator(dev).manual_seed(SPMD["seed"]))
    p0 = {n: t.detach() for n, t in model.named_parameters()}
    del model
    _, opt, step = steps.make_train_step(cfg, device="meta", mesh=mesh)
    s0 = opt.init(p0)
    b0 = synthetic_lm_batch(np.random.default_rng(SPMD["seed"]),
                            spec["batch"], spec["seq"], cfg.vocab, dev)
    places = step_placements("train", mesh, params=p0, opt_state=s0,
                             batch=b0)["in"]
    args = tuple(train.distribute(t, pl, mesh)
                 for t, pl in zip((p0, s0, b0), places))
    del p0, s0, b0
    held = sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(args))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out[2].full_tensor()))
    del out, args
    torch.cuda.empty_cache()
    return dict(argument_bytes=held, resident_at_reset=base,
                max_memory_allocated=peak, step_peak=peak - base + held,
                finite=finite)


def spmd_cost(torch, pred, step_flops, measured, step_ms):
    """The ``cost`` line: the dry run's prediction ``pred`` of the train
    step against its ``step_flops`` (the unsharded step's count) and the
    card's ``measured`` bytes and step times."""
    from repro_torch.core.profiles import GPU_HBM_BW, GPU_PEAK_FLOPS
    step_s = statistics.median(step_ms) / 1e3
    ma = pred["memory_analysis"]
    got = {"argument_size": abs(ma["argument_size"]
                                - measured["argument_bytes"])
           / measured["argument_bytes"],
           "peak_size": abs(ma["peak_size"] - measured["step_peak"])
           / measured["step_peak"]}
    line = dict(
        arch=SPMD["train"][0]["arch"], batch=SPMD["train"][0]["batch"],
        seq=SPMD["train"][0]["seq"], mesh=[1, 1], strategy="tp_fsdp",
        predicted={k: pred[k] for k in (
            "flops_per_device", "matmul_flops_per_device",
            "bytes_per_device", "memory_analysis", "cost_method",
            "memory_method", "spmd_s")},
        step_flops=step_flops,
        matmul_over_step_flops=pred["matmul_flops_per_device"] / step_flops,
        measured=measured, step_ms_mesh=step_ms, median_step_s=step_s,
        flop_bound_s=pred["flops_per_device"] / GPU_PEAK_FLOPS,
        flop_bound_over_step=pred["flops_per_device"] / GPU_PEAK_FLOPS
        / step_s,
        byte_time_s=pred["bytes_per_device"] / GPU_HBM_BW,
        byte_time_over_step=pred["bytes_per_device"] / GPU_HBM_BW / step_s,
        rel_err=got, limits=COST_TOL,
        err_over_limit={k: v / COST_TOL[k] for k, v in got.items()})
    emit("cost", **line)
    require(pred["matmul_flops_per_device"] == step_flops,
            f"cost: matmul FLOPs a device on 1×1 "
            f"{pred['matmul_flops_per_device']} != step_flops {step_flops}")
    require(line["flop_bound_s"] <= step_s,
            f"cost: the FLOP bound {line['flop_bound_s']} s is above the "
            f"measured step {step_s} s: the count is too high")
    for k, v in got.items():
        require(not v > COST_TOL[k], f"cost: predicted {k} {ma[k]} is "
                f"{v} off the card's, over {COST_TOL[k]}")
    require(measured["finite"], "cost: the measured step's loss not finite")
    return line


def run_spmd(torch):
    """Phase 18: the dry run's cost of smollm-360m's train step on the 1×1
    mesh (before NCCL starts: the dry run's fake group needs no other);
    NCCL at world size 1 and the 1×1 mesh of ``fit_mesh``; smollm-360m's
    and hymba-1.5b's DTensor train steps against the plain step, and
    smollm's arguments and peak memory a step against the prediction;
    llama3.2-3b, mixtral-8x22b, rwkv6-1.6b, llava-next-34b,
    seamless-m4t-large-v2 and hymba-1.5b (each cut in depth) on the mesh
    route."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, train
    t0 = time.perf_counter()
    costed = SPMD["train"][0]
    pred = dryrun.step_cost(get_config(costed["arch"]), "train",
                            costed["batch"], costed["seq"], (1, 1), "tp_fsdp")
    step_flops = dryrun.step_record(get_config(costed["arch"]), dict(
        kind="train", batch=costed["batch"], seq=costed["seq"]))["step_flops"]
    mesh = train.fit_mesh(torch.device("cuda:0"))
    try:
        group = dict(backend=dist.get_backend(),
                     world=dist.get_world_size(),
                     mesh=list(mesh.shape),
                     axes=list(mesh.mesh_dim_names))
        # each case on a line of its own as it ends ("spmd_case"), then
        # all of them on the phase's line
        trained = {}
        for spec in SPMD["train"]:
            t = time.perf_counter()
            trained[spec["arch"]] = spmd_train(torch, mesh, spec)
            trained[spec["arch"]]["s"] = time.perf_counter() - t
            emit("spmd_case", kind="train", **trained[spec["arch"]])
        measured = spmd_memory(torch, mesh, costed)
        infer = {}
        for arch, n_layers in SPMD["infer"]:
            t = time.perf_counter()
            infer[arch] = spmd_infer(torch, mesh, arch, n_layers)
            infer[arch]["s"] = time.perf_counter() - t
            emit("spmd_case", kind="infer", **infer[arch])
    finally:
        dist.destroy_process_group()
    emit("spmd", **group, train=trained, infer=infer,
         s=time.perf_counter() - t0)
    require(group["backend"] == "nccl" and group["world"] == 1
            and group["mesh"] == [1, 1], f"spmd: the group {group}")
    for arch, step in trained.items():
        for k, v in step["err_over_limit"].items():
            require(not v > 1.0 and v == v,
                    f"spmd: {arch}'s DTensor train step against the plain "
                    f"step, {k} {step[k]} > {step['limits'][k]}")
        require(step["finite"], f"spmd: {arch}: a non-finite loss or "
                "gradient")
    for arch, r in infer.items():
        require(r["finite"], f"spmd: {arch}'s mesh-route logits not finite")
        require(r["mesh_vs_plain"]["ok"],
                f"spmd: {arch} mesh route != plain: {r['mesh_vs_plain']}")
        # K3 once a layer of the mesh route's prefill (an encoder's)
        want_k3 = 0 if arch.startswith("rwkv") else (
            r["encoder_layers"] or r["n_layers"])
        require(r["k3_launches"] == want_k3,
                f"spmd: K3 launched {r['k3_launches']} times in {arch}'s "
                f"mesh-route prefill, want {want_k3}")
    enc = infer["seamless-m4t-large-v2"]["enc_kv_mesh_vs_plain"]
    require(not enc > ENC_TOL, f"spmd: seamless's (k, v) on the mesh route "
            f"{enc} > {ENC_TOL} of the route without a mesh")
    require(infer["mixtral-8x22b"]["k5_launches"] > 0,
            "spmd: K5 never launched on mixtral's mesh route")
    require(infer["rwkv6-1.6b"]["k4_launches"] > 0,
            "spmd: K4 never launched on rwkv6's mesh route")
    cost = spmd_cost(torch, pred, step_flops, measured,
                     trained[costed["arch"]]["step_ms_mesh"])
    return {"train": trained, "infer": infer, "cost": cost}


# --------------------------------------------------------------------------
# phase 19: FedZero scheduling sites of H100 cards profiled by the dry run


def sites_run(torch, rows, bk):
    """tests/test_pod_sites.py's FedZero set-up over the sites of
    ``rows`` (the registry made anew from them) on backend ``bk``."""
    from repro_torch.core import (FLSimulation, ProxyTrainer, make_strategy,
                                  registry_from_roofline)
    from repro_torch.core.profiles import GPU_CARD_W
    from repro_torch.data.traces import make_scenario
    S = SITES
    reg = registry_from_roofline(rows, shape=S["shape"],
                                 n_sites_per_arch=S["n_sites_per_arch"],
                                 chips_per_site=S["chips_per_site"])
    sc = make_scenario("global", n_clients=len(reg), days=1, seed=0,
                       peak_w=S["chips_per_site"] * GPU_CARD_W * 1.5,
                       backend=bk)
    # the registry's power domains by name (nine sites fill nine of the
    # scenario's ten: the tenth keeps its own name and has no site)
    sc.domain_names = (list(reg.domains)
                       + list(sc.domain_names)[len(reg.domains):])
    strat = make_strategy("fedzero", reg, n=S["n"], d_max=S["d_max"], seed=0,
                          backend=bk)
    sim = FLSimulation(reg, sc, strat, ProxyTrainer(len(reg), k=S["k"]),
                       eval_every=1)
    t = time.perf_counter()
    summary = sim.run(until_step=S["hours"] * 60)
    if bk.name != "numpy":
        torch.cuda.synchronize()
    rounds = [(r.start_step, r.duration, r.contributor_idx.tolist(),
               r.energy_used) for r in sim.results]
    return reg, summary, rounds, time.perf_counter() - t


def dryrun_against_reference():
    """XLA_FLOPS' steps as DTensor programs on the fake group under this
    torch (``launch.dryrun.spmd_run``, meta tensors): each one's
    ``flops_per_device`` over the reference's count, its largest ops."""
    from repro_torch.launch import dryrun
    out = {}
    with dryrun.fake_group():
        for case, want in XLA_FLOPS.items():
            cfg, shape, mesh = dryrun.case_config(case)
            t = time.perf_counter()
            run = dryrun.spmd_run(cfg, shape, dryrun.fake_mesh(mesh),
                                  "tp_fsdp")
            out[case] = dict(
                ok=run["ok"], flops_per_device=run["cost"]["flops"],
                xla_flops=want, over_xla=run["cost"]["flops"] / want,
                flops_by_op=dryrun.largest(run["flops_by_op"], 6),
                s=time.perf_counter() - t)
    return out


def run_sites(torch, cuda_bk, host):
    """Phase 19: the dry run under this torch against the reference's XLA
    count (XLA_FLOPS, within FLOP_RATIO); train_4k × single_pod records of
    SITES' archs from the dry run in process (FLOPs within SITES_TOL of
    torch 2.13's, SITES_2_13), the registry of their sites, and FedZero
    over them on ``cuda`` (K1/K2's counts set to 0 just before, read just
    after) and on NumPy: identical rounds and energy, and the reference
    test's site ratios, within SITES_TOL of the ones 2.13's records
    give."""
    from repro_torch.core.profiles import gpu_site_profile
    from repro_torch.kernels import counter_hash as ch
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    reference = dryrun_against_reference()
    emit("sites_reference", cases=reference, limit=FLOP_RATIO,
         s=time.perf_counter() - t0)
    t1 = time.perf_counter()
    with dryrun.fake_group():
        rows = [dryrun.dryrun_one(arch, SITES["shape"], "single_pod",
                                  spmd=True, verbose=False)
                for arch in SITES["archs"]]
    records_s = time.perf_counter() - t1
    ch.piece_window.launches = 0
    ch.forecast_z.launches = 0
    reg, s_cuda, r_cuda, cuda_s = sites_run(torch, rows, cuda_bk)
    launches = {"piece_window": ch.piece_window.launches,
                "forecast_z": ch.forecast_z.launches}
    _, s_np, r_np, numpy_s = sites_run(torch, rows, host)
    per = {}
    for c in reg.clients.values():
        arch = c.name.split("-", 1)[1].rsplit("-", 1)[0]
        per.setdefault(arch, {"delta_wmin_per_step": c.delta,
                              "capacity_steps_per_min": c.m_max_capacity})
    kimi, smol = per["kimi-k2-1t-a32b"], per["smollm-360m"]
    # the ratios the 2.13 records give: δ and capacity of a site of
    # SITES' cards, as registry_from_roofline profiles it
    want = {a: gpu_site_profile(f, b, SITES["chips_per_site"], 1)
            for a, (f, b) in SITES_2_13.items()}
    line = dict(
        archs=list(SITES["archs"]), sites=len(reg),
        records={r["arch"]: {**{k: r[k] for k in (
            "flops_per_device", "bytes_per_device", "memory_analysis",
            "flops_by_op", "spmd_s", "run_s")},
            "flops_over_2_13": r["flops_per_device"]
            / SITES_2_13[r["arch"]][0]} for r in rows},
        records_s=records_s, per_arch=per,
        delta_kimi_over_smollm=kimi["delta_wmin_per_step"]
        / smol["delta_wmin_per_step"],
        capacity_smollm_over_kimi=smol["capacity_steps_per_min"]
        / kimi["capacity_steps_per_min"],
        delta_kimi_over_smollm_2_13=want["kimi-k2-1t-a32b"][1]
        / want["smollm-360m"][1],
        capacity_smollm_over_kimi_2_13=want["smollm-360m"][0]
        / want["kimi-k2-1t-a32b"][0],
        rounds=len(r_cuda), total_energy_wh=s_cuda["total_energy_wh"],
        total_energy_wh_numpy=s_np["total_energy_wh"],
        kernel_launches=launches, util_mode="dense", cuda_s=cuda_s,
        numpy_s=numpy_s, s=time.perf_counter() - t0)
    emit("sites", **line)
    for case, r in reference.items():
        require(r["ok"], f"sites: {case}'s step off its out-placements")
        require(not abs(r["over_xla"] - 1) > FLOP_RATIO,
                f"sites: {case}'s FLOPs a device {r['flops_per_device']} "
                f"are {r['over_xla']} of the reference's XLA count "
                f"{r['xla_flops']}, beyond {FLOP_RATIO}")
    for arch, r in line["records"].items():
        require(not abs(r["flops_over_2_13"] - 1) > SITES_TOL,
                f"sites: {arch}'s FLOPs a device {r['flops_per_device']} "
                f"are {r['flops_over_2_13']} of torch 2.13's "
                f"{SITES_2_13[arch][0]}, beyond {SITES_TOL}")
    for k in ("delta_kimi_over_smollm", "capacity_smollm_over_kimi"):
        require(not abs(line[k] / line[k + "_2_13"] - 1) > SITES_TOL,
                f"sites: {k} {line[k]} against 2.13's records' "
                f"{line[k + '_2_13']}, beyond {SITES_TOL}")
    require(all(r["spmd_ok"] and r["shapes_ok"] for r in rows),
            "sites: a dry-run record failed its shapes or placements")
    require(r_cuda == r_np, "sites: cuda rounds differ from numpy rounds")
    require(s_cuda["total_energy_wh"] == s_np["total_energy_wh"],
            "sites: total energy differs")
    require(len(r_cuda) >= 1 and s_cuda["total_energy_wh"] > 0,
            f"sites: {len(r_cuda)} rounds, "
            f"{s_cuda['total_energy_wh']} Wh")
    require(line["delta_kimi_over_smollm"] > SITES["ratio"]
            and line["capacity_smollm_over_kimi"] > SITES["ratio"],
            "sites: kimi's δ or smollm's capacity not 5× the other's")
    require(launches["piece_window"] + launches["forecast_z"] > 0,
            f"sites: no kernel launched: {launches}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=1_000_000)
    # 131 steps of the 1M-client day (20 rounds, the least the phase
    # takes): cut from 200 (34 rounds), then 150 (23), to keep the whole
    # script inside its time (PERF.md §4)
    ap.add_argument("--until-step", type=int, default=131)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + NAMED_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES + NAMED_PHASES):
        ap.error(f"--phases: not in {PHASES + NAMED_PHASES}: {phases}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.backend import get_backend
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    t = time.perf_counter()
    libs = _build.build(*_build.all_sources())
    build_s = time.perf_counter() - t
    ptxas = {}
    for so in libs:
        log = so.with_suffix(".log")
        ptxas[so.name] = [ln for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Compiling" in ln or "arning" in ln
                          ] if log.exists() else None
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s, ptxas=ptxas)
    spills = [ln for lines in ptxas.values() for ln in lines or ()
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads"
              not in ln]
    require(not spills, f"a kernel spills registers: {spills}")
    # float32 products in full float32 on the card, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    host = get_backend("numpy")
    cuda_bk = get_backend()
    require(cuda_bk.device == torch.device("cuda:0"), "default backend device")
    require(get_backend("torch") is cuda_bk, "torch is not the cuda backend")

    if "kernels" in phases:
        kern = check_kernels(torch, cuda_bk, host)
    if "ops" in phases:
        t = time.perf_counter()
        check_ops(torch, cuda_bk, host)
        emit("ops", backend=cuda_bk.name, bit_equal=True,
             s=time.perf_counter() - t)
    if "main_path" in phases:
        launches = run_scheduler(torch, cuda_bk, args)
    if "service" in phases:
        service = run_service(torch, cuda_bk, host)
        emit("service_phase", s=service["s"])
    if "k3" in phases:
        attn = check_flash_attention(torch)
    if "model" in phases:
        model = run_model(torch)
    if "k4" in phases:
        scan = check_rwkv_scan(torch)
    if "rwkv" in phases:
        rwkv = run_rwkv(torch)
    if "k5" in phases:
        gemm = check_moe_gemm(torch)
    if "moe" in phases:
        moe = run_moe(torch)
    if "kimi" in phases:
        run_kimi(torch)
    if "mla" in phases:
        run_mla(torch)
    if "train" in phases:
        run_train(torch)
    if "launch" in phases:
        run_launch(torch)
    if "vlm" in phases:
        run_vlm(torch)
    if "encdec" in phases:
        run_encdec(torch)
    if "hybrid" in phases:
        run_hybrid(torch)
    if "spmd" in phases:
        run_spmd(torch)
    if "sites" in phases:
        run_sites(torch, cuda_bk, host)
    if not set(PHASES) <= set(phases):
        return 0
    kern["flash_attention"] = attn[(K3_TIMED[0], "torch.bfloat16")]
    launches["flash_attention"] = model["k3_launches"]
    kern["rwkv_scan"] = scan
    launches["rwkv_scan"] = rwkv["k4_launches"]
    kern["moe_gemm"] = gemm
    launches["moe_gemm"] = moe["k5_launches"]

    kernels = []
    for name in ("piece_window", "forecast_z", "flash_attention",
                 "rwkv_scan", "moe_gemm"):
        m = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m.get("library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
