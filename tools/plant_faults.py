#!/usr/bin/env python3
"""Run chip_smoke.py's kernels (K1/K2), K3, model, K4, rwkv, K5, moe,
train, launch, encdec and hybrid checks on copies of the tree, each with one
planted fault, to show where each check's tolerance sits.

    python3 tools/plant_faults.py [--faults NAME,...]

For each fault it copies ``src/`` and ``chip_smoke.py`` into
``build/planted/<name>/`` (git-ignored), replaces one line (or a few) of
the copy,
runs ``chip_smoke.py --phases <phase>`` there for each phase the fault
touches (the copy builds its own kernels), and prints, as one JSON line
per run, what the checks read. The phases ``spmd_cpu`` and
``spmd_families_cpu`` run on the CPU instead: the two programs of
``tests/test_torch_spmd.py`` or ``tests/test_torch_spmd_families.py``
(the reference's sharded step on four forced host devices, the port's on
four gloo ranks) in the copy, and every one of that file's readings, over
its limit (``--faults sound_spmd`` and ``sound_spmd_families`` plant
nothing, for the sound readings); ``dryrun_cost_cpu`` the readings of
``tests/test_torch_dryrun_cost.py`` (the dry run's per-device FLOPs
against ``step_flops`` on 1×1, the reference's XLA count on 2×2 and a
layer counted by hand; ``sound_dryrun_cost`` plants nothing).
``--phases`` runs only the named phases of each fault (``--faults
ffn_hidden_replicated_over_model --phases sites``: the card's check of
the dry run alone).
What ``chip_smoke.py`` reads: the kernel lines' errors, the rwkv line's
route, decode and state checks, the moe line's per-layer route and oracle,
decode, cache and float32 checks, the train and launch phases'
card-against-CPU parity, the vlm and encdec lines' route, decode and
teacher-forced checks, the hybrid line's route, decode (logits, KV slots,
Mamba state) and float32 card-against-CPU checks, and the error that
stopped the run. A
sound tree passes every check; each planted fault must fail one. Needs a
CUDA device, as chip_smoke.py does.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name -> (file, the sound line(s), the faulty line(s), phases to run)
FAULTS = {
    "k3_pv_drops_lo": (
        # P V on P's high bf16 part alone: the split's cost and its check
        "src/repro_torch/csrc/flash_attention.cu",
        "        wgmma_bf16_rs<1>(o, &plo[4 * kk], dv, 1);\n", "",
        ("k3", "model")),
    "k3_producer_skips_last_kv_stage": (
        # an item's last K and V boxes start past Sk: TMA fills zeros
        "src/repro_torch/csrc/flash_attention.cu",
        ("            tma_load_4d(sk(s) + c * T::kKBox, &tmap_k, &k_full[s], 64 * c,\n"
         "                        kj * kTK, kvh, it.b);",
         "            tma_load_4d(sv(s) + c * T::kKBox, &tmap_v, &v_full[s], 64 * c,\n"
         "                        kj * kTK, kvh, it.b);"),
        ("            tma_load_4d(sk(s) + c * T::kKBox, &tmap_k, &k_full[s], 64 * c,\n"
         "                        kj < it.last ? kj * kTK : p.Sk + kTK, kvh, it.b);",
         "            tma_load_4d(sv(s) + c * T::kKBox, &tmap_v, &v_full[s], 64 * c,\n"
         "                        kj < it.last ? kj * kTK : p.Sk + kTK, kvh, it.b);"),
        ("k3", "model")),
    "k3_frees_stage_before_wgmma_wait": (
        # the previous tile's stage freed as soon as its P V is issued
        "src/repro_torch/csrc/flash_attention.cu",
        ("        wgmma_wait<1>();  // S has arrived",
         "        if (lane == 0) mbar_arrive(&kv_empty[s_prev]);  // its stage is read"),
        ("        if (lane == 0) mbar_arrive(&kv_empty[s_prev]);\n"
         "        wgmma_wait<1>();  // S has arrived", ";"),
        ("k3", "model")),
    "k3_call_drops_window": (
        # the model's K3 calls without their window: the encoder of an
        # encoder-decoder attends to every earlier frame, hymba's prefill
        # to every earlier token
        "src/repro_torch/models/attention.py",
        "v.transpose(1, 2), causal=True, window=w)",
        "v.transpose(1, 2), causal=True, window=0)", ("encdec", "hybrid")),
    "k3_causal_diagonal_off_by_one": (
        "src/repro_torch/csrc/flash_attention.cu",
        "ok = ok && kpos <= qpos;", "ok = ok && kpos < qpos;",
        ("k3", "model")),
    "k2_premix_of_neighbouring_row": (
        "src/repro_torch/csrc/counter_hash.cu",
        "row_h[i] = sm64(rows[r0 + i] ^ fold);",
        "row_h[i] = sm64(rows[r0 + ((i ^ 1) < n_rows ? i ^ 1 : i)] ^ fold);",
        ("kernels",)),
    "k2_walk_wraps_one_column_early": (
        "src/repro_torch/csrc/counter_hash.cu",
        "if (++cc == W) {", "if (++cc == W - 1) {", ("kernels",)),
    "k4_state_not_carried": (
        # each chunk of a group starts from its own contribution alone
        "src/repro_torch/csrc/rwkv_scan.cu",
        "float4 st = *reinterpret_cast<float4*>(sS + o);",
        "float4 st = make_float4(0.f, 0.f, 0.f, 0.f);",
        ("k4", "rwkv")),
    "k4_group_state_not_carried": (
        # the state entering a group is the previous group's own alone
        "src/repro_torch/csrc/rwkv_scan.cu",
        "s = p.carry_decay[slot * dh + i] * s + *x;", "s = *x;",
        ("k4", "rwkv")),
    "k4_group_decay_off_by_one": (
        # a group's keys decayed by their own step too
        "src/repro_torch/csrc/rwkv_scan.cu",
        ("        sk[t * LD + tid] *= pow2(suffix);\n"
         "        suffix += sL[t * LD + tid];",),
        ("        suffix += sL[t * LD + tid];\n"
         "        sk[t * LD + tid] *= pow2(suffix);",), ("k4", "rwkv")),
    "k4_ragged_last_chunk_dropped": (
        "src/repro_torch/csrc/rwkv_scan.cu",
        "for (int t0 = t_begin; t0 < t_end; t0 += kT) {",
        "for (int t0 = t_begin; t0 + kT <= t_end; t0 += kT) {",
        ("k4", "rwkv")),
    "k4_decay_anchor_off_by_one": (
        # the queries' anchor one token late, the keys' where it was
        "src/repro_torch/csrc/rwkv_scan.cu",
        "pow2(lprev - sL[((t / kSub) * kSub - 1) * LD + c]);",
        "pow2(lprev - sL[((t / kSub) * kSub) * LD + c]);", ("k4", "rwkv")),
    "decode_stale_shift": (
        "src/repro_torch/models/ssm.py",
        "return y, state._replace(shift=x[:, 0], S=S_new)",
        "return y, state._replace(S=S_new)", ("rwkv",)),
    "k5_wide_producer_skips_last_k_stage": (
        "src/repro_torch/csrc/moe_gemm.cu",
        "const int k0 = kb * kWK;",
        # the last stage's boxes start past d: TMA fills them with zeros
        "const int k0 = kb < nk - 1 ? kb * kWK : p.d;", ("k5", "moe")),
    "k5_narrow_ragged_c_unmasked": (
        "src/repro_torch/csrc/moe_gemm.cu",
        ("if (c < p.C)", "if (c + 1 < p.C)"),
        ("if (true)", "if (true)"), ("k5",)),
    "k5_wide_walk_drops_last_tile": (
        "src/repro_torch/csrc/moe_gemm.cu",
        "const int n_tiles = p.E * tiles_c * tiles_f;",
        "const int n_tiles = p.E * tiles_c * tiles_f - 1;", ("k5", "moe")),
    "k5_wide_releases_stage_before_wgmma_wait": (
        "src/repro_torch/csrc/moe_gemm.cu",
        ("if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);  // ...free it",
         "if (lane == 0) mbar_arrive(&empty[prev]);"),
        # each stage freed once, as soon as its own group is issued
        ("if (lane == 0) mbar_arrive(&empty[s]);", ";"), ("k5", "moe")),
    "k5_f32_skip_last_d_step": (
        "src/repro_torch/csrc/moe_gemm.cu",
        "for (int k0 = 0; k0 < p.d; k0 += kFK) {",
        "for (int k0 = 0; k0 < p.d - kFK; k0 += kFK) {", ("k5", "moe")),
    "combine_ignores_gate": (
        "src/repro_torch/models/moe.py",
        "w = (gate.reshape(T * K) * keep_u.float())[:, None]",
        "w = keep_u.float()[:, None]", ("moe",)),
    "hybrid_mamba_state_not_carried": (
        # each decode step starts every layer's Mamba branch from a zeroed
        # conv and h, as if the prefill had left no state
        "src/repro_torch/models/transformer.py",
        "            layer = (layer, ssm_mod.MambaState(*(t[i] for t in m)))",
        "            layer = (layer, ssm_mod.MambaState(\n"
        "                *(torch.zeros_like(t[i]) for t in m)))", ("hybrid",)),
    "grouped_pack_stride_off_by_one_group": (
        "src/repro_torch/models/moe.py",
        "sorted_e * (G * C) + grp * C + rank",
        "sorted_e * ((G - 1) * C) + grp * C + rank", ("moe",)),
    # the paper models, planted on the card side only (the train phase
    # holds the trainer on the card to the same trainer on the CPU)
    "kwt_exact_gelu_on_card": (
        "src/repro_torch/models/paper_models.py",
        '            x = x + F.gelu(hn @ p["w1"], approximate="tanh") @ p["w2"]',
        '            x = x + F.gelu(hn @ p["w1"], approximate="none" if '
        'hn.is_cuda else "tanh") @ p["w2"]', ("train",)),
    "lstm_forget_gate_without_bias_on_card": (
        "src/repro_torch/models/paper_models.py",
        "            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * "
        "torch.tanh(g)",
        "            c = torch.sigmoid(f + (0.0 if f.is_cuda else 1.0)) * c + "
        "torch.sigmoid(i) * torch.tanh(g)", ("train",)),
    "convnet_head_nchw_on_card": (
        "src/repro_torch/models/paper_models.py",
        "        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order",
        "        x = (x if x.is_cuda else x.permute(0, 2, 3, 1)).reshape("
        "x.shape[0], -1)", ("train",)),
    # the sharded train step (launch/steps.py, a DTensor program), held on
    # the CPU to the reference's sharded step and to the port's 1×1 step
    # (tests/test_torch_spmd.py, four gloo ranks; phase "spmd_cpu"): each
    # gradient's partial sums over the data axes taken as the whole
    "spmd_grad_not_reduced_over_data": (
        "src/repro_torch/launch/steps.py",
        "    return grad.redistribute(grad.device_mesh, placements)\n",
        "    from torch.distributed.tensor import DTensor, Partial, Replicate\n"
        "    grad = DTensor.from_local(grad.to_local(), grad.device_mesh, [\n"
        "        Replicate() if isinstance(p, Partial) and axis != 'model'\n"
        "        else p for axis, p in zip(grad.device_mesh.mesh_dim_names,\n"
        "                                  grad.placements)], run_check=False)\n"
        "    return grad.redistribute(grad.device_mesh, placements)\n",
        ("spmd_cpu",)),
    # the hybrid's Mamba scan on a mesh (models/ssm.py, per rank in
    # local_map), held on the CPU to the reference's sharded step
    # (tests/test_torch_spmd_families.py, four gloo ranks; phase
    # "spmd_families_cpu"): A's gradient over the batch split taken as
    # replicated, where each rank's is its rows' partial sum
    "hybrid_scan_A_grad_not_partial": (
        "src/repro_torch/models/ssm.py",
        "    a_grad = tuple(Partial() if r == \"batch\" else p for r, p in "
        "zip(roles, a))\n",
        "    a_grad = a\n", ("spmd_families_cpu",)),
    # the DecoderLM train step, planted on the card side only (the launch
    # phase holds it to the same step on the CPU)
    "swiglu_w1_w3_swapped_on_card": (
        "src/repro_torch/models/common.py",
        "    h = F.silu(x @ w1) * (x @ w3)\n",
        "    w1, w3 = (w3, w1) if x.is_cuda else (w1, w3)\n"
        "    h = F.silu(x @ w1) * (x @ w3)\n", ("launch",)),
    # the dry run's per-device cost (launch/dryrun.py), held on the CPU by
    # tests/test_torch_dryrun_cost.py's readings (phase "dryrun_cost_cpu"):
    # each DTensor op counted once at its global shapes (run on plain meta
    # tensors of them) in place of the rank-local ops it becomes
    "cost_counts_global_shapes": (
        "src/repro_torch/launch/dryrun.py",
        ("            if any(t is DTensor for t in types):\n"
         "                return NotImplemented\n",
         "            if not COSTS[\"quiet\"]:\n"),
        ("            if any(t is DTensor for t in types):\n"
         "                from torch.utils._pytree import tree_map\n"
         "                whole = tree_map(lambda x: torch.empty(\n"
         "                    x.shape, dtype=x.dtype, device=\"meta\")\n"
         "                    if isinstance(x, DTensor) else x, (args, kwargs))\n"
         "                got = func(*whole[0], **whole[1])\n"
         "                self._count(func, *whole, got, _tensors(got), None)\n"
         "                self.on_mesh = True\n"
         "                return NotImplemented\n",
         "            if not (COSTS[\"quiet\"] or getattr(self, \"on_mesh\", 0)):\n"),
        ("dryrun_cost_cpu",)),
    # the dry run's per-device cost against the reference: the FFN's
    # hidden activation pinned replicated over model before its down
    # projection, so that each rank does that projection's weight-gradient
    # product whole; held by the readings of
    # tests/test_torch_dryrun_cost.py (its 2×16 case) and by chip_smoke.py's
    # sites phase (the reference's XLA counts, torch 2.13's 16×16 records)
    "ffn_hidden_replicated_over_model": (
        "src/repro_torch/models/common.py",
        "    h = maybe_shard(h, *((BATCH_AXES,) + (None,) * (h.ndim - 2)"
        " + (\"model\",)))\n",
        "    h = maybe_shard(h, *((BATCH_AXES,) + (None,) * (h.ndim - 2)"
        " + (None,)))\n",
        ("dryrun_cost_cpu", "sites")),
}
# the sound tree through a phase (nothing planted): each must pass
SOUND = {"sound_spmd": (None, None, None, ("spmd_cpu",)),
         "sound_spmd_families": (None, None, None, ("spmd_families_cpu",)),
         "sound_dryrun_cost": (None, None, None, ("dryrun_cost_cpu",))}
# a CPU phase -> the test file whose two programs it runs
CPU_PHASES = {"spmd_cpu": "test_torch_spmd",
              "spmd_families_cpu": "test_torch_spmd_families"}
FAULTS.update(SOUND)
KEEP = ("name", "case", "R", "W", "equal_plain", "equal_numpy", "dtype",
        "logit_mean", "finite", "ms", "library_ms", "k3_launches", "k3_vs_einsum",
        "variant", "max_abs_err_out", "max_abs_err_state", "err_over_limit_out",
        "err_over_limit_state", "k4_launches", "k4_vs_plain",
        "decode_vs_prefill", "state_vs_prefill", "f32_k4_vs_plain",
        "f32_k4_vs_plain_state", "max_abs_err", "err_over_limit",
        "k5_vs_library_max_abs_err", "k5_equals_library", "k5_launches",
        "k5_variant_launches",
        "worst", "per_layer", "k5_vs_einsum_bf16_model",
        "cache_vs_prefill", "f32_k5_vs_einsum", "model", "logits", "losses",
        "sample_losses", "params", "accuracy_card", "accuracy_cpu",
        "err_over_limit", "grads", "worst_grad", "worst_param",
        "encode_k3_vs_einsum", "decode_k3_vs_einsum_enc_kv",
        "decode_vs_teacher_forced", "mamba_vs_prefill", "f32_k3_vs_einsum",
        "f32_decode_vs_prefill", "f32_card_vs_cpu", "cases", "records",
        "delta_kimi_over_smollm", "delta_kimi_over_smollm_2_13")


def copy_tree(dst: Path, path: str, sound, faulty) -> Path:
    """``src/``, ``tests/`` and ``chip_smoke.py`` copied to ``dst`` with
    each line (or lines) of ``sound`` in the copy's ``path`` replaced by
    ``faulty``'s (none where ``sound`` is None)."""
    shutil.rmtree(dst, ignore_errors=True)
    for tree in ("src", "tests"):
        shutil.copytree(ROOT / tree, dst / tree,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if sound is None:
        return dst
    if isinstance(sound, str):
        sound, faulty = (sound,), (faulty,)
    text = (dst / path).read_text()
    for good, bad in zip(sound, faulty):
        if text.count(good) != 1:
            raise RuntimeError(f"{dst.name}: {good!r} is not once in {path}")
        text = text.replace(good, bad)
    (dst / path).write_text(text)
    return dst


def plant(name: str) -> Path:
    path, sound, faulty, _ = FAULTS[name]
    return copy_tree(ROOT / "build" / "planted" / name, path, sound, faulty)


def run_spmd_cpu(name: str, phase: str) -> dict:
    """The two programs of the phase's test file (tests/test_torch_spmd.py
    or tests/test_torch_spmd_families.py) in the planted copy, and that
    file's readings of their results."""
    import importlib
    import tempfile
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    spmd = importlib.import_module(CPU_PHASES[phase])
    tree = plant(name)
    out = tempfile.mkdtemp(prefix="planted_spmd_")
    procs = spmd.start(out, tree)
    logs = {role: p.communicate(timeout=900)[0] for role, p in procs.items()}
    failed = {role: logs[role][-2000:] for role, p in procs.items()
              if p.returncode != 0}
    if failed:
        return {"fault": name, "phase": phase, "rc": 1, "read": [],
                "error": json.dumps(failed)[:2000]}
    read = spmd.readings(spmd.load(out))
    bad = sorted(k for k, v in read.items() if not v <= 1.0)
    return {"fault": name, "phase": phase, "rc": 1 if bad else 0,
            "read": read, "over_limit": bad,
            "worst": max(read.values()), "error": None}


def run_dryrun_cost_cpu(name: str) -> dict:
    """tests/test_torch_dryrun_cost.py's readings (matmul FLOPs on 1×1
    over ``step_flops``; 2×2 FLOPs over the reference's XLA count; the
    hand-counted layer over the dry run) in the planted copy."""
    tree = plant(name)
    code = ("import json, sys; sys.path[:0] = ['src', 'tests']; "
            "import test_torch_dryrun_cost as t; "
            "print(json.dumps(t.readings()))")
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        return {"fault": name, "phase": "dryrun_cost_cpu", "rc": 1,
                "read": {}, "error": proc.stderr[-2000:]}
    read = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = sorted(k for k, (_, ok) in read.items() if not ok)
    return {"fault": name, "phase": "dryrun_cost_cpu", "rc": 1 if bad else 0,
            "read": {k: v for k, (v, _) in read.items()}, "over_limit": bad,
            "error": None}


def run(name: str, phase: str) -> dict:
    if phase in CPU_PHASES:
        return run_spmd_cpu(name, phase)
    if phase == "dryrun_cost_cpu":
        return run_dryrun_cost_cpu(name)
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", phase],
                          cwd=plant(name), capture_output=True, text=True,
                          timeout=900)
    read = []
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") in ("kernel", "kernel_case", "model", "rwkv",
                                "moe", "train_parity", "launch_parity",
                                "vlm", "encdec", "hybrid", "sites_reference",
                                "sites"):
            read.append({k: rec[k] for k in KEEP if k in rec})
    err = [ln for ln in proc.stderr.splitlines() if "Error" in ln][-1:]
    return {"fault": name, "phase": phase, "rc": proc.returncode,
            "read": read, "error": err[0][:400] if err else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--phases", default=None,
                    help="run only these of each fault's phases")
    args = ap.parse_args(argv)
    only = None if args.phases is None else set(args.phases.split(","))
    caught = True
    for name in args.faults.split(","):
        for phase in FAULTS[name][3]:
            if only is not None and phase not in only:
                continue
            rec = run(name, phase)
            print(json.dumps(rec), flush=True)
            caught = caught and (rec["rc"] == 0 if name in SOUND
                                 else rec["rc"] != 0)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
