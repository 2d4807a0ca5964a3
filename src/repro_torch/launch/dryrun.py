"""Dry run of every (arch × shape × mesh × strategy) on the meta device:
parameter and state accounting per device, and a run of each step that
proves its shapes and counts its FLOPs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out benchmarks/results/dryrun_torch.json

The port of ``repro.launch.dryrun``, narrowed: no device is involved and
nothing is compiled. Per record:

* ``params``, ``active_params``: the config's counts;
* ``state_bytes_per_device``: the bytes each device of the production
  mesh (``make_production_mesh``: 16×16, or 2×16×16) holds under the
  strategy's specs, as the reference's ``_sharded_bytes``: parameters and
  optimizer state (train, the ``default_optimizer``), parameters
  (prefill), parameters and the decode cache (decode, whose cache shards
  its sequence dim over ``model`` unless the strategy says otherwise);
* ``step_flops``: the whole step's FLOPs (unsharded) by
  ``torch.utils.flop_counter.FlopCounterMode`` over a run of the step on
  meta tensors (``make_train_step`` with remat; prefill and decode on
  the reference's route, as the reference's dry run lowers them, since
  the kernels have no meta implementation), and ``shapes_ok``: the step
  returned what it takes (new parameters and state of the same shapes
  and dtypes, a cache of the input's, logits [B, 1, vocab]; an
  encoder-decoder's prefill, the cross-attention K/V of its frames). The
  train and prefill steps of a model with a recurrence over tokens loop
  in Python on meta tensors (rwkv6's, about 0.05 s a token; the hybrid's
  Mamba scan), so they run at the ``PROBE_SEQ`` of their family and their
  FLOPs are the polynomial through those runs at the shape's sequence
  length (``flops_method``): linear for rwkv6; for the hybrid, quadratic
  (``a + b S + c S^2``: the projections and the scan's ``h . C`` are linear
  in S, the einsum route's masked scores quadratic).

The reference's XLA fields (HLO FLOPs and bytes per device, collectives,
memory analysis, compile times) and its layer-count cost probes have no
counterpart here. A step that fails is recorded as an error row, as the
reference records a failure.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from fractions import Fraction

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_archs, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import SHAPES, input_specs, params_spec
from repro_torch.sharding import (STRATEGIES, cache_specs, port_param_specs,
                                  sharded_bytes)

# family -> sequence lengths of the meta runs of its train or prefill
# step, one more than the degree of its FLOPs in the sequence length
PROBE_SEQ = {"ssm": (16, 32), "hybrid": (16, 32, 48)}
PROBE_FIT = {2: "linear", 3: "quadratic"}


def probe_family(cfg):
    return "hybrid" if cfg.hybrid else cfg.family


def through(points, S):
    """The polynomial of degree ``len(points) - 1`` through ``points``
    [(seq, flops), ...] at ``S``, exactly (Lagrange's form in
    fractions)."""
    total = Fraction(0)
    for i, (si, fi) in enumerate(points):
        term = Fraction(fi)
        for j, (sj, _) in enumerate(points):
            if j != i:
                term *= Fraction(S - sj, si - sj)
        total += term
    return total


def cut_specs(specs, kind, s):
    """A train or prefill step's inputs cut to their first ``s`` tokens."""
    cut = {k: v[:, :s] for k, v in
           (specs["batch"] if kind == "train" else specs).items()}
    return {"batch": cut} if kind == "train" else cut


def _same(a, b) -> bool:
    """Whether two trees of tensors (dicts, tuples) have equal shapes and
    dtypes leaf for leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    return a.shape == b.shape and a.dtype == b.dtype


def _run_step(cfg, shape_name, kind, specs):
    """(FLOPs, shapes_ok, optimizer name) of one meta run of the step."""
    B = SHAPES[shape_name]["batch"]
    opt_name = None
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            model, opt, step = make_train_step(cfg, device="meta")
            opt_name = opt.name
            params = dict(model.named_parameters())
            state = opt.init(params)
            new_p, new_s, loss = step(params, state, specs["batch"])
            ok = (_same(new_p, params) and _same(new_s, state)
                  and loss.shape == () and loss.dtype == torch.float32)
        elif kind == "prefill":
            model, step = make_prefill_step(cfg, shape_name, device="meta")
            model.use_kernels = False
            if cfg.encoder_layers > 0:
                enc_kv = step(specs["frames"])
                ok = _same(enc_kv, model.precompute_enc_kv(specs["frames"]))
            else:
                # the cache holds the shape's seq positions: a vlm's
                # frontend embeddings and its tokens
                logits, cache = step(
                    specs["tokens"],
                    frontend_embeds=specs.get("frontend_embeds"))
                ok = (logits.shape == (B, 1, cfg.vocab_padded)
                      and _same(tuple(cache), tuple(model.init_cache(
                          B, SHAPES[shape_name]["seq"]))))
        else:
            model, step = make_decode_step(cfg, shape_name, device="meta")
            model.use_kernels = False
            want = tuple(specs["cache"])
            enc_kv = (specs["enc_kv"],) if "enc_kv" in specs else ()
            logits, cache = step(specs["cache"], specs["tokens"], *enc_kv)
            ok = (logits.shape == (B, 1, cfg.vocab_padded)
                  and _same(tuple(cache), want))
    return fc.get_total_flops(), ok, opt_name


def step_record(cfg, shape_name: str) -> dict:
    """The meta run of ``cfg``'s step for ``shape_name``: kind, optimizer,
    ``step_flops``, ``flops_method``, ``shapes_ok`` and ``run_s``."""
    t = time.perf_counter()
    kind, specs = input_specs(cfg, shape_name)
    seqs = PROBE_SEQ.get(probe_family(cfg))
    if seqs and kind != "decode":
        runs = [_run_step(cfg, shape_name, kind, cut_specs(specs, kind, s))
                for s in seqs]
        exact = through([(s, f) for s, (f, _, _) in zip(seqs, runs)],
                        SHAPES[shape_name]["seq"])
        flops, opt = round(exact), runs[0][2]
        at = ", ".join(map(str, seqs[:-1])) + f" and {seqs[-1]}"
        method = (f"{PROBE_FIT[len(seqs)]} in seq from meta runs at {at}"
                  + ("" if exact.denominator == 1
                     else f" (not integral: {float(exact)!r})"))
        ok = all(r[1] for r in runs)
    else:
        flops, ok, opt = _run_step(cfg, shape_name, kind, specs)
        method = "meta run"
    return {"kind": kind, "optimizer": opt, "step_flops": int(flops),
            "flops_method": method, "shapes_ok": bool(ok),
            "run_s": round(time.perf_counter() - t, 2)}


def state_bytes(cfg, shape_name: str, mesh, strategy: str) -> int:
    """Per-device bytes of the step's resident state under ``strategy``."""
    kind, specs = input_specs(cfg, shape_name)
    skw = STRATEGIES[strategy]
    params = params_spec(cfg, shape_name)
    total = sharded_bytes(params, port_param_specs(params, mesh, **skw), mesh)
    if kind == "train":
        _, opt, _ = make_train_step(cfg, device="meta")
        state = opt.init(params)
        total += sharded_bytes(state, port_param_specs(state, mesh, **skw),
                               mesh)
    elif kind == "decode":
        cache = specs["cache"]
        total += sharded_bytes(cache, cache_specs(
            cache, mesh, seq_over_model=skw.get("seq_over_model", True)), mesh)
    return total


def dryrun_one(arch: str, shape_name: str, mesh_kind: str,
               strategy: str = "tp_fsdp", steps: dict = None,
               verbose: bool = True) -> dict:
    """One record. ``steps`` caches :func:`step_record` by (arch, shape):
    the step's run does not depend on the mesh or the strategy."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"))
    cfg = get_config(arch)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "strategy": strategy, "chips": mesh.size,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "state_bytes_per_device": state_bytes(cfg, shape_name, mesh,
                                                    strategy)}
    steps = {} if steps is None else steps
    if (arch, shape_name) not in steps:
        steps[arch, shape_name] = step_record(cfg, shape_name)
    record.update(steps[arch, shape_name])
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind} ({strategy}): "
              f"flops {record['step_flops']:.3e} ({record['flops_method']}), "
              f"state/dev {record['state_bytes_per_device'] / 2**30:.2f} GiB, "
              f"shapes_ok {record['shapes_ok']}", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--strategy", default="tp_fsdp")
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = all_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r["strategy"]) for r in results
            if "error" not in r}

    failures, steps = 0, {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = (arch, shape, mesh_kind, args.strategy)
                if key in done:
                    continue
                try:
                    rec = dryrun_one(arch, shape, mesh_kind, args.strategy,
                                     steps)
                    if not rec["shapes_ok"]:
                        raise AssertionError(f"the step's outputs do not "
                                             f"match its inputs: {rec}")
                except Exception as e:  # a row per failure, as the reference
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "strategy": args.strategy, "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[dryrun] FAIL {key}: {e}", flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"],
                               r["strategy"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"[dryrun] complete: {len(results)} records, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
