"""The dry run's SPMD fields (``repro_torch.launch.dryrun.spmd_record``):
each step of the slice's families as a DTensor program on torch's fake
process group, over the production meshes, on meta tensors.

* ``spmd_ok`` for every arch (dense, moe, ssm, vlm, encoder-decoder,
  hybrid) on 16×16 and 2×16×16 under ``tp_fsdp`` (decode; prefill on
  16×16, where K3's placement checks run in each prefill but rwkv6's; the
  train step for one arch of each family in
  tests/test_torch_spmd_dryrun_train.py), and on 16×16 under every
  strategy (decode); ``collective_counts`` and ``collective_bytes``
  filled for the reference's five op types; ``state_bytes_per_device``
  unchanged by the SPMD run.
* One layer's train step counted by hand: reduced smollm-360m with one
  layer (remat on, as ``make_train_step`` builds it) through
  ``spmd_run`` on a 2×2 fake mesh under ``tp_fsdp``, batch 4 × 32. Every
  move DTensor plans for it (each step of each redistribution: a mesh
  dim, its placement before and after) is recorded, and the collective
  each implies is worked out here from the placements alone: a shard
  gathered (all-gather), a partial sum reduced (all-reduce, its bytes
  twice) or reduced onto a shard (reduce-scatter), a shard moved to
  another tensor dim (all-to-all), each returning the tensor's
  per-device shard under the placements after the move; a move to a
  shard or a partial from a replica is local. The sums per op type must
  equal the dry run's counts and bytes exactly; the all-to-alls among
  them are counted at their per-device result, as NCCL's.
* One case counted by hand end to end: reduced smollm-360m's FFN projection ``w1``
  [256, 512] on a 2×2 fake mesh under ``tp_fsdp`` (its rows over ``data``,
  FSDP; its columns over ``model``, TP), a batch of 4 × 512 tokens over
  ``data``: the forward gathers the weight's rows over ``data`` (one
  all-gather returning [256, 256] float32, 262,144 bytes a device); the
  hidden activations come out pinned as the reference pins them, (batch
  over ``data``, hidden over ``model``), with no other move; the
  backward's weight gradient is a partial sum over the batch shards, and
  its reduction onto the weight's placements is one reduce-scatter over
  ``data`` returning [128, 256] float32, 131,072 bytes.
* The port imports ``torch.testing._internal`` in the dry run only.
"""
import dataclasses
import math
import os
import re
from collections import defaultdict
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import reduce_grad
from repro_torch.models.common import BATCH_AXES, maybe_shard, use_mesh
from repro_torch.sharding import (STRATEGIES, MeshShape, batch_specs,
                                  port_param_specs, tree_placements)

SLICE = ("smollm-360m", "llama3.2-3b", "granite-3-2b", "stablelm-3b",
         "mixtral-8x22b", "kimi-k2-1t-a32b", "rwkv6-1.6b", "llava-next-34b",
         "seamless-m4t-large-v2", "hymba-1.5b")
MESHES = ("single_pod", "multi_pod")
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _check(rec):
    assert rec["spmd_ok"] is True, rec
    for field in ("collective_counts", "collective_bytes"):
        assert tuple(rec[field]) == dryrun.COLLECTIVES, rec
        assert all(isinstance(v, int) and v >= 0
                   for v in rec[field].values()), rec
    assert rec["collective_bytes_total"] == sum(
        rec["collective_bytes"].values()) > 0
    assert sum(rec["collective_counts"].values()) > 0


@pytest.mark.parametrize("arch", SLICE)
def test_spmd_ok_on_both_meshes_under_tp_fsdp(arch, monkeypatch):
    """Also: the prefill runs the kernel route, as ``make_prefill_step``
    builds it: K3 (attention) and K5 (a MoE's experts) through their
    wrappers' placement checks, on each rank's shard."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    calls = defaultdict(int)
    for module in (fa, mg):
        def counted(*a, _run=module._on_mesh, _name=module.__name__):
            calls[_name.rsplit(".", 1)[1]] += 1
            return _run(*a)
        monkeypatch.setattr(module, "_on_mesh", counted)
    cfg, steps = get_config(arch), {}
    for shape, meshes in (("decode_32k", MESHES),
                          ("prefill_32k", MESHES[:1])):
        for mesh_kind in meshes:
            calls.clear()
            rec = dryrun.dryrun_one(arch, shape, mesh_kind, verbose=False,
                                    spmd=True, steps=steps)
            _check(rec)
            if shape == "prefill_32k" and cfg.family != "ssm":
                assert calls["flash_attention"] > 0, dict(calls)
            if cfg.family == "moe":
                assert calls["moe_gemm"] > 0, dict(calls)
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi_pod")
            assert rec["state_bytes_per_device"] == dryrun.state_bytes(
                cfg, shape, mesh, "tp_fsdp")


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_spmd_ok_under_every_strategy(strategy):
    mesh = make_production_mesh()
    for arch in SLICE:
        _check(dryrun.spmd_record(get_config(arch), "decode_32k", mesh,
                                  strategy))


# hymba's Mamba scan on 16×16: (x's placements, the state h's, A's
# gradient placements) per shape. decode_32k's state [B 128, d 1600, n]
# has the batch over data and d over model (cache_specs' sequence rule
# reads its dim 2); long_500k's batch of 1 puts d over data; prefill and
# train split the batch over data, A's gradient partial there
SCAN_SPLITS = {
    "decode_32k": ((Shard(0), Shard(2)), (Shard(0), Shard(1)),
                   (Partial(), Shard(0))),
    "long_500k": ((Shard(2), Replicate()), (Shard(1), Replicate()),
                  (Shard(0), Replicate())),
    "prefill_32k": ((Shard(0), Replicate()), (Shard(0), Replicate()),
                    (Partial(), Replicate()))}


@pytest.mark.parametrize("shape", sorted(SCAN_SPLITS))
def test_hybrid_scan_splits_on_16x16(shape, monkeypatch):
    """The per-rank Mamba scan takes the split its inputs name: the batch,
    or d where the decode state is split there; A's gradient is partial
    over a batch split."""
    from repro_torch.models import ssm
    seen, run = set(), ssm.on_shards

    def spy(fn, out, *args, grad_placements=None):
        seen.add((tuple(args[0].placements), tuple(args[5].placements),
                  tuple(grad_placements[4])))
        return run(fn, out, *args, grad_placements=grad_placements)

    monkeypatch.setattr(ssm, "on_shards", spy)
    rec = dryrun.spmd_record(get_config("hymba-1.5b"), shape,
                             make_production_mesh(), "tp_fsdp")
    _check(rec)
    assert seen == {SCAN_SPLITS[shape]}, seen


def test_hand_counted_projection_on_2x2():
    B, S, d, f = 4, 512, 256, 512
    name = "blocks.0.ffn.w1"
    with dryrun.fake_group():
        mesh = dryrun.fake_mesh(MeshShape(("data", "model"), (2, 2)))
        params = {name: torch.empty(d, f, device="meta")}
        pl = tree_placements(port_param_specs(params, mesh), mesh)[name]
        assert tuple(pl) == (Shard(0), Shard(1))
        w = train.distribute(params, {name: pl}, mesh)[name]
        w.requires_grad_()
        x = torch.empty(B, S, d, device="meta")
        x = train.distribute({"x": x}, tree_placements(
            batch_specs({"x": x}, mesh), mesh), mesh)["x"]
        counter = dryrun._collective_bytes_mode()
        with use_mesh(mesh), counter:
            h = maybe_shard(x @ w, BATCH_AXES, None, "model")
            assert tuple(h.placements) == (Shard(0), Shard(2))
            g, = torch.autograd.grad(h.sum(), [w])
            g = reduce_grad(g, pl)
        assert g.placements == w.placements
    f32 = 4
    assert dict(counter.counts) == {"all-gather": 1, "reduce-scatter": 1}
    assert dict(counter.bytes) == {
        "all-gather": d * (f // 2) * f32,              # w's rows gathered
        "reduce-scatter": (d // 2) * (f // 2) * f32}   # its gradient


def _planned_moves(monkeypatch):
    """Record each redistribution DTensor runs: (its spec before, the
    moves it plans: one per mesh dim it changes, after DTensor's own
    merging)."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redist
    moves, specs = [], []
    run, optimize = redist.redistribute_local_tensor, \
        redist._optimize_transform_infos

    def redistribute(local, current, target, *a, **kw):
        specs.append(current)
        try:
            return run(local, current, target, *a, **kw)
        finally:
            specs.pop()

    def optimized(*a, **kw):
        out = optimize(*a, **kw)
        moves.append((specs[-1], list(out)))
        return out

    for module in (redist, dispatch, api):
        monkeypatch.setattr(module, "redistribute_local_tensor", redistribute)
    monkeypatch.setattr(redist, "_optimize_transform_infos", optimized)
    return moves


def _by_hand(moves, sizes):
    """The collectives ``moves`` imply on a mesh of ``sizes``: (counts,
    bytes) per op type, each the bytes of its per-device result."""
    def sharded(p):
        return isinstance(p, Shard)  # _StridedShard is a Shard too

    counts, nbytes = defaultdict(int), defaultdict(int)
    for spec, infos in moves:
        placements = list(spec.placements)
        for info in infos:
            assert len(getattr(info, "original_mesh_dims", (0,))) == 1
            src, dst = info.src_dst_placements
            assert placements[info.mesh_dim] == src
            placements[info.mesh_dim] = dst
            shard = list(spec.shape)
            for size, p in zip(sizes, placements):
                if sharded(p):
                    shard[p.dim] //= size
            n = math.prod(shard) * spec.tensor_meta.dtype.itemsize
            if src.is_partial() and dst.is_replicate():
                kind, n = "all-reduce", 2 * n
            elif src.is_partial() and sharded(dst):
                kind = "reduce-scatter"
            elif sharded(src) and dst.is_replicate():
                kind = "all-gather"
            elif sharded(src) and sharded(dst):
                kind = "all-to-all"
            else:  # a replica sliced or split into partial sums: local
                continue
            counts[kind] += 1
            nbytes[kind] += n
    return dict(counts), dict(nbytes)


def test_hand_counted_layer_train_step_on_2x2(monkeypatch):
    B, S = 4, 32
    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              n_layers=1)
    batch = {k: torch.empty(B, S, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    moves = _planned_moves(monkeypatch)
    with dryrun.fake_group():
        mesh = dryrun.fake_mesh(MeshShape(("data", "model"), (2, 2)))
        run = dryrun.spmd_run(cfg, "train_4k", mesh, "tp_fsdp",
                              specs={"batch": batch})
    assert run["ok"]
    counts, nbytes = _by_hand(moves, (2, 2))
    assert run["counts"] == counts and run["bytes"] == nbytes
    # ZeRO-3 with TP: weights gathered, gradients scattered, and the
    # embedding's vocab shards moved onto its columns (an all-to-all)
    assert counts["all-gather"] and counts["reduce-scatter"]
    assert counts["all-to-all"]


@pytest.mark.parametrize("arch,shape,at", (
    ("rwkv6-1.6b", "train_4k", (4, 0)),
    ("seamless-m4t-large-v2", "prefill_32k", (3, 3))))
def test_layer_line_holds_at_a_fourth_depth(arch, shape, at):
    """The line through the probe depths equals a run at one more depth
    exactly, counts and bytes (each layer after the first adds the same
    program): rwkv6's train step at 4 layers; seamless's prefill (its
    encoder and the cross attention's K/V) at 3 + 3, a line in each of
    its stacks through (2, 2), (3, 2) and (2, 3)."""
    cfg = get_config(arch)
    depths = dryrun._probe_depths(cfg)
    with dryrun.fake_group():
        mesh = dryrun.fake_mesh(make_production_mesh())
        runs = {d: dryrun.spmd_run(dataclasses.replace(
            cfg, n_layers=d[0], encoder_layers=d[1]), shape, mesh, "tp_fsdp")
            for d in (*depths, at)}
    deeper = dataclasses.replace(cfg, n_layers=at[0], encoder_layers=at[1])
    for field in ("counts", "bytes"):
        line = dryrun._extrapolated(depths, [runs[d][field] for d in depths],
                                    deeper)
        assert line == runs[at][field], field


def test_cli_rows_and_fake_group_ends(tmp_path):
    out = str(tmp_path / "dry.json")
    assert dryrun.main(["--arch", "smollm-360m,hymba-1.5b", "--shape",
                        "decode_32k", "--mesh", "single_pod", "--out",
                        out]) == 0
    import json
    with open(out) as f:
        rows = {r["arch"]: r for r in json.load(f)}
    _check(rows["smollm-360m"])
    _check(rows["hymba-1.5b"])
    assert not torch.distributed.is_initialized()


def test_internal_torch_module_in_the_dry_run_only():
    pattern = re.compile(r"torch\.testing\._internal")
    users = sorted(str(p.relative_to(SRC)) for p in SRC.rglob("*.py")
                   if pattern.search(p.read_text()))
    assert users == [os.path.join("launch", "dryrun.py")], users
