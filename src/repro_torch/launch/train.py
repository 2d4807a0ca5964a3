"""End-to-end training driver of a ``DecoderLM`` on a mesh of the
process group's devices.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --batch 8 --seq 2048 --steps 20 --ckpt-dir /tmp/ckpt      # one GPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --batch 8 --seq 2048 --steps 20       # 4 GPUs
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 200 --batch 8 --seq 128 --device cpu     # CPU

The port of ``repro.launch.train`` with the same flags and printed lines
(``step %5d loss … tok/s …``, ``resumed from step N``, ``done: final
loss``), plus ``--device`` (default ``cuda``; it raises without a CUDA
device, so the CPU runs only when asked for). Synthetic LM data (a
learnable bigram stream) feeds the loss of ``make_train_step`` (AdamW,
weight decay 0.1, remat unless ``--reduced``); the weights are made on the
device from ``torch.Generator(device).manual_seed(seed)``, the same on
every rank.

The mesh is :func:`fit_mesh`: every rank of the process group (one
process without one; ``torchrun``'s group, or a spawned one) as ``(n //
m, m)`` over ``("data", "model")``, as the reference takes every device
the backend offers. The parameters and the optimizer state are DTensors
with the placements of the ``tp_fsdp`` specs, each batch goes in under
``batch_specs`` (every rank draws the same stream and keeps its rows),
and the step is a DTensor program (``make_train_step(..., mesh=)``): the
gradients are reduced onto the parameters' placements and the loss comes
out replicated. Checkpoints go to ``--ckpt-dir`` in the reference's
layout (``(params, opt_state)`` stacked as the reference's trees), whole:
rank 0 writes each DTensor gathered, and a run on any mesh finds the
latest, resumes from it and places it on its own mesh.

As in the reference, a resumed run draws its batches from a generator
restarted at ``--seed``: the batches after a resume are the first ones
again, not those an uninterrupted run would have drawn.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh, start_group
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import (opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.optim import adamw
from repro_torch.sharding import step_placements


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, device=None):
    """Bigram-structured token stream: next token = (3·tok + noise) % V.
    The reference's arrays (int32), as tensors on ``device``."""
    toks = np.zeros((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.integers(0, 7, (batch, seq))
    for t in range(seq):
        toks[:, t + 1] = (3 * toks[:, t] + noise[:, t]) % vocab
    return {"tokens": torch.as_tensor(toks[:, :-1], device=device),
            "labels": torch.as_tensor(toks[:, 1:], device=device)}


def fit_mesh_shape(n: int):
    """The reference's mesh of ``n`` devices: ``(n // m, m)``, ``m`` the
    largest of 16, 8, 4, 2, 1 that divides ``n``."""
    model_par = 1
    for cand in (16, 8, 4, 2, 1):
        if n % cand == 0 and cand <= n:
            model_par = cand
            break
    return n // model_par, model_par


def fit_mesh(device=None):
    """Every rank of the process group as a ``(data, model)`` mesh of
    :func:`fit_mesh_shape`; one process (no group) is the 1×1 mesh, on a
    group of one that this starts."""
    device = resolve_device(device)
    start_group(device)
    return make_mesh(fit_mesh_shape(dist.get_world_size()),
                     ("data", "model"), device)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts (and of trees of the same
    structure beside it)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def distribute(tree, placements, mesh):
    """Each tensor of ``tree`` (the same on every rank) as a DTensor of
    ``mesh`` under its placements: each rank keeps its own shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return _map(lambda t, pl: distribute_tensor(t, mesh, pl,
                                                src_data_rank=None),
                tree, placements)


def gather(tree):
    """Each DTensor of ``tree`` as the whole tensor (an all-gather)."""
    return _map(lambda t: t.full_tensor(), tree)


def _meta(tree):
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                tree)


def save_state(directory, step, params, opt_state, extra):
    """``(params, opt_state)`` as the reference's ``(params, opt_state)``
    tree: ``0/blocks/attn/wq`` [L, d, H, dh], ``1/m/blocks/attn/wq``,
    ``1/step``, …; DTensors are gathered whole first (every rank takes
    part), and rank 0 writes. Returns the path on rank 0, else None."""
    if _is_dtensor_tree(params):
        params, opt_state = gather(params), gather(opt_state)
    path = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        path = save_checkpoint(directory, step, (
            params_to_reference(params), opt_state_to_reference(opt_state)),
            extra=extra)
    if dist.is_initialized():
        dist.barrier()
    return path


def _is_dtensor_tree(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tree.values())


def load_state(directory, params, opt_state, device, step=None,
               placements=None, mesh=None):
    """The ``(params, opt_state)`` of a checkpoint in the reference's
    layout, in the port's names, on ``device``, with the dtypes and shapes
    of ``params`` and ``opt_state``; and the checkpoint's extra state.
    With ``placements`` (``{"params", "opt_state"}``) and a ``mesh`` they
    come back as DTensors placed on it, whatever mesh wrote them."""
    (p, o), extra = load_checkpoint(directory, (
        params_to_reference(_meta(params)),
        opt_state_to_reference(_meta(opt_state))), step=step)
    def to_dev(t):
        return t.to(device)
    p = _map(to_dev, params_from_reference(p))
    o = _map(to_dev, opt_state_from_reference(o))
    if placements is not None:
        p = distribute(p, placements["params"], mesh)
        o = distribute(o, placements["opt_state"], mesh)
    return p, o, extra


def main(argv=None) -> dict:
    """Run the driver; returns what it did: the first step it ran
    (``start``), each step's loss and host seconds (each step ends in
    reading its loss, a device synchronise), the mesh's shape, and the
    final ``params`` and ``opt_state`` (gathered: plain tensors)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch, reduced=args.reduced)
    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:  # torchrun's group
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _train(args, cfg, device, fit_mesh(device))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, device, mesh) -> dict:
    model, opt, train_step = make_train_step(
        cfg, optimizer=adamw(args.lr, weight_decay=0.1),
        remat=not args.reduced, device=device, mesh=mesh)
    model.init(torch.Generator(device).manual_seed(args.seed))
    params = {n: p.detach() for n, p in model.named_parameters()}
    model.to_empty(device="meta")  # the step reads ``params`` only
    opt_state = opt.init(params)
    rng = np.random.default_rng(args.seed)
    batch0 = synthetic_lm_batch(rng, args.batch, args.seq, cfg.vocab, device)
    pl, ol, bplace = step_placements("train", mesh, params=params,
                                     opt_state=opt_state, batch=batch0)["in"]
    placements = {"params": pl, "opt_state": ol}
    rank0 = dist.get_rank() == 0

    start = 0
    if args.ckpt_dir and (latest := latest_step(args.ckpt_dir)) is not None:
        params, opt_state, extra = load_state(
            args.ckpt_dir, params, opt_state, device, placements=placements,
            mesh=mesh)
        start = (extra or {}).get("step", latest)
        if rank0:
            print(f"resumed from step {start}")
    else:
        params = distribute(params, placements["params"], mesh)
        opt_state = distribute(opt_state, placements["opt_state"], mesh)

    losses, step_s = [], []
    loss = torch.tensor(float("nan"))  # a run that resumes at its end
    t0 = time.time()
    for step in range(start, args.steps):
        t = time.perf_counter()
        batch = distribute(synthetic_lm_batch(rng, args.batch, args.seq,
                                              cfg.vocab, device), bplace, mesh)
        params, opt_state, loss = train_step(params, opt_state, batch)
        loss = loss.full_tensor()  # replicated: every rank holds it
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t)
        if rank0 and (step % args.log_every == 0 or step == args.steps - 1):
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:5d} loss {losses[-1]:.4f} tok/s {tok_s:,.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, step + 1, params, opt_state,
                       extra={"step": step + 1, "arch": args.arch})
    if args.ckpt_dir:
        save_state(args.ckpt_dir, args.steps, params, opt_state,
                   extra={"step": args.steps, "arch": args.arch})
    if rank0:
        print("done: final loss", float(loss))
    return {"start": start, "losses": losses, "step_s": step_s,
            "mesh": tuple(mesh.shape), "params": gather(params),
            "opt_state": gather(opt_state)}


if __name__ == "__main__":
    main()
