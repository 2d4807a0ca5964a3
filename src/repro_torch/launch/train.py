"""End-to-end training driver of a ``DecoderLM`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --batch 8 --seq 2048 --steps 20 --ckpt-dir /tmp/ckpt      # GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 200 --batch 8 --seq 128 --device cpu     # CPU

The port of ``repro.launch.train`` with the same flags and printed lines
(``step %5d loss … tok/s …``, ``resumed from step N``, ``done: final
loss``), plus ``--device`` (default ``cuda``; it raises without a CUDA
device, so the CPU runs only when asked for). Synthetic LM data (a
learnable bigram stream) feeds the loss of ``make_train_step`` (AdamW,
weight decay 0.1, remat unless ``--reduced``); the weights are made on the
device from ``torch.Generator(device).manual_seed(seed)``.

The parameters and the optimizer state are DTensors on the mesh of
:func:`fit_mesh`, with the placements of the ``tp_fsdp`` specs; each step
runs on their local tensors and wraps the results back under the same
placements. The step issues no collectives, so a mesh of more than one
device raises: one process is the 1×1 host mesh, whose local tensors are
the whole tensors (every spec is replicated on it). Checkpoints go to
``--ckpt-dir`` in the reference's layout (``(params, opt_state)`` stacked
as the reference's trees), every ``--ckpt-every`` steps and at the end;
a run finds the latest and resumes from it.

As in the reference, a resumed run draws its batches from a generator
restarted at ``--seed``: the batches after a resume are the first ones
again, not those an uninterrupted run would have drawn.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import (opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.optim import adamw
from repro_torch.sharding import batch_specs, port_param_specs, tree_placements


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


def fit_mesh(device=None):
    """The mesh of the process group's devices: one process (no group, or
    a group of one) is the 1×1 host mesh. The train step issues no
    collectives, so a group of more than one raises."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != 1:
        raise RuntimeError(f"the train step issues no collectives: it runs "
                           f"on one device, not on {n}")
    return make_host_mesh(device)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts (and of trees of the same
    structure beside it)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def distribute(tree, placements, mesh):
    """Each tensor of ``tree`` as a DTensor of ``mesh`` under its
    placements: on the 1×1 mesh each is its own local tensor."""
    from torch.distributed.tensor import DTensor
    return _map(lambda t, pl: DTensor.from_local(t, mesh, pl,
                                                 run_check=False),
                tree, placements)


def local(tree):
    return _map(lambda t: t.to_local(), tree)


def step_on_local(train_step, mesh, params, opt_state, batch, placements):
    """One ``train_step`` on the local tensors of DTensor ``params``,
    ``opt_state`` and ``batch``; the new parameters and state come back as
    DTensors under ``placements`` (``{"params", "opt_state"}``)."""
    new_p, new_o, loss = train_step(local(params), local(opt_state),
                                    local(batch))
    return (distribute(new_p, placements["params"], mesh),
            distribute(new_o, placements["opt_state"], mesh), loss)


def _meta(tree):
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                tree)


def save_state(directory, step, params, opt_state, extra):
    """``(params, opt_state)`` (local tensors) as the reference's
    ``(params, opt_state)`` tree: ``0/blocks/attn/wq`` [L, d, H, dh],
    ``1/m/blocks/attn/wq``, ``1/step``, …"""
    return save_checkpoint(directory, step, (
        params_to_reference(params), opt_state_to_reference(opt_state)),
        extra=extra)


def load_state(directory, params, opt_state, device, step=None):
    """The ``(params, opt_state)`` of a checkpoint in the reference's
    layout, in the port's names, on ``device``, with the dtypes and shapes
    of ``params`` and ``opt_state``; and the checkpoint's extra state."""
    (p, o), extra = load_checkpoint(directory, (
        params_to_reference(_meta(params)),
        opt_state_to_reference(_meta(opt_state))), step=step)
    def to_dev(t):
        return t.to(device)
    return (_map(to_dev, params_from_reference(p)),
            _map(to_dev, opt_state_from_reference(o)), extra)


def main(argv=None) -> dict:
    """Run the driver; returns what it did: the first step it ran
    (``start``), each step's loss and host seconds (each step ends in
    reading its loss, a device synchronise), and the final ``params`` and
    ``opt_state`` (plain tensors)."""
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
    try:
        return _train(args, cfg, device, fit_mesh(device))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, device, mesh) -> dict:
    model, opt, train_step = make_train_step(
        cfg, optimizer=adamw(args.lr, weight_decay=0.1),
        remat=not args.reduced, device=device)
    model.init(torch.Generator(device).manual_seed(args.seed))
    params = {n: p.detach() for n, p in model.named_parameters()}
    model.to_empty(device="meta")  # the step reads ``params`` only
    opt_state = opt.init(params)
    rng = np.random.default_rng(args.seed)
    batch0 = synthetic_lm_batch(rng, args.batch, args.seq, cfg.vocab, device)
    placements = {"params": tree_placements(port_param_specs(params, mesh),
                                            mesh),
                  "opt_state": tree_placements(
                      port_param_specs(opt_state, mesh), mesh)}
    bplace = tree_placements(batch_specs(batch0, mesh), mesh)

    start = 0
    if args.ckpt_dir and (latest := latest_step(args.ckpt_dir)) is not None:
        params, opt_state, extra = load_state(args.ckpt_dir, params,
                                              opt_state, device)
        start = (extra or {}).get("step", latest)
        print(f"resumed from step {start}")
    params = distribute(params, placements["params"], mesh)
    opt_state = distribute(opt_state, placements["opt_state"], mesh)

    losses, step_s = [], []
    loss = torch.tensor(float("nan"))  # a run that resumes at its end
    t0 = time.time()
    for step in range(start, args.steps):
        t = time.perf_counter()
        batch = distribute(synthetic_lm_batch(rng, args.batch, args.seq,
                                              cfg.vocab, device), bplace, mesh)
        params, opt_state, loss = step_on_local(train_step, mesh, params,
                                                opt_state, batch, placements)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:5d} loss {losses[-1]:.4f} tok/s {tok_s:,.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, step + 1, local(params),
                       local(opt_state),
                       extra={"step": step + 1, "arch": args.arch})
    if args.ckpt_dir:
        save_state(args.ckpt_dir, args.steps, local(params), local(opt_state),
                   extra={"step": args.steps, "arch": args.arch})
    print("done: final loss", float(loss))
    return {"start": start, "losses": losses, "step_s": step_s,
            "params": local(params), "opt_state": local(opt_state)}


if __name__ == "__main__":
    main()
