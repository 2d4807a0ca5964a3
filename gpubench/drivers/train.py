"""LM training on ``repro_torch.launch.train``'s route, steps dispatched
ahead.

Set-up builds what ``_train`` builds: ``fit_mesh()``'s 1×1 mesh,
``make_train_step(cfg, optimizer=adamw(...), remat, device, mesh)``, the
parameters filled with the seed's weights, the AdamW state, both
distributed by ``step_placements``; and a pool of bigram batches on the
card, distributed as the step takes them. It then runs the first
``checked_steps`` steps through the same call and pool as the window, on
batches whose rows all differ, and keeps, on the card, their losses, each
leaf's first gradient (the optimizer's first moment over 1 - b1, after
step 1) and each leaf's change over those steps. The window dispatches
step after step until ``seconds`` have passed, and ends with a device
synchronise; its throughput is every token of its steps over its length.
Losses stay on the card until then.

Once the window has closed and the memory's peak is read, the program is
freed and the reference follows the checked steps from the same weights
and batches.
"""
from __future__ import annotations

import time

import torch

from gpubench.check import train as check
from gpubench.core import card, trace as tr
from gpubench.core import weights as W
from gpubench.core.traffic import train_pool

# the traffic's keys that cut it to a CPU test's size
TINY = dict(batch=4, seq=16, pool_batches=4, chunk_tokens=32)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _norms(tensors) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(_whole(t).float())
                        for t in tensors])


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    import torch.distributed as dist
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import distribute, fit_mesh
    from repro_torch.optim import adamw
    from repro_torch.sharding import step_placements

    fam = cell.family
    a = fam.arch.sizes(cell.config)
    o = cell.config["optimizer"]
    mix = cell.traffic
    B, S = mix["batch"], mix["seq"]
    ended = not dist.is_initialized()
    mesh = fit_mesh(device)
    try:
        model, opt, step = make_train_step(
            fam.port.model_config(cell.config),
            optimizer=adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                            weight_decay=o["weight_decay"]),
            remat=o["remat"], device=device, mesh=mesh)
        params = {n: p.detach() for n, p in model.named_parameters()}
        W.load_port(params, fam.arch, a, seed, device)
        model.to_empty(device="meta")  # the step reads ``params`` only
        state = opt.init(params)
        pool = train_pool(mix, a.vocab, seed, device)
        pl, ol, bplace = step_placements("train", mesh, params=params,
                                         opt_state=state,
                                         batch=pool[0])["in"]
        params = distribute(params, pl, mesh)
        state = distribute(state, ol, mesh)
        fed = [distribute(b, bplace, mesh) for b in pool]
        names = list(params)
        # each of the port's leaves under the benchmark's name
        bench = {fam.arch.port_name(n): n for n in W.names(fam.arch, a)}
        leaves = [bench[n] for n in names]

        k = mix["checked_steps"]
        losses = []
        for i in range(k):
            params, state, loss = step(params, state, fed[i % len(fed)])
            losses.append(loss)
            if i == 0:
                grad = _norms(state["m"][n] for n in names) / (1 - o["b1"])
        p0 = dict(W.every(fam.arch, a, seed, device))
        change = []
        for n, leaf in zip(names, leaves):
            change.append(torch.linalg.vector_norm(
                _whole(params[n]).float() - p0.pop(leaf).float()))
        change = torch.stack(change)
        card.sync(device)
        out = {"setup_s": time.time() - started}

        done = 0
        if trace:
            n = mix["trace_steps"]
            with tr.profiled() as prof:
                with torch.profiler.record_function(tr.WINDOW):
                    for _ in range(n):
                        params, state, loss = step(
                            params, state, fed[(k + done) % len(fed)])
                        done += 1
                    card.sync(device)
            out["trace"] = tr.summarize(prof)
            del prof
        else:
            t0 = time.perf_counter()
            t_end = t0 + seconds
            while time.perf_counter() < t_end:
                params, state, loss = step(params, state,
                                           fed[(k + done) % len(fed)])
                done += 1
            card.sync(device)
            t1 = time.perf_counter()
            out["e2e"] = {"train_tokens_per_s": done * B * S / (t1 - t0)}
        out["units"] = [{"flops": fam.counts.train_flops(a, B, S)}] * done
        out["attempted"] = done
        out["failed"] = 0
        out["device"] = card.device_line(device, cell.workload["chips"])

        # the window has closed: read the checked steps, free the program
        prog = {"loss": [float(_whole(x)) for x in losses],
                "grad_norm": dict(zip(leaves, grad.tolist())),
                "change": dict(zip(leaves, change.tolist()))}
        del params, state, fed, model, step, opt, losses, loss
    finally:
        if ended and dist.is_initialized():
            dist.destroy_process_group()
    card.free(device)
    ref = fam.reference.train(a, seed,
                              [pool[i % len(pool)] for i in range(k)], o,
                              device, chunk_tokens=mix["chunk_tokens"])
    out["readings"] = check.readings(prog, ref)
    return out
