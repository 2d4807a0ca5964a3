"""Run the always-on scheduler against a synthetic churn trace.

    python -m repro_torch.service --synthetic-churn [--clients 2000] [--steps 60]
    python -m repro_torch.service --device cpu --clients 400 --steps 5 --json

Builds a FedZero service over a synthesized scenario, drives it with
random arrivals/departures + admission requests for ``--steps`` virtual
minutes, verifies the recorded request log replays bit-identically, and
prints the metrics snapshot (JSON with ``--json``). Defaults finish in
well under a minute — the CI smoke invocation.

The backend is ``cuda`` on the card unless asked otherwise: without
CUDA it exits non-zero with a ``RuntimeError``. ``--device cpu`` runs the
same backend on the CPU (its kernels' plain PyTorch versions);
``--backend numpy`` runs the host reference.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..backend.cuda_backend import CudaBackend
from ..core import (ExperimentConfig, FleetSection, RunSection,
                    ScenarioSection, ServiceSection, StrategySection)
from ..device import resolve_device

from .engine import build_service, run_synthetic
from .faults import FaultPlan


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--synthetic-churn", action="store_true",
                    help="drive the service with a synthetic arrival/"
                    "departure trace (the only mode; the flag names the "
                    "mode explicitly for scripts)")
    ap.add_argument("--clients", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=60,
                    help="virtual minutes to simulate")
    ap.add_argument("--churn", type=float, default=0.01,
                    help="per-step fraction of the fleet departing (and "
                    "arriving)")
    ap.add_argument("--admits-per-step", type=int, default=4)
    ap.add_argument("--quotes-per-step", type=int, default=0,
                    help="read-only quote() pricings issued before the "
                    "admits each step (exercise the result memo)")
    ap.add_argument("--n", type=int, default=10,
                    help="clients per admission request")
    ap.add_argument("--d-max", type=int, default=30)
    ap.add_argument("--util-mode", choices=("dense", "sparse"),
                    default="sparse")
    ap.add_argument("--solver", choices=("greedy", "mip"), default="greedy")
    ap.add_argument("--backend", choices=("cuda", "numpy"),
                    default="cuda",
                    help="array backend: cuda runs on --device, numpy on "
                    "the host")
    ap.add_argument("--device", default=None,
                    help="device of the cuda backend (default: cuda:0; "
                    "'cpu' runs its kernels' plain versions on the CPU)")
    ap.add_argument("--executor", choices=("inprocess", "multiprocess"),
                    default="inprocess",
                    help="round executor: in-process, or sharded across "
                    "worker processes (workers regenerate their trace "
                    "rows locally)")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker processes for --executor multiprocess")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault plan, e.g. "
                    "'crash=0.01,dropout=0.05,delay=0.1,loss=0.01,seed=3' "
                    "(see repro_torch.service.faults.FaultPlan.parse)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-replay-check", action="store_true",
                    help="skip the replay bit-parity self-check")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.backend == "numpy":
        if args.device is not None:
            ap.error("--device names where the cuda backend runs; the "
                     "numpy backend runs on the host")
        backend = "numpy"
    else:
        backend = CudaBackend(device=resolve_device(
            args.device, "pass --device cpu to run on the CPU"))
    plan = FaultPlan.parse(args.faults) if args.faults else None
    cfg = ExperimentConfig(
        scenario=ScenarioSection(days=1, seed=args.seed,
                                 util_mode=args.util_mode),
        fleet=FleetSection(n_clients=args.clients, seed=args.seed),
        strategy=StrategySection(n=args.n, d_max=args.d_max, seed=args.seed,
                                 options={"solver": args.solver}),
        run=RunSection(backend=backend),
        service=ServiceSection(seed=args.seed, executor=args.executor,
                               workers=args.workers, faults=plan))
    svc = build_service(cfg)
    try:
        snap = run_synthetic(svc, steps=args.steps, churn=args.churn,
                             admits_per_step=args.admits_per_step,
                             quotes_per_step=args.quotes_per_step,
                             seed=args.seed, verbose=not args.json)
    finally:
        svc.close()

    snap["replay_ok"] = None
    if not args.no_replay_check:
        # the replay twin runs on the live service's backend object
        fresh = build_service(cfg, scenario=svc.scenario,
                              registry=svc.registry, executor="none")
        replayed = fresh.replay(svc.log)
        snap["replay_ok"] = (len(replayed) == len(svc.history)) and all(
            (a is None and b is None)
            or (a is not None and b is not None
                and np.array_equal(a, np.asarray(b.rows)))
            for a, b in zip(svc.history, replayed))
        if not snap["replay_ok"]:
            raise SystemExit("replay parity FAILED: the recorded log did "
                             "not reproduce the live admissions")
    if args.json:
        print(json.dumps(snap, indent=2, default=float))
    else:
        n_dec = snap["admit_requests"] + snap["quote_requests"]
        print(f"\n{n_dec} admission decisions in "
              f"{snap['elapsed_s']:.2f}s "
              f"({snap['decisions_per_sec']:.1f}/s), "
              f"p50={snap['p50_ms']:.1f}ms p99={snap['p99_ms']:.1f}ms, "
              f"admitted={snap['admitted']} rejected={snap['rejected']}, "
              f"replay_ok={snap['replay_ok']}")
        if plan is not None:
            print(f"faults: crashes={snap['worker_crashes']} "
                  f"restarts={snap['worker_restarts']} "
                  f"retries={snap['shard_retries']} "
                  f"dropouts={snap['client_dropouts']} "
                  f"lost={snap['reports_lost']} "
                  f"degraded={snap['rounds_degraded']} "
                  f"report_p99={snap['report_p99_steps']:.0f} steps")
    return snap


if __name__ == "__main__":
    main()
