"""End-to-end example on the PyTorch/CUDA port: REAL federated training of
a conv net on synthetic non-iid image data (Dirichlet α=0.5), scheduled by
FedZero on solar excess energy, with FedProx local training — the paper's
full loop, as ``examples/train_federated.py`` runs it in JAX.

Run from a checkout:

    PYTHONPATH=src python examples/train_federated_torch.py \
        [--rounds 20] [--clients 20] [--strategy fedzero]      # GPU
    python examples/train_federated_torch.py --device cpu --rounds 2

Scheduling runs on the ``"cuda"`` backend and the trainer on ``cuda:0``
unless ``--device`` names another device (both then run there); without
a CUDA device and without ``--device cpu`` it raises. The experiment is
an ``ExperimentConfig`` whose trainer section carries a ``TorchTrainer``
factory; the registry is retuned to the dataset's shard sizes between
``build_registry`` and ``build_experiment``.
"""
import argparse
import os
import sys

try:
    import repro_torch  # noqa: F401
except ImportError:  # run from a checkout without PYTHONPATH=src
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.core import (ExperimentConfig, FleetSection, RunSection,
                              ScenarioSection, StrategySection,
                              TorchTrainer, TrainerSection, build_experiment,
                              build_registry, build_scenario)
from repro_torch.data.federated import synthetic_classification
from repro_torch.models import ConvNet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--strategy", default="fedzero")
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="run scheduling and training here (default: the "
                         "cuda backend and cuda:0)")
    args = ap.parse_args(argv)
    backend = ("cuda" if args.device is None
               else CudaBackend(device=args.device))

    def torch_trainer(reg):
        return TorchTrainer(ConvNet(n_classes=10, channels=(16, 32), hw=12,
                                    device=args.device),
                            data, lr=0.05, prox_mu=0.1, seed=args.seed,
                            max_steps_per_round=30, device=args.device)

    cfg = ExperimentConfig(
        scenario=ScenarioSection(name="global", days=7, seed=args.seed),
        fleet=FleetSection(n_clients=args.clients, seed=args.seed),
        strategy=StrategySection(name=args.strategy, n=args.n, d_max=60,
                                 seed=args.seed),
        trainer=TrainerSection(factory=torch_trainer),
        run=RunSection(max_rounds=args.rounds, eval_every=1, seed=args.seed,
                       backend=backend),
    )
    sc = build_scenario(cfg)
    reg = build_registry(cfg, sc)
    data = synthetic_classification(
        args.clients, reg.client_names, n_classes=10, n_samples=4000,
        hw=12, alpha=0.5, seed=args.seed)
    for c in reg.client_names:  # retune fleet to the real shard sizes
        reg.clients[c].n_samples = data.n_samples(c)
        reg.clients[c].batches_per_epoch = max(1, data.n_samples(c) // 10)
    reg.refresh_arrays()

    sim = build_experiment(cfg, scenario=sc, registry=reg)
    summary = sim.run(max_rounds=args.rounds, verbose=True)

    print(f"\ndevice:        {sim.trainer.device}")
    print(f"final accuracy: {summary['best_metric']:.3f} "
          f"(chance = 0.100)")
    print(f"energy used:   {summary['total_energy_wh']:.1f} Wh "
          f"(all renewable excess)")
    print(f"sim time:      {summary['sim_minutes'] / 60:.1f} h over "
          f"{summary['rounds']} rounds")
    part = np.asarray(summary['participation'], dtype=float)  # row-keyed
    print(f"participation: {part.mean():.1f} ± {part.std():.1f} rounds/client")


if __name__ == "__main__":
    main()
