"""Trainer plugged into the FL simulation.

``ProxyTrainer`` is an analytic convergence proxy for scheduler-scale
experiments (100k clients, 7 simulated days) where real training is not
the object of study. Calibrated to show diminishing returns per client
(re-selecting the same clients helps less — the mechanism behind the
paper's fairness/convergence coupling). It takes **registry rows** in
``local_update`` (row-ID-first identity) and is pure flat arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class ProxyTrainer:
    """Analytic accuracy model: progress grows with sqrt(batches) per
    contributor, discounted for repeatedly-selected clients, so strategies
    that over-select the same energy-rich clients converge slower — the
    effect the paper measures. Per-sample losses fed back to Oort/FedZero
    utility are proportional to the remaining loss with client-specific
    offsets. State is flat arrays indexed by registry row."""

    def __init__(self, n_clients: int, acc_max: float = 0.9,
                 k: float = 0.003, seed: int = 0):
        self.acc_max = acc_max
        self.k = k
        self.progress = 0.0
        self.counts = np.zeros(n_clients, dtype=np.int64)
        rng = np.random.default_rng(seed)
        self.client_hardness = rng.uniform(0.7, 1.3, n_clients)

    def local_update(self, row: int, n_batches: float) -> Dict:
        self.counts[row] += 1
        novelty = 1.0 / np.sqrt(self.counts[row])
        gain = np.sqrt(max(n_batches, 0.0)) * novelty
        acc = self.evaluate()
        loss_level = max(1e-3, -np.log(max(1e-6, acc / self.acc_max + 1e-3)))
        losses = np.full(16, loss_level * self.client_hardness[row])
        return {"row": row, "params": None, "weight": n_batches,
                "sample_losses": losses,
                "mean_loss": float(losses.mean()), "_gain": gain}

    def aggregate(self, updates: List[Dict]):
        self.progress += sum(u["_gain"] for u in updates)

    def evaluate(self) -> float:
        return self.acc_max * (1.0 - np.exp(-self.k * self.progress))
