"""Trainers plugged into the FL simulation.

* ``TorchTrainer`` — real federated training in PyTorch: per-client
  FedProx/SGD local updates on the client's data shard, FedAvg aggregation
  weighted by samples processed, evaluation on a held-out test set. It is
  the reference's ``JaxTrainer`` on a torch device (``cuda:0`` unless the
  caller names another).
* ``ProxyTrainer`` — analytic convergence proxy for scheduler-scale
  experiments (100k clients, 7 simulated days) where real training is not
  the object of study. Calibrated to show diminishing returns per client
  (re-selecting the same clients helps less — the mechanism behind the
  paper's fairness/convergence coupling).

Both take **registry rows** in ``local_update`` (row-ID-first identity).
The TorchTrainer maps row → dataset shard through a positional name list —
the dataset is the one place client names legitimately live — while the
ProxyTrainer is pure flat arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.federated import FederatedData
from ..device import resolve_device
from ..optim import fedprox_loss, sgd


class TorchTrainer:
    """The global model is ``model``'s parameters (``params`` reads them
    by name), on ``device``: ``model`` is moved there and initialised from
    ``seed``; weights from elsewhere are loaded afterwards with
    ``trainer.model.load_state_dict``. A local update trains a copy of
    them (the model holds the copy while the update runs and gets the
    global weights back after it); :meth:`aggregate` writes the weighted
    mean into the model. Batches are drawn from ``self.rng`` in the
    reference's order: ``steps`` batches, then one probe of
    ``4 * batch_size``. Besides the reference's keys, an update carries
    ``losses``, each step's loss."""

    def __init__(self, model, data: FederatedData, lr: float = 0.05,
                 batch_size: int = 10, prox_mu: float = 0.1,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 seed: int = 0, max_steps_per_round: int = 50,
                 eval_batch: int = 512,
                 client_names: Optional[List[str]] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data = data
        # row -> dataset shard key; defaults to dataset insertion order,
        # which the experiment builds align with the registry's row order
        self._names = list(client_names if client_names is not None
                           else data.client_data)
        self.batch_size = batch_size
        self.max_steps = max_steps_per_round
        self.eval_batch = eval_batch
        self.rng = np.random.default_rng(seed)
        self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        self.opt = sgd(lr, momentum=momentum, weight_decay=weight_decay)

        def loss_fn(params, batch):  # params: the model's own parameters
            return self.model.loss(batch)

        if prox_mu > 0:
            self._local_loss = fedprox_loss(loss_fn, prox_mu)
        else:
            self._local_loss = lambda p, b, g: loss_fn(p, b)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The global model's parameters by name (views, no grad)."""
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def _batch(self, arrays) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in arrays.items()}

    def _local_step(self, live, opt_state, batch, global_params):
        loss = self._local_loss(live, batch, global_params)
        grads = torch.autograd.grad(loss, list(live.values()))
        with torch.no_grad():
            new, opt_state = self.opt.update(
                dict(zip(live, grads)), opt_state,
                {n: p.detach() for n, p in live.items()})
            for n, p in live.items():
                p.copy_(new[n])
        return opt_state, loss.detach()

    @torch.no_grad()
    def _sample_losses(self, batch) -> np.ndarray:
        logits = self.model.logits_fn(batch).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["labels"][..., None].long()
                            )[..., 0]
        nll = logz - gold
        if nll.dim() > 1:  # LM: mean over sequence
            nll = nll.mean(dim=tuple(range(1, nll.dim())))
        return nll.cpu().numpy()

    def local_update(self, row: int, n_batches: float) -> Dict:
        client = self._names[row]
        steps = int(min(max(1, round(n_batches)), self.max_steps))
        live = dict(self.model.named_parameters())
        global_params = {n: p.detach().clone() for n, p in live.items()}
        opt_state = self.opt.init(global_params)
        losses = []
        try:
            for _ in range(steps):
                batch = self._batch(self.data.sample_batch(
                    client, self.batch_size, self.rng))
                opt_state, loss = self._local_step(live, opt_state, batch,
                                                   global_params)
                losses.append(loss)
            probe = self._batch(self.data.sample_batch(
                client, 4 * self.batch_size, self.rng))
            sample_losses = self._sample_losses(probe)
            params = {n: p.detach().clone() for n, p in live.items()}
        finally:
            with torch.no_grad():
                for n, p in live.items():
                    p.copy_(global_params[n])
        losses = torch.stack(losses).tolist()
        return {"row": row, "params": params,
                "weight": float(steps * self.batch_size),
                "sample_losses": sample_losses,
                "mean_loss": float(np.mean(losses)), "losses": losses}

    @torch.no_grad()
    def aggregate(self, updates: List[Dict]):
        weights = np.array([u["weight"] for u in updates], np.float32)
        weights = weights / weights.sum()
        for n, p in self.model.named_parameters():
            agg = sum(float(w) * u["params"][n].float()
                      for w, u in zip(weights, updates))
            p.copy_(agg.to(p.dtype))

    @torch.no_grad()
    def evaluate(self) -> float:
        td = self.data.test_data
        n = len(next(iter(td.values())))
        take = min(self.eval_batch, n)
        batch = self._batch({k: v[:take] for k, v in td.items()})
        pred = torch.argmax(self.model.logits_fn(batch), dim=-1)
        return float(torch.mean((pred == batch["labels"]).float()))


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
