"""Federated dataset: synthetic tasks + Dirichlet(α) non-iid partitioner.

The paper skews both the number of samples and the class distribution per
client with a Dirichlet(α=0.5) prior (following Hsu et al. [22]); the
Shakespeare dataset is naturally partitioned by speaking role with heavy
sample imbalance (2365 ± 4674, min 730, max 27950 — §5.2). Both regimes
are reproduced here over synthetic data (offline container):

* ``synthetic_classification`` — Gaussian-mixture images -> class labels
  (stands in for CIFAR-100 / TinyImageNet);
* ``synthetic_chars``          — Markov-chain character streams with
  per-client transition skew (stands in for Shakespeare);
* ``synthetic_speech``         — class-dependent MFCC-patch sequences
  (stands in for Google Speech Commands).

A copy of the reference's ``repro/data/federated.py`` (NumPy only): the
same arguments give the same arrays. As there, ``synthetic_chars`` seeds
each client from ``hash(name)``, which Python salts per process, so its
data repeats only within one process.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FederatedData:
    """Per-client arrays + a held-out global test set."""

    client_data: Dict[str, Dict[str, np.ndarray]]
    test_data: Dict[str, np.ndarray]
    task: str  # classification | lm

    def n_samples(self, client: str) -> int:
        arrs = self.client_data[client]
        return len(next(iter(arrs.values())))

    def sample_batch(self, client: str, batch_size: int, rng: np.random.Generator):
        data = self.client_data[client]
        n = self.n_samples(client)
        idx = rng.integers(0, n, size=min(batch_size, n))
        return {k: v[idx] for k, v in data.items()}


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_client: int = 10) -> List[np.ndarray]:
    """Partition sample indices by Dirichlet(α) over classes per client
    (Hsu et al. 2019). Skews both class mix and client sizes. Every sample
    is assigned to exactly one client."""
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == k)[0] for k in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    # per-class allocation proportions over clients
    client_indices: List[List[int]] = [[] for _ in range(n_clients)]
    for k in range(n_classes):
        props = rng.dirichlet(alpha * np.ones(n_clients))
        counts = np.floor(props * len(idx_by_class[k])).astype(int)
        # distribute remainder to the largest proportions
        rem = len(idx_by_class[k]) - counts.sum()
        for j in np.argsort(-props)[:rem]:
            counts[j] += 1
        start = 0
        for c in range(n_clients):
            client_indices[c].extend(idx_by_class[k][start:start + counts[c]])
            start += counts[c]
    # ensure a minimum per client by stealing from the largest
    sizes = np.array([len(ci) for ci in client_indices])
    for c in np.where(sizes < min_per_client)[0]:
        donor = int(np.argmax([len(ci) for ci in client_indices]))
        need = min_per_client - len(client_indices[c])
        client_indices[c].extend(client_indices[donor][-need:])
        del client_indices[donor][-need:]
    return [np.array(sorted(ci), dtype=np.int64) for ci in client_indices]


# ---------------------------------------------------------------------------
# synthetic tasks


def synthetic_classification(n_clients: int, client_names: List[str],
                             n_classes: int = 20, n_samples: int = 20000,
                             hw: int = 16, channels: int = 3,
                             alpha: float = 0.5, seed: int = 0,
                             n_test: int = 2000) -> FederatedData:
    """Gaussian-mixture 'images': each class has a random prototype; samples
    are prototype + noise. Learnable but non-trivial, heavy class skew."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (n_classes, hw, hw, channels)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_samples)
    x = (protos[labels] + rng.normal(0, 1.2, (n_samples, hw, hw, channels))
         ).astype(np.float32)
    test_labels = rng.integers(0, n_classes, n_test)
    test_x = (protos[test_labels] + rng.normal(0, 1.2, (n_test, hw, hw, channels))
              ).astype(np.float32)
    parts = dirichlet_partition(labels, n_clients, alpha, rng)
    client_data = {name: {"image": x[part], "labels": labels[part]}
                   for name, part in zip(client_names, parts)}
    return FederatedData(client_data=client_data,
                         test_data={"image": test_x, "labels": test_labels},
                         task="classification")


def synthetic_chars(n_clients: int, client_names: List[str], vocab: int = 64,
                    seq_len: int = 48, seed: int = 0, n_test: int = 500,
                    mean_samples: int = 2365) -> FederatedData:
    """Markov character streams; each client has its own 'speaking role'
    (skewed transition matrix) and a log-normal sample count mirroring the
    Shakespeare imbalance (min 730, max 27950)."""
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(0.3 * np.ones(vocab), size=vocab)
    client_data = {}
    sizes = np.clip(rng.lognormal(np.log(mean_samples * 0.45), 1.0, n_clients),
                    730, 27950).astype(int) // 10  # scaled down for CPU
    for name, size in zip(client_names, sizes):
        crng = np.random.default_rng(abs(hash(name)) % 2**31)
        skew = crng.dirichlet(0.5 * np.ones(vocab), size=vocab)
        trans = 0.7 * base + 0.3 * skew
        trans /= trans.sum(1, keepdims=True)
        seqs = np.zeros((size, seq_len + 1), np.int32)
        state = crng.integers(0, vocab, size)
        seqs[:, 0] = state
        for t in range(1, seq_len + 1):
            u = crng.random(size)
            cdf = np.cumsum(trans[seqs[:, t - 1]], axis=1)
            seqs[:, t] = (u[:, None] > cdf).sum(1)
        client_data[name] = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    test = np.zeros((n_test, seq_len + 1), np.int32)
    trng = np.random.default_rng(seed + 1)
    test[:, 0] = trng.integers(0, vocab, n_test)
    for t in range(1, seq_len + 1):
        u = trng.random(n_test)
        cdf = np.cumsum(base[test[:, t - 1]], axis=1)
        test[:, t] = (u[:, None] > cdf).sum(1)
    return FederatedData(client_data=client_data,
                         test_data={"tokens": test[:, :-1], "labels": test[:, 1:]},
                         task="lm")


def synthetic_speech(n_clients: int, client_names: List[str],
                     n_classes: int = 30, n_samples: int = 12000,
                     n_patches: int = 32, seed: int = 0,
                     n_test: int = 1500) -> FederatedData:
    """Class-dependent random MFCC sequences (stands in for Google Speech:
    speakers assigned randomly to clients → near-iid class mix, uneven
    sizes)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (n_classes, n_patches, 40)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_samples)
    x = (protos[labels] + rng.normal(0, 1.0, (n_samples, n_patches, 40))
         ).astype(np.float32)
    tl = rng.integers(0, n_classes, n_test)
    tx = (protos[tl] + rng.normal(0, 1.0, (n_test, n_patches, 40))).astype(np.float32)
    # random speaker->client assignment = near-uniform partition, uneven sizes
    assignment = rng.integers(0, n_clients, n_samples)
    client_data = {}
    for c, name in enumerate(client_names):
        part = np.where(assignment == c)[0]
        if len(part) < 10:
            part = rng.integers(0, n_samples, 10)
        client_data[name] = {"mfcc": x[part], "labels": labels[part]}
    return FederatedData(client_data=client_data,
                         test_data={"mfcc": tx, "labels": tl}, task="classification")
