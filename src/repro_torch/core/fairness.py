"""Fair-participation blocklist (paper §4.4) — registry-row arrays.

Clients enter the blocklist after participating in a round; at the start of
each round a blocked client c is released with probability

    P(c) = (p(c) − ω)^(−α)   if p(c) − ω > 0
    P(c) = 1                 otherwise

where p(c) is the client's total past participation count, α controls
release speed (paper uses α = 1), and ω is periodically updated to the mean
participation over all clients so release probabilities do not decay over
the course of a long training.

State is two flat arrays indexed by registry row (``participation`` int64,
``blocked`` bool): ω refresh is one vectorized mean and the stochastic
release is a single batched draw over the blocked rows in ascending row
order. (The pre-row-ID implementation drew over the *sorted-name* order,
which differs from row order once names stop sorting lexicographically —
the release draws are therefore distributionally, not bitwise, equivalent;
see tests/test_rowid_parity.py.)
"""
from __future__ import annotations

import numpy as np


class Blocklist:
    def __init__(self, n_clients: int, alpha: float = 1.0, seed: int = 0,
                 omega_update_every: int = 1):
        self.alpha = alpha
        self.blocked = np.zeros(n_clients, dtype=bool)
        self.participation = np.zeros(n_clients, dtype=np.int64)
        self.omega = 0.0
        self._round = 0
        self._omega_every = omega_update_every
        self._rng = np.random.default_rng(seed)

    def release_probability(self, row: int) -> float:
        excess = self.participation[row] - self.omega
        if excess <= 0:
            return 1.0
        return float(min(1.0, excess ** (-self.alpha)))

    def blocked_rows(self) -> np.ndarray:
        """Currently-blocked registry rows, ascending."""
        return np.nonzero(self.blocked)[0]

    def start_round(self):
        """Update ω periodically and stochastically release blocked rows."""
        self._round += 1
        if (self._round - 1) % self._omega_every == 0:
            self.omega = float(self.participation.mean())
        rows = np.nonzero(self.blocked)[0]
        if not rows.size:
            return
        excess = self.participation[rows] - self.omega
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            probs = np.where(excess > 0,
                             np.minimum(1.0, excess ** (-self.alpha)), 1.0)
        released = self._rng.random(rows.size) < probs
        self.blocked[rows[released]] = False

    def record_participation(self, rows: np.ndarray):
        self.participation[rows] += 1
        self.blocked[rows] = True

    def is_blocked(self, row: int) -> bool:
        return bool(self.blocked[row])
