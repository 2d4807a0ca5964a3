"""Statistical utility σ_c (paper §4.3, based on Oort [30]).

    σ_c = |B_c| · sqrt( 1/|B_c| · Σ_{k∈B_c} loss(k)² )   if p(c) ≥ 1
    σ_c = 1                                               otherwise

The per-sample losses come from the client's most recent participation.
Blocked clients (fairness module) override σ_c = 0 at selection time.

Implementation: flat structure-of-arrays indexed by registry row —
participation counts, squared-loss means (NaN = never reported) and
dataset sizes — so ``sigmas`` over a 100k-client fleet is three gathers
and a ``where``. No names enter this module; callers pass registry rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class UtilityTracker:
    def __init__(self, n_samples: np.ndarray):
        self.n_samples_arr = np.asarray(n_samples, dtype=float)
        n = len(self.n_samples_arr)
        self.sq_loss_mean_arr = np.full(n, np.nan)
        self.participation_arr = np.zeros(n, dtype=np.int64)

    def record(self, row: int, sample_losses: np.ndarray):
        """Store the loss statistics reported after a participation."""
        self.participation_arr[row] += 1
        if len(sample_losses):
            self.sq_loss_mean_arr[row] = float(
                np.mean(np.square(sample_losses)))

    def sigma(self, row: int) -> float:
        sq = self.sq_loss_mean_arr[row]
        if self.participation_arr[row] < 1 or np.isnan(sq):
            return 1.0
        return float(self.n_samples_arr[row] * np.sqrt(sq))

    def sigmas(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """σ per registry row (all rows when ``rows`` is None) —
        vectorized, returns a fresh array."""
        idx = slice(None) if rows is None else rows
        sq = self.sq_loss_mean_arr[idx]
        seen = (self.participation_arr[idx] >= 1) & ~np.isnan(sq)
        return np.where(seen,
                        self.n_samples_arr[idx]
                        * np.sqrt(np.where(np.isnan(sq), 0.0, sq)),
                        1.0)
