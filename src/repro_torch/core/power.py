"""Runtime power sharing within a power domain (paper §4.5).

When several participating clients share one excess-energy budget, the
domain controller attributes power in two phases, each weighted by the
energy a client still needs:

  1. clients below their m_min   — weight δ_c·(m_min − m_comp)
  2. clients below their m_max   — weight δ_c·(m_max − m_comp)

Clients are also capacity-constrained (they may not be able to use their
whole share), so attribution iterates "in constant consultation with
clients": any share a capacity-limited client cannot consume is
redistributed to the rest (waterfilling until fixpoint).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _waterfill(budget: float, needs: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Distribute ``budget`` proportionally to ``needs`` with per-client caps
    (both in energy units). Returns energy granted per client."""
    grant = np.zeros_like(needs, dtype=float)
    active = (needs > 1e-12) & (caps > 1e-12)
    # fast path: budget covers every active client's usable need — common
    # around solar peak; one vector op instead of the saturation fixpoint
    # loop (which is O(#cap-saturations) passes over the domain).
    limit = np.minimum(needs, caps)
    if active.any() and budget >= limit[active].sum():
        grant[active] = limit[active]
        return grant
    remaining = budget
    for _ in range(len(needs) + 1):  # converges in ≤ len(needs) rounds
        if remaining <= 1e-9 or not active.any():
            break
        w = needs * active
        share = remaining * w / w.sum()
        eff_cap = np.minimum(caps - grant, needs - grant)
        inc = np.minimum(share, np.maximum(eff_cap, 0.0))
        grant += inc
        remaining -= inc.sum()
        active = active & (grant < np.minimum(caps, needs) - 1e-12)
    return grant


def share_power(budget: float, deltas: np.ndarray, computed: np.ndarray,
                m_min: np.ndarray, m_max: np.ndarray,
                capacity: np.ndarray) -> np.ndarray:
    """Energy attributed to each active client for one timestep.

    budget    — excess energy available this step (Wmin)
    deltas    — δ_c energy per batch
    computed  — m_comp batches already done this round
    m_min/max — per-client round bounds (batches)
    capacity  — spare computing capacity this step (batches)

    Returns energy grants (Wmin); grants/δ_c is the batch allowance.
    """
    cap_energy = np.maximum(capacity, 0.0) * deltas
    # phase 1: fund clients below m_min
    need1 = np.maximum(m_min - computed, 0.0) * deltas
    g1 = _waterfill(budget, need1, cap_energy)
    # phase 2: remaining budget to clients below m_max
    need2 = np.maximum(m_max - computed, 0.0) * deltas - g1
    g2 = _waterfill(budget - g1.sum(), np.maximum(need2, 0.0),
                    np.maximum(cap_energy - g1, 0.0))
    return g1 + g2
