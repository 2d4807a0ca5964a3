"""Deterministic fault injection for the service's round executors.

FedZero's clients run on volatile excess energy and spare capacity —
power can vanish mid-round, workers die, report messages arrive late or
not at all. This module models exactly that unreliability as a
:class:`FaultPlan`: a frozen schedule whose every decision is a
**counter hash** of ``(seed, kind, round_id, …)`` through the backend's
splitmix64 primitives (:func:`repro_torch.backend.base.hash64` /
:func:`~repro_torch.backend.base.u01`). No RNG object, no process state, no
wall clock — two runs with the same plan draw the same faults, a worker
process consults the same plan the parent ships it, and a replayed
event log never needs the plan at all (faults only shape *what gets
logged*, never how the log is consumed; see docs/service.md).
The draws are per-row host scalars and stay NumPy: they equal the
reference package's plan bit for bit, and nothing in them belongs on a
device.

Fault kinds:

* **worker crashes** — ``worker_crash(round_id, slot, attempt)``: the
  worker process owning a round shard dies mid-round (``os._exit`` in
  the multiprocess executor). Either rate-based or pinned via
  ``crash_schedule`` triples; retried per :class:`RetryPolicy`.
* **client mid-round dropouts** — when a selected client's power-domain
  *realized* excess hits zero inside the round window, the client drops
  with probability ``dropout_rate`` at that step: its work so far
  counts (energy accounting covers discarded work, paper §4.5), but it
  computes nothing further.
* **stragglers** — a client's effective compute rate is scaled by
  ``straggler_slowdown`` with probability ``straggler_rate``.
* **delayed / lost reports** — a round's completion message arrives
  ``report_delay_steps`` late with probability ``report_delay_rate``;
  each delivery attempt is lost with probability ``report_loss_rate``
  and re-tried after ``RetryPolicy.backoff_steps`` virtual steps. A
  round whose delivery budget is exhausted closes **degraded**.

All timing is in *virtual* steps — retries, backoff and timeouts move
with the service clock, which is what keeps a faulted run replayable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..backend.base import hash64, u01

# salts: one per fault kind so the per-kind streams never collide
_SALT_CRASH = 0xFA01
_SALT_DROP = 0xFA02
_SALT_STRAG = 0xFA03
_SALT_DELAY = 0xFA04
_SALT_LOSS = 0xFA05


def _coin(seed: int, salt: int, *keys) -> np.ndarray:
    """Uniform [0,1) draw(s), pure in (seed, salt, keys)."""
    return u01(hash64(seed, salt, *keys))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry / timeout / backoff knobs shared by both fault surfaces.

    ``max_retries`` bounds *per-shard* worker-crash retries and
    *per-round* report redeliveries (each budget is counted
    independently). ``backoff_steps`` is the virtual-step spacing
    between report delivery attempts (clamped to >= 1 — the service
    polls once per clock step). ``timeout_steps``, when set, hard-caps
    how late past its natural end a round may report; a delivery
    scheduled beyond the cap degrades the round immediately instead.
    """

    max_retries: int = 2
    backoff_steps: int = 1
    timeout_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule (see module docstring).

    ``crash_schedule`` pins explicit ``(round_id, worker_slot, attempt)``
    crashes on top of the rate — the reproducible-failure hook the fault
    tests use. An empty plan (all rates zero, no schedule) injects
    nothing; ``FaultPlan.parse("crash=0.01,dropout=0.05")`` builds one
    from the CLI spec (``python -m repro_torch.service --faults ...``).
    """

    seed: int = 0
    worker_crash_rate: float = 0.0
    crash_schedule: Tuple[Tuple[int, int, int], ...] = ()
    dropout_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_slowdown: float = 0.25
    report_delay_rate: float = 0.0
    report_delay_steps: int = 3
    report_loss_rate: float = 0.0
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)

    # ------------------------------------------------------------------
    @property
    def any_faults(self) -> bool:
        return bool(self.crash_schedule) or any(
            r > 0 for r in (self.worker_crash_rate, self.dropout_rate,
                            self.straggler_rate, self.report_delay_rate,
                            self.report_loss_rate))

    # -- worker faults --------------------------------------------------
    def worker_crash(self, round_id: int, slot: int, attempt: int) -> bool:
        """Does the worker in ``slot`` die while executing this round's
        shard on this ``attempt``? Pure — the worker process and the
        parent agree on the answer without talking."""
        if (int(round_id), int(slot), int(attempt)) in self.crash_schedule:
            return True
        if self.worker_crash_rate <= 0:
            return False
        return float(_coin(self.seed, _SALT_CRASH, round_id, slot,
                           attempt)) < self.worker_crash_rate

    # -- client faults --------------------------------------------------
    def round_effects(self, scenario, dom_rows: np.ndarray,
                      rows: np.ndarray, now: int, d_max: int,
                      round_id: int
                      ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Per-selected-client fault effects for one round: the
        ``(drop_step, speed)`` arrays :func:`~repro_torch.core.simulation.
        execute_round` consumes, aligned with ``rows``.

        A client drops at the **first step its domain's realized excess
        is zero** inside the round window (never earlier — FedZero's
        premise is that the volatility is in the energy), coin-gated per
        ``(seed, round, row)``; stragglers get their compute rate scaled
        by ``straggler_slowdown``. Returns ``(None, None)`` when neither
        rate is set."""
        rows = np.asarray(rows, dtype=np.int64)
        drop = speed = None
        if self.straggler_rate > 0 and rows.size:
            c = u01(hash64(self.seed, _SALT_STRAG, round_id, rows))
            speed = np.where(c < self.straggler_rate,
                             float(self.straggler_slowdown), 1.0)
        if self.dropout_rate > 0 and rows.size:
            window = int(max(0, min(d_max, scenario.n_steps - now)))
            drop = np.full(rows.size, -1, dtype=np.int64)
            if window:
                exc = np.stack([scenario.excess_at(now + s)
                                for s in range(window)], axis=1)  # [P, w]
                dead_win = exc <= 0.0
                dom = dom_rows[rows]
                c = u01(hash64(self.seed, _SALT_DROP, round_id, rows))
                for i in range(rows.size):
                    zero = np.nonzero(dead_win[dom[i]])[0]
                    if zero.size and float(c[i]) < self.dropout_rate:
                        drop[i] = int(zero[0])
        return drop, speed

    # -- report-message faults ------------------------------------------
    def report_delay(self, round_id: int) -> int:
        """Virtual steps the round's completion message arrives late."""
        if self.report_delay_rate <= 0:
            return 0
        late = float(_coin(self.seed, _SALT_DELAY,
                           round_id)) < self.report_delay_rate
        return int(self.report_delay_steps) if late else 0

    def report_lost(self, round_id: int, attempt: int) -> bool:
        """Is delivery ``attempt`` of this round's report lost?"""
        if self.report_loss_rate <= 0:
            return False
        return float(_coin(self.seed, _SALT_LOSS, round_id,
                           attempt)) < self.report_loss_rate

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a ``k=v,k=v`` CLI spec. Keys: ``seed``,
        ``crash``, ``dropout``, ``straggler``, ``slowdown``, ``delay``
        (rate), ``delay_steps``, ``loss``, ``retries``, ``backoff``,
        ``timeout``. Example: ``"crash=0.01,dropout=0.05,seed=3"``."""
        fields = {
            "seed": ("seed", int), "crash": ("worker_crash_rate", float),
            "dropout": ("dropout_rate", float),
            "straggler": ("straggler_rate", float),
            "slowdown": ("straggler_slowdown", float),
            "delay": ("report_delay_rate", float),
            "delay_steps": ("report_delay_steps", int),
            "loss": ("report_loss_rate", float),
        }
        policy = {"retries": ("max_retries", int),
                  "backoff": ("backoff_steps", int),
                  "timeout": ("timeout_steps", int)}
        kw, pol = {}, {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, _, val = part.partition("=")
            if key in fields:
                name, typ = fields[key]
                kw[name] = typ(val)
            elif key in policy:
                name, typ = policy[key]
                pol[name] = typ(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r} "
                                 f"(known: {sorted(fields) + sorted(policy)})")
        if pol:
            kw["retry"] = RetryPolicy(**pol)
        return cls(**kw)
