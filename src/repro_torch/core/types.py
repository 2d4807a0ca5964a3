"""Core data types for the FedZero scheduling system (paper Table 1).

Identity convention (row-ID-first): the **registry row index** is the
sole identity currency on the scheduling path. Client names exist only at
the I/O boundary — registry construction and ``FLSimulation.summary()``
— where :class:`ClientRegistry` owns the canonical name↔row maps.
Everything downstream (:class:`Selection`, :class:`RoundResult`, the
blocklist, the utility tracker, the solvers and the round executor)
carries integer row arrays and indexes the registry's structure-of-arrays
mirrors; no name-keyed dict is ever touched per round.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ClientSpec:
    """Static registration info for one FL client (paper §4.1)."""

    name: str
    domain: str                 # power domain id
    m_max_capacity: float       # m_c: max batches per timestep
    delta: float                # δ_c: energy per batch (Wmin/batch)
    n_samples: int              # |B_c| local dataset size
    batches_per_epoch: int      # ceil(n_samples / batch_size)
    min_epochs: float = 1.0     # lower bound: m_c^min = min_epochs * batches_per_epoch
    max_epochs: float = 5.0

    @property
    def m_min_batches(self) -> float:
        return self.min_epochs * self.batches_per_epoch

    @property
    def m_max_batches(self) -> float:
        return self.max_epochs * self.batches_per_epoch


@dataclasses.dataclass
class PowerDomain:
    """A cluster of clients sharing one excess-energy budget (paper §3.1)."""

    name: str
    clients: List[str] = dataclasses.field(default_factory=list)
    max_output: float = 800.0  # W (paper §5.1: 800 W per domain)


@dataclasses.dataclass
class Selection:
    """Output of a client-selection strategy for one round.

    ``rows`` are registry row indices in selection order;
    ``expected_batches`` (if the solver planned them) aligns with
    ``rows``.
    """

    rows: np.ndarray
    expected_duration: int                    # d (timesteps)
    expected_batches: Optional[np.ndarray] = None
    grid: bool = False   # grid-fallback round (carbon-accounted, not zero)


@dataclasses.dataclass
class RoundResult:
    """Per-round outcome; all client identity is registry row arrays.

    ``contributor_idx`` gives each contributor's position within
    ``participants`` (and therefore within ``batches``), so callers never
    need a reverse lookup.
    """

    round_idx: int
    start_step: int
    duration: int                  # actual timesteps used
    participants: np.ndarray       # selected registry rows (selection order)
    contributors: np.ndarray       # rows that reached m_min, finish order
    contributor_idx: np.ndarray    # positions of contributors in participants
    stragglers: np.ndarray         # selected rows whose work was discarded
    energy_used: float             # Wmin, all selected clients (incl. discarded)
    grid_energy: float = 0.0       # Wmin drawn from the grid (fallback rounds)
    carbon_g: float = 0.0          # gCO2 emitted (fallback rounds only)
    batches: Optional[np.ndarray] = None   # [len(participants)] batches done
    train_loss: float = float("nan")
    eval_metric: float = float("nan")


@dataclasses.dataclass(frozen=True, eq=False)
class ServiceEvent:
    """One record of the always-on scheduler's request log
    (:mod:`repro_torch.service`). The log is the service's determinism
    contract: replaying the same event sequence against a fresh service
    instance — or against the from-scratch batch engine — must produce
    bit-identical admissions (see docs/service.md).

    ``kind`` is one of ``advance`` / ``register`` / ``deregister`` /
    ``admit`` / ``report``; ``step`` the virtual-clock time at which the
    event was processed. ``rows`` carries the registry rows of a
    register/deregister burst; ``n``/``d_max`` the admit request
    parameters (``n`` doubles as the step count of an ``advance``);
    ``round_id`` the round an admit opened (−1 for an infeasible admit)
    or a report closed. ``payload`` carries a report's training outcome —
    ``contributors`` / ``participants`` row arrays and the per-contributor
    ``sample_losses`` list — so replay never re-runs a trainer.
    """

    kind: str
    step: int
    rows: Optional[np.ndarray] = None
    n: int = 0
    d_max: int = 0
    round_id: int = -1
    payload: Optional[Dict] = None


class ClientRegistry:
    """Owns the canonical name↔row maps and the SoA spec columns.

    Rows are assigned by construction order and never change; the
    scheduling stack identifies clients exclusively by these rows. The
    structure-of-arrays columns (``delta_arr``, ``capacity_arr``,
    ``m_min_arr``, ``m_max_arr``, ``n_samples_arr``) align with
    ``client_names``; the simulation step loop and the selection solvers
    index them with integer row arrays instead of doing per-client
    attribute/dict lookups, which is what makes 100k-client rounds
    tractable.

    Array-first construction: :meth:`from_arrays` is the canonical
    constructor — it adopts the SoA columns directly, allocates **no**
    per-client Python objects, and generates names/dicts lazily only at
    the I/O boundary (``rows``, ``name_of``, ``clients``, ``domains``,
    ``summary()`` reporting). A 1M-client registry is five float columns
    plus one int column (~46 MB) built in a few hundred milliseconds
    (gated by ``1m_registry`` in benchmarks/e2e_simulation.py); the
    name list and dicts cost O(C) Python objects when first touched, so
    fleet-scale code should stay on the columns until the reporting
    boundary. The legacy spec-list constructor
    (``ClientRegistry(clients, domains)``) survives as a compatibility
    shim that derives the columns from the specs.

    :class:`ClientSpec` access on an array-built registry is an
    **on-demand view**: the first touch of ``clients`` materializes spec
    objects from the columns (O(C) Python — avoid on huge fleets) and
    from then on the specs are the mutable source of truth, exactly like
    the legacy constructor: field edits are reflected lazily before the
    first column read, or via ``refresh_arrays()`` afterwards.
    """

    def __init__(self, clients: List[ClientSpec], domains: List[PowerDomain]):
        # legacy spec-backed construction (compat shim): specs canonical,
        # columns derived lazily so the documented tweak-after-construction
        # pattern (test_system.py, train_federated.py) keeps working
        self._specs: Optional[Dict[str, ClientSpec]] = \
            {c.name: c for c in clients}
        self._domains_dict: Optional[Dict[str, PowerDomain]] = \
            {p.name: p for p in domains}
        for p in self._domains_dict.values():
            p.clients = [c.name for c in clients if c.domain == p.name]
        self._names: Optional[List[str]] = [c.name for c in clients]
        self._name_fmt = "client_{:03d}"
        self._n = len(clients)
        self._domain_names = [p.name for p in domains]
        # per-domain W caps; collapses to a scalar when uniform so legacy
        # single-cap registries round-trip unchanged
        caps = {p.max_output for p in domains}
        self._max_output = (caps.pop() if len(caps) == 1 else
                            np.array([p.max_output for p in domains],
                                     dtype=float)) if domains else 800.0
        self._domain_idx: Optional[np.ndarray] = None
        self._domain_of: Optional[Dict[str, str]] = \
            {c.name: c.domain for c in clients}
        self._row_of: Optional[Dict[str, int]] = \
            {n: i for i, n in enumerate(self._names)}
        self._cols: Optional[tuple] = None
        self._view_fields: Optional[tuple] = None
        self._domain_rows_cache: Dict[tuple, np.ndarray] = {}

    @classmethod
    def from_arrays(cls, *, delta: np.ndarray, capacity: np.ndarray,
                    m_min: np.ndarray, m_max: np.ndarray,
                    n_samples: np.ndarray, domain_idx: np.ndarray,
                    domain_names: Sequence[str],
                    names: Optional[Sequence[str]] = None,
                    name_fmt: str = "client_{:03d}",
                    max_output=800.0,
                    batches_per_epoch: Optional[np.ndarray] = None,
                    min_epochs=1.0, max_epochs=5.0) -> "ClientRegistry":
        """Canonical array-first constructor: adopt SoA columns directly.

        ``domain_idx[c]`` indexes ``domain_names``; ``names`` (or lazily
        ``name_fmt.format(row)``) exists only for the I/O boundary and is
        not generated here. ``max_output`` is the domain power cap in W —
        a scalar (paper §5.1: 800 W everywhere) or a per-domain
        ``[len(domain_names)]`` array for heterogeneous solar
        installations (``max_output_arr`` serves the broadcast view;
        :func:`repro_torch.core.experiment.build_scenario` sizes each domain's
        solar peak from it). ``batches_per_epoch``/``min_epochs``/
        ``max_epochs`` parameterize the on-demand :class:`ClientSpec`
        view only — when omitted, view specs carry ``batches_per_epoch=1``
        with ``min/max_epochs`` equal to the batch bounds, so their
        derived properties still match the columns exactly. When given,
        they must reproduce the adopted columns exactly
        (``m_min == min_epochs·bpe``, ``m_max == max_epochs·bpe``) —
        enforced here, because a later ``clients`` view access re-derives
        the columns from the view: custom batch bounds that don't factor
        this way should simply omit ``batches_per_epoch``.
        """
        self = cls.__new__(cls)
        n = len(delta)
        cols = tuple(np.ascontiguousarray(a, dtype=float)
                     for a in (delta, capacity, m_min, m_max, n_samples))
        for a in cols:
            if a.shape != (n,):
                raise ValueError("column shape mismatch")
        if not np.array_equal(cols[4], np.trunc(cols[4])):
            # the spec view holds int(n_samples); fractional counts would
            # be silently truncated on a later `clients` view round-trip
            raise ValueError("n_samples must be integral")
        self._cols = cols
        self._domain_idx = np.ascontiguousarray(domain_idx, dtype=int)
        if self._domain_idx.shape != (n,):
            raise ValueError("domain_idx shape mismatch")
        self._domain_names = list(domain_names)
        mo = np.asarray(max_output, dtype=float)
        if mo.ndim == 0:
            self._max_output = float(mo)
        elif mo.shape == (len(self._domain_names),):
            # per-domain W caps (heterogeneous solar installations)
            self._max_output = mo.copy()
        else:
            raise ValueError(
                f"max_output has shape {mo.shape}, expected a scalar or "
                f"({len(self._domain_names)},) per-domain caps")
        self._n = n
        self._names = list(names) if names is not None else None
        if self._names is not None and len(self._names) != n:
            raise ValueError("names length mismatch")
        self._name_fmt = name_fmt
        self._specs = None
        self._domains_dict = None
        self._domain_of = None
        self._row_of = None
        if batches_per_epoch is not None:
            # the spec view re-derives m_min/m_max as epochs × bpe; reject
            # inconsistent view parameters now rather than silently
            # rewriting the scheduling columns on first `clients` access
            bpe = np.asarray(batches_per_epoch)
            for given, epochs, label in ((cols[2], min_epochs, "m_min"),
                                         (cols[3], max_epochs, "m_max")):
                if not np.array_equal(np.asarray(epochs, dtype=float) * bpe,
                                      given):
                    raise ValueError(
                        f"{label} must equal "
                        f"{label.replace('m_', '')}_epochs * "
                        f"batches_per_epoch for the spec view; omit "
                        f"batches_per_epoch for custom batch bounds")
        self._view_fields = (batches_per_epoch, min_epochs, max_epochs)
        self._domain_rows_cache: Dict[tuple, np.ndarray] = {}
        return self

    # -- SoA columns ------------------------------------------------------
    # Spec-backed registries build the columns lazily on first use, so the
    # documented pattern of tweaking ClientSpec fields right after
    # construction (e.g. matching n_samples/batches_per_epoch to a real
    # dataset, see test_system.py) is reflected. After mutating specs
    # *once columns have been read*, call refresh_arrays().
    def _arrays(self) -> tuple:
        if self._cols is None:
            specs = [self._specs[n] for n in self.client_names]
            self._cols = (
                np.array([s.delta for s in specs], dtype=float),
                np.array([s.m_max_capacity for s in specs], dtype=float),
                np.array([s.m_min_batches for s in specs], dtype=float),
                np.array([s.m_max_batches for s in specs], dtype=float),
                np.array([s.n_samples for s in specs], dtype=float),
            )
        return self._cols

    @property
    def delta_arr(self) -> np.ndarray:
        return self._arrays()[0]

    @property
    def capacity_arr(self) -> np.ndarray:
        return self._arrays()[1]

    @property
    def m_min_arr(self) -> np.ndarray:
        return self._arrays()[2]

    @property
    def m_max_arr(self) -> np.ndarray:
        return self._arrays()[3]

    @property
    def n_samples_arr(self) -> np.ndarray:
        return self._arrays()[4]

    def refresh_arrays(self):
        """Invalidate the cached SoA columns after mutating ClientSpecs."""
        if self._specs is not None:
            self._cols = None

    # -- ClientSpec compatibility view ------------------------------------
    def _materialize_specs(self) -> Dict[str, ClientSpec]:
        """Build the per-client spec view from the columns (compat only).

        After this call the specs are the mutable source of truth: the
        columns re-derive from them (lazily, or via ``refresh_arrays``),
        preserving the legacy mutate-after-construction contract. O(C)
        Python objects — never called by the scheduling path.
        """
        if self._specs is None:
            delta, cap, m_min, m_max, ns = self._arrays()
            bpe, min_ep, max_ep = self._view_fields
            names = self.client_names
            dom_names = self._domain_names
            dom_idx = self._domain_idx
            specs = {}
            for i in range(self._n):
                if bpe is not None:
                    b = int(bpe[i])
                    lo = float(min_ep if np.isscalar(min_ep) else min_ep[i])
                    hi = float(max_ep if np.isscalar(max_ep) else max_ep[i])
                else:  # no epoch structure given: encode the bounds directly
                    b, lo, hi = 1, float(m_min[i]), float(m_max[i])
                specs[names[i]] = ClientSpec(  # compat spec view (I/O boundary)
                    name=names[i], domain=dom_names[dom_idx[i]],
                    m_max_capacity=float(cap[i]), delta=float(delta[i]),
                    n_samples=int(ns[i]), batches_per_epoch=b,
                    min_epochs=lo, max_epochs=hi)
            self._specs = specs
            self._cols = None  # specs now canonical: columns re-derive lazily
        return self._specs

    @property
    def clients(self) -> Dict[str, ClientSpec]:
        """name → :class:`ClientSpec` view (materialized on demand)."""
        return self._materialize_specs()

    @property
    def max_output_arr(self) -> np.ndarray:
        """[P] per-domain power cap in W (a scalar cap broadcasts)."""
        mo = np.asarray(self._max_output, dtype=float)
        if mo.ndim == 0:
            return np.full(len(self._domain_names), float(mo))
        return mo

    @property
    def domains(self) -> Dict[str, PowerDomain]:
        """name → :class:`PowerDomain` view (materialized on demand)."""
        if self._domains_dict is None:
            names = self.client_names
            dom_clients: Dict[str, List[str]] = \
                {d: [] for d in self._domain_names}
            for i, di in enumerate(self._domain_idx):
                dom_clients[self._domain_names[di]].append(names[i])
            mo = self.max_output_arr
            self._domains_dict = {
                d: PowerDomain(name=d, clients=dom_clients[d],
                               max_output=float(mo[j]))
                for j, d in enumerate(self._domain_names)}
        return self._domains_dict

    # -- name↔row boundary (construction / reporting only) ---------------
    @property
    def client_names(self) -> List[str]:
        """Positional name list (generated on demand for array-built
        registries — reporting boundary, not the scheduling path)."""
        if self._names is None:
            fmt = self._name_fmt
            self._names = [fmt.format(i) for i in range(self._n)]
        return self._names

    @property
    def row_of(self) -> Dict[str, int]:
        if self._row_of is None:
            self._row_of = {n: i for i, n in enumerate(self.client_names)}
        return self._row_of

    @property
    def domain_of(self) -> Dict[str, str]:
        if self._domain_of is None:
            self._domain_of = {
                n: self._domain_names[di]
                for n, di in zip(self.client_names, self._domain_idx)}
        return self._domain_of

    def rows(self, names: Sequence[str]) -> np.ndarray:
        """Registry row index per name (I/O boundary gather key)."""
        if names is self._names:
            return np.arange(self._n)
        row_of = self.row_of
        return np.array([row_of[n] for n in names], dtype=int)

    def name_of(self, row: int) -> str:
        return self.client_names[int(row)]

    def names_of(self, rows: Sequence[int]) -> List[str]:
        names = self.client_names
        return [names[int(r)] for r in rows]

    def domain_rows(self, domain_order: List[str]) -> np.ndarray:
        """[C] index of each client's domain within ``domain_order``.

        Cached per domain ordering: simulations/strategies call this every
        round with the scenario's (stable) domain list. Array-built
        registries answer their native ordering straight from the
        ``domain_idx`` column — no name dict is ever materialized.
        """
        key = tuple(domain_order)
        cached = self._domain_rows_cache.get(key)
        if cached is None:
            if self._domain_idx is not None:
                if list(domain_order) == self._domain_names:
                    # read-only view: the canonical identity column must
                    # not be mutable through a lookup's return value
                    cached = self._domain_idx.view()
                    cached.flags.writeable = False
                else:
                    idx = {p: i for i, p in enumerate(domain_order)}
                    perm = np.array([idx[d] for d in self._domain_names],
                                    dtype=int)
                    cached = perm[self._domain_idx]
            else:
                idx = {p: i for i, p in enumerate(domain_order)}
                domain_of = self.domain_of
                cached = np.array([idx[domain_of[n]]
                                   for n in self.client_names], dtype=int)
            self._domain_rows_cache[key] = cached
        return cached

    def domain_clients(self, domain: str) -> List[ClientSpec]:
        clients = self.clients
        return [clients[n] for n in self.domains[domain].clients]

    def __len__(self):
        return self._n
