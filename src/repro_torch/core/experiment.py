"""Declarative experiment API: config in, comparable summaries out.

The paper's evaluation (§5) is a grid of scenario × strategy × fleet-size
runs; hand-wiring each one through the four-step construction
(``make_scenario`` → ``make_paper_registry`` → ``make_strategy`` →
``FLSimulation``) does not scale to "as many scenarios as you can
imagine". This module makes the whole experiment a value:

* :class:`ExperimentConfig` — five frozen dataclass sections
  (:class:`ScenarioSection`, :class:`FleetSection`,
  :class:`StrategySection`, :class:`TrainerSection`, :class:`RunSection`)
  that fully determine a run. Configs are cheap to construct, copy with
  ``dataclasses.replace`` / :meth:`ExperimentConfig.with_strategy`, and
  carry their own seeds, so a sweep is a list comprehension.
* :func:`run_experiment` — build + run one config, return its summary.
* :func:`run_sweep` — run several configs; configs sharing a scenario
  section share **one** :class:`ScenarioStore` (traces are counter-seeded
  and read-only on the round path, so a shared store is bit-identical to
  per-run stores — pinned by tests/test_experiment_api.py).
* granular builders (:func:`build_scenario`, :func:`build_registry`,
  :func:`build_trainer`, :func:`build_experiment`) for entrypoints that
  need to interpose — e.g. a custom trainer over a real dataset —
  without re-hand-wiring everything.
* :func:`config_from_reference` — carry a reference-package config
  (``dataclasses.asdict`` of it) over to this package's equal config.

Construction is array-first end to end: the fleet section synthesizes the
registry's SoA columns directly (:meth:`ClientRegistry.from_arrays` via
``make_paper_registry`` — no per-client Python objects), which is what
makes 1M-client configs practical (see benchmarks/e2e_simulation.py,
``1m_registry``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.traces import ScenarioStore, make_scenario

from .profiles import make_paper_registry
from .simulation import FLSimulation
from .strategies import BaseStrategy, make_strategy
from .trainers import ProxyTrainer
from .types import ClientRegistry


@dataclasses.dataclass(frozen=True, eq=False)
class ScenarioSection:
    """Energy/load environment. Either a synthesis spec (``name``/
    ``days``/``peak_w``) or explicit trace arrays (``excess``/``util``/
    optional ``carbon`` — drop-in real traces or test fixtures)."""

    name: str = "global"            # 'global' | 'co_located' (paper Fig. 2)
    days: int = 1
    seed: int = 0
    peak_w: float = 800.0
    error: str = "realistic"        # realistic | none | no_load
    # util synthesis: 'dense' (chunked [C, chunk] slabs, bit-identical to
    # the pre-sparse store) or 'sparse' (counter-based sparse-activity
    # segments, gathered per row — the million-client path; FedZero's
    # greedy solver auto-switches to sharded lazy selection over it)
    util_mode: str = "dense"
    unlimited_domains: Tuple[str, ...] = ()
    excess: Optional[np.ndarray] = None   # [P, T] explicit-trace mode
    util: Optional[np.ndarray] = None     # [C, T]
    carbon: Optional[np.ndarray] = None   # [P, T]
    domain_names: Optional[Tuple[str, ...]] = None  # explicit-trace mode


@dataclasses.dataclass(frozen=True, eq=False)
class FleetSection:
    """Client population: paper Table 2 hardware profiles over the
    scenario's power domains, synthesized as SoA columns."""

    n_clients: int = 100
    workload: str = "densenet"
    seed: int = 0
    min_epochs: float = 1.0
    max_epochs: float = 5.0
    # domain power cap in W: a scalar, or a per-domain [P] array — then
    # build_scenario also sizes each domain's solar peak from it (the
    # fleet's installations win over the scenario's uniform peak_w)
    max_output: object = 800.0
    samples_per_client: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True, eq=False)
class StrategySection:
    """Client-selection strategy (a ``make_strategy`` key + options)."""

    name: str = "fedzero"
    n: int = 10
    d_max: int = 60
    seed: int = 0
    options: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, eq=False)
class TrainerSection:
    """Trainer plugged into the simulation; ``factory(registry)``
    overrides the built-in :class:`ProxyTrainer` (e.g. a
    :class:`~repro_torch.core.trainers.TorchTrainer` over a real federated
    dataset: FedProx local training of a model on ``cuda:0``)."""

    kind: str = "proxy"
    k: float = 0.003
    acc_max: float = 0.9
    seed: int = 0
    factory: Optional[Callable[[ClientRegistry], object]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class RunSection:
    """Simulation horizon and reporting cadence. ``until_step`` wins over
    ``days`` (which resolves to ``days·1440 − d_max − 1``, the benchmark
    convention); both ``None`` runs to the end of the scenario.

    ``backend`` picks the array backend for the scheduling hot path
    (``repro_torch.backend.available_backends()``: ``"cuda"``, the
    default, is the device path on ``cuda:0`` with the hand-written CUDA
    synthesis kernels and raises without CUDA; ``"torch"`` names the same
    backend; ``"numpy"`` is the bit-exact host reference, run only when
    asked for; an :class:`~repro_torch.backend.ArrayBackend` instance
    such as ``CudaBackend(device="cpu")`` picks another device). It threads
    into both the scenario store (sparse-util gather grids) and the
    selection solvers, and wins over any ``backend`` in the strategy
    section's options — the run decides where its math executes.

    ``exact_uncapped`` governs the exact uncapped sharded selection walk
    (the segment-domain reach evaluator): ``None`` (default) lets each
    strategy auto-detect — the overlay is used whenever the scenario
    store provides one; ``True`` requires it (the run fails fast where
    it cannot apply, e.g. dense stores or a positive ``candidate_cap``);
    ``False`` forces the legacy optimistic bounds. Only ``True``/
    ``False`` are forwarded to the strategy, so a strategy section's own
    ``exact_uncapped`` option survives the default."""

    until_step: Optional[int] = None
    days: Optional[float] = None
    max_rounds: Optional[int] = None
    target_metric: Optional[float] = None
    eval_every: int = 5
    seed: int = 0
    verbose: bool = False
    backend: str = "cuda"
    exact_uncapped: Optional[bool] = None


@dataclasses.dataclass(frozen=True, eq=False)
class ServiceSection:
    """Always-on scheduling service knobs (:mod:`repro_torch.service`) — how
    :func:`repro_torch.service.build_service` turns this experiment into a
    continuously-running scheduler instead of a batch loop. The batch
    entrypoints (:func:`run_experiment` / :func:`run_sweep`) ignore this
    section entirely.

    ``n``/``d_max`` default to the strategy section's; ``executor``
    picks the round executor (``"inprocess"`` runs rounds eagerly via
    :func:`repro_torch.core.simulation.execute_round` + the configured trainer
    and completes them when the virtual clock passes the round end;
    ``"multiprocess"`` shards rounds by power domain across ``workers``
    persistent worker processes — summary-identical to in-process when
    fault-free; ``"none"`` leaves round reporting to the caller — the
    replay path). ``faults`` optionally carries a
    :class:`repro_torch.service.faults.FaultPlan` for deterministic fault
    injection (typed loosely here to keep core free of service
    imports). ``incremental`` toggles the admission cache (engine reuse +
    deactivation + backend ``reach_state_subset``); ``False`` prices
    every admit from scratch — the batch reference the determinism
    contract pins against. ``compact_frac`` is the dead-candidate
    fraction past which a reused engine is compacted via the backend's
    incremental reach-state subset op. ``exclude_training`` removes rows
    of in-flight (unreported) rounds from admission. ``record_log``
    keeps the :class:`~repro_torch.core.types.ServiceEvent` request log for
    replay."""

    n: Optional[int] = None
    d_max: Optional[int] = None
    executor: str = "inprocess"
    workers: int = 2
    faults: Optional[object] = None
    incremental: bool = True
    compact_frac: float = 0.25
    exclude_training: bool = True
    record_log: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class ExperimentConfig:
    """One fully-specified experiment: scenario × fleet × strategy ×
    trainer × run. Sections default sensibly, so
    ``ExperimentConfig(strategy=StrategySection(name="oort"))`` is a
    complete experiment. The optional ``service`` section only matters
    to :func:`repro_torch.service.build_service` (the always-on scheduler);
    batch runs ignore it."""

    scenario: ScenarioSection = dataclasses.field(
        default_factory=ScenarioSection)
    fleet: FleetSection = dataclasses.field(default_factory=FleetSection)
    strategy: StrategySection = dataclasses.field(
        default_factory=StrategySection)
    trainer: TrainerSection = dataclasses.field(
        default_factory=TrainerSection)
    run: RunSection = dataclasses.field(default_factory=RunSection)
    service: ServiceSection = dataclasses.field(
        default_factory=ServiceSection)

    def with_strategy(self, name: str, **options) -> "ExperimentConfig":
        """Sweep helper: same experiment, different strategy. ``options``
        *replace* the base section's (they are strategy-specific — a
        fedzero ``solver`` means nothing to oort); n/d_max/seed carry
        over. The scenario section object is shared, so :func:`run_sweep`
        shares the store."""
        strat = dataclasses.replace(self.strategy, name=name,
                                    options=options)
        return dataclasses.replace(self, strategy=strat)

    def with_seed(self, seed: int) -> "ExperimentConfig":
        """Repetition helper: reseed every section in one step."""
        return dataclasses.replace(
            self,
            scenario=dataclasses.replace(self.scenario, seed=seed),
            fleet=dataclasses.replace(self.fleet, seed=seed),
            strategy=dataclasses.replace(self.strategy, seed=seed),
            trainer=dataclasses.replace(self.trainer, seed=seed),
            run=dataclasses.replace(self.run, seed=seed))


_SECTIONS = {"scenario": ScenarioSection, "fleet": FleetSection,
             "strategy": StrategySection, "trainer": TrainerSection,
             "run": RunSection, "service": ServiceSection}


def config_from_reference(d: Dict) -> ExperimentConfig:
    """The equal :class:`ExperimentConfig` of a reference-package config,
    given as ``dataclasses.asdict`` of it.

    The scheduler has no weights: registry, scenario and noise all
    follow from the config's seeds, so carrying the config carries the
    whole state of a run. Each section's fields are taken as they are
    (arrays, tuples, options), and a field this package does not know
    raises ``TypeError``. ``asdict`` flattens the service section's
    ``faults`` (a reference ``FaultPlan``, its ``RetryPolicy`` within) to
    a dict: it is rebuilt as this package's
    :class:`~repro_torch.service.faults.FaultPlan`, and ``None`` stays
    ``None``."""
    secs = {name: dict(d[name]) for name in _SECTIONS if name in d}
    faults = secs.get("service", {}).get("faults")
    if isinstance(faults, dict):
        # imported here: core imports nothing of the service at load
        from ..service.faults import FaultPlan, RetryPolicy
        faults = dict(faults)
        if isinstance(faults.get("retry"), dict):
            faults["retry"] = RetryPolicy(**faults["retry"])
        faults["crash_schedule"] = tuple(
            tuple(int(k) for k in c) for c in faults.get("crash_schedule", ()))
        secs["service"]["faults"] = FaultPlan(**faults)
    return ExperimentConfig(**{name: _SECTIONS[name](**kw)
                               for name, kw in secs.items()})


# ---------------------------------------------------------------------------
# granular builders


def _fleet_peak_w(cfg: ExperimentConfig):
    """Solar peak per domain: a per-domain ``fleet.max_output`` array
    sizes each domain's installation (caps and panels are the same
    hardware), else the scenario's uniform ``peak_w``."""
    mo = np.asarray(cfg.fleet.max_output, dtype=float)
    return mo if mo.ndim else cfg.scenario.peak_w


def build_scenario(cfg: ExperimentConfig) -> ScenarioStore:
    sc = cfg.scenario
    if sc.excess is not None or sc.util is not None:
        if sc.util_mode != "dense":
            # explicit arrays ARE a dense util panel; silently ignoring
            # the knob would skip the sharded selection path the caller
            # asked for
            raise ValueError("util_mode='sparse' requires synthesized "
                             "scenarios; explicit excess/util arrays are "
                             "dense by construction")
        return ScenarioStore(
            excess=sc.excess, util=sc.util, carbon=sc.carbon,
            domain_names=list(sc.domain_names or ()), seed=sc.seed,
            error=sc.error, unlimited_domains=sc.unlimited_domains,
            backend=cfg.run.backend)
    return make_scenario(sc.name, n_clients=cfg.fleet.n_clients,
                         days=sc.days, seed=sc.seed,
                         peak_w=_fleet_peak_w(cfg),
                         error=sc.error, util_mode=sc.util_mode,
                         unlimited_domains=sc.unlimited_domains,
                         backend=cfg.run.backend)


def build_registry(cfg: ExperimentConfig,
                   scenario: ScenarioStore) -> ClientRegistry:
    fl = cfg.fleet
    if scenario.n_clients != fl.n_clients:
        # synthesized stores always match (their C comes from the fleet);
        # this catches explicit-trace configs whose util panel disagrees
        # with the fleet size before it becomes an opaque IndexError (or a
        # silent subset) deep in the round loop
        raise ValueError(
            f"fleet.n_clients={fl.n_clients} but the scenario's util panel "
            f"has {scenario.n_clients} client rows")
    return make_paper_registry(
        n_clients=fl.n_clients, workload=fl.workload, seed=fl.seed,
        samples_per_client=fl.samples_per_client,
        min_epochs=fl.min_epochs, max_epochs=fl.max_epochs,
        domain_names=scenario.domain_names, max_output=fl.max_output)


def build_trainer(cfg: ExperimentConfig, registry: ClientRegistry):
    tr = cfg.trainer
    if tr.factory is not None:
        return tr.factory(registry)
    if tr.kind != "proxy":
        raise ValueError(f"unknown trainer kind {tr.kind!r} "
                         "(use factory= for custom trainers)")
    return ProxyTrainer(len(registry), acc_max=tr.acc_max, k=tr.k,
                        seed=tr.seed)


def build_experiment(cfg: ExperimentConfig, *,
                     scenario: Optional[ScenarioStore] = None,
                     registry: Optional[ClientRegistry] = None,
                     strategy: Optional[BaseStrategy] = None,
                     trainer=None) -> FLSimulation:
    """Config → ready-to-run :class:`FLSimulation`. Pre-built pieces may
    be passed in (sweeps share a scenario; a caller may pass its own
    trainer + a registry retuned to its dataset)."""
    if scenario is None:
        scenario = build_scenario(cfg)
    if registry is None:
        registry = build_registry(cfg, scenario)
    if strategy is None:
        # the run section decides where the math executes: its backend
        # overrides any 'backend' in the strategy options; exact_uncapped
        # is forwarded only when explicitly set (None = strategy default)
        run_kw = {"backend": cfg.run.backend}
        if cfg.run.exact_uncapped is not None:
            run_kw["exact_uncapped"] = cfg.run.exact_uncapped
        strategy = make_strategy(cfg.strategy, registry, **run_kw)
    if trainer is None:
        trainer = build_trainer(cfg, registry)
    return FLSimulation(registry, scenario, strategy, trainer,
                        d_max=cfg.strategy.d_max,
                        eval_every=cfg.run.eval_every, seed=cfg.run.seed)


def _until_step(cfg: ExperimentConfig) -> Optional[int]:
    if cfg.run.until_step is not None:
        return cfg.run.until_step
    if cfg.run.days is not None:
        return int(cfg.run.days * 24 * 60) - cfg.strategy.d_max - 1
    return None


def run_experiment(cfg: ExperimentConfig, *,
                   scenario: Optional[ScenarioStore] = None,
                   sim_out: Optional[list] = None) -> Dict:
    """Build and run one experiment; returns ``FLSimulation.summary()``.

    Bit-for-bit identical to the hand-wired four-step construction for
    the same parameters (pinned against the pre-refactor golden summaries
    in tests/test_experiment_api.py). ``sim_out``, when given, receives
    the :class:`FLSimulation` for post-run inspection.
    """
    sim = build_experiment(cfg, scenario=scenario)
    if sim_out is not None:
        sim_out.append(sim)
    return sim.run(until_step=_until_step(cfg),
                   max_rounds=cfg.run.max_rounds,
                   target_metric=cfg.run.target_metric,
                   verbose=cfg.run.verbose)


def run_sweep(cfgs: Sequence[ExperimentConfig], *,
              sims_out: Optional[list] = None) -> List[Dict]:
    """Run a grid of experiments; summaries align with ``cfgs``.

    Configs that carry the *same scenario section object* (e.g. built via
    :meth:`ExperimentConfig.with_strategy`) share one lazily-chunked
    :class:`ScenarioStore`: traces are synthesized once for the whole
    sweep instead of once per run. Sharing is exact — trace chunks are
    counter-seeded pure functions and forecast memos are keyed by
    ``(kind, now, rows)``, so a shared store serves every run the same
    bits a private store would (seed-for-seed parity is pinned by
    tests/test_experiment_api.py).
    """
    # materialize up front: the share caches below key by section object
    # identity, which is only stable while every config stays alive (a
    # consumed generator's sections could be freed and their ids reused)
    cfgs = list(cfgs)
    stores: Dict[tuple, ScenarioStore] = {}
    registries: Dict[tuple, ClientRegistry] = {}
    out = []
    for cfg in cfgs:
        # keyed by section identity AND fleet size (a synthesized store's
        # util panel is [n_clients, T], so differently-sized fleets can
        # never share one) AND the run backend + derived solar peaks,
        # which both parameterize the store itself
        mo = np.asarray(cfg.fleet.max_output, dtype=float)
        bk = cfg.run.backend
        key = (id(cfg.scenario), cfg.fleet.n_clients,
               bk if isinstance(bk, str) else id(bk),
               tuple(mo.tolist()) if mo.ndim else None)
        store = stores.get(key)
        if store is None:
            store = build_scenario(cfg)
            stores[key] = store
        # registries are read-only on the run path, so configs sharing a
        # fleet section (and the store's domain ordering) share one build —
        # except when a trainer factory is set: factories receive the
        # registry and may retune it (the train_federated.py pattern), so
        # each such config gets a private build
        if cfg.trainer.factory is not None:
            registry = build_registry(cfg, store)
        else:
            reg_key = (id(cfg.fleet), key)
            registry = registries.get(reg_key)
            if registry is None:
                registry = build_registry(cfg, store)
                registries[reg_key] = registry
        sim = build_experiment(cfg, scenario=store, registry=registry)
        if sims_out is not None:
            sims_out.append(sim)
        out.append(sim.run(until_step=_until_step(cfg),
                           max_rounds=cfg.run.max_rounds,
                           target_metric=cfg.run.target_metric,
                           verbose=cfg.run.verbose))
    return out
