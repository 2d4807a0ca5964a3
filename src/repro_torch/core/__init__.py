"""FedZero core: client selection on renewable excess energy (paper §3–4)."""
from .types import (ClientRegistry, ClientSpec, PowerDomain, RoundResult,
                    Selection, ServiceEvent)
from .selection import (LazySelectionInputs, SelectionInputs,
                        find_clients_for_duration, select_clients)
from .fairness import Blocklist
from .utility import UtilityTracker
from .power import share_power
from .strategies import (BaseStrategy, EnvView, FedZeroStrategy, OortStrategy,
                         RandomStrategy, UpperBoundStrategy, make_strategy)
from .simulation import FLSimulation, execute_round
from .trainers import ProxyTrainer, TorchTrainer
from .profiles import (gpu_site_profile, make_paper_registry, paper_profile,
                       registry_from_roofline)
from .experiment import (ExperimentConfig, FleetSection, RunSection,
                         ScenarioSection, ServiceSection, StrategySection,
                         TrainerSection, build_experiment, build_registry,
                         build_scenario, build_trainer,
                         config_from_reference, run_experiment, run_sweep)

__all__ = [
    "ClientRegistry", "ClientSpec", "PowerDomain", "RoundResult", "Selection",
    "ServiceEvent",
    "LazySelectionInputs", "SelectionInputs", "find_clients_for_duration",
    "select_clients",
    "Blocklist", "UtilityTracker", "share_power",
    "BaseStrategy", "EnvView", "FedZeroStrategy", "OortStrategy",
    "RandomStrategy", "UpperBoundStrategy", "make_strategy",
    "FLSimulation", "execute_round", "ProxyTrainer", "TorchTrainer",
    "make_paper_registry", "paper_profile", "gpu_site_profile",
    "registry_from_roofline",
    "ExperimentConfig", "ScenarioSection", "FleetSection", "StrategySection",
    "TrainerSection", "RunSection", "ServiceSection", "build_experiment",
    "build_registry", "build_scenario", "build_trainer",
    "config_from_reference", "run_experiment", "run_sweep",
]
