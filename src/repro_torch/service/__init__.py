"""Always-on scheduling service: FedZero admission at request rate over
a live fleet (docs/service.md).

The batch loop (:class:`~repro_torch.core.simulation.FLSimulation`) asks
"which clients, for the next round?" once per round; this package keeps
the scheduler *resident* — clients register and deregister while
training is in flight, admission requests are priced on demand against
the current fleet view, and every request lands in a replayable event
log whose admissions are bit-identical to pricing each request from
scratch with the batch engine.

This is the PyTorch port of the reference package's service: the same
classes and names, on the port's array backends (``"cuda"`` by default,
with the hand-written K1/K2 kernels in the service process and in every
spawned worker).

Entry points::

    from repro_torch.service import build_service, run_synthetic
    svc = build_service(cfg)          # cfg: core.ExperimentConfig
    rid, sel = svc.admit()            # price one round now
    svc.advance(5)                    # tick the virtual clock

    python -m repro_torch.service --synthetic-churn   # runnable demo
"""
from .admission import AdmissionCache
from .engine import SchedulerService, build_service, run_synthetic
from .executors import InProcessExecutor, MultiprocessExecutor
from .faults import FaultPlan, RetryPolicy
from .metrics import ServiceMetrics

__all__ = ["AdmissionCache", "FaultPlan", "InProcessExecutor",
           "MultiprocessExecutor", "RetryPolicy", "SchedulerService",
           "ServiceMetrics", "build_service", "run_synthetic"]
