"""Client hardware profiles.

Paper Table 2 (downscaled T4 / V100 / A100 classes) for the FL simulation,
plus the profiles of training sites of H100 cards derived from the dry
run's per-device cost of the production architectures: a "client" in that
world is a site training one of the assigned architectures, its m_c
(batches/timestep) and δ_c (energy/batch) computed from the step's
roofline time on the site's cards and their power.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from .types import ClientRegistry

# paper Table 2: max energy (W) and samples/min per workload
PAPER_CLIENT_TYPES = {
    #          W     densenet  efficientnet  lstm   kwt
    "small": (70.0, {"densenet": 110, "efficientnet": 118, "lstm": 276, "kwt": 87}),
    "mid":   (300.0, {"densenet": 384, "efficientnet": 411, "lstm": 956, "kwt": 303}),
    "large": (700.0, {"densenet": 742, "efficientnet": 795, "lstm": 1856, "kwt": 586}),
}

BATCH_SIZE = 10  # paper: clients train on minibatches of size 10


def paper_profile(client_type: str, workload: str):
    """(m_c batches/min, δ_c Wmin/batch) for a paper Table 2 client."""
    watts, perf = PAPER_CLIENT_TYPES[client_type]
    samples_per_min = perf[workload]
    m_c = samples_per_min / BATCH_SIZE           # batches per 1-min timestep
    delta = watts / m_c                          # Wmin per batch at full power
    return m_c, delta


def make_paper_registry(n_clients: int = 100, n_domains: int = 10,
                        workload: str = "densenet", seed: int = 0,
                        samples_per_client: Optional[np.ndarray] = None,
                        min_epochs: float = 1.0, max_epochs: float = 5.0,
                        domain_names: Optional[List[str]] = None,
                        max_output=800.0) -> ClientRegistry:
    """The paper's experimental setup: 100 clients of 3 random types over
    10 power domains with 800 W peak each. ``max_output`` may be a
    per-domain [P] array for heterogeneous domain caps.

    Fleet synthesis is fully vectorized onto
    :meth:`ClientRegistry.from_arrays`: the RNG draw order is unchanged
    from the per-spec implementation (same ``integers`` + ``choice``
    calls), but no per-client Python object is ever constructed, so a
    1M-client registry builds in well under a second and a few tens of MB
    (see benchmarks/e2e_simulation.py, ``1m_registry``).
    """
    rng = np.random.default_rng(seed)
    if domain_names is None:
        domain_names = [f"domain_{i}" for i in range(n_domains)]
    if samples_per_client is None:
        samples_per_client = rng.integers(200, 1200, n_clients)
    types = rng.choice(list(PAPER_CLIENT_TYPES), n_clients)
    type_names = np.array(list(PAPER_CLIENT_TYPES))
    profiles = np.array([paper_profile(t, workload) for t in type_names])
    type_idx = (np.asarray(types)[:, None] == type_names[None, :]).argmax(1)
    ns = np.asarray(samples_per_client, dtype=np.int64)
    bpe = np.maximum(1, -(-ns // BATCH_SIZE))
    return ClientRegistry.from_arrays(
        delta=profiles[type_idx, 1],
        capacity=profiles[type_idx, 0],
        m_min=min_epochs * bpe,
        m_max=max_epochs * bpe,
        n_samples=ns,
        domain_idx=np.arange(n_clients) % len(domain_names),
        domain_names=list(domain_names),
        name_fmt="client_{:03d}",
        max_output=max_output,
        batches_per_epoch=bpe,
        min_epochs=min_epochs, max_epochs=max_epochs)


# ---------------------------------------------------------------------------
# Sites of H100 cards, profiled from the dry run's per-device cost


# an NVIDIA H100 80GB HBM3 (SXM) at a 700 W power limit, its spec sheet
GPU_PEAK_FLOPS = 989.4e12   # dense bf16 FLOP/s per card
GPU_HBM_BW = 3.35e12        # bytes/s per card
GPU_CARD_W = 700.0          # W per card under load (its power limit)


def gpu_site_profile(flops_per_step: float, bytes_per_step: float,
                     n_chips: int, batch_per_step: int,
                     chip_watts: float = None):
    """(m_c batches/min, δ_c Wmin/batch) for a site of ``n_chips`` cards
    drawing ``chip_watts`` each (default :data:`GPU_CARD_W`).

    Step time = max(compute, memory) roofline term of the train step;
    one "batch" here is one global training batch.
    """
    chip_watts = GPU_CARD_W if chip_watts is None else chip_watts
    t_compute = flops_per_step / (n_chips * GPU_PEAK_FLOPS)
    t_memory = bytes_per_step / (n_chips * GPU_HBM_BW)
    step_s = max(t_compute, t_memory)
    steps_per_min = 60.0 / step_s
    m_c = steps_per_min
    delta = (n_chips * chip_watts) / steps_per_min  # Wmin per step
    return m_c, delta


def registry_from_roofline(rows, shape: str = "train_4k",
                           n_sites_per_arch: int = 1, chips_per_site: int = 256,
                           seed: int = 0) -> ClientRegistry:
    """Build an FL registry whose clients are sites of H100 cards running
    the assigned architectures, profiled from the dry run's records:
    ``rows``, a list of them or the path of the JSON file the dry run
    writes. Each ``shape`` × ``single_pod`` row gives ``n_sites_per_arch``
    sites of ``chips_per_site`` cards from its ``flops_per_device`` and
    ``bytes_per_device`` (:func:`gpu_site_profile`), in the reference's
    arithmetic and draw order; as the reference does with its per-device
    ``hlo_flops``, the per-device count is divided by the site's cards once
    more.

    Array-first note: ``n_samples`` is now one batched ``integers`` draw
    instead of one scalar draw per site, so per-site values differ from
    the pre-array-first implementation at the same seed (same
    distribution; nothing pins these values — unlike
    ``make_paper_registry``, whose draw order is golden-pinned).
    """
    if isinstance(rows, (str, bytes)) or hasattr(rows, "__fspath__"):
        with open(rows) as f:
            rows = json.load(f)
    rng = np.random.default_rng(seed)
    names, caps, deltas = [], [], []
    for row in rows:
        if row.get("shape") != shape or row.get("mesh") != "single_pod":
            continue
        m_c, delta = gpu_site_profile(row["flops_per_device"],
                                      row["bytes_per_device"],
                                      chips_per_site, 1)
        for s in range(n_sites_per_arch):
            names.append(f"site-{row['arch']}-{s}")
            caps.append(m_c)
            deltas.append(delta)
    n = len(names)
    ns = rng.integers(5_000, 50_000, n)
    bpe = np.maximum(1, ns // 1024)
    n_domains = min(10, n)
    return ClientRegistry.from_arrays(
        delta=np.array(deltas), capacity=np.array(caps),
        m_min=1.0 * bpe, m_max=5.0 * bpe, n_samples=ns,
        domain_idx=np.arange(n) % 10,
        domain_names=[f"grid_{k}" for k in range(n_domains)],
        names=names, max_output=chips_per_site * GPU_CARD_W * 2,
        batches_per_epoch=bpe)
