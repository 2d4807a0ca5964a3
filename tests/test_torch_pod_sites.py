"""FedZero over sites of H100 cards profiled from the port's dry run
(``repro_torch.core.profiles``), against the reference's pod sites
(``repro.core.profiles``, ``tests/test_pod_sites.py``) on the CPU.

* ``gpu_site_profile`` is the reference's ``tpu_site_profile`` with the
  card's constants: with the port's constants set to the reference's, the
  same (m_c, δ_c), exactly; ``registry_from_roofline`` gives array-equal
  registries in both packages from the same rows (each row carrying both
  packages' keys: the port's ``flops_per_device``/``bytes_per_device``
  and the reference's ``hlo_flops``/``hlo_bytes``, equal).
* The reference test's three checks on the port's own records: 20 sites
  from the ten archs' reduced configs, two each; kimi-k2's δ above 5×
  smollm-360m's and smollm's capacity above 5× kimi's, from the two full
  configs' train steps (reduced configs are all of one width, so their
  steps cost about the same); the memory-bound profile on the card's
  byte rate.
* FedZero over the reduced configs' sites (the reference test's set-up:
  ``global``, n 5, d_max 60, cut from 20 hours to 6) on
  ``CudaBackend(device="cpu")``
  gives the same rounds and energy as the ``numpy`` backend and as the
  reference's ``FLSimulation`` on the same registry.

The records are ``launch.dryrun.step_cost`` of a train step of batch 8 ×
seq 32 (reduced configs) or 8 × 128 (full configs) on a 1×1 mesh: the
registry reads them as rows of a shape named here.
"""
import json

import numpy as np
import pytest

from repro.core import FLSimulation as RefSimulation
from repro.core import ProxyTrainer as RefProxyTrainer
from repro.core import make_strategy as ref_make_strategy
from repro.core import profiles as ref_profiles
from repro.core.types import ClientRegistry as RefRegistry
from repro.data.traces import make_scenario as ref_make_scenario
from repro_torch.backend import get_backend
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.configs import all_archs, get_config
from repro_torch.core import (FLSimulation, ProxyTrainer, gpu_site_profile,
                              make_strategy, registry_from_roofline)
from repro_torch.core import profiles
from repro_torch.data.traces import make_scenario
from repro_torch.launch import dryrun

SHAPE = "train_8x32"
# the reference test's set-up runs 20 hours; 6 (108 rounds here) keep the
# three runs under 10 s on the CPU
HOURS = 6


def _row(arch, cfg, batch, seq):
    rec = dryrun.step_cost(cfg, "train", batch, seq, (1, 1))
    return {"arch": arch, "shape": SHAPE, "mesh": "single_pod",
            **rec, "hlo_flops": rec["flops_per_device"],
            "hlo_bytes": rec["bytes_per_device"]}


@pytest.fixture(scope="module")
def rows():
    """A reduced record of each arch (its train step at 8 × 32)."""
    return [_row(a, get_config(a, reduced=True), 8, 32) for a in all_archs()]


def _same_registry(a, b):
    for col in ("delta_arr", "capacity_arr", "m_min_arr", "m_max_arr",
                "n_samples_arr", "max_output_arr"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=col)
    assert list(a.client_names) == list(b.client_names)
    assert ([a.domain_of[n] for n in a.client_names]
            == [b.domain_of[n] for n in b.client_names])


@pytest.mark.parametrize("flops,nbytes,chips,watts", (
    (1e15, 1e9, 4, None), (1e12, 1e13, 8, None), (3.1e14, 2.2e12, 64, 120.0),
    (7e13, 2.9e11, 256, None)))
def test_gpu_site_profile_is_the_reference_arithmetic(flops, nbytes, chips,
                                                      watts, monkeypatch):
    """With the reference's v5e constants in the port's module, the
    port's profile equals the reference's bit for bit (compute-bound,
    memory-bound, another wattage, both terms near each other)."""
    monkeypatch.setattr(profiles, "GPU_PEAK_FLOPS",
                        ref_profiles.V5E_PEAK_FLOPS)
    monkeypatch.setattr(profiles, "GPU_HBM_BW", ref_profiles.V5E_HBM_BW)
    monkeypatch.setattr(profiles, "GPU_CARD_W", ref_profiles.V5E_CHIP_W)
    kw = {} if watts is None else {"chip_watts": watts}
    assert gpu_site_profile(flops, nbytes, chips, 1, **kw) == \
        ref_profiles.tpu_site_profile(flops, nbytes, chips, 1, **kw)


@pytest.mark.parametrize("sites,chips", ((1, 256), (3, 64)))
def test_registry_from_roofline_equals_the_reference(rows, sites, chips,
                                                     tmp_path, monkeypatch):
    monkeypatch.setattr(profiles, "GPU_PEAK_FLOPS",
                        ref_profiles.V5E_PEAK_FLOPS)
    monkeypatch.setattr(profiles, "GPU_HBM_BW", ref_profiles.V5E_HBM_BW)
    monkeypatch.setattr(profiles, "GPU_CARD_W", ref_profiles.V5E_CHIP_W)
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(rows))
    ref = ref_profiles.registry_from_roofline(
        str(path), shape=SHAPE, n_sites_per_arch=sites, chips_per_site=chips)
    for given in (rows, str(path)):  # the records, or the dry run's file
        _same_registry(registry_from_roofline(
            given, shape=SHAPE, n_sites_per_arch=sites,
            chips_per_site=chips), ref)


def test_registry_from_roofline_builds_sites(rows):
    reg = registry_from_roofline(rows, shape=SHAPE, n_sites_per_arch=2,
                                 chips_per_site=256)
    assert len(reg) == 20  # 10 archs × 2 sites
    assert set(reg.max_output_arr) == {256 * profiles.GPU_CARD_W * 2}


def test_heavier_arch_takes_more_energy_a_step():
    """kimi-k2's sites against smollm-360m's, from the full configs'
    train steps: more Wmin a step, fewer steps a minute, each by > 5×."""
    full = [_row(a, get_config(a), 8, 128)
            for a in ("smollm-360m", "kimi-k2-1t-a32b")]
    reg = registry_from_roofline(full, shape=SHAPE, n_sites_per_arch=2,
                                 chips_per_site=256)
    deltas = {c.name: c.delta for c in reg.clients.values()}
    kimi = [v for k, v in deltas.items() if "kimi" in k][0]
    smol = [v for k, v in deltas.items() if "smollm" in k][0]
    assert kimi > 5 * smol
    caps = {c.name: c.m_max_capacity for c in reg.clients.values()}
    kimi_c = [v for k, v in caps.items() if "kimi" in k][0]
    smol_c = [v for k, v in caps.items() if "smollm" in k][0]
    assert smol_c > 5 * kimi_c


def test_gpu_site_profile_memory_bound():
    m_c, delta = gpu_site_profile(flops_per_step=1e12, bytes_per_step=1e13,
                                  n_chips=8, batch_per_step=1)
    t = 1e13 / (8 * 3.35e12)
    assert m_c == pytest.approx(60.0 / t)
    assert delta == pytest.approx(8 * 700.0 / (60.0 / t))


def _port_run(reg, backend):
    sc = make_scenario("global", n_clients=len(reg), days=1, seed=0,
                       peak_w=64 * profiles.GPU_CARD_W * 1.5, backend=backend)
    sc.domain_names = list(reg.domains)
    strat = make_strategy("fedzero", reg, n=5, d_max=60, seed=0,
                          backend=backend)
    sim = FLSimulation(reg, sc, strat, ProxyTrainer(len(reg), k=0.01),
                       eval_every=1)
    s = sim.run(until_step=HOURS * 60)
    return s, [(r.start_step, r.duration, r.contributor_idx.tolist(),
                r.energy_used) for r in sim.results]


def _ref_run(reg):
    sc = ref_make_scenario("global", n_clients=len(reg), days=1, seed=0,
                           peak_w=64 * profiles.GPU_CARD_W * 1.5)
    sc.domain_names = list(reg.domains)
    strat = ref_make_strategy("fedzero", reg, n=5, d_max=60, seed=0)
    sim = RefSimulation(reg, sc, strat, RefProxyTrainer(len(reg), k=0.01),
                        eval_every=1)
    s = sim.run(until_step=HOURS * 60)
    return s, [(r.start_step, r.duration, np.asarray(
        r.contributor_idx).tolist(), r.energy_used) for r in sim.results]


def test_fedzero_schedules_card_sites_as_the_reference(rows):
    """30 sites of 64 cards (three an arch): the port's FedZero on the
    device backend (on the CPU), on NumPy, and the reference's on the same
    registry give the same rounds and energy."""
    def reg():
        return registry_from_roofline(rows, shape=SHAPE, n_sites_per_arch=3,
                                      chips_per_site=64)

    r = reg()
    ref_reg = RefRegistry.from_arrays(
        delta=r.delta_arr, capacity=r.capacity_arr, m_min=r.m_min_arr,
        m_max=r.m_max_arr, n_samples=r.n_samples_arr.astype(np.int64),
        domain_idx=np.arange(len(r)) % 10,
        domain_names=list(r.domains), names=list(r.client_names),
        max_output=r.max_output_arr[0],
        batches_per_epoch=np.maximum(1, r.n_samples_arr.astype(np.int64)
                                     // 1024))
    s_dev, r_dev = _port_run(reg(), CudaBackend(device="cpu"))
    s_np, r_np = _port_run(reg(), get_backend("numpy"))
    s_ref, r_ref = _ref_run(ref_reg)
    assert s_dev["rounds"] >= 1 and s_dev["total_energy_wh"] > 0
    assert r_dev == r_np == r_ref
    assert (s_dev["total_energy_wh"] == s_np["total_energy_wh"]
            == s_ref["total_energy_wh"])


def test_port_states_no_tpu_rate():
    """The port's profile constants are the card's, named with it."""
    src = open(profiles.__file__).read()
    assert "V5E" not in src and "197e12" not in src
    assert (profiles.GPU_PEAK_FLOPS, profiles.GPU_HBM_BW,
            profiles.GPU_CARD_W) == (989.4e12, 3.35e12, 700.0)
