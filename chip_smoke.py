#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--until-step N] [--clients N]

Run from the root of a checkout on a host with a CUDA device. It builds
the port's CUDA kernels from ``src/repro_torch/csrc`` and then runs four
phases, each printing JSON lines:

1. ``env`` — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the kernel build time and the compiler's register
   report.
2. ``kernel`` — K1 ``piece_window`` and K2 ``forecast_z`` on the card at
   the main path's full window (2^20 rows × 64 steps), a ragged 70 000 ×
   12 and 1 × 1, held to their plain PyTorch versions on the card and to
   the NumPy reference on the host with ``torch.equal`` /
   ``array_equal`` (tolerance 0: the contract is bit-exact). Median
   kernel time over CUDA events, the byte bound at 3.35 TB/s, the plain
   version's time, and the upload/download time of a host-NumPy call as
   the backend makes it.
3. ``ops`` — every op the device backend overrides, on the card,
   against the NumPy backend bit for bit (``top_m`` with forced ties,
   int64 multiplies that wrap).
4. ``main_path`` — the sparse-utilisation, exact uncapped greedy
   FedZero configuration of the 1M-client gate, built with
   ``build_experiment`` and run with ``FLSimulation.run`` (what
   ``run_experiment`` does, with set-up and round loop timed apart), at
   one million clients on ``backend="cuda"`` for at least 20 rounds,
   then the same on the NumPy backend: round results and total energy
   must be identical, and both kernels must have launched on the
   ``cuda`` run.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before the last line. Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
K1_SOURCE = "src/repro_torch/csrc/counter_hash.cu"
REPLACES = {"piece_window": "src/repro/kernels/counter_hash.py:102",
            "forecast_z": "src/repro/kernels/counter_hash.py:138"}
FULL_R, FULL_W, FULL_S = 1 << 20, 64, 4


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=2):
    """Median device time of ``fn`` in ms over CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(torch, fn, iters=3):
    """Median host time of ``fn`` (ending in a synchronise) in ms."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phase 2: the kernels


def window_case(rng, R, S, W):
    levels = rng.random((R, S), dtype=np.float32)
    slot = rng.integers(0, S, (R, W)).astype(np.int64)
    rows = np.arange(R, dtype=np.int64)
    return levels, slot, rows


def std_lead(W):
    lead = np.arange(1, W + 1, dtype=np.float32)
    return 0.05 + 0.20 * np.minimum(lead / 1440.0, 1.0)


def check_kernels(torch, bk, host):
    from repro_torch.data.traces import _SparseUtil
    from repro_torch.kernels import counter_hash as ch

    amp = _SparseUtil._NOISE_AMP
    rng = np.random.default_rng(0)
    fold = np.uint64(rng.integers(0, 2 ** 63))
    results = {}
    for R, S, W in ((FULL_R, FULL_S, FULL_W), (70_000, 6, 12), (1, 1, 1)):
        full = R == FULL_R
        levels, slot, rows = window_case(rng, R, S, W)
        std = std_lead(W)
        lv, sl, rw = bk._window_args(levels, slot, rows)
        rw2, sd = bk._forecast_args(rows, W, std)
        n1, n2 = ch.piece_window.launches, ch.forecast_z.launches
        k1 = ch.piece_window(lv, sl, fold, rw, 10_000, amp)
        k2 = ch.forecast_z(fold, rw2, 777, sd)
        torch.cuda.synchronize()
        require(ch.piece_window.launches == n1 + 1, "K1 did not count")
        require(ch.forecast_z.launches == n2 + 1, "K2 did not count")
        p1 = ch.piece_window_plain(lv, sl, fold, rw, 10_000, amp)
        p2 = ch.forecast_z_plain(fold, rw2, 777, sd)
        require(torch.equal(k1, p1), f"K1 != plain at {R}x{W}")
        require(torch.equal(k2, p2), f"K2 != plain at {R}x{W}")
        h1 = host.synth_window(levels.copy(), slot, fold, rows, 10_000, amp)
        h2 = host.forecast_noise_z(fold, rows, 777, W, std)
        require(np.array_equal(k1.cpu().numpy(), h1), f"K1 != numpy {R}x{W}")
        require(np.array_equal(k2.cpu().numpy(), h2), f"K2 != numpy {R}x{W}")
        err1 = float((k1 - p1).abs().max())
        err2 = float((k2 - p2).abs().max())
        line = {"R": R, "W": W, "S": S, "equal_plain": True,
                "equal_numpy": True, "max_abs_err": [err1, err2]}
        if full:
            b1 = (R * S * 4 + R * W * 8 + R * 8 + R * W * 4)
            b2 = (R * 8 + W * 4 + R * W * 4)
            # float32 ops per cell: K1 sub, mul, add, 2 compares; K2 sub,
            # 2 muls. The 64-bit hashing has no peak rate in the table
            f1, f2 = 5 * R * W, 3 * R * W
            t = {
                "piece_window": dict(
                    ms=cuda_ms(torch, lambda: ch.piece_window(
                        lv, sl, fold, rw, 10_000, amp), 20),
                    plain_ms=cuda_ms(torch, lambda: ch.piece_window_plain(
                        lv, sl, fold, rw, 10_000, amp), 5),
                    bytes=b1, flops=f1, max_abs_err=err1,
                    upload_ms=host_ms(torch, lambda: bk._window_args(
                        levels, slot, rows)),
                    download_ms=host_ms(torch, lambda: bk._np(k1)),
                    backend_call_ms=host_ms(torch, lambda: bk.synth_window(
                        levels, slot, fold, rows, 10_000, amp))),
                "forecast_z": dict(
                    ms=cuda_ms(torch, lambda: ch.forecast_z(
                        fold, rw2, 777, sd), 20),
                    plain_ms=cuda_ms(torch, lambda: ch.forecast_z_plain(
                        fold, rw2, 777, sd), 5),
                    bytes=b2, flops=f2, max_abs_err=err2,
                    upload_ms=host_ms(torch, lambda: bk._forecast_args(
                        rows, W, std)),
                    download_ms=host_ms(torch, lambda: bk._np(k2)),
                    backend_call_ms=host_ms(torch, lambda: bk.forecast_noise_z(
                        fold, rows, 777, W, std))),
            }
            for name, m in t.items():
                byte_ms = 1e3 * m["bytes"] / HBM_BYTES_PER_S
                op_ms = 1e3 * m["flops"] / FP32_FLOPS
                m["bound_ms"] = max(byte_ms, op_ms)
                m["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
                m["launches_phase2"] = getattr(ch, name).launches
                emit("kernel", name=name, R=R, W=W, S=S, **m)
            results = t
        emit("kernel_case", **line)
        del lv, sl, rw, rw2, sd, k1, k2, p1, p2
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------
# phase 3: backend ops


def check_ops(torch, bk, host):
    from repro_torch.kernels.counter_hash import i64

    eq = np.testing.assert_array_equal
    rng = np.random.default_rng(1)
    # int64 multiplies wrap on the card exactly as uint64 does on the host
    a = rng.integers(0, 2 ** 63, 4096, dtype=np.int64).astype(np.uint64)
    a[0] = np.uint64(2 ** 64 - 1)
    m = np.uint64(0xFF51AFD7ED558CCD)
    with np.errstate(over="ignore"):
        want = (a * m).view(np.int64)
    got = (torch.from_numpy(a.view(np.int64)).to(bk.device) * i64(m)).cpu()
    eq(want, got.numpy())

    x = rng.integers(0, 2 ** 63, 70_000, dtype=np.int64).astype(np.uint64)
    fold = np.uint64(0x9E3779B97F4A7C15)
    eq(host.sm64(x), bk.sm64(x))
    eq(host.u01(x), bk.u01(x))
    eq(host.cheap_u01(fold, x), bk.cheap_u01(fold, x))
    keys = rng.integers(0, 10 ** 9, (257, 3)).astype(np.uint64)
    eq(host.hash64(42, 201, keys, keys[::-1]), bk.hash64(42, 201, keys,
                                                         keys[::-1]))
    R, W = 5000, 64
    rows = np.sort(rng.choice(10 ** 6, R, replace=False)).astype(np.int64)
    t_grid = 10_000 + np.arange(W)
    eq(host.cell_noise(fold, rows, t_grid), bk.cell_noise(fold, rows, t_grid))
    levels, slot, _ = window_case(rng, R, 5, W)
    eq(host.synth_window(levels.copy(), slot, fold, rows, 10_000, 0.1732),
       bk.synth_window(levels.copy(), slot, fold, rows, 10_000, 0.1732))
    std = std_lead(W)
    eq(host.forecast_noise_z(fold, rows, 777, W, std),
       bk.forecast_noise_z(fold, rows, 777, W, std))

    B, d, P = 6000, 60, 10
    spare = rng.random((B, d)) * 5
    budgets = rng.random((P, d)) * 300
    dom = rng.integers(0, P, B)
    delta = 0.5 + rng.random(B) * 3
    eq(host.take_matrix(spare, budgets[dom], delta),
       bk.take_matrix(spare, budgets[dom], delta))
    eq(host.take_reach(spare, budgets[dom], delta),
       bk.take_reach(spare, budgets[dom], delta))
    sigma, reach = rng.random(B), rng.random(B) * 100
    m_min, m_max = rng.random(B) * 20, 20 + rng.random(B) * 80
    for u, v in zip(host.greedy_scores(sigma, reach, m_min, m_max),
                    bk.greedy_scores(sigma, reach, m_min, m_max)):
        eq(u, v)

    K, M = 9000, 256
    cols = dict(delta=0.5 + rng.random(K) * 3, m_min=rng.random(K) * 12,
                m_max=30 + rng.random(K) * 50, sigma=rng.random(K),
                spare_ub=rng.random(K) * 4, dom=rng.integers(0, P, K))
    excess = rng.random(P) * 400
    excess[0] = 0.0
    for dd in (1.0, 17.0, 60.0):
        ua, na = host.score_ub(host.fleet_cols(**cols), excess, dd)
        hb, nb = bk.score_ub(bk.fleet_cols(**cols), excess, dd)
        require(na == nb, "score_ub viable count")
        eq(ua, bk.asnumpy(hb))
        eq(host.viable_positions(ua), bk.viable_positions(hb))
        ia, ba = host.top_m(ua, M)
        ib, bb = bk.top_m(hb, M)
        eq(np.sort(ia), np.sort(ib))
        require(ba == bb, "top_m bound")
    # forced ties straddling M, and a wall-to-wall plateau
    for ub in (np.where(rng.random(2000) < 0.5, 3.5, 1.25),
               np.full(20000, 36.75)):
        ub[rng.integers(0, ub.size, 64)] = -np.inf
        for M in (1, 40, 512):
            ia, ba = host.top_m(host.adopt_scores(ub), M)
            ib, bb = bk.top_m(bk.adopt_scores(ub), M)
            eq(np.sort(ia), np.sort(ib))
            require(ba == bb, "top_m tie bound")

    drain = rng.random((5000, 32)) * 2
    dsel = np.sort(rng.integers(0, 8, 5000))
    bud = rng.random((8, 32)) * drain.sum(0).mean() * 0.1
    bud[3, 5] = -1e-12
    eq(host.margin_prefix_ok(drain, dsel, bud),
       bk.margin_prefix_ok(drain, dsel, bud))
    m_max2 = m_min + rng.random(B) * 60
    fa, oa, ca = host.admit_domains(spare, budgets / 20, dom, delta, m_min,
                                    m_max2)
    fb, ob, cb = bk.admit_domains(spare, budgets / 20, dom, delta, m_min,
                                  m_max2)
    eq(fa, fb)
    eq(oa[fa], ob[fa])
    eq(ca, cb)

    Pr, H, N = 8, 60, 9000
    r_ex = rng.integers(0, 64, size=(Pr, H)) / 8.0
    r_ex[3, :10] = r_ex[3, 10]
    ta, tb = host.reach_tables(r_ex), bk.reach_tables(r_ex)
    sdom = rng.integers(0, Pr, N)
    sa = rng.integers(0, H + 1, N)
    sb = np.minimum(sa + rng.integers(0, H + 1, N), H)
    w = rng.integers(0, 80, N) / 8.0
    eq(host.segment_reach(ta, sdom, sa, sb, w),
       bk.segment_reach(tb, sdom, sa, sb, w))
    Kk = 5000
    lens = rng.integers(1, 4, size=Kk)
    owner = np.repeat(np.arange(Kk), lens)
    S = owner.size
    a0 = rng.integers(0, 24, size=S)
    seg = {"a": a0, "b": np.minimum(a0 + rng.integers(1, 24, size=S), 24),
           "x": rng.random(S), "owner": owner,
           "dom": rng.integers(0, 3, size=Kk)[owner],
           "capd": 1.0 + rng.random(S)}
    kept = {"delta": 1.0 + rng.random(Kk), "m_min": 1.0 + rng.random(Kk),
            "m_max": 5.0 + rng.random(Kk), "sigma": rng.random(Kk) + 0.1,
            "dom": rng.integers(0, 3, size=Kk)}
    rx = rng.random((3, 24)) * 100
    nu = 1.0 + 0.1 * rng.random(24)
    st_a = host.reach_state(rx, seg=seg, kept=kept, noise_mult_ub=nu)
    st_b = bk.reach_state(rx, seg=seg, kept=kept, noise_mult_ub=nu)
    keep = rng.random(Kk) > 0.4
    pairs = [(st_a, st_b), (host.reach_state_subset(st_a, keep),
                            bk.reach_state_subset(st_b, keep))]
    for dd in (1, 12, 24):
        for u, v in pairs:
            ua, na = host.probe_scores(u, dd, rx[:, dd - 1])
            ub_, nb = bk.probe_scores(v, dd, rx[:, dd - 1])
            require(na == nb, "probe viable count")
            eq(ua, ub_)


# --------------------------------------------------------------------------
# phase 4: the main path


def main_path_config(n_clients, until_step, backend):
    from repro_torch.core import (ExperimentConfig, FleetSection, RunSection,
                                  ScenarioSection, StrategySection,
                                  TrainerSection)
    return ExperimentConfig(
        scenario=ScenarioSection(name="global", days=1, seed=0,
                                 util_mode="sparse"),
        fleet=FleetSection(n_clients=n_clients, seed=0),
        strategy=StrategySection(name="fedzero", n=10, d_max=60, seed=0,
                                 options={"solver": "greedy"}),
        trainer=TrainerSection(k=0.0004, seed=0),
        run=RunSection(until_step=until_step, eval_every=5, seed=0,
                       backend=backend))


def window_histogram(window_shapes):
    """Per op: calls by power-of-two row bucket (``"<=R"``) and by window
    width W, the number of distinct (R, W) shapes, and the commonest."""
    rows, width = {}, {}
    for (op, R, W), n in window_shapes.items():
        rb = f"<={1 << max(R - 1, 0).bit_length()}"
        rows.setdefault(op, {}).setdefault(rb, 0)
        rows[op][rb] += n
        width.setdefault(op, {}).setdefault(W, 0)
        width[op][W] += n
    top = sorted(([op, R, W, n] for (op, R, W), n in window_shapes.items()),
                 key=lambda v: -v[3])[:12]
    by_bound = {op: dict(sorted(h.items(), key=lambda kv: int(kv[0][2:])))
                for op, h in rows.items()}
    return {"window_rows_hist": by_bound,
            "window_w_hist": {op: dict(sorted(h.items()))
                              for op, h in width.items()},
            "window_distinct_shapes": len(window_shapes),
            "window_top_shapes": top}


def run_main(torch, cfg):
    """Build the experiment and run its round loop (what
    ``run_experiment`` does), timing set-up and loop apart."""
    from repro_torch.core import build_experiment
    torch.cuda.synchronize()
    t = time.perf_counter()
    sim = build_experiment(cfg)
    setup = time.perf_counter() - t
    t = time.perf_counter()
    summary = sim.run(until_step=cfg.run.until_step)
    torch.cuda.synchronize()
    loop = time.perf_counter() - t
    rounds = [(r.start_step, r.duration, r.contributor_idx.tolist(),
               r.energy_used) for r in sim.results]
    return summary, rounds, {"setup_s": setup, "loop_s": loop,
                             "ms_per_round": 1e3 * loop / max(len(rounds), 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=1_000_000)
    ap.add_argument("--until-step", type=int, default=200)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.backend import get_backend
    from repro_torch.kernels import counter_hash as ch

    smi = nvidia_smi()
    t = time.perf_counter()
    ch.load_library()
    build_s = time.perf_counter() - t
    log = ch.library_path().with_suffix(".log")
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s,
         ptxas=[ln for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if log.exists()
         else None)

    host = get_backend("numpy")
    cuda_bk = get_backend()
    require(cuda_bk.device == torch.device("cuda:0"), "default backend device")
    require(get_backend("torch") is cuda_bk, "torch is not the cuda backend")

    kern = check_kernels(torch, cuda_bk, host)

    t = time.perf_counter()
    check_ops(torch, cuda_bk, host)
    emit("ops", backend=cuda_bk.name, bit_equal=True,
         s=time.perf_counter() - t)

    # the main path: counts from zero, driven once, read right after
    cfg = main_path_config(args.clients, args.until_step, "cuda")
    cuda_bk.reset_dispatch_counts()
    cuda_bk.window_shapes.clear()
    ch.piece_window.launches = 0
    ch.forecast_z.launches = 0
    torch.cuda.reset_peak_memory_stats()
    s_cuda, r_cuda, t_cuda = run_main(torch, cfg)
    launches = {"piece_window": ch.piece_window.launches,
                "forecast_z": ch.forecast_z.launches}
    peak = torch.cuda.max_memory_allocated()
    dispatch = dict(sorted(cuda_bk.dispatch_counts.items()))
    shapes = window_histogram(cuda_bk.window_shapes)
    s_np, r_np, t_np = run_main(
        torch, main_path_config(args.clients, args.until_step, "numpy"))
    n_rounds = len(r_cuda)
    emit("main_path", clients=args.clients, until_step=args.until_step,
         rounds=n_rounds, total_energy_wh=s_cuda["total_energy_wh"],
         total_energy_wh_numpy=s_np["total_energy_wh"],
         cuda=t_cuda, numpy=t_np,
         kernel_launches=launches, dispatch_counts=dispatch,
         max_memory_allocated=peak, **shapes)
    require(n_rounds >= 20, f"only {n_rounds} rounds; raise --until-step")
    require(r_cuda == r_np, "cuda rounds differ from numpy rounds")
    require(s_cuda["total_energy_wh"] == s_np["total_energy_wh"],
            "total energy differs")
    require(launches["piece_window"] > 0 and launches["forecast_z"] > 0,
            f"a kernel never launched on the main path: {launches}")

    kernels = []
    for name in ("piece_window", "forecast_z"):
        m = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": K1_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
