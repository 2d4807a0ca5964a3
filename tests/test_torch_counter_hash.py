"""Counter-hash kernels of the port against the reference, bit for bit.

The port's K1/K2 (``repro_torch.kernels.counter_hash``: ``piece_window``
and ``forecast_z``) are held to two references with
``assert_array_equal`` — no tolerance, the contract is bit-exact:

* the JAX package's Pallas kernels, run in interpreter mode as its own
  tests run them (block-multiple shapes, under ``jax.enable_x64``);
* the JAX package's NumPy reference backend, at ragged shapes the Pallas
  launcher does not take, including the 70k-row case.

On the CPU the wrappers run their plain PyTorch versions (the input
tensors lie on the CPU), and so does ``CudaBackend(device="cpu")``. The
kernel itself is compared with its plain version by the ``cuda``-marked
test, which skips on a host without a CUDA device.
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. The alias is process-wide and
# set when this file is collected, which every pytest process (each
# xdist worker included) does for the whole suite before it runs a test,
# so every test of the run sees it.
jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro.backend import get_backend
from repro.kernels import ops as ref_ops
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.kernels import counter_hash as ch
from repro_torch.kernels import ops

NP = get_backend("numpy")
CB = CudaBackend(device="cpu")
_U64 = np.uint64


def _grid_case(rng, R, S, W):
    levels = rng.random((R, S), dtype=np.float32)
    slot = rng.integers(0, S, (R, W)).astype(np.int64)
    rows = np.sort(rng.choice(10 ** 7, R, replace=False)).astype(np.uint64)
    return levels, slot, rows


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64
                            else a.copy())


def _std(W):
    return (0.05 + 0.2 * np.minimum(np.arange(1, W + 1) / 1440.0, 1.0)
            ).astype(np.float32)


def _port_window(levels, slot, fold, rows, t0, amp):
    """(wrapper on CPU tensors, CudaBackend(cpu)) results."""
    a = ch.piece_window(_t(levels), _t(slot), fold, _t(rows), t0, amp)
    b = CB.synth_window(levels.copy(), slot, fold, rows, t0, amp)
    return a.numpy(), b


def _port_forecast(fold, rows, now, std):
    a = ch.forecast_z(fold, _t(rows), now, _t(std))
    b = CB.forecast_noise_z(fold, rows, now, std.shape[0], std)
    return a.numpy(), b


@pytest.mark.parametrize("R,S,W,br,bw", [
    (16, 3, 16, 16, 16),        # single tile
    (256, 5, 96, 64, 32),       # multi-tile both axes
    (512, 8, 64, 256, 64),      # uneven tiling, levels wider than slots
])
def test_piece_window_matches_pallas_interpreter(R, S, W, br, bw, rng):
    levels, slot, rows = _grid_case(rng, R, S, W)
    fold = _U64(rng.integers(0, 2 ** 62))
    amp = np.float32(0.05 * np.sqrt(12.0))
    with jax.enable_x64():
        want = np.asarray(ref_ops.piece_window(
            levels, slot, fold, rows, np.int64(10_000), amp,
            block_r=br, block_w=bw))
    for got in _port_window(levels, slot, fold, rows, 10_000, amp):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("R,W,br,bw", [(64, 16, 64, 16), (512, 64, 128, 32)])
def test_forecast_z_matches_pallas_interpreter(R, W, br, bw, rng):
    rows = rng.integers(0, 2 ** 40, R, dtype=np.int64).astype(np.uint64)
    fold = _U64(rng.integers(0, 2 ** 62))
    std = _std(W)
    with jax.enable_x64():
        want = np.asarray(ref_ops.forecast_z(fold, rows, _U64(777), std,
                                             block_r=br, block_w=bw))
    for got in _port_forecast(fold, rows, 777, std):
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("R,S,W", [(1, 1, 1), (7, 3, 13), (300, 5, 40),
                                   (70_000, 6, 12)])
def test_kernels_match_numpy_reference_ragged(R, S, W, rng):
    """Shapes off any block multiple, which the port takes unpadded."""
    levels, slot, rows = _grid_case(rng, R, S, W)
    fold = _U64(rng.integers(0, 2 ** 62))
    want = NP.synth_window(levels.copy(), slot, fold, rows, 4_321, 0.1732)
    for got in _port_window(levels, slot, fold, rows, 4_321, 0.1732):
        np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        want, ops.piece_window_ref(levels, slot, fold, rows, 4_321, 0.1732))

    std = _std(W)
    wantz = NP.forecast_noise_z(fold, rows, 777, W, std)
    for got in _port_forecast(fold, rows, 777, std):
        np.testing.assert_array_equal(wantz, got)
    zb = CB.forecast_noise_z(fold, rows, 777, W, std)
    assert zb.flags.writeable                   # callers np.exp in place
    np.testing.assert_array_equal(
        wantz, ops.forecast_z_ref(fold, rows, 777, std))


# K2's row tiling and column walk: R, W, first row key, now (as
# chip_smoke.py's K2_CASES, cut in R for the CPU)
K2_EDGE_CASES = [
    (4099, 60, 0, 777),                # the main path's d_max, R ragged
    (1001, 61, 0, 777),                # W 61: R * W not a multiple of 4
    (1001, 64, 0, 777),                # R off the 64-row tile
    (517, 60, 2 ** 63 + 12_345, 777),  # row keys >= 2^63
    (256, 60, 0, 2 ** 44 - 3),         # now << 20 wraps past 2^64
    (9, 4097, 0, 5),                   # W past one tile's cells
]


@pytest.mark.parametrize("R,W,row0,now", K2_EDGE_CASES)
def test_forecast_z_edge_cases_match_numpy(R, W, row0, now):
    rows = np.uint64(row0) + np.arange(R, dtype=np.uint64)
    fold = _U64(0x9E3779B97F4A7C15)
    std = _std(W)
    want = NP.forecast_noise_z(fold, rows, now, W, std)
    for got in _port_forecast(fold, rows, now, std):
        np.testing.assert_array_equal(want, got)


def test_cuda_backend_ticks_once_per_window_and_records_shapes(rng):
    bk = CudaBackend(device="cpu")
    levels, slot, rows = _grid_case(rng, 33, 4, 9)
    fold = _U64(5)
    bk.synth_window(levels, slot, fold, rows, 100, 0.1732)
    bk.synth_window(levels, slot, fold, rows, 101, 0.1732)
    bk.forecast_noise_z(fold, rows, 7, 9, _std(9))
    assert bk.dispatch_counts == {"synth_window": 2, "forecast_noise_z": 1}
    assert bk.window_shapes == {("synth_window", 33, 9): 2,
                                ("forecast_noise_z", 33, 9): 1}


def test_wrappers_count_no_launch_on_cpu(rng):
    """The launch counters count kernel launches only: the CPU path runs
    the plain version and leaves them alone."""
    before = (ch.piece_window.launches, ch.forecast_z.launches)
    levels, slot, rows = _grid_case(rng, 8, 2, 4)
    ch.piece_window(_t(levels), _t(slot), 3, _t(rows), 0, 0.5)
    ch.forecast_z(3, _t(rows), 0, _t(_std(4)))
    assert (ch.piece_window.launches, ch.forecast_z.launches) == before


def _key_sweep_case(seed, row_key, segment):
    """One (seed, row, segment) key triple → port vs both references."""
    rng = np.random.default_rng(seed)
    R, S, W = 32, 4, 16
    levels = rng.random((R, S), dtype=np.float32)
    slot = np.full((R, W), segment % S, dtype=np.int64)
    rows = (np.arange(R, dtype=np.uint64) * _U64(2654435761)
            + _U64(row_key)) & _U64((1 << 40) - 1)
    fold = NP.hash64(seed, 17, np.uint64(segment))
    amp = np.float32(0.1732)
    want = NP.synth_window(levels.copy(), slot, fold, rows, segment, amp)
    with jax.enable_x64():
        pallas = np.asarray(ref_ops.piece_window(
            levels, slot, _U64(fold), rows, np.int64(segment), amp,
            block_r=16, block_w=16))
    np.testing.assert_array_equal(want, pallas)
    for got in _port_window(levels, slot, fold, rows, segment, amp):
        np.testing.assert_array_equal(want, got)

    std = np.full(W, 0.07, dtype=np.float32)
    wantz = NP.forecast_noise_z(fold, rows, row_key, W, std)
    with jax.enable_x64():
        pallasz = np.asarray(ref_ops.forecast_z(
            _U64(fold), rows, _U64(row_key), std, block_r=16, block_w=16))
    np.testing.assert_array_equal(wantz, pallasz)
    for got in _port_forecast(fold, rows, row_key, std):
        np.testing.assert_array_equal(wantz, got)


try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1),
           row_key=st.integers(0, 2 ** 32 - 1),
           segment=st.integers(0, 10 ** 6))
    def test_counter_hash_key_sweep(seed, row_key, segment):
        _key_sweep_case(seed, row_key, segment)

except ImportError:  # pragma: no cover - optional dev dep

    @pytest.mark.parametrize("seed,row_key,segment", [
        (0, 0, 0), (1, 1, 1), (2 ** 31 - 1, 2 ** 32 - 1, 10 ** 6),
        (12345, 99991, 86_400), (7, 2 ** 24, 65_535), (42, 3, 1_000_003),
    ])
    def test_counter_hash_key_sweep(seed, row_key, segment):
        """Seeded fallback sweep when hypothesis is unavailable."""
        _key_sweep_case(seed, row_key, segment)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,W", [(1, 1, 1), (70_000, 6, 12),
                                   (4096, 9, 64)])
def test_kernels_match_plain_on_card(R, S, W):
    """K1/K2 launched on the card equal their plain versions on the card
    and the NumPy reference on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(R)
    levels, slot, rows = _grid_case(rng, R, S, W)
    fold = _U64(rng.integers(0, 2 ** 62))
    dev = torch.device("cuda:0")
    lv, sl, rw = _t(levels).to(dev), _t(slot).to(dev), _t(rows).to(dev)
    n0 = ch.piece_window.launches
    k = ch.piece_window(lv, sl, fold, rw, 4_321, 0.1732)
    torch.cuda.synchronize()
    assert ch.piece_window.launches == n0 + 1
    assert torch.equal(k, ch.piece_window_plain(lv, sl, fold, rw, 4_321,
                                                0.1732))
    np.testing.assert_array_equal(
        k.cpu().numpy(),
        NP.synth_window(levels.copy(), slot, fold, rows, 4_321, 0.1732))

    sd = _t(_std(W)).to(dev)
    z = ch.forecast_z(fold, rw, 777, sd)
    torch.cuda.synchronize()
    assert torch.equal(z, ch.forecast_z_plain(fold, rw, 777, sd))
    np.testing.assert_array_equal(
        z.cpu().numpy(), NP.forecast_noise_z(fold, rows, 777, W, _std(W)))


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,row0,now", K2_EDGE_CASES)
def test_forecast_z_edge_cases_on_card(R, W, row0, now):
    """K2 launched on the card at its tiling and walk edges equals its
    plain version on the card and the NumPy reference on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = np.uint64(row0) + np.arange(R, dtype=np.uint64)
    fold = _U64(0x9E3779B97F4A7C15)
    dev = torch.device("cuda:0")
    rw, sd = _t(rows).to(dev), _t(_std(W)).to(dev)
    n0 = ch.forecast_z.launches
    z = ch.forecast_z(fold, rw, now, sd)
    torch.cuda.synchronize()
    assert ch.forecast_z.launches == n0 + 1
    assert torch.equal(z, ch.forecast_z_plain(fold, rw, now, sd))
    np.testing.assert_array_equal(
        z.cpu().numpy(), NP.forecast_noise_z(fold, rows, now, W, _std(W)))
