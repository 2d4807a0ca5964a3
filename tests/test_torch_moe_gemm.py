"""K5 of the port (``repro_torch.kernels.moe_gemm``) against the reference.

The same inputs, made from a seed with NumPy (standard normal, as the
reference's tests draw them), go through:

* the JAX package's Pallas kernel ``ops.moe_gemm``, in interpreter mode
  as its own tests run it (tests/test_kernels.py), at the three shapes of
  those tests, in float32 and bfloat16, within the reference's
  tolerances (1e-3 in float32; atol = rtol = 5e-2 in bfloat16);
* the JAX package's oracle ``ref.moe_gemm_ref``, also at ragged C (37 and
  1), which the Pallas launcher does not take;
* the routed product (``moe_gemm_routed``: each expert's rows in one
  128-aligned segment of x [R, d], the segments' starts in a device array)
  against the same oracle on each expert's rows, empty experts included.

On the CPU the port's wrapper runs its plain version (the tensors lie on
the CPU), and the rule that picks the bf16 kernel (``pick_variant``: the
``narrow`` kernel up to C 64, the ``wide`` one above) and the checks of
``launch`` are tested here. The kernels themselves are held to that plain
version by the ``cuda``-marked tests, which skip on a host without a CUDA
device; the routed kernels also at segments of 0, 1, 127, 128, 129 and 2048
rows and all rows on one expert, with NaN in the padding rows (no real row
may read one), and bit for bit against the dense ``wide`` and ``f32``
kernels on the same rows. Both accumulate in float32 and differ only in summation order, so
those tests are tighter: atol 1e-4 + rtol 1e-2 in bfloat16 (one output
rounding step, 2^-7 of the value), 1e-4 in float32, as chip_smoke.py's
``K5_TOL``.
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. Set here, before repro.kernels
# is imported, so this file does not depend on collection order.
jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import moe_gemm as k5
from repro_torch.models.convert import to_tensor

SHAPES = [  # E, C, d, f, bc, bf, bd: the reference's test shapes
    (2, 64, 128, 256, 32, 128, 64),
    (4, 32, 64, 64, 32, 64, 64),
    (8, 128, 256, 128, 128, 128, 128),
]


def _tol(dtype):
    return (dict(atol=5e-2, rtol=5e-2) if dtype == jnp.bfloat16
            else dict(atol=1e-3, rtol=1e-3))


def _inputs(seed, E, C, d, f, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d), dtype=np.float32).astype(dtype)
    w = rng.standard_normal((E, d, f), dtype=np.float32).astype(dtype)
    return x, w


def _port(x, w):
    return k5.moe_gemm(to_tensor(x), to_tensor(w)).float().numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("E,C,d,f,bc,bf,bd", SHAPES)
def test_plain_matches_pallas_kernel(E, C, d, f, bc, bf, bd, dtype):
    x, w = _inputs(0, E, C, d, f, dtype)
    want = ref_ops.moe_gemm(jnp.asarray(x), jnp.asarray(w), block_c=bc,
                            block_f=bf, block_d=bd, interpret=True)
    got = _port(x, w)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("E,C,d,f", [(3, 37, 64, 48), (2, 1, 128, 8)])
def test_plain_matches_oracle_ragged(E, C, d, f, dtype):
    x, w = _inputs(1, E, C, d, f, dtype)
    want = ref.moe_gemm_ref(jnp.asarray(x), jnp.asarray(w))
    got = _port(x, w)
    assert got.shape == (E, C, f)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **_tol(dtype))


def test_wrapper_on_cpu_runs_plain_and_checks_shapes():
    x, w = (to_tensor(a) for a in _inputs(2, 2, 5, 16, 24))
    n0 = k5.moe_gemm.launches
    out = k5.moe_gemm(x, w)
    assert k5.moe_gemm.launches == n0
    assert out.dtype == x.dtype and out.shape == (2, 5, 24)
    torch.testing.assert_close(out, k5.moe_gemm_plain(x, w), rtol=0, atol=0)
    for bad_x, bad_w in ((x[:, :, :12], w[:, :12]),     # d not a multiple of 8
                         (x, w[:, :, :20]),             # f not a multiple of 8
                         (x[:1], w),                    # E differs
                         (x, w[:, :8]),                 # d differs
                         (x[:, :0], w),                 # C = 0
                         (x.double(), w.double()),      # dtype
                         (x, w.bfloat16())):            # mixed dtypes
        with pytest.raises(ValueError):
            k5.moe_gemm(bad_x, bad_w)


@pytest.mark.parametrize("C,variant", [
    (1, "narrow"), (8, "narrow"), (9, "narrow"), (37, "narrow"),
    (64, "narrow"), (65, "wide"), (80, "wide"), (2560, "wide")])
def test_pick_variant_splits_at_narrow_max_c(C, variant):
    assert k5.NARROW_MAX_C == 64
    assert k5.pick_variant(C) == variant


def test_launch_checks_variant_before_device():
    x, w = (to_tensor(a) for a in _inputs(4, 2, 5, 16, 24))
    xb, wb = x.bfloat16(), w.bfloat16()
    x65 = torch.zeros((2, 65, 16), dtype=torch.bfloat16)
    for args in ((xb, wb, "tiled"),      # no such variant
                 (x, w, "wide"),         # float32 runs on f32 only
                 (xb, wb, "f32"),        # ...and bf16 on wide or narrow
                 (x65, wb, "narrow"),    # narrow takes C <= 64
                 (xb, wb, "narrow"),     # a sound call, but CPU tensors
                 (x, w, "f32")):
        with pytest.raises(ValueError):
            k5.launch(*args)


def test_counts_start_at_zero_and_cpu_does_not_count():
    k5.reset_counts()
    assert k5.moe_gemm.launches == 0
    assert k5.moe_gemm.variant_launches == {"f32": 0, "wide": 0,
                                            "narrow": 0}
    x, w = (to_tensor(a) for a in _inputs(5, 2, 70, 16, 24))
    k5.moe_gemm(x.bfloat16(), w.bfloat16())
    k5.moe_gemm(x[:, :8], w)
    assert k5.moe_gemm.launches == 0
    assert sum(k5.moe_gemm.variant_launches.values()) == 0


def _routed(lengths, x, pad=0.0, tail=128):
    """The routed buffer of x [E, C, d]'s first lengths[e] rows of each
    expert: segments padded to 128 rows (the padding rows and ``tail``
    rows past the last segment hold ``pad``), and the starts in tiles."""
    seg = [-(-n // k5.ROUTE_ROWS) * k5.ROUTE_ROWS for n in lengths]
    starts = np.concatenate([[0], np.cumsum(seg)]).astype(np.int64)
    xr = torch.full((int(starts[-1]) + tail, x.shape[-1]), pad,
                    dtype=x.dtype, device=x.device)
    for e, n in enumerate(lengths):
        xr[starts[e]:starts[e] + n] = x[e, :n]
    tiles = torch.from_numpy(starts // k5.ROUTE_ROWS).to(torch.int32)
    return xr, tiles.to(x.device), starts


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("lengths", [(37, 0, 128, 129), (0, 0, 5, 0)])
def test_routed_plain_matches_oracle(lengths, dtype):
    E, C = len(lengths), max(lengths)
    x, w = _inputs(8, E, C, 64, 48, dtype)
    want = np.asarray(ref.moe_gemm_ref(jnp.asarray(x), jnp.asarray(w)),
                      np.float32)
    xr, tiles, starts = _routed(lengths, to_tensor(x), pad=7.0)
    n0 = k5.moe_gemm.launches
    got = k5.moe_gemm_routed(xr, to_tensor(w), tiles)
    assert k5.moe_gemm.launches == n0
    assert got.shape == (xr.shape[0], 48) and got.dtype == xr.dtype
    got = got.float().numpy()
    for e, n in enumerate(lengths):
        np.testing.assert_allclose(got[starts[e]:starts[e] + n], want[e, :n],
                                   **_tol(dtype))
    assert not got[starts[-1]:].any()   # past the last segment: zeros


def test_routed_wrapper_checks_its_inputs():
    x, w = (to_tensor(a) for a in _inputs(9, 2, 5, 16, 24))
    xr, tiles, _ = _routed((5, 3), x)
    for bad in ((xr[None], w, tiles),                    # x not [R, d]
                (xr[:, :8], w, tiles),                   # d differs
                (xr, w, tiles.long()),                   # tiles not int32
                (xr, w, tiles[:-1]),                     # not E + 1 entries
                (xr.bfloat16(), w, tiles)):              # mixed dtypes
        with pytest.raises(ValueError):
            k5.moe_gemm_routed(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        k5.launch_routed(xr, w, tiles)


def _card_inputs(E, C, d, f, dtype, seed=3):
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, C, d), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((E, d, f), dtype=np.float32)
                         / np.sqrt(d, dtype=np.float32))
    return x.to(dev, dtype), w.to(dev, dtype)


def _card_tol(dtype):
    return (dict(atol=1e-4, rtol=1e-2) if dtype == torch.bfloat16
            else dict(atol=1e-4, rtol=1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f", [
    (8, 200, 512, 384),    # ragged C against a 128-row tile
    (4, 8, 6144, 256),     # mixtral decode: C 8, d 6144
    (3, 37, 72, 40),       # d and f not multiples of the tiles
    (2, 1, 8, 8),          # one row, one 8-wide step
    (4, 64, 512, 384),     # the largest C of the narrow kernel
    (4, 65, 512, 384),     # the smallest C of the wide kernel
    (3, 300, 1000, 512),   # d 1000: not a multiple of a stage (wide)
    (3, 5, 1000, 512),     # ... (narrow)
    (3, 300, 512, 1032),   # f 1032: a ragged last f tile (wide)
    (3, 5, 512, 1032),     # ... (narrow)
    (1, 200, 512, 384),    # E 1 (wide)
    (1, 8, 512, 384),      # E 1 (narrow)
])
def test_kernel_matches_plain_on_card(E, C, d, f, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = _card_inputs(E, C, d, f, dtype)
    variant = "f32" if dtype == torch.float32 else k5.pick_variant(C)
    n0 = k5.moe_gemm.launches
    v0 = k5.moe_gemm.variant_launches[variant]
    got = k5.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert k5.moe_gemm.launches == n0 + 1
    assert k5.moe_gemm.variant_launches[variant] == v0 + 1
    want = k5.moe_gemm_plain(x, w)
    torch.testing.assert_close(got.float(), want.float(), **_card_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["narrow", "wide"])
@pytest.mark.parametrize("C", [1, 8, 13, 37, 64])
def test_both_bf16_kernels_match_plain_on_card(C, variant):
    """Where both bf16 kernels take C, each one, named, agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = _card_inputs(3, C, 1000, 1032, torch.bfloat16, seed=6)
    got = k5.launch(x, w, variant)
    torch.cuda.synchronize()
    want = k5.moe_gemm_plain(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **_card_tol(torch.bfloat16))


def _card_routed(lengths, d, f, dtype, pad=0.0, seed=4):
    x, w = _card_inputs(len(lengths), max(max(lengths), 1), d, f, dtype,
                        seed=seed)
    xr, tiles, starts = _routed(lengths, x, pad=pad)
    return x, w, xr, tiles, starts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [
    (0, 1, 127, 128, 129, 2048),   # every edge of a 128-row segment
    (0, 0, 300, 0),                # every row on one expert
    (300, 0, 0, 0),
    (0, 0, 0, 300),
    (1,),                          # one expert, one row
])
def test_routed_kernel_matches_plain_on_card(lengths, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, w, xr, tiles, starts = _card_routed(lengths, 512, 384, dtype)
    variant = "f32" if dtype == torch.float32 else "wide"
    v0 = k5.moe_gemm.variant_launches[variant]
    got = k5.moe_gemm_routed(xr, w, tiles)
    torch.cuda.synchronize()
    assert k5.moe_gemm.variant_launches[variant] == v0 + 1
    want = k5.moe_gemm_routed_plain(xr, w, tiles)
    n = int(starts[-1])
    torch.testing.assert_close(got[:n].float(), want[:n].float(),
                               **_card_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_kernel_nan_padding_stays_in_padding_on_card(dtype):
    """NaN in every padding row and past the last segment: each real row
    is finite and equals its product with zero padding, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lengths = (0, 1, 127, 129, 200)
    _, w, xr, tiles, starts = _card_routed(lengths, 1000, 1032, dtype,
                                           pad=float("nan"))
    clean = torch.nan_to_num(xr, nan=0.0)
    got = k5.moe_gemm_routed(xr, w, tiles)
    want = k5.moe_gemm_routed(clean, w, tiles)
    torch.cuda.synchronize()
    for e, n in enumerate(lengths):
        rows = slice(int(starts[e]), int(starts[e]) + n)
        assert torch.isfinite(got[rows]).all()
        assert torch.equal(got[rows], want[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [256, 200])
def test_routed_kernel_equals_dense_bits_on_card(C, dtype):
    """On the same rows the routed kernel's output equals the dense
    kernel's (``wide`` in bf16, ``f32``) bit for bit: each row's product
    is the same sum in the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = _card_inputs(4, C, 6144 // 4, 2048, dtype, seed=5)
    xr, tiles, starts = _routed((C,) * 4, x)
    dense = k5.launch(x.contiguous(), w,
                      "f32" if dtype == torch.float32 else "wide")
    got = k5.moe_gemm_routed(xr, w, tiles)
    torch.cuda.synchronize()
    for e in range(4):
        assert torch.equal(got[starts[e]:starts[e] + C], dense[e])
