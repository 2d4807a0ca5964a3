"""K4 of the port (``repro_torch.kernels.rwkv_scan``) against the reference.

The same inputs, made from a seed with NumPy the way the reference's tests
make them (r, k ~ 0.5 N(0, 1), v ~ N(0, 1), w = exp(-exp(0.5 N(0, 1) -
0.5)), u ~ 0.3 N(0, 1)), go through:

* the JAX package's Pallas kernel, in interpreter mode as its own tests run
  it (tests/test_kernels.py), at the three shapes of those tests;
* the JAX package's oracle ``ref.rwkv_scan_ref`` (out and final state),
  also at ragged S (31 and 1), which the Pallas launcher does not take.

Tolerance atol 1e-4, rtol 1e-3: the reference's own for this kernel. On the
CPU the port's wrapper runs its plain PyTorch version (the tensors lie on
the CPU); the kernel itself is held to that plain version by the
``cuda``-marked tests, which skip on a host without a CUDA device. Both
compute in float32 (the kernel in chunks, its products in three TF32
parts), so those tests are tighter: atol 1e-4, rtol 1e-4, as
chip_smoke.py's ``K4_TOL``. The kernel's decomposition in plain PyTorch,
``rwkv_scan_chunked_plain`` (TF32 rounding emulated), is held here on the
CPU to the serial plain version within ``K4_TOL``, at the model's decay
and at a strong one, and to the Pallas kernel within the reference's
tolerance.
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
from repro_torch.kernels import rwkv_scan as k4

REF_TOL = dict(atol=1e-4, rtol=1e-3)
K4_TOL = dict(atol=1e-4, rtol=1e-4)
# decay logit means: the model's init (w ~ 0.55 a step), a trained
# model's strong decay (w ~ 6e-4 a step, 2^-340 over a 32-token chunk) and
# a weak one (w ~ 0.98: the state carried across chunks matters)
MODEL_DECAY, STRONG_DECAY, WEAK_DECAY = -0.5, 2.0, -4.0


def _inputs(seed, B, S, H, dh, logit_mean=MODEL_DECAY):
    rng = np.random.default_rng(seed)
    r = 0.5 * rng.standard_normal((B, S, H, dh), dtype=np.float32)
    k = 0.5 * rng.standard_normal((B, S, H, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, H, dh), dtype=np.float32)
    logit = (0.5 * rng.standard_normal((B, S, H, dh), dtype=np.float32)
             + logit_mean)
    w = np.exp(-np.exp(logit)).astype(np.float32)
    u = 0.3 * rng.standard_normal((H, dh), dtype=np.float32)
    return r, k, v, w, u


def _port(*arrays, **kw):
    return k4.rwkv_scan(*(torch.from_numpy(a) for a in arrays), **kw)


@pytest.mark.parametrize("B,S,H,dh,chunk", [
    (1, 32, 1, 16, 8),
    (2, 64, 2, 32, 16),
    (1, 128, 4, 64, 32),
])
def test_plain_matches_pallas_kernel(B, S, H, dh, chunk):
    args = _inputs(0, B, S, H, dh)
    want = np.asarray(ref_ops.rwkv_scan(*map(jnp.asarray, args),
                                        chunk=chunk, interpret=True))
    np.testing.assert_allclose(_port(*args).numpy(), want, **REF_TOL)


@pytest.mark.parametrize("B,S,H,dh", [
    (2, 64, 2, 32),
    (2, 31, 3, 64),    # ragged S
    (3, 1, 2, 16),     # one token
])
def test_out_and_state_match_oracle(B, S, H, dh):
    args = _inputs(1, B, S, H, dh)
    want_out, want_state = ref.rwkv_scan_ref(*map(jnp.asarray, args))
    out, state = _port(*args, return_state=True)
    assert out.shape == (B, S, H, dh) and state.shape == (B, H, dh, dh)
    assert out.dtype == state.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **REF_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               **REF_TOL)


@pytest.mark.parametrize("B,S,H,dh,chunk", [
    (1, 32, 1, 16, 8),
    (2, 64, 2, 32, 16),
    (1, 128, 4, 64, 32),
])
def test_chunked_plain_matches_pallas_kernel(B, S, H, dh, chunk):
    args = _inputs(0, B, S, H, dh)
    want = np.asarray(ref_ops.rwkv_scan(*map(jnp.asarray, args),
                                        chunk=chunk, interpret=True))
    out, _ = k4.rwkv_scan_chunked_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), want, **REF_TOL)


@pytest.mark.parametrize("group", [None, k4.CHUNK, 4 * k4.CHUNK],
                         ids=["one group", "groups of a chunk",
                              "groups of 4 chunks"])
@pytest.mark.parametrize("logit_mean", [MODEL_DECAY, STRONG_DECAY,
                                        WEAK_DECAY],
                         ids=["model decay", "strong decay", "weak decay"])
@pytest.mark.parametrize("B,S,H,dh", [
    (2, 64, 2, 32),
    (2, 77, 3, 64),    # a ragged third chunk
    (1, 17, 2, 16),    # one ragged chunk
    (1, 33, 2, 64),    # one token past a chunk
    (2, 1, 2, 64),
    (1, 129, 2, 32),   # one token past a group
    (1, 300, 2, 64),   # three groups, the last ragged
])
def test_chunked_plain_matches_serial_plain(B, S, H, dh, logit_mean,
                                            group):
    """The kernels' decomposition (groups, chunks, anchored decays, TF32
    hi + lo products) holds the serial recurrence within K4_TOL, also where
    a chunk's cumulative decay is far below float32's range, and where the
    state carried across chunks and groups matters: in one group (the
    serial chunk walk), and in groups of one and of four chunks."""
    args = [torch.from_numpy(a) for a in _inputs(5, B, S, H, dh, logit_mean)]
    want_out, want_state = k4.rwkv_scan_plain(*args)
    out, state = k4.rwkv_scan_chunked_plain(*args, group=group)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    torch.testing.assert_close(out, want_out, **K4_TOL)
    torch.testing.assert_close(state, want_state, **K4_TOL)


def test_one_tf32_product_does_not_hold_k4_tol():
    """Why the kernel splits each operand: the decomposition with one TF32
    product per term misses K4_TOL at the model's scale (unit-normal r, k,
    v), while the three-part products hold it."""
    rng = np.random.default_rng(6)
    r, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 2, 64),
                                                    dtype=np.float32))
               for _ in range(3))
    w = torch.exp(-torch.exp(MODEL_DECAY + 0.6 * torch.from_numpy(
        rng.standard_normal((1, 256, 2, 64), dtype=np.float32))))
    u = torch.from_numpy(rng.standard_normal((2, 64), dtype=np.float32)) / 8
    want, _ = k4.rwkv_scan_plain(r, k, v, w, u)

    def over_limit(out):
        return float(((out - want).abs()
                      / (K4_TOL["atol"] + K4_TOL["rtol"] * want.abs())).max())

    assert over_limit(k4.rwkv_scan_chunked_plain(r, k, v, w, u)[0]) <= 1.0
    three_part = k4._mm3
    try:
        k4._mm3 = lambda a, b: k4._tf32(a) @ k4._tf32(b)
        assert over_limit(k4.rwkv_scan_chunked_plain(r, k, v, w, u)[0]) > 10
    finally:
        k4._mm3 = three_part


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e38],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, 3.0e38], dtype=torch.float32)
    got = k4._tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) / 3.0e38 - 1) < 2 ** -10


def test_wrapper_takes_bf16_rkv_as_their_float32_casts():
    """bf16 -> float32 is exact, so bf16 r, k, v give what their float32
    casts give; w and u stay float32."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(7, 2, 40, 2, 32))
    rb, kb, vb = (x.bfloat16() for x in (r, k, v))
    out, state = k4.rwkv_scan(rb, kb, vb, w, u, return_state=True)
    want_out, want_state = k4.rwkv_scan(rb.float(), kb.float(), vb.float(),
                                        w, u, return_state=True)
    assert out.dtype == state.dtype == torch.float32
    assert torch.equal(out, want_out) and torch.equal(state, want_state)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _inputs(2, 2, 9, 2, 16)]
    n0 = k4.rwkv_scan.launches
    out, state = k4.rwkv_scan(*args, return_state=True)
    assert k4.rwkv_scan.launches == n0
    want_out, want_state = k4.rwkv_scan_plain(*args)
    assert torch.equal(out, want_out) and torch.equal(state, want_state)
    assert torch.equal(k4.rwkv_scan(*args), want_out)
    # strided inputs (a [B, H, S, dh] tensor seen as [B, S, H, dh]) agree
    r, k, v, w, u = args
    rt = r.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(k4.rwkv_scan(rt, k, v, w, u), want_out)


@pytest.mark.parametrize("case", ["rank", "k shape", "u shape", "bf16",
                                  "u float64", "dh 48", "dh 128", "S 0",
                                  "w bf16", "r float16"])
def test_bad_inputs_raise_value_error(case):
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 16))
    if case == "rank":
        r = r[0]
    elif case == "k shape":
        k = k[:, :3]
    elif case == "u shape":
        u = u[:1]
    elif case == "bf16":   # r, k and v in two dtypes
        v = v.bfloat16()
    elif case == "w bf16":
        r, k, v, w = (x.bfloat16() for x in (r, k, v, w))
    elif case == "r float16":
        r, k, v = (x.half() for x in (r, k, v))
    elif case == "u float64":
        u = u.double()
    elif case.startswith("dh"):
        dh = int(case.split()[1])
        r, k, v, w, u = (torch.from_numpy(a)
                         for a in _inputs(3, 1, 4, 2, dh))
    elif case == "S 0":
        r, k, v, w = (t[:, :0] for t in (r, k, v, w))
    with pytest.raises(ValueError):
        k4.rwkv_scan(r, k, v, w, u)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh", [
    (2, 300, 4, 64),    # ragged against the chunk and the group
    (1, 1, 3, 64),      # one token
    (3, 47, 2, 32),
    (2, 33, 5, 16),
    (2, 129, 3, 64),    # one token past a group
])
def test_kernel_matches_plain_on_card(B, S, H, dh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    r, k, v, w, u = (torch.from_numpy(a).to(dev)
                     for a in _inputs(4, B, S, H, dh))
    # r as the model could pass it: a strided view of a [B, H, S, dh] tensor
    r = r.transpose(1, 2).contiguous().transpose(1, 2)
    n0 = k4.rwkv_scan.launches
    out, state = k4.rwkv_scan(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    assert k4.rwkv_scan.launches == n0 + k4.kernel_launches(B, H, S)
    want_out, want_state = k4.rwkv_scan_plain(r, k, v, w, u)
    # the same recurrence in float32: summation order and FMAs only
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)
    assert torch.equal(k4.rwkv_scan(r, k, v, w, u), out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh,dtype,logit_mean", [
    (2, 2048, 4, 64, torch.bfloat16, MODEL_DECAY),   # the model's dtype
    (2, 2048, 4, 64, torch.float32, STRONG_DECAY),
    (2, 2048, 4, 64, torch.float32, WEAK_DECAY),
    (3, 17, 2, 64, torch.float32, MODEL_DECAY),      # against the chunk
    (3, 33, 2, 64, torch.bfloat16, MODEL_DECAY),
    (2, 65, 3, 16, torch.float32, STRONG_DECAY),
    (2, 300, 3, 64, torch.bfloat16, WEAK_DECAY),   # against the group
])
def test_kernel_chunk_cases_on_card(B, S, H, dh, dtype, logit_mean):
    """K4's bf16 inputs, a strong and a weak decay and chunk and group
    edges, as chip_smoke.py's K4 cases, against the plain version on the
    card within K4_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    r, k, v, w, u = (torch.from_numpy(a).to(dev)
                     for a in _inputs(8, B, S, H, dh, logit_mean))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    n0 = k4.rwkv_scan.launches
    out, state = k4.rwkv_scan(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    assert k4.rwkv_scan.launches == n0 + k4.kernel_launches(B, H, S)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    want_out, want_state = k4.rwkv_scan_plain(r.float(), k.float(),
                                              v.float(), w, u)
    torch.testing.assert_close(out, want_out, **K4_TOL)
    torch.testing.assert_close(state, want_state, **K4_TOL)
