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
``cuda``-marked test, which skips on a host without a CUDA device. Both run
the same recurrence in float32 and differ only in summation order and fused
multiply-adds, so that test is tighter: atol 1e-4, rtol 1e-4, as
chip_smoke.py's ``K4_TOL``.
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


def _inputs(seed, B, S, H, dh):
    rng = np.random.default_rng(seed)
    r = 0.5 * rng.standard_normal((B, S, H, dh), dtype=np.float32)
    k = 0.5 * rng.standard_normal((B, S, H, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, H, dh), dtype=np.float32)
    logit = 0.5 * rng.standard_normal((B, S, H, dh), dtype=np.float32) - 0.5
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
                                  "u float64", "dh 48", "dh 128", "S 0"])
def test_bad_inputs_raise_value_error(case):
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 16))
    if case == "rank":
        r = r[0]
    elif case == "k shape":
        k = k[:, :3]
    elif case == "u shape":
        u = u[:1]
    elif case == "bf16":
        v = v.bfloat16()
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
    (2, 300, 4, 64),    # ragged against the 16-step chunk
    (1, 1, 3, 64),      # one token
    (3, 47, 2, 32),
    (2, 33, 5, 16),
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
    assert k4.rwkv_scan.launches == n0 + 1
    want_out, want_state = k4.rwkv_scan_plain(r, k, v, w, u)
    # the same recurrence in float32: summation order and FMAs only
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)
    assert torch.equal(k4.rwkv_scan(r, k, v, w, u), out)
