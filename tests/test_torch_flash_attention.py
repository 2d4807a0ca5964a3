"""K3 of the port (``repro_torch.kernels.flash_attention``) against the
reference.

The same inputs, made from a seed with NumPy (bfloat16 ones cast with
``ml_dtypes`` and carried across bit for bit), go through:

* the JAX package's Pallas kernel, in interpreter mode as its own tests
  run it (tests/test_kernels.py), at the shapes of those tests: MHA, GQA
  2:1 and 4:1 in float32 and bfloat16, sliding windows 32/64/128 and
  non-causal; and at the head dims those tests do not reach, 112
  (kimi-k2) and 32 (seamless reduced), causal and windowed;
* the JAX package's oracle ``ref.flash_attention_ref`` at shapes the
  Pallas launcher does not take: a ragged S and S < Sk.

Tolerances are the reference's own (tests/test_kernels.py): 2e-4 in
float32, 5e-2 in bfloat16. On the CPU the port's wrapper runs its plain
PyTorch version (the tensors lie on the CPU); the kernel itself is held
to that plain version by the ``cuda``-marked tests, which skip on a host
without a CUDA device; one of them at latent attention's q/k 192 against
v 128 in bfloat16, with q, k and v laid out as the model passes them.
Both compute in float32, so those tests are tighter: atol 1e-4 + rtol
1e-2 in bfloat16 (one output rounding step), 1e-5 in float32.
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
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.convert import to_tensor


def _tol(dtype):
    return (dict(atol=5e-2, rtol=5e-2) if dtype == jnp.bfloat16
            else dict(atol=2e-4, rtol=2e-4))


def _qkv(seed, B, H, KV, S, Sk, dh, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, dh), dtype=np.float32)
    k = rng.standard_normal((B, KV, Sk, dh), dtype=np.float32)
    v = rng.standard_normal((B, KV, Sk, dh), dtype=np.float32)
    return tuple(a.astype(dtype) for a in (q, k, v))


def _port(q, k, v, **kw):
    out = fa.flash_attention(to_tensor(q), to_tensor(k), to_tensor(v), **kw)
    return out.float().numpy()


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,dh,bq,bk", [
    (1, 2, 2, 128, 64, 64, 64),    # MHA
    (2, 4, 2, 256, 64, 128, 128),  # GQA 2:1
    (1, 8, 2, 128, 128, 64, 32),   # GQA 4:1, uneven blocks
])
def test_plain_matches_pallas_causal(B, H, KV, S, dh, bq, bk, dtype):
    q, k, v = _qkv(0, B, H, KV, S, S, dh, dtype)
    want = ref_ops.flash_attention(q, k, v, causal=True, block_q=bq,
                                   block_k=bk, interpret=True)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _f32(want), **_tol(dtype))


@pytest.mark.parametrize("window", [32, 64, 128])
def test_plain_matches_pallas_sliding_window(window):
    q, k, v = _qkv(1, 1, 2, 2, 256, 256, 64)
    want = ref_ops.flash_attention(q, k, v, causal=True, window=window,
                                   block_q=64, block_k=64, interpret=True)
    got = _port(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, _f32(want), atol=2e-4, rtol=2e-4)
    # the window changes the result against full causal attention
    full = _port(q, k, v, causal=True, window=0)
    assert np.max(np.abs(full - got)) > 1e-3


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("dh,window", [(112, 0), (112, 64), (32, 0), (32, 64)])
def test_plain_matches_pallas_head_dims_112_and_32(dh, window, dtype):
    q, k, v = _qkv(6, 1, 8, 2, 256, 256, dh, dtype)  # GQA 4:1
    want = ref_ops.flash_attention(q, k, v, causal=True, window=window,
                                   block_q=64, block_k=64, interpret=True)
    got = _port(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, _f32(want), **_tol(dtype))


def test_head_dims_cover_every_config():
    # the kernel takes every d_head of the reference's configs, full and
    # reduced, as the Pallas kernel (whose blocks span dh whole) does
    from repro.configs import all_archs, get_config
    dims = {get_config(a, reduced).d_head for a in all_archs()
            for reduced in (False, True)}
    assert dims <= set(fa.HEAD_DIMS), sorted(dims - set(fa.HEAD_DIMS))


def test_plain_matches_pallas_noncausal():
    q, k, v = _qkv(2, 1, 2, 2, 128, 128, 64)
    want = ref_ops.flash_attention(q, k, v, causal=False, block_q=64,
                                   block_k=64, interpret=True)
    got = _port(q, k, v, causal=False)
    np.testing.assert_allclose(got, _f32(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,Sk,dh,window", [
    (2, 4, 2, 100, 100, 64, 0),    # ragged S = Sk
    (1, 8, 2, 37, 160, 128, 0),    # S < Sk: queries aligned to the end
    (1, 4, 4, 50, 130, 80, 48),    # S < Sk with a window, dh 80
])
def test_plain_matches_oracle_ragged(B, H, KV, S, Sk, dh, window, dtype):
    q, k, v = _qkv(3, B, H, KV, S, Sk, dh, dtype)
    g = H // KV
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.repeat(k, g, axis=1),
                                   jnp.repeat(v, g, axis=1), causal=True,
                                   window=window)
    got = _port(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, _f32(want), **_tol(dtype))


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    q, k, v = (to_tensor(a) for a in _qkv(4, 1, 4, 2, 33, 33, 64))
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True, window=8)
    assert fa.flash_attention.launches == n0
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(
        out, fa.flash_attention_plain(q, k, v, causal=True, window=8),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :1], v, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :3], k, v, causal=True)


def test_each_source_has_its_own_hash_keyed_library(tmp_path):
    srcs = _build.all_sources()
    assert {p.name for p in srcs} >= {"counter_hash.cu", "flash_attention.cu"}
    libs = [_build.library_path(p) for p in srcs]
    assert len(set(libs)) == len(libs)
    assert all(lib.parent == _build.BUILD_DIR for lib in libs)
    src = tmp_path / "kern.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    src.write_text("// two\n")
    assert first.name.startswith("kern_") and _build.library_path(src) != first


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,Sk,dh,causal,window", [
    (2, 32, 8, 256, 256, 128, True, 0),     # llama3.2-3b grouping
    (2, 16, 8, 200, 200, 64, True, 0),      # GQA 2:1, ragged
    (1, 8, 8, 130, 130, 80, True, 64),      # dh 80, window
    (1, 8, 2, 70, 300, 128, True, 0),       # S < Sk
    (1, 4, 2, 96, 160, 64, False, 0),       # non-causal
    (1, 4, 2, 33, 77, 80, False, 0),        # non-causal, ragged
    (1, 4, 2, 1, 1, 64, True, 0),           # one query, one key
    (2, 8, 8, 200, 200, 112, True, 0),      # dh 112, ragged
    (1, 64, 8, 256, 256, 112, True, 0),     # kimi-k2 grouping, 8:1
    (2, 4, 4, 300, 300, 32, True, 0),       # dh 32
    (1, 4, 2, 70, 300, 32, True, 64),       # dh 32, S < Sk, window
    (1, 64, 8, 704, 704, 128, True, 0),     # llava-next-34b grouping, ragged
    (2, 16, 16, 1100, 1100, 64, True, 256),  # seamless's encoder, windowed
    (1, 32, 8, 1100, 1100, 64, True, 256),  # hymba-1.5b grouping 4:1, windowed
])
def test_kernel_matches_plain_on_card(B, H, KV, S, Sk, dh, causal, window,
                                      dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    q, k, v = (to_tensor(a).to(dev, dtype)
               for a in _qkv(5, B, H, KV, S, Sk, dh))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    # both compute in float32 (summation order aside); a bf16 output then
    # differs by at most one rounding step, 2^-7 of the value
    tol = (dict(atol=1e-4, rtol=1e-2) if dtype == torch.bfloat16
           else dict(atol=1e-5, rtol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,Sk,causal", [
    (1, 64, 64, 512, 512, True),     # Kimi-K2's 64 heads, MLA's KV = H
    (2, 8, 8, 300, 300, True),       # ragged S
    (1, 8, 8, 70, 300, True),        # S < Sk
    (1, 16, 4, 256, 256, True),      # grouped, 4:1
    (2, 8, 8, 200, 333, False),      # non-causal, ragged
    (1, 4, 4, 1, 1, True),           # one query, one key
])
def test_kernel_at_qk_192_v_128_matches_plain_on_card(B, H, KV, S, Sk,
                                                     causal):
    """As ``models.attention.mla_train`` passes them: q [B, S, H, 192]
    and k = [k_nope | the one k_pe broadcast] made whole, v a view of
    the [k_nope | v] product's last 128 columns, all seen as [B, H, S,
    .] through a transpose; the scale YaRN's, 0.1308608."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn(B, S, H, 192, generator=g, device=dev).bfloat16()
    kv = torch.randn(B, Sk, KV, 256, generator=g, device=dev).bfloat16()
    pe = torch.randn(B, Sk, 1, 64, generator=g, device=dev).bfloat16()
    k = torch.cat([kv[..., :128], pe.expand(B, Sk, KV, 64)], dim=-1)
    v = kv[..., 128:]
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(*args, causal=causal, scale=0.1308608)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    assert got.shape == (B, H, S, 128)
    want = fa.flash_attention_plain(*args, causal=causal, scale=0.1308608)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=1e-2)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(*(t.float() for t in args), causal=causal)
