"""Common building blocks of the PyTorch model stack.

A copy of ``repro/models/common.py`` with torch dtypes and tensors in place
of jnp ones. The layers are plain functions of tensors; the parameters of
a model live in its ``nn.Module`` (:mod:`.transformer`), with the
reference's shapes, so that its weights carry across as a plain copy.

On a mesh (:func:`use_mesh`, the counterpart of JAX's ``with mesh``)
the parameters and activations are DTensors, and :func:`maybe_shard`
redistributes an activation to the placements the reference's
``with_sharding_constraint`` pins there. Without a mesh it returns its
input: the one-device route does not change.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._shards import is_dtensor


class Yarn(NamedTuple):
    """YaRN's rope scaling (``rope_scaling`` of type ``yarn``): the
    frequencies past the correction range divided by ``factor``, a ramp
    between, and the softmax scale multiplied by ``mscale(mscale_all_dim)``
    squared (:func:`yarn_freqs`, :func:`yarn_softmax_scale`)."""

    factor: float
    original_max: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention variant: 'full' or 'swa' (sliding window)
    attn_variant: str = "full"
    window: int = 4096

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # router: softmax over the experts, or sigmoid scores whose top_k (by
    # score + a selection-only bias, the layer's ``router_bias``) are
    # normalised to sum to 1 and scaled by ``routed_scale`` (DeepSeek-V3's
    # noaux_tc)
    router_score: str = "softmax"
    routed_scale: float = 1.0
    # the expert-parallel share a layer holds: experts [experts_first,
    # experts_first + experts_held) of the n_experts it routes over
    # (0: all of them)
    experts_held: int = 0
    experts_first: int = 0
    # leading dense SwiGLU layers (width d_ff) before the expert layers
    first_dense_layers: int = 0

    # latent attention (MLA) where kv_lora_rank > 0: d_head is then the
    # rope-free part of a q/k head, qk_rope_dim its rope part (one key a
    # token, shared by the heads), v_head_dim a value head's width
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    rope_yarn: Optional[Yarn] = None

    # KV-cache storage dtype for decode: None -> activation dtype;
    # torch.float8_e4m3fn halves cache bytes
    cache_dtype: Any = None

    # MoE dispatch: 'grouped' or 'flat' (see the reference's moe.py)
    moe_dispatch: str = "grouped"

    # SSM (rwkv6 / mamba branch)
    ssm_state: int = 0

    # hybrid: parallel attention and Mamba heads
    hybrid: bool = False

    # enc-dec
    encoder_layers: int = 0  # >0 -> encoder-decoder model
    encoder_window: int = 0  # local attention window for the (audio) encoder

    # vlm / audio frontend stub: number of embedding positions provided
    # directly as dense vectors instead of token ids
    n_frontend_embeds: int = 0

    # physical head counts (logical heads keep the exact numbers above;
    # padding heads are masked to zero contribution)
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0

    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.float32       # activation dtype
    param_dtype: Any = torch.float32
    tie_embeddings: bool = False

    # citation for the source model card / paper
    source: str = ""

    # physical vocab rows (0 -> auto: vocab rounded up to a multiple of 64
    # when not already divisible by 16; padded columns are masked)
    vocab_padded: int = 0

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        if self.vocab_padded == 0:
            vp = self.vocab if self.vocab % 16 == 0 else -(-self.vocab // 64) * 64
            object.__setattr__(self, "vocab_padded", vp)
        if self.n_heads_padded == 0:
            object.__setattr__(self, "n_heads_padded", self.n_heads)
        if self.n_kv_heads_padded == 0:
            object.__setattr__(self, "n_kv_heads_padded", self.n_kv_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def n_held(self) -> int:
        """The experts a layer holds and computes."""
        return self.experts_held or self.n_experts

    def has_experts(self, layer: int) -> bool:
        """Whether layer ``layer`` is an expert layer (past the leading
        dense ones)."""
        return self.n_experts > 0 and layer >= self.first_dense_layers

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND model-flops accounting)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.family != "ssm":
            H, KV, dh = self.n_heads_padded, self.n_kv_heads_padded, self.d_head
            per_layer += d * H * dh + 2 * d * KV * dh + H * dh * d
        if self.family == "ssm":
            # rwkv6: r,k,v,g,o projections + decay lora + channel mix
            per_layer += 5 * d * d + 3 * d * self.d_ff
        elif self.hybrid:
            per_layer += 4 * d * d  # mamba branch in/out/gate/dt
            per_layer += 3 * d * self.d_ff
        if self.n_experts > 0:
            per_layer += d * self.n_experts  # router
            per_layer += 3 * self.n_experts * d * self.moe_d_ff
            per_layer += 3 * self.n_shared_experts * d * self.moe_d_ff
        elif self.family != "ssm":
            per_layer += 3 * d * self.d_ff
        per_layer += 2 * d  # norms
        n += self.n_layers * per_layer
        if self.encoder_layers:
            enc_layer = 4 * d * d + 3 * d * self.d_ff + 2 * d
            n += self.encoder_layers * enc_layer
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        expert_p = 3 * self.n_experts * self.d_model * self.moe_d_ff * self.n_layers
        active_e = 3 * (self.top_k + self.n_shared_experts) * self.d_model * self.moe_d_ff * self.n_layers
        return full - expert_p + active_e


# ---------------------------------------------------------------------------
# initializers (seeded by an explicit generator; the numbers differ from
# jax.random's for the same seed, so parity tests carry weights across with
# repro_torch.models.convert instead)


def _normal(gen: torch.Generator, shape, scale, dtype):
    # scaled in place: one float32 copy of the weight at a time (kimi-k2's
    # [384, 7168, 2048] experts are 21 GiB in float32)
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return x.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in, shape, dtype):
    """Normal fan-in init, scale 1/sqrt(d_in)."""
    return _normal(gen, shape, 1.0 / math.sqrt(d_in), dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype):
    return _normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# primitive layers


def rmsnorm(x, gamma, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def swiglu(x, w1, w3, w2):
    """SwiGLU MLP: silu(x@w1) * (x@w3) @ w2."""
    h = F.silu(x @ w1) * (x @ w3)
    h = maybe_shard(h, *((BATCH_AXES,) + (None,) * (h.ndim - 2) + ("model",)))
    return summed(h @ w2)


def rope_freqs(d_head: int, theta: float):
    """Rotary frequencies in float64 NumPy, as the reference computes them."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(d_rope: int, theta: float, y: Yarn):
    """YaRN's rotary frequencies in float64 NumPy (DeepSeek-V3's
    ``DeepseekV3YarnRotaryEmbedding``): frequency ``i`` is
    ``theta^(-2i/d)``, divided by ``factor`` past the correction range
    [floor(c(beta_fast)), ceil(c(beta_slow))] of
    ``c(b) = d ln(original_max / (2 pi b)) / (2 ln theta)``, linearly
    between; and the factor on cos and sin, ``mscale(mscale) /
    mscale(mscale_all_dim)``."""
    def corr(b):
        return d_rope * math.log(y.original_max / (b * 2 * math.pi)) / (
            2 * math.log(theta))
    lo = max(math.floor(corr(y.beta_fast)), 0)
    hi = min(math.ceil(corr(y.beta_slow)), d_rope - 1)
    if lo == hi:
        hi += 0.001
    extra = rope_freqs(d_rope, theta)
    ramp = np.clip((np.arange(d_rope // 2) - lo) / (hi - lo), 0.0, 1.0)
    keep = 1.0 - ramp  # 1: the frequency as it is, 0: divided by factor
    freqs = extra / y.factor * (1.0 - keep) + extra * keep
    return freqs, (_yarn_mscale(y.factor, y.mscale)
                   / _yarn_mscale(y.factor, y.mscale_all_dim))


def yarn_softmax_scale(d_qk: int, y: Optional[Yarn]) -> float:
    """Attention's softmax scale: ``d_qk^-0.5``, times
    ``mscale(mscale_all_dim)^2`` under YaRN where ``mscale_all_dim`` is
    set."""
    s = d_qk ** -0.5
    if y is not None and y.mscale_all_dim:
        s *= _yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return s


def apply_rope(x, positions, theta, yarn: Optional[Yarn] = None):
    """x: [..., S, H, dh]; positions: [..., S] integer. Split-half rotation;
    ``yarn`` scales the frequencies and cos / sin (:func:`yarn_freqs`)."""
    dh = x.shape[-1]
    if yarn is None:
        f, m = rope_freqs(dh, theta), 1.0
    else:
        f, m = yarn_freqs(dh, theta, yarn)
    freqs = torch.as_tensor(f.astype(np.float32), device=x.device)
    ang = positions[..., None].float() * freqs  # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    if m != 1.0:
        cos, sin = cos * m, sin * m
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def vocab_mask(cfg: ModelConfig, device=None) -> Optional[torch.Tensor]:
    """Static additive mask (-1e30 on padded vocab columns), or None."""
    if cfg.vocab_padded == cfg.vocab:
        return None
    m = torch.zeros((cfg.vocab_padded,), dtype=torch.float32, device=device)
    m[cfg.vocab:] = -1e30
    return m


def head_mask(cfg: ModelConfig, device=None) -> Optional[torch.Tensor]:
    """Static 0/1 mask zeroing the padded attention heads, or None.

    Padded heads keep the reference's physical head counts; masking their
    outputs keeps the math identical to the logical architecture.
    """
    if cfg.n_heads_padded == cfg.n_heads:
        return None
    m = torch.zeros((cfg.n_heads_padded,), dtype=torch.float32, device=device)
    m[: cfg.n_heads] = 1.0
    return m


# ---------------------------------------------------------------------------
# activation sharding constraints
#
# The reference pins activation shardings explicitly (GSPMD alone
# replicated the attention and FFN inner dims on the model axis); a pin
# applies only under an ambient mesh with the named axes, so the same model
# code runs unsharded on one device.

BATCH_AXES = "__batch__"  # role: ('pod','data') when pod exists, else 'data'

# the meshes of the open use_mesh scopes, innermost last: process-wide, not
# per thread, since autograd runs a CUDA backward (and remat's
# recomputation in it) on a thread of its own
_MESHES = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model on ``mesh`` (a ``DeviceMesh`` with named dims, or
    ``None``: no mesh, the one-device route). Under it, plain tensors that
    meet DTensors (positions, masks, freshly made buffers) count as
    replicated."""
    if mesh is None:
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def _ambient_mesh():
    """The mesh of the innermost :func:`use_mesh`, or ``None``."""
    return _MESHES[-1] if _MESHES else None


def spec_placements(spec, mesh):
    """A spec (one entry per dim: ``None``, an axis name or a tuple of
    them) as DTensor placements on ``mesh``, one per mesh dim: ``Shard(d)``
    where dim ``d``'s entry names that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if axis == e or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def mesh_axis_names(mesh):
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def constraint_spec(shape, entries, mesh):
    """The reference's ``maybe_shard`` rules: ``BATCH_AXES`` is ('pod',
    'data') or 'data', an axis the mesh lacks is skipped, and a dim is
    sharded only where its size divides the axes' product."""
    names = mesh_axis_names(mesh)
    sizes = dict(zip(names, tuple(mesh.shape)))
    spec = []
    for d, entry in enumerate(entries):
        if entry == BATCH_AXES:
            entry = tuple(a for a in ("pod", "data") if a in names) or None
        if entry is None:
            spec.append(None)
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple)
                                 else (entry,)) if a in names)
        size = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if size <= 1 or shape[d] % size != 0:
            spec.append(None)
        else:
            spec.append(axes if len(axes) > 1 else axes[0])
    return tuple(spec)


def as_dtensor(x, mesh):
    """``x`` as a DTensor of ``mesh``: a plain tensor counts as
    replicated, as under ``use_mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def maybe_shard(x, *entries):
    """The reference's ``with_sharding_constraint`` guarded by an ambient
    mesh, the axis names it has and the divisibility of each dim: on a
    mesh, ``x`` redistributed to the placements of ``entries`` (a ``None``
    entry, or one that does not apply, replicates that dim); without one,
    ``x`` itself."""
    mesh = _ambient_mesh()
    if mesh is None or x is None:
        return x
    spec = constraint_spec(x.shape, entries, mesh)
    return as_dtensor(x, mesh).redistribute(mesh, spec_placements(spec, mesh))


def _sum_partial(t):
    """DTensor ``t`` redistributed to ``Replicate`` on the mesh dims where
    it is a partial sum."""
    if not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


class _Summed(torch.autograd.Function):
    """The identity of a DTensor, summed where it is a partial sum, and its
    gradient too (DTensor's own redistribute passes a gradient that comes
    back as a partial sum on unsummed)."""

    @staticmethod
    def forward(ctx, y):
        return _sum_partial(y)

    @staticmethod
    def backward(ctx, g):
        return _sum_partial(g)


def summed(y):
    """``y``, the output of a product whose contracted dim is split over
    ``model`` (an output projection: attention's ``wo``, the FFN's ``w2``),
    summed where it is a partial sum over a mesh dim (redistributed to
    ``Replicate`` there), as the reference's partitioner sums it, in the
    forward pass and the backward alike. DTensor left alone keeps such
    sums pending, and then does a product of them whole on every rank:
    with a residual stream that is a partial sum it gathers the next
    projections' weights (torch 2.13 plans so in an encoder's blocks),
    with a gradient that is one the backward products of this projection
    (torch 2.11). Without a mesh, ``y`` itself."""
    return _Summed.apply(y) if is_dtensor(y) else y


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level cross entropy. logits [..., V] cast to float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())
    nll = (logz[..., None] - gold)[..., 0]
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
