"""The port's partition specs (``repro_torch.sharding``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's, on the CPU.

* For every config of the reference (the ten archs at full width, the
  one the port has not reached included), on the 1×1, 16×16 and
  2×16×16 meshes and under every entry of ``STRATEGIES``: the port's
  ``param_specs`` of the parameters and of the default optimizer's state,
  ``batch_specs`` of the train and prefill inputs and ``cache_specs`` of
  the decode caches equal ``repro.sharding``'s, leaf for leaf, on the same
  shapes (the reference's ``ShapeDtypeStruct`` trees as meta tensors).
* For the archs the port runs, ``port_param_specs`` of the port's own
  per-layer parameters (and optimizer state) is the reference's stacked
  spec without its ``L`` entry: ``blocks``, and the encoder-decoder's
  ``enc_blocks`` and ``dec_blocks``.
* ``tree_placements``, the L-dim guard, ``MeshShape`` and the meshes.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import all_archs as ref_all_archs
from repro.configs import get_config as ref_get_config
from repro.launch.steps import default_optimizer as ref_default_optimizer
from repro.models import input_specs as ref_input_specs
from repro.models import params_spec as ref_params_spec
from repro.sharding import STRATEGIES as REF_STRATEGIES
from repro.sharding import batch_specs as ref_batch_specs
from repro.sharding import cache_specs as ref_cache_specs
from repro.sharding import make_abstract_mesh
from repro.sharding import param_specs as ref_param_specs
from repro_torch.configs import all_archs, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import default_optimizer
from repro_torch.models import params_spec
from repro_torch.models.convert import torch_dtype
from repro_torch.models.common import spec_placements
from repro_torch.sharding import (STRATEGIES, MeshShape, PartitionSpec,
                                  batch_specs, cache_specs, param_specs,
                                  port_param_specs, step_placements,
                                  tree_placements)
from repro_torch.sharding.specs import _layer_spec

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _meshes(name):
    axes, sizes = MESHES[name]
    return make_abstract_mesh(sizes, axes), MeshShape(axes, sizes)


def _to_meta(tree):
    """A reference ``ShapeDtypeStruct`` tree as meta tensors, structure and
    named tuples kept."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                              device="meta"), tree)


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """(params, optimizer state, {shape: input specs}) of the reference's
    full-width ``arch``, as ShapeDtypeStructs."""
    cfg = ref_get_config(arch)
    params = ref_params_spec(cfg)
    state = jax.eval_shape(ref_default_optimizer(cfg).init, params)
    inputs = {s: ref_input_specs(cfg, s)[1]
              for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    return params, state, inputs


def _leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, (PartitionSpec,
                                               jax.sharding.PartitionSpec)))


def _assert_specs_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, PartitionSpec)
        assert tuple(g) == tuple(w), (g, w)


@pytest.mark.parametrize("strategy", list(REF_STRATEGIES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ref_all_archs())
def test_specs_match_reference(arch, mesh, strategy):
    assert STRATEGIES == REF_STRATEGIES
    ref_mesh, port_mesh = _meshes(mesh)
    skw = STRATEGIES[strategy]
    params, state, inputs = _structs(arch)
    for tree in (params, state):
        _assert_specs_equal(param_specs(_to_meta(tree), port_mesh, **skw),
                            ref_param_specs(tree, ref_mesh, **skw))
    for shape, specs in inputs.items():
        for key in ("batch", "tokens", "frames", "frontend_embeds"):
            if key in specs:
                _assert_specs_equal(batch_specs(_to_meta(specs[key]),
                                                port_mesh),
                                    ref_batch_specs(specs[key], ref_mesh))
        for key in ("cache", "enc_kv"):
            if key not in specs:
                continue
            for seq in {skw.get("seq_over_model", True), False}:
                _assert_specs_equal(
                    cache_specs(_to_meta(specs[key]), port_mesh,
                                seq_over_model=seq),
                    ref_cache_specs(specs[key], ref_mesh, seq_over_model=seq))


def _stacked(tree, name):
    node = tree
    for key in name.split("."):
        node = node[key]
    return node


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", all_archs())
def test_port_per_layer_specs_drop_the_layer_dim(arch, mesh):
    """The port's per-layer parameters and its optimizer state take the
    reference's stacked specs without the ``L`` entry (which no rule
    shards), under every strategy."""
    ref_mesh, port_mesh = _meshes(mesh)
    params, state, _ = _structs(arch)
    cfg = get_config(arch)
    port = params_spec(cfg)
    port_state = default_optimizer(cfg).init(port)
    n_layers = {"blocks": cfg.n_layers, "enc_blocks": cfg.encoder_layers,
                "dec_blocks": cfg.n_layers}
    for strategy, skw in STRATEGIES.items():
        want_p = ref_param_specs(params, ref_mesh, **skw)
        want_s = ref_param_specs(state, ref_mesh, **skw)
        got_p = port_param_specs(port, port_mesh, **skw)
        got_s = port_param_specs(port_state, port_mesh, **skw)
        assert got_p.keys() == port.keys()
        assert got_s.keys() == port_state.keys()
        for name, spec in got_p.items():
            head, _, rest = name.partition(".")
            if head in n_layers:
                i, _, leaf = rest.partition(".")
                assert int(i) < n_layers[head]
                want = _stacked(want_p[head], leaf)
                assert want[0] is None
                assert tuple(spec) == tuple(want)[1:], (strategy, name)
                for k in [k for k in got_s if k != "step"]:
                    assert tuple(got_s[k][name]) == tuple(
                        _stacked(want_s[k][head], leaf))[1:]
            else:
                assert tuple(spec) == tuple(want_p[name]), (strategy, name)
                for k in [k for k in got_s if k != "step"]:
                    assert tuple(got_s[k][name]) == tuple(want_s[k][name])
        assert tuple(got_s["step"]) == tuple(want_s["step"]) == ()


def test_mixtral_and_kimi_expert_specs():
    """Kimi (384 experts) shards E over model; Mixtral (8) falls back to
    the expert hidden dim (the reference's test_moe_expert_parallel_vs_tp),
    per layer in the port."""
    mesh = make_production_mesh()
    sk = port_param_specs(params_spec(get_config("kimi-k2-1t-a32b")), mesh)
    sm = port_param_specs(params_spec(get_config("mixtral-8x22b")), mesh)
    assert sk["blocks.0.moe.w1"][0] == "model"
    assert sm["blocks.0.moe.w1"] == PartitionSpec(None, "data", "model")


def test_tree_placements():
    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    specs = {"a": PartitionSpec(("pod", "data"), None, "model"),
             "b": [PartitionSpec(), PartitionSpec(None, "data")]}
    pl = tree_placements(specs, mesh)
    assert pl["a"] == (Shard(0), Shard(0), Shard(2))
    assert pl["b"][0] == (Replicate(),) * 3
    assert pl["b"][1] == (Replicate(), Shard(1), Replicate())
    host = MeshShape(("data", "model"), (1, 1))
    params = params_spec(get_config("smollm-360m"))
    assert all(p == (Replicate(), Replicate()) for p in tree_placements(
        port_param_specs(params, host), host).values())


@pytest.mark.parametrize("strategy", list(REF_STRATEGIES))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b",
                                  "llava-next-34b", "seamless-m4t-large-v2",
                                  "hymba-1.5b"])
def test_step_placements_are_the_reference_specs(arch, strategy):
    """The in- and out-placements of each step kind: the parameters and
    the optimizer state under the strategy's specs, the tokens and the
    batch under the reference's ``batch_specs``, the cache under its
    ``cache_specs`` (the sequence over ``model`` unless the strategy says
    otherwise; a hybrid's (KVCache, MambaState)), the logits and the loss
    replicated; a vlm's ``frontend_embeds`` and an encoder-decoder's
    ``frames`` under ``batch_specs`` (the reference's dry run,
    ``src/repro/launch/dryrun.py:148``), its ``enc_kv`` under
    ``cache_specs`` without the sequence over ``model`` (:171), in
    decode and out of its prefill."""
    ref_mesh, mesh = _meshes("16x16")
    skw = STRATEGIES[strategy]
    inputs = _structs(arch)[2]
    pp = params_spec(get_config(arch))
    ps = default_optimizer(get_config(arch)).init(pp)
    tokens = inputs["decode_32k"]["tokens"]
    cache = inputs["decode_32k"]["cache"]
    batch = inputs["train_4k"]["batch"]

    def ref(spec_tree):
        return [spec_placements(s, mesh) for s in _leaves(spec_tree)]

    def got(tree):
        return jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(p, (Shard, Replicate)) for p in x))

    rep = (Replicate(), Replicate())
    want_params = tree_placements(port_param_specs(pp, mesh, **skw), mesh)
    want_cache = ref(ref_cache_specs(cache, ref_mesh, seq_over_model=skw.get(
        "seq_over_model", True)))
    want_tokens = ref(ref_batch_specs(tokens, ref_mesh))
    train = step_placements("train", mesh, strategy, params=pp,
                            opt_state=ps, batch=_to_meta(batch))
    assert train["in"][0] == want_params == train["out"][0]
    assert train["in"][1] == tree_placements(
        port_param_specs(ps, mesh, **skw), mesh) == train["out"][1]
    assert got(train["in"][2]) == ref(ref_batch_specs(batch, ref_mesh))
    assert train["out"][2] == rep
    prefill = step_placements("prefill", mesh, strategy, params=pp,
                              tokens=_to_meta(tokens), cache=_to_meta(cache))
    decode = step_placements("decode", mesh, strategy, params=pp,
                             tokens=_to_meta(tokens), cache=_to_meta(cache))
    assert prefill["in"][0] == decode["in"][0] == want_params
    assert [prefill["in"][1]] == [decode["in"][2]] == want_tokens
    assert got(prefill["out"][1]) == got(decode["in"][1]) == \
        got(decode["out"][1]) == want_cache
    assert prefill["out"][0] == decode["out"][0] == rep
    # an argument left out has None in its places
    assert step_placements("decode", mesh, strategy,
                           cache=_to_meta(cache))["in"][0::2] == (None, None)
    pre = inputs["prefill_32k"]
    if "frontend_embeds" in pre:
        vlm = step_placements("prefill", mesh, strategy,
                              tokens=_to_meta(pre["tokens"]),
                              frontend_embeds=_to_meta(pre["frontend_embeds"]))
        assert [vlm["in"][1]] == ref(ref_batch_specs(pre["tokens"], ref_mesh))
        assert [vlm["in"][2]] == ref(ref_batch_specs(pre["frontend_embeds"],
                                                     ref_mesh))
    else:
        assert prefill["in"][2] is None
    if "frames" not in pre:
        assert decode["in"][3] is None
        return
    enc_kv = inputs["decode_32k"]["enc_kv"]
    want_kv = ref(ref_cache_specs(enc_kv, ref_mesh))  # "batch only"
    enc = step_placements("prefill", mesh, strategy, params=pp,
                          frames=_to_meta(pre["frames"]),
                          enc_kv=_to_meta(enc_kv))
    assert enc["in"][0] == want_params
    assert [enc["in"][1]] == ref(ref_batch_specs(pre["frames"], ref_mesh))
    assert got(enc["out"]) == want_kv
    assert got(step_placements("decode", mesh, strategy, cache=_to_meta(cache),
                               enc_kv=_to_meta(enc_kv))["in"][3]) == want_kv


def test_layer_dim_is_never_sharded():
    assert _layer_spec(PartitionSpec(None, "data", "model"), 3) == \
        PartitionSpec("data", "model")
    assert _layer_spec(PartitionSpec("model", None), None) == \
        PartitionSpec("model", None)
    with pytest.raises(AssertionError, match="layer dim"):
        _layer_spec(PartitionSpec("data", None), 0)


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single == MeshShape(("data", "model"), (16, 16))
    assert single.size == 256 and single.shape == {"data": 16, "model": 16}
    assert multi == MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert multi.size == 512
    assert np.prod(list(multi.shape.values())) == 512
