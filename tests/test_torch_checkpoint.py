"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

* Port -> port: a tree of dicts, lists, tuples and named tuples with
  bfloat16 (inf, nan, -0 among them), float32 and an int32 step round
  trips bit for bit, with its extra state; the latest step is found.
* Reference -> port: ``repro.checkpoint.save_checkpoint`` of a reduced
  smollm-360m, mixtral-8x22b, rwkv6-1.6b, hymba-1.5b (a hybrid: each
  block's ``mamba`` group) or seamless-m4t-large-v2 (an
  ``EncDecLM``: ``enc_blocks``, ``enc_norm``, ``dec_blocks`` with
  ``xattn`` and ``ln_x``) ``(params, adamw state)`` (and smollm in
  bfloat16) loads into the port's reference-layout tree
  (``params_to_reference``, ``opt_state_to_reference``), bit for bit, and
  back to the port's names.
* Port -> reference: the port's file of ``(params, opt_state)`` has the
  reference's key set and loads through ``repro.checkpoint.load_checkpoint``
  into the reference's tree, bit for bit.
* A shape that does not match raises ``ValueError``.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.checkpoint.checkpoint import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.models import build_model
from repro_torch.models.convert import (model_config_from_reference,
                                        opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference, to_tensor)
from repro_torch.optim import adamw

Pair = collections.namedtuple("Pair", "a b")
ARCHS = ["smollm-360m", "mixtral-8x22b", "rwkv6-1.6b", "hymba-1.5b",
         "seamless-m4t-large-v2"]


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))


def _tmap(fn, tree):
    """``fn`` over the tensors of a tree, keeping its structure and key
    order (``jax.tree_util`` sorts dict keys)."""
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_tmap(fn, v) for v in tree]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def _tree(gen):
    bf = (torch.randn((3, 5), generator=gen) * 1e3).to(torch.bfloat16)
    bf[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    return ({"w": bf, "blocks": {"x": torch.randn((2, 4, 3), generator=gen)}},
            [torch.tensor(7, dtype=torch.int32),
             Pair(torch.randn((4,), generator=gen),
                  torch.arange(6, dtype=torch.int32).reshape(2, 3))])


def test_port_round_trip_is_bit_exact(tmp_path):
    tree = _tree(torch.Generator().manual_seed(0))
    assert latest_step(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), 3, tree)
    path = save_checkpoint(str(tmp_path), 12, tree, extra={"step": 12})
    assert path.endswith("ckpt_00000012.npz")
    assert latest_step(str(tmp_path)) == 12
    assert not list(tmp_path.glob("*.tmp"))
    ref = _tree(torch.Generator().manual_seed(1))  # same layout, other values
    got, extra = load_checkpoint(str(tmp_path), ref)
    assert extra == {"step": 12}
    _assert_same_tree(got, tree)
    got3, extra3 = load_checkpoint(str(tmp_path), ref, step=3)
    assert extra3 is None
    _assert_same_tree(got3, tree)
    with np.load(tmp_path / "ckpt_00000012.npz") as data:
        assert sorted(data.files) == ["0/blocks/x", "1/0", "1/1/0", "1/1/1",
                                      "__bf16__0/w"]
        assert data["__bf16__0/w"].dtype == np.uint16


def test_load_from_meta_reference_and_dtype_cast(tmp_path):
    tree = _tree(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), 1, tree)
    meta = _tmap(  # meta leaves: restored on the CPU
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    got, _ = load_checkpoint(str(tmp_path), meta)
    _assert_same_tree(got, tree)
    as_f32 = ({"w": torch.zeros((3, 5)), "blocks": tree[0]["blocks"]},
              tree[1])
    got, _ = load_checkpoint(str(tmp_path), as_f32)
    assert got[0]["w"].dtype == torch.float32
    np.testing.assert_array_equal(got[0]["w"].numpy(),
                                  tree[0]["w"].float().numpy())


def test_load_rejects_a_shape_mismatch(tmp_path):
    tree = _tree(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), 1, tree)
    bad = ({"w": tree[0]["w"], "blocks": {"x": torch.zeros((2, 4, 4))}},
           tree[1])
    with pytest.raises(ValueError, match="shape mismatch for 0/blocks/x"):
        load_checkpoint(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), tree)


def _reference_state(arch, bf16=False):
    cfg = ref_get_config(arch, reduced=True)
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    if bf16:
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                        params)
    opt = ref_adamw(1e-3, weight_decay=0.1)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda a: (a * 0.5).astype(a.dtype), params)
    params, state = opt.update(grads, state, params)  # m, v, step nonzero
    return cfg, jax.tree_util.tree_map(np.asarray, (params, state))


@pytest.mark.parametrize("arch,bf16", [(a, False) for a in ARCHS]
                         + [("smollm-360m", True)])
def test_reference_checkpoint_loads_into_port(tmp_path, arch, bf16):
    cfg, (params, state) = _reference_state(arch, bf16)
    ref_save(str(tmp_path), 5, (params, state), extra={"step": 5})
    model = build_model(model_config_from_reference(cfg), device="cpu")
    port_params = {n: torch.zeros_like(t) if not bf16
                   else torch.zeros_like(t, dtype=torch.bfloat16)
                   for n, t in model.state_dict().items()}
    port_state = adamw(1e-3).init(
        {n: torch.zeros(t.shape) for n, t in port_params.items()})
    ref_tree = (params_to_reference(port_params),
                opt_state_to_reference(port_state))
    (p, o), extra = load_checkpoint(str(tmp_path), ref_tree)
    assert extra == {"step": 5}
    _assert_same_tree((p, o), (
        jax.tree_util.tree_map(to_tensor, params),
        jax.tree_util.tree_map(to_tensor, state)))
    # back to the port's names: the model and optimizer take them as they are
    model.load_state_dict(params_from_reference(p))
    named = opt_state_from_reference(o)
    assert named.keys() == port_state.keys() and named["step"] == 1
    for k in ("m", "v"):
        assert named[k].keys() == port_state[k].keys()
        want = params_from_reference(state[k])
        for n, t in named[k].items():
            assert torch.equal(t, want[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_loads_into_reference(tmp_path, arch):
    cfg, (params, state) = _reference_state(arch)
    model = build_model(model_config_from_reference(cfg), device="cpu")
    model.load_state_dict(params_from_reference(params))
    sd = {n: t.detach() for n, t in model.named_parameters()}
    opt = adamw(1e-3, weight_decay=0.1)
    port_state = opt.init(sd)
    with torch.no_grad():
        sd, port_state = opt.update({n: t * 0.5 for n, t in sd.items()},
                                    port_state, sd)
    tree = (params_to_reference(sd), opt_state_to_reference(port_state))
    path = save_checkpoint(str(tmp_path), 7, tree, extra={"step": 7})
    ref_params = ref_build_model(cfg).init(jax.random.PRNGKey(1))
    ref_tree = (ref_params, ref_adamw(1e-3).init(ref_params))
    with np.load(path) as data:
        assert set(data.files) == set(ref_flatten(ref_tree))
    (p, o), extra = ref_load(str(tmp_path), ref_tree)
    assert extra == {"step": 7} and int(o["step"]) == 1
    want = _tmap(lambda t: t.numpy(), tree)
    got = jax.tree_util.tree_map(np.asarray, (p, o))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    stack = "dec_blocks" if cfg.encoder_layers else "blocks"
    assert o["m"][stack]["ln1"].shape == (cfg.n_layers, cfg.d_model)
