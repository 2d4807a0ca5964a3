"""The port's counterparts of the reference's smaller entry points, each
against the reference on the CPU:

* ``repro_torch.backend.register_backend``: a registered factory's name
  is listed and resolves to one singleton, as in ``repro.backend``; an
  unknown name raises ``KeyError`` in both;
* ``repro_torch.configs.paper_model``: the paper's three models by the
  reference's names, with its keyword arguments, the same parameter
  counts (the reference's trees carried across, ``convert``);
* ``unroll`` in ``build_model`` and the step factories: accepted, and
  the same values as without it (the port's layers are a Python loop),
  which equal the reference's with ``unroll=True``;
* ``repro_torch.launch.serve``: the deprecated alias of the inference
  demo, with the reference's ``DeprecationWarning``;
* ``repro_torch.sharding.make_abstract_mesh``: the reference's axis names
  and sizes, and the production meshes built with it.
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.backend as ref_backend
from repro.configs import get_config as ref_get_config
from repro.configs import paper_model as ref_paper_model
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro_torch import backend
from repro_torch.configs import paper_model
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.convert import (model_config_from_reference,
                                        paper_params_from_reference,
                                        params_from_reference)

TOL = dict(atol=1e-5, rtol=1e-5)


def test_register_backend_as_reference():
    made = []

    def factory(pkg):
        def make():
            made.append(pkg)
            return pkg.NumpyBackend()
        return make

    for pkg in (ref_backend, backend):
        pkg.register_backend("Counterpart-Test", factory(pkg))
        assert "counterpart-test" in pkg.available_backends()
        first = pkg.get_backend("counterpart-test")
        assert pkg.get_backend("COUNTERPART-TEST") is first
        assert isinstance(first, pkg.NumpyBackend)
        with pytest.raises(KeyError):
            pkg.get_backend("no-such-backend")
    assert made == [ref_backend, backend]


@pytest.mark.parametrize("name, kw", [
    ("shakespeare-lstm", dict(hidden=16, layers=2)),
    ("kwt1", dict(d=32, layers=2, mlp=64, n_patches=10)),
    ("convnet", dict(channels=(4, 8, 16), hw=16))])
def test_paper_model_as_reference(name, kw):
    ref = ref_paper_model(name, **kw)
    port = paper_model(name, device="cpu", **kw)
    assert type(port).__name__ == type(ref).__name__
    tree = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    sd = paper_params_from_reference(port, tree)
    port.load_state_dict(sd)
    assert sum(t.numel() for t in port.state_dict().values()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(tree))
    with pytest.raises(KeyError):
        paper_model("no-such-model")


def test_unroll_is_accepted_and_changes_nothing():
    cfg = ref_get_config("smollm-360m", reduced=True)
    ref = ref_build_model(cfg, unroll=True)
    params = ref.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    want = ref.logits_fn(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    port_cfg = model_config_from_reference(cfg)
    sd = params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    got = {}
    for unroll in (False, True):
        model = build_model(port_cfg, use_kernels=False, device="cpu",
                            unroll=unroll)
        model.load_state_dict(sd)
        got[unroll] = model.logits_fn({"tokens": torch.from_numpy(tokens)})
    assert torch.equal(got[False], got[True])
    np.testing.assert_allclose(got[True].detach().numpy(), np.asarray(want),
                               **TOL)
    _, ref_step = ref_steps.make_prefill_step(cfg, "prefill_32k", unroll=True)
    model, prefill = steps.make_prefill_step(port_cfg, "prefill_32k",
                                             device="cpu", unroll=True)
    model.load_state_dict(sd)
    want, _ = ref_step(params, jnp.asarray(tokens, jnp.int32))
    got, _ = prefill(torch.from_numpy(tokens), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    steps.make_decode_step(port_cfg, "decode_32k", device="meta",
                           unroll=True)
    steps.make_train_step(port_cfg, device="meta", unroll=True)


def test_serve_is_the_deprecated_demo_as_reference():
    for name in ("repro.launch.serve", "repro_torch.launch.serve"):
        sys.modules.pop(name, None)
        with pytest.warns(DeprecationWarning, match="inference_demo"):
            mod = importlib.import_module(name)
        demo = importlib.import_module(
            name.replace(".serve", ".inference_demo"))
        assert mod.main is demo.main


@pytest.mark.parametrize("sizes, axes", [((16, 16), ("data", "model")),
                                         ((2, 16, 16),
                                          ("pod", "data", "model"))])
def test_make_abstract_mesh_as_reference(sizes, axes):
    from repro.sharding import make_abstract_mesh as ref_make
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import make_abstract_mesh
    ref, port = ref_make(sizes, axes), make_abstract_mesh(sizes, axes)
    assert dict(ref.shape) == port.shape
    assert tuple(ref.axis_names) == port.axis_names
    assert make_production_mesh(multi_pod=len(sizes) == 3) == port
