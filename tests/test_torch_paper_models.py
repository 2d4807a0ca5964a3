"""The port's paper models (``repro_torch.models.paper_models``: LSTM,
KWT-1, ConvNet) against the JAX package's, on the CPU.

The reference's own weights (``init`` from a PRNG key) carry across with
``paper_params_from_reference``, and the batches are made from a seed with
NumPy, so both sides compute on the same numbers. ``logits_fn``, ``loss``
and the gradient of every parameter (``jax.value_and_grad`` of the
reference's ``loss``) must agree within ``MODEL_TOL`` = 1e-5 of the
largest value of each: both compute in float32 and differ in summation
order only (about 1e-6 here, the LSTM's 19 recurrent steps included).
Small sizes: LSTM vocab 30, hidden 32, 19 steps; KWT d 32, 2 layers, 2
heads, 8 patches; ConvNet channels (8, 16), hw 8. Then the shapes of
every parameter at the published widths against the reference's
(``jax.eval_shape``; the port's on the meta device), the init laws, the
default device, and the reference's own smoke cases
(tests/test_arch_smoke.py) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import paper_models as RP
from repro_torch.models import ConvNet, KWTModel, LSTMModel
from repro_torch.models.convert import (_flatten,
                                        paper_params_from_reference)

MODEL_TOL = 1e-5


def _lstm_batch(rng):
    toks = rng.integers(0, 30, (4, 20)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _kwt_batch(rng):
    return {"mfcc": rng.normal(size=(4, 8, 40)).astype(np.float32),
            "labels": rng.integers(0, 10, 4)}


def _conv_batch(rng):
    return {"image": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, 4)}


# name -> (reference model, port model class and kwargs, batch maker)
SMALL = {
    "lstm": (lambda: RP.LSTMModel(vocab=30, embed=8, hidden=32, layers=2),
             (LSTMModel, dict(vocab=30, embed=8, hidden=32, layers=2)),
             _lstm_batch),
    "lstm_masked": (lambda: RP.LSTMModel(vocab=30, embed=8, hidden=32),
                    (LSTMModel, dict(vocab=30, embed=8, hidden=32)),
                    lambda rng: dict(_lstm_batch(rng), mask=(
                        rng.random((4, 19)) < 0.7).astype(np.float32))),
    "kwt": (lambda: RP.KWTModel(n_classes=10, d=32, layers=2, heads=2,
                                mlp=64, n_patches=8),
            (KWTModel, dict(n_classes=10, d=32, layers=2, heads=2, mlp=64,
                            n_patches=8)),
            _kwt_batch),
    "convnet": (lambda: RP.ConvNet(n_classes=10, channels=(8, 16), hw=8),
                (ConvNet, dict(n_classes=10, channels=(8, 16), hw=8)),
                _conv_batch),
    "convnet_odd_hw": (lambda: RP.ConvNet(n_classes=5, channels=(4,), hw=9),
                       (ConvNet, dict(n_classes=5, channels=(4,), hw=9)),
                       lambda rng: {"image": rng.normal(size=(3, 9, 9, 3))
                                    .astype(np.float32),
                                    "labels": rng.integers(0, 5, 3)}),
}
FULL = {  # the published widths (the reference's defaults)
    "lstm": (RP.LSTMModel, LSTMModel),
    "kwt": (RP.KWTModel, KWTModel),
    "convnet": (RP.ConvNet, ConvNet),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, seed=0):
    """(reference model, its weights as NumPy, port model on the CPU with
    the same weights)."""
    make_ref, (cls, kw), _ = SMALL[name]
    ref = make_ref()
    tree = _np_tree(ref.init(jax.random.PRNGKey(seed)))
    port = cls(**kw, device="cpu")
    port.load_state_dict(paper_params_from_reference(port, tree))
    return ref, tree, port


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= MODEL_TOL, f"{what}: {err:.3g} of the largest value"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_logits_loss_and_gradients_match_reference(name):
    ref, tree, port = _pair(name)
    batch = SMALL[name][2](np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    _close(port.logits_fn(tb), ref.logits_fn(jparams, jb), "logits")
    want, want_g = jax.value_and_grad(ref.loss)(jparams, jb)
    got = port.loss(tb)
    got.backward()
    _close(got.reshape(1), np.asarray(want).reshape(1), "loss")
    want_g = dict(_flatten(_np_tree(want_g)))
    assert set(want_g) == {n for n, _ in port.named_parameters()}
    for n, p in port.named_parameters():
        _close(p.grad, want_g[n], f"grad {n}")


@pytest.mark.parametrize("name", sorted(FULL))
def test_published_widths_match_reference(name):
    """Every parameter at the published widths (the ``__init__``
    defaults) has the reference's name and shape, float32: nothing is
    allocated on either side."""
    ref_cls, cls = FULL[name]
    tree = jax.eval_shape(ref_cls().init, jax.random.PRNGKey(0))
    want = {n: (tuple(a.shape), str(a.dtype)) for n, a in _flatten(tree)}
    model = cls(device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for n, p in model.named_parameters()}
    assert got == want


def test_published_widths():
    lstm, kwt, conv = LSTMModel(device="meta"), KWTModel(device="meta"), \
        ConvNet(device="meta")
    assert (lstm.vocab, lstm.d_embed, lstm.hidden, lstm.layers) == \
        (90, 8, 100, 2)
    assert (kwt.layers, kwt.d, kwt.heads, kwt.mlp, kwt.n_patches,
            kwt.n_classes) == (12, 64, 1, 256, 98, 35)
    assert (conv.channels, conv.hw, conv.n_classes) == ((32, 64, 128), 32,
                                                        100)


@pytest.mark.parametrize("name", sorted(FULL))
def test_init_follows_the_reference_laws(name):
    """Zeros and ones where the reference puts them, 0.02 for ``pos`` and
    the embedding, 1/sqrt(fan-in) for every dense weight (within 10 %)."""
    model = FULL[name][1](device="cpu").init(
        torch.Generator().manual_seed(0))
    ref_cls = FULL[name][0]
    tree = ref_cls().init(jax.random.PRNGKey(0))
    for n, want in _flatten(_np_tree(tree)):
        got = dict(model.named_parameters())[n].detach().numpy()
        want_std = float(np.std(want))
        if want_std == 0.0:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            assert abs(float(np.std(got)) / want_std - 1) < 0.1, n
            assert abs(float(np.mean(got))) < 0.1 * want_std + 1e-3, n


def test_converter_rejects_a_tree_of_another_shape():
    ref = RP.ConvNet(n_classes=10, channels=(8, 16), hw=8)
    tree = _np_tree(ref.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="does not fit ConvNet"):
        paper_params_from_reference(
            ConvNet(n_classes=10, channels=(8,), hw=8, device="cpu"), tree)


@pytest.mark.parametrize("cls", [LSTMModel, KWTModel, ConvNet])
def test_model_defaults_to_the_card(cls):
    """A model built with no device is on ``cuda:0``, and raises where
    there is none: it never falls back to the host."""
    if torch.cuda.is_available():
        assert next(cls().parameters()).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


def test_convnet_head_reads_nhwc_order():
    """The head's rows are in the reference's NHWC flatten order: moving
    one head row changes the logits exactly as the reference's do."""
    ref, tree, port = _pair("convnet")
    batch = _conv_batch(np.random.default_rng(3))
    tree = dict(tree, head=tree["head"][::-1].copy())
    port.load_state_dict(paper_params_from_reference(port, tree))
    want = ref.logits_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    _close(port.logits_fn({k: torch.from_numpy(v)
                           for k, v in batch.items()}), want, "logits")


# -- the reference's smoke cases (tests/test_arch_smoke.py), on the port ------


def test_paper_lstm_trains():
    model = LSTMModel(vocab=30, embed=8, hidden=32, layers=2,
                      device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 30, (4, 20),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    assert torch.isfinite(model.loss(batch))
    assert model.logits_fn(batch).shape == (4, 19, 30)


def test_paper_kwt_trains():
    model = KWTModel(n_classes=10, d=32, layers=2, heads=2, mlp=64,
                     n_patches=8, device="cpu").init(
                         torch.Generator().manual_seed(0))
    batch = {"mfcc": torch.randn((4, 8, 40),
                                 generator=torch.Generator().manual_seed(1)),
             "labels": torch.tensor([0, 1, 2, 3])}
    assert torch.isfinite(model.loss(batch))


def test_paper_convnet_trains():
    model = ConvNet(n_classes=10, channels=(8, 16), hw=16, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {"image": torch.randn((4, 16, 16, 3),
                                  generator=torch.Generator().manual_seed(1)),
             "labels": torch.tensor([0, 1, 2, 3])}
    assert torch.isfinite(model.loss(batch))
