"""The lookup by family: a configuration's ``reference`` names its family,
whose modules (``arch``, ``counts``, ``reference``, ``port``) the harness
finds by that name alone. A family that only this test defines, with a
first layer of other weights than the rest, runs through it; the decoder
family's weights and counts are those it had before the lookup (the
digests and counts below were taken then, on the CPU)."""
import hashlib
import sys
import types

import pytest
import torch

from gpubench.core import spec
from gpubench.core import weights as W
from gpubench.tests import tiny

SEED = 2 ** 31 + 5


def _twokind():
    """A family of a dense first layer and expert layers after it, under
    other names in the port."""
    arch = types.ModuleType("gpubench.arch.twokind")
    arch.sizes = lambda c: types.SimpleNamespace(
        vocab=c["vocab_size"], n_layers=c["num_hidden_layers"],
        d=c["hidden_size"], dtype="float32")

    def layer_shapes(a, i):
        d = a.d
        if i == 0:
            return {"norm": ((d,), None, a.dtype),
                    "mlp.w1": ((d, 4 * d), d, a.dtype)}
        return {"norm": ((d,), None, a.dtype),
                "moe.w1": ((3, d, 2 * d), d, a.dtype)}

    arch.layer_shapes = layer_shapes
    arch.global_shapes = lambda a: {"embed": ((a.vocab, a.d), 0.02,
                                              a.dtype)}
    arch.port_name = lambda n: n.replace("blocks.", "layers.", 1)
    arch.check_config = lambda c: None
    arch.tiny = lambda c: {}
    counts = types.ModuleType("gpubench.counts.twokind")
    counts.prefill_flops = lambda a, B, S: 2 * B * S * a.d * a.d
    counts.train_flops = lambda a, B, S: 6 * B * S * a.d * a.d
    counts.k5_launches = lambda a, B, S: [(B * S, a.d)] * (a.n_layers - 1)
    counts.k3_launches = lambda a, B, S: []
    reference = types.ModuleType("gpubench.reference.twokind")
    reference.prefill_logits = lambda *args, **kw: []
    reference.train = lambda *args, **kw: {}
    port = types.ModuleType("gpubench.port.twokind")
    port.model_config = lambda c: c["name"]
    return {m.__name__: m for m in (arch, counts, reference, port)}


@pytest.fixture
def twokind(monkeypatch):
    for name, module in _twokind().items():
        monkeypatch.setitem(sys.modules, name, module)
    config = {"name": "tk", "reference": "twokind", "vocab_size": 11,
              "num_hidden_layers": 3, "hidden_size": 4}
    fam = spec.family(config)
    return fam, fam.arch.sizes(config)


def test_the_family_is_found_by_its_name(twokind):
    fam, a = twokind
    assert fam.name == "twokind"
    for role, supplied in spec.ROLES.items():
        module = fam.module(role)
        assert module is sys.modules[f"gpubench.{role}.twokind"]
        assert all(callable(getattr(module, n)) for n in supplied)
    assert fam.counts.prefill_flops(a, 2, 5) == 2 * 2 * 5 * 16
    assert len(fam.counts.k5_launches(a, 2, 5)) == 2
    assert fam.reference.train is sys.modules[
        "gpubench.reference.twokind"].train


def test_every_draws_each_layer_by_its_index(twokind):
    fam, a = twokind
    drawn = list(W.every(fam.arch, a, SEED, "cpu"))
    assert [n for n, _ in drawn] == list(W.names(fam.arch, a))
    shapes = {n: tuple(t.shape) for n, t in drawn}
    assert shapes == {"embed": (11, 4),
                      "blocks.0.norm": (4,), "blocks.0.mlp.w1": (4, 16),
                      "blocks.1.norm": (4,), "blocks.1.moe.w1": (3, 4, 8),
                      "blocks.2.norm": (4,), "blocks.2.moe.w1": (3, 4, 8)}
    # a layer made again alone has the same bits
    alone = dict(W.layer(fam.arch, a, SEED, 2, "cpu"))
    assert torch.equal(alone["moe.w1"], dict(drawn)["blocks.2.moe.w1"])
    assert not torch.equal(dict(drawn)["blocks.1.moe.w1"], alone["moe.w1"])


def test_load_port_maps_the_names(twokind):
    fam, a = twokind
    want = dict(W.every(fam.arch, a, SEED, "cpu"))
    params = {fam.arch.port_name(n): torch.zeros_like(t)
              for n, t in want.items()}
    assert "layers.0.mlp.w1" in params and "blocks.0.mlp.w1" not in params
    W.load_port(params, fam.arch, a, SEED, "cpu")
    for n, t in want.items():
        assert torch.equal(params[fam.arch.port_name(n)], t)
    with pytest.raises(KeyError, match="layers.1.moe.w1"):
        W.load_port({k: v for k, v in params.items()
                     if k != "layers.1.moe.w1"}, fam.arch, a, SEED, "cpu")
    with pytest.raises(KeyError, match="extra"):
        W.load_port(dict(params, extra=torch.zeros(1)), fam.arch, a, SEED,
                    "cpu")


def test_a_cell_of_the_family_names_its_files(twokind):
    c = spec.cell("mixtral-8x22b.prefill")
    c.config["reference"] = "twokind"
    assert c.family.name == "twokind"
    files = {str(f.relative_to(spec.BENCH)) for f in c.files()}
    assert {"arch/twokind.py", "counts/twokind.py", "reference/twokind.py",
            "port/twokind.py", "drivers/prefill.py"} <= files


def _digest(parts) -> str:
    h = hashlib.sha256()
    for name, t in parts:
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(name.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


# the weights outside the layers, then each layer's, as drawn before the
# lookup (seed 2**31 + 5, CPU generators)
DIGESTS = {
    ("mixtral-8x22b.prefill", True): [
        "cfc5f8bdd14ca72e", "e629d67df4ec365e", "a20222e9a42c310d"],
    ("smollm-360m.train-s2048", True): [
        "ae210f4340b92970", "95cfd23854dab755", "f01d0f7a0c6ac118"],
    # smollm-360m at its published size: layers 0 and 31
    ("smollm-360m.train-s2048", False): [
        "bafd7875501e39fb", "2669d22d3f8beeb5", "66701f1b47ce3b6a"],
}


@pytest.mark.parametrize("name,small", sorted(DIGESTS))
def test_decoder_weights_are_the_ones_drawn_before(name, small):
    c = tiny.cell(name) if small else spec.cell(name)
    fam = c.family
    assert fam.name == "decoder"
    a = fam.arch.sizes(c.config)
    layers = range(a.n_layers) if small else (0, a.n_layers - 1)
    got = [_digest(W.outer(fam.arch, a, SEED, "cpu"))] + [
        _digest(W.layer(fam.arch, a, SEED, i, "cpu")) for i in layers]
    assert got == DIGESTS[name, small]


# the decoder family's counts at the cells' sizes, as counted before the
# lookup: prefill FLOPs, K5's and K3's first launch and their number
PREFILL = {(8, 1024): 91544811995136, (4, 2048): 92367835103232,
           (2, 4096): 94016297238528}
K3_OPS = {(8, 1024): 103179878400, (4, 2048): 206259093504,
          (2, 4096): 412417523712}


@pytest.mark.parametrize("shape", sorted(PREFILL))
def test_decoder_prefill_counts_are_the_ones_before(shape):
    c = spec.cell("mixtral-8x22b.prefill")
    counts, a = c.family.counts, c.family.arch.sizes(c.config)
    assert counts.prefill_flops(a, *shape) == PREFILL[shape]
    k5, k3 = counts.k5_launches(a, *shape), counts.k3_launches(a, *shape)
    assert (k5[0], len(k5)) == ((3298534883328, 2348810240), 24)
    assert (k3[0], len(k3)) == ((K3_OPS[shape], 234881024), 8)


def test_decoder_train_count_is_the_one_before():
    c = spec.cell("smollm-360m.train-s2048")
    a = c.family.arch.sizes(c.config)
    assert c.family.counts.train_flops(a, 16, 2048) == 83500204032000
