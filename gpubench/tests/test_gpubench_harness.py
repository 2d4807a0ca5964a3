"""The harness finds every cell's files by name, BENCHMARK.json keeps to
the benchmark's contract, and the traffic repeats exactly for a seed."""
import copy
import json
import re

import pytest
import torch

from gpubench.core import spec, traffic

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVERS = sorted(p.stem for p in (spec.BENCH / "drivers").glob("*.py")
                 if p.stem != "__init__")


def _finds_its_files(c):
    assert c.config["name"] == c.workload["config"]
    for f in c.files():
        assert f.exists(), f"{c.name} names {f.relative_to(spec.ROOT)}"
    for role, supplied in spec.ROLES.items():
        module = c.family.module(role)
        assert all(callable(getattr(module, n, None)) for n in supplied)
    assert c.limits["numbers"]
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    _finds_its_files(spec.cell(name))


@pytest.mark.parametrize("driver", DRIVERS)
def test_a_cell_finds_any_driver_that_exists(driver):
    c = copy.deepcopy(spec.cell(CELLS[0]))
    c.traffic["driver"] = driver
    _finds_its_files(c)


@pytest.mark.parametrize("part,name", [("driver", "decode"),
                                       ("family", "no-such-family")])
def test_a_cell_that_names_a_missing_file_fails(part, name):
    c = copy.deepcopy(spec.cell(CELLS[0]))
    if part == "driver":
        c.traffic["driver"] = name
    else:
        c.config["reference"] = name
    with pytest.raises(AssertionError, match=name):
        _finds_its_files(c)


def test_a_cell_that_is_not_there():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", sorted({w["config"]
                                         for w in BENCH["workloads"]}))
def test_config_names_its_changes(name):
    c = next(x for x in BENCH["configs"] if x["name"] == name)
    cfg = spec.load_json(spec.ROOT / c["file"])
    assert cfg["source"] == c["source"]
    assert sorted(cfg["changed"]) == sorted(c["reduced"])
    # the family's own check: for the decoder, the heads add up to d_model
    spec.family(cfg).arch.check_config(cfg)


def test_prefill_traffic_repeats_for_a_seed():
    mix = dict(spec.cell("mixtral-8x22b.prefill").traffic, pool_batches=6)
    seed = 2 ** 31 + 5
    a = traffic.prefill_pool(mix, 1000, seed, "cpu")
    b = traffic.prefill_pool(mix, 1000, seed, "cpu")
    c = traffic.prefill_pool(mix, 1000, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(x.shape != y.shape or not torch.equal(x, y)
               for x, y in zip(a, c))
    order = traffic.shape_order(mix, seed)
    assert sorted(order) == sorted(tuple(s) for s in mix["shapes"])
    assert [tuple(x.shape) for x in a] == order + order
    assert {x.numel() for x in a} == {8192}


@pytest.mark.parametrize("batch,seq", [(3, 40), (6, 9)])
def test_train_traffic_repeats_for_a_seed(batch, seq):
    mix = dict(spec.cell("smollm-360m.train-s2048").traffic, batch=batch,
               seq=seq)
    a = traffic.train_pool(mix, 1000, 7, "cpu")
    b = traffic.train_pool(mix, 1000, 7, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    rows = torch.cat([x["tokens"] for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


@pytest.mark.parametrize("vocab,S", [(49152, 2048), (1000, 37), (7, 5)])
def test_bigram_is_the_drivers_rule(vocab, S):
    g = torch.Generator().manual_seed(S)
    x0 = torch.randint(0, vocab, (3,), generator=g)
    noise = torch.randint(0, 7, (3, S), generator=g)
    want = torch.zeros((3, S + 1), dtype=torch.int64)
    want[:, 0] = x0
    for t in range(S):  # repro_torch.launch.train.synthetic_lm_batch's loop
        want[:, t + 1] = (3 * want[:, t] + noise[:, t]) % vocab
    assert torch.equal(traffic.bigram(x0, noise, vocab), want)
