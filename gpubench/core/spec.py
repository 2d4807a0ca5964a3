"""Everything a cell is made of, found by name.

``BENCHMARK.json`` at the repository's root names the cells. A cell's
``config`` is ``gpubench/configs/<config>.json``, its ``traffic`` is
``gpubench/traffic/<traffic>.json`` and the limits of its correctness
check are ``gpubench/limits/<workload>.json``. The traffic file's
``driver`` is ``gpubench/drivers/<driver>.py``. The configuration file's
``reference`` names its family: ``gpubench/<role>/<family>.py`` for each
of :data:`ROLES` (see :class:`Family`). A per-layer metric is read by
``gpubench/metrics/<metric>.py``, which defines ``read(ctx)``. Adding a
cell, a configuration, a family, a traffic mix or a metric adds files; no
file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


# what a family supplies, one module each (``gpubench/<role>/<family>.py``)
# with these functions: its sizes and weights, its counts, its plain
# reference and the program's configuration of it (see README.md)
ROLES = {
    "arch": ("sizes", "layer_shapes", "global_shapes", "port_name",
             "check_config", "tiny"),
    "counts": ("prefill_flops", "train_flops", "k5_launches",
               "k3_launches"),
    "reference": ("prefill_logits", "train"),
    "port": ("model_config",),
}


@dataclasses.dataclass(frozen=True)
class Family:
    """A configuration's family, found by name: ``arch`` is
    ``gpubench/arch/<name>.py``, ``counts``, ``reference`` and ``port``
    likewise. Only ``port`` imports the program."""

    name: str

    def module(self, role: str):
        return importlib.import_module(f"gpubench.{role}.{self.name}")

    @property
    def arch(self):
        return self.module("arch")

    @property
    def counts(self):
        return self.module("counts")

    @property
    def reference(self):
        return self.module("reference")

    @property
    def port(self):
        return self.module("port")


def family(config: dict) -> Family:
    """The family of a configuration file: the one its ``reference``
    names."""
    return Family(config["reference"])


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def family(self) -> Family:
        return family(self.config)

    def files(self) -> list[Path]:
        """The files the cell's driver, family and per-layer metrics are
        read from (its configuration, traffic and limits are read
        already)."""
        return ([BENCH / "drivers" / f"{self.driver}.py"]
                + [BENCH / role / f"{self.family.name}.py" for role in ROLES]
                + [BENCH / "metrics" / f"{m['name']}.py"
                   for m in self.per_layer])


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default)."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({names})")
    w = found[0]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, workload=w,
        config=load_json(ROOT / config["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
