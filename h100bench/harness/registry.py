"""Find a cell's files by the names in ``BENCHMARK.json``.

Every piece that belongs to one configuration, traffic mix, driver kind
or per-layer metric is a file of its own, found by name:

    configs/<config>.json      the configuration's sizes and its reference
    traffic/<traffic>.json     the mix's parameters, with its driver kind
    drivers/<kind>.py          one general driver per kind (``Driver``)
    metrics/<metric>.py        the per-layer metric's reader (``read``); where
                               there is no such file, the file of the longest
                               prefix of the name that ends before a dot:
                               idle_share.py reads idle_share.train and .live,
                               mfu.train.py reads mfu.train.fcdn57
    limits/<cell>.json         the limits of the numbers ``correct`` compares

A new configuration, mix, driver or metric is a new file and a new entry
in ``BENCHMARK.json``; no existing file changes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str]            # per-layer metrics only
    workloads: Optional[List[str]]  # None: every cell that reports ``moves``


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, spec: dict, bench_dir: Path = BENCH_DIR):
        self.spec = spec
        self.dir = bench_dir
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"], w["chips"])
                      for w in spec["workloads"]}
        self.end_to_end = [_metric(m) for m in spec["end_to_end"]]
        self.per_layer = [_metric(m) for m in spec["per_layer"]]

    @classmethod
    def load(cls, root: Path = ROOT) -> "Benchmark":
        path = Path(root) / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        return cls(json.loads(path.read_text()))

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[name]

    # -- what a cell reports ---------------------------------------------------

    def end_to_end_of(self, cell: str) -> List[Metric]:
        return [m for m in self.end_to_end
                if m.workloads is None or cell in m.workloads]

    def per_layer_of(self, cell: str) -> List[Metric]:
        reported = {m.name for m in self.end_to_end_of(cell)}
        return [m for m in self.per_layer
                if (cell in m.workloads if m.workloads is not None
                    else m.moves in reported)]

    # -- files by name ---------------------------------------------------------

    def config(self, name: str) -> dict:
        return _json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _json(self.dir / "limits" / f"{cell}.json")["limits"]

    def driver(self, kind: str) -> ModuleType:
        return load_module(self.dir / "drivers" / f"{kind}.py")

    def metric_reader(self, name: str) -> ModuleType:
        parts = name.split(".")
        for n in range(len(parts), 0, -1):
            path = self.dir / "metrics" / (".".join(parts[:n]) + ".py")
            if path.is_file():
                return load_module(path)
        raise FileNotFoundError(f"no reader for the metric {name!r} in {self.dir / 'metrics'}")


def _metric(m: dict) -> Metric:
    return Metric(m["name"], m["unit"], m["better"], m["source"], m.get("moves"),
                  m.get("workloads"))


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """Import a file by its path (metric names hold dots, so they are no
    module names); once per process."""
    path = Path(path).resolve()
    key = "h100bench_file_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if key in sys.modules:
        return sys.modules[key]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def reference_model(config: dict):
    """The plain reference network of a configuration: the module its file
    names under ``reference`` builds it from the same sizes."""
    return load_module(BENCH_DIR / config["reference"]).build(config)
