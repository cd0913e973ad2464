"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations, the
cells (``workloads``) and the metrics.  Everything else belongs to one name
and sits in a file of its own, which this module finds by that name:

* ``bench/configs/<config>.json``: the configuration's sizes (its ``file``
  in ``BENCHMARK.json``), with ``family``, the name of its program adapter
  (``bench/families/<family>.py``) and of its plain reference
  (``bench/reference/<family>.py``); its numbers are the source's, and
  ``port_departures`` holds ``[published, run]`` for each key that the
  program runs otherwise, which a cell's ``config`` takes (``as_run``);
* ``bench/traffic/<traffic>.json``: the traffic mix, whose ``mode`` names the
  loop that drives it (``bench/modes/<mode>.py``);
* ``bench/limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell;
* ``bench/metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    @property
    def family(self) -> str:
        return self.config["family"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def as_run(conf: dict) -> dict:
    """The configuration file ``conf`` with each of its ``port_departures``
    put in: the configuration that the program runs and the reference follows."""
    out = dict(conf)
    for key, (published, run) in conf.get("port_departures", {}).items():
        if conf[key] != published:
            raise ValueError(f"{conf['name']}: {key} is {conf[key]!r}, its departure "
                             f"starts from {published!r}")
        out[key] = run
    return out


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits = json.loads((root / "bench" / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=entry["chips"], config_name=conf["name"],
        config=as_run(json.loads((root / conf["file"]).read_text())),
        traffic_name=entry["traffic"],
        traffic=json.loads((root / "bench" / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits={k: float(v) for k, v in limits["limits"].items()},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def mode_module(mode: str) -> ModuleType:
    return importlib.import_module(f"bench.modes.{mode}")


def family_module(family: str) -> ModuleType:
    """The program adapter of a model family: the port's config and model."""
    return importlib.import_module(f"bench.families.{family}")


def reference_module(family: str) -> ModuleType:
    """The plain PyTorch reference of a model family."""
    return importlib.import_module(f"bench.reference.{family}")


def metric_module(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of per-layer metric ``name``: ``bench/metrics/<name>.py``,
    loaded by its path (a metric's name may hold dots)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
