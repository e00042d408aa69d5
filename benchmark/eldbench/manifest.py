"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``traffic/<name>.json``),
its limits (``limits/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or
None).  A new cell is files and an entry in the manifest; nothing here
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def _for(metrics: List[dict], name: str) -> List[dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def cell(name: str) -> Cell:
    manifest = load()
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(os.path.join(ROOT, conf["file"])),
                traffic=_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                limits=_json(os.path.join(HERE, "limits", f"{name}.json")),
                end_to_end=_for(manifest["end_to_end"], name),
                per_layer=_for(manifest["per_layer"], name))


def reader(metric: str):
    """The module ``metrics/<metric>.py``, loaded by path."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"eldbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
