"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``traffic/<name>.json``),
its limits (``limits/<cell>.json``), each per-layer metric's reader
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or
None) and the configuration's architecture (``archs/<arch>.py``, for the
config's ``arch``).

A new cell is files and entries in the manifest; nothing here changes.
A configuration of an architecture the benchmark has no module for adds
that module beside them, with

  * ``param_specs(config)``: (name, shape) of every parameter, in the
    program's ``state_dict`` names;
  * ``make_weights(seed, config, device)``: the initial weights from the
    seed, drawn from ``reference.weight_generator`` by the architecture's
    own init rule;
  * ``forward(config, p, x, precision)``: the model in plain float32
    ``torch``, NHWC in and out; "bf16" runs under the caller's autocast,
    "fp8" rounds every conv or matmul as ``reference._conv`` does;
  * ``program_args(config)``: the program's model flags (``--netG`` and
    what follows it);
  * ``step_flops(config, batch, h, w)``: the frozen analytic FLOPs of one
    train step.

The reference runs ``forward`` over the whole batch in one pass; a model
whose float32 backward would not fit saves its memory inside its own
``forward`` (``torch.utils.checkpoint`` around its blocks, say).
"""

from __future__ import annotations

import dataclasses
import functools
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


def _load(folder: str, name: str):
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"eldbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module ``metrics/<metric>.py``, loaded by path."""
    return _load("metrics", metric)


@functools.lru_cache(maxsize=None)
def arch(name: str):
    """The module ``archs/<name>.py``, loaded by path once."""
    return _load("archs", name)
