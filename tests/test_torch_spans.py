"""The program's spans on the pooled train path (``utils/logging.py::span``),
on the CPU through the stand-in card of ``test_torch_fake_card.py``, so
``train/steps.py::_GraphCall`` runs its eager call, capture and replays:
no span is entered without a profiler, under one each epoch, call, graph
step, read and report is one span inside its parent, and tracing leaves
the parameters as they are."""

import json

import numpy as onp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eld_tpu_torch.config import Config
from eld_tpu_torch.tools.train_syn import train_epochs
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.utils import logging as eld_logging
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card

NO_EVAL = 1 << 30
# two epochs of 5 steps at K = 2: calls of 2, 2 and 1 steps
EPOCHS, STEPS, K = 2, 5, 2
# the span each span lies in
PARENTS = {"eld.pool.epoch": ("eld.epoch",), "eld.pool.call": ("eld.pool.epoch",),
           "eld.pool.read": ("eld.pool.call", "eld.pool.epoch"),
           "eld.pool.report": ("eld.pool.call", "eld.pool.epoch"),
           "eld.epoch.end": ("eld.pool.epoch",)}
GRAPH = ("eld.graph.seeds", "eld.graph.bind", "eld.graph.eager", "eld.graph.capture",
         "eld.graph.replay", "eld.graph.outputs")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_card(monkeypatch):
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)


def _engine(tmp_path, name):
    return Engine(Config(device="cpu", noise="eld", include=4, base_width=4, batch_size=2,
                         is_train=True, no_log=True, no_verbose=True,
                         checkpoints_dir=str(tmp_path), name=name))


def _pool():
    recs = onp.random.default_rng(1).integers(0, 65535, (6, 32, 32, 4), dtype=onp.uint16)
    return {"clean": torch.from_numpy(recs)}


def _train(engine):
    train_epochs(engine, EPOCHS, NO_EVAL, {}, None, _pool(), STEPS, K)


def _spans(path):
    """The trace's ``eld.*`` spans, (name, start ns, end ns) in order of
    start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], round(e["ts"] * 1e3), round((e["ts"] + e["dur"]) * 1e3))
             for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("eld.")]
    return sorted(spans, key=lambda s: s[1])


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_without_a_profiler_is_one_shared_no_op(fake_card, tmp_path, monkeypatch):
    """With no profiler recording, ``span`` returns the same null context
    every time and a pooled epoch never enters ``record_function``."""
    assert not torch.autograd._profiler_enabled()
    assert eld_logging.span("eld.pool.call", 3) is eld_logging.span("eld.graph.bind")

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    engine = _engine(tmp_path, "off")
    _train(engine)
    assert (engine.epoch, engine.iterations) == (EPOCHS, EPOCHS * STEPS)


def test_traced_epochs_name_every_call_and_leave_the_parameters_unchanged(fake_card,
                                                                          tmp_path):
    """Two traced epochs (calls of 2, 2 and 1 steps): 2 epoch and 6 call
    spans; each call holds one seeds, bind and outputs span, a binding's
    first call its eager run, the next its capture and replay, later calls
    the replay alone; each drained call one read, in the next call or the
    epoch's final drain; every span inside its parent; the parameters
    equal an untraced run's bit for bit."""
    traced = _engine(tmp_path, "on")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(traced)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _spans(path)
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    assert len(by_name["eld.epoch"]) == len(by_name["eld.pool.epoch"]) == EPOCHS
    assert len(by_name["eld.epoch.end"]) == EPOCHS
    calls = by_name["eld.pool.call"]
    assert len(calls) == 6
    # K = 2: eager, capture; K = 1: eager; then K = 2 replays twice, K = 1 captures
    kinds = [("eld.graph.eager",), ("eld.graph.capture", "eld.graph.replay"),
             ("eld.graph.eager",), ("eld.graph.replay",), ("eld.graph.replay",),
             ("eld.graph.capture", "eld.graph.replay")]
    for call, kind in zip(calls, kinds):
        inner = [s[0] for s in spans if s[0] in GRAPH and _inside(s, call)]
        assert sorted(inner) == sorted(("eld.graph.seeds", "eld.graph.bind",
                                        "eld.graph.outputs") + kind), (call, inner)
    reads = by_name["eld.pool.read"]
    assert len(reads) == len(by_name["eld.pool.report"]) == 6
    in_calls = [c for c in calls if any(_inside(r, c) for r in reads)]
    assert [calls.index(c) % 3 for c in in_calls] == [1, 2, 1, 2]
    for epoch in by_name["eld.pool.epoch"]:
        last = [c for c in calls if _inside(c, epoch)][-1]
        tail = [r for r in reads if _inside(r, epoch) and r[1] >= last[2]]
        assert len(tail) == 1
    for s in spans:
        if s[0] in GRAPH:
            assert any(_inside(s, c) for c in calls), s
        elif s[0] in PARENTS:
            assert any(_inside(s, p) for p in spans if p[0] in PARENTS[s[0]]), s

    untraced = _engine(tmp_path, "off")
    _train(untraced)
    assert traced.iterations == untraced.iterations == EPOCHS * STEPS
    for (name, a), b in zip(traced.model.state_dict().items(),
                            untraced.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n,calls", [(17, [2, 3, 4, 5]), (4, [2, 3]), (3, [2]), (2, [1]),
                                     (1, [0])])
def test_profile_traces_the_first_warm_replays(n, calls):
    """--profile's pooled window: an epoch's third through sixth calls,
    past the eager call and the capture, or its last call where it has
    fewer than three."""
    assert list(Engine._trace_calls(n)) == calls
