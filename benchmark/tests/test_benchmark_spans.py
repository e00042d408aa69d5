"""The readers of the program's spans (``eldbench/spans.py``,
``metrics/pool.*``, ``metrics/epoch.boundary_idle_ms.py``) on canned
traces: hand-valued on one, the three idle metrics summing to the trace's
idle time on random ones, and nothing read where the trace holds no span."""

import os
import random
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from eldbench import manifest, spans, trace  # noqa: E402

METRICS = ("pool.host_ms", "pool.host_idle_ms", "pool.graph_idle_ms", "epoch.boundary_idle_ms")


def _span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}


def _kernel(a, b):
    return {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop", "ts": a, "dur": b - a}


def _canned():
    """Two epochs of two calls (us).  The device runs 50-250, 260-350,
    360-450, 490-600 and 620-950: idle 250-260 (in call 2, outside its
    read: host), 350-360 (in call 2's read: graph), 450-490 (480-490
    outside every call and read: boundary; the rest in epoch 1's final
    drain: graph) and 600-620 (in call 3: host)."""
    ev = [_span("eld.epoch", 0, 500), _span("eld.pool.epoch", 0, 500),
          _span("eld.epoch", 500, 1000), _span("eld.pool.epoch", 500, 1000),
          _span("eld.pool.call", 20, 200), _span("eld.pool.call", 200, 400),
          _span("eld.pool.call", 510, 700), _span("eld.pool.call", 700, 900),
          _span("eld.pool.read", 300, 380), _span("eld.pool.read", 420, 480),
          _span("eld.pool.read", 800, 880), _span("eld.pool.read", 910, 960),
          _span("eld.graph.replay", 30, 60),
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 340,
           "dur": 30}]
    ev += [_kernel(a, b) for a, b in ((50, 250), (260, 350), (360, 450), (490, 600),
                                      (620, 950))]
    return trace.from_events(ev)


def _read(name, t):
    return manifest.reader(name).read(types.SimpleNamespace(trace=t))


def test_readers_on_a_canned_trace():
    t = _canned()
    assert (t.window_us, t.busy_us) == (900, 820)
    s = spans.split(t)
    assert (s.calls, s.epochs) == (4, 2)
    assert (s.host_idle_us, s.graph_idle_us, s.boundary_idle_us) == (30, 40, 10)
    # the calls' 770 us less their reads' 160 (the final drains lie outside them)
    assert _read("pool.host_ms", t) == pytest.approx(0.610 / 4)
    assert _read("pool.host_idle_ms", t) == pytest.approx(0.030 / 4)
    assert _read("pool.graph_idle_ms", t) == pytest.approx(0.040 / 4)
    assert _read("epoch.boundary_idle_ms", t) == pytest.approx(0.010 / 2)
    # a gap's innermost host event may now be a span
    labels = dict(trace.breakdown(t)["idle_gaps"])
    assert labels["eld.pool.call"] == pytest.approx(30e-6)
    assert labels["cudaStreamSynchronize"] == pytest.approx(10e-6)


@pytest.mark.parametrize("seed", range(8))
def test_the_idle_metrics_divide_the_idle_time(seed):
    """calls x (host + graph) + epochs x boundary = (1 - busy/window) x
    window, on random spans and device operations."""
    rng = random.Random(seed)
    ev, t0 = [], 0.0
    for _ in range(rng.randint(1, 3)):
        start = t0
        for _ in range(rng.randint(1, 5)):
            a = t0 + rng.uniform(0, 20)
            b = a + rng.uniform(10, 200)
            ev.append(_span("eld.pool.call", a, b))
            r = rng.uniform(a, b)
            ev.append(_span("eld.pool.read", r, rng.uniform(r, b)))
            t0 = b
        r = t0 + rng.uniform(0, 10)
        t0 = r + rng.uniform(1, 50)
        ev += [_span("eld.pool.read", r, t0), _span("eld.pool.epoch", start, t0)]
    cursor = rng.uniform(0, 30)
    while cursor < t0:
        b = cursor + rng.uniform(1, 60)
        ev.append(_kernel(cursor, b))
        cursor = b + rng.choice([0.0, rng.uniform(0, 15)])
    t = trace.from_events(ev)
    s = spans.split(t)
    values = {name: _read(name, t) for name in METRICS}
    assert min(s.host_idle_us, s.graph_idle_us, s.boundary_idle_us) >= -1e-9
    total = (s.calls * (values["pool.host_idle_ms"] + values["pool.graph_idle_ms"])
             + s.epochs * values["epoch.boundary_idle_ms"])
    assert total == pytest.approx((t.window_us - t.busy_us) * 1e-3, rel=1e-9, abs=1e-12)
    assert 0 <= values["pool.host_ms"] <= t0 * 1e-3


def test_readers_find_no_span_to_read():
    """A trace of a program without the spans (the parent of this
    benchmark's readers): every reader returns None and raises nothing."""
    t = trace.from_events([_kernel(0, 5), _kernel(9, 12),
                           {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 4,
                            "dur": 6}])
    assert spans.split(t) is None
    assert all(_read(name, t) is None for name in METRICS)
    calls_only = trace.from_events([_kernel(0, 5), _kernel(9, 12),
                                    _span("eld.pool.call", 0, 12)])
    assert _read("pool.host_idle_ms", calls_only) == pytest.approx(0.004)
    assert _read("epoch.boundary_idle_ms", calls_only) is None
    assert _read("epoch.boundary_idle_ms", trace.from_events([])) is None
