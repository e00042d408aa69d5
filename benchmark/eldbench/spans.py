"""The program's own spans in a traced run against the device's idle gaps.

The port names its pooled train path's host work in spans
(``eld_tpu_torch/utils/logging.py::span``), ``user_annotation`` events
on the profiler's clock beside the device's operations.  ``split`` divides
the device's idle time of the traced span three ways, by what the host
was in:

  * ``graph_idle_us``: inside an ``eld.pool.read``, where the host waits
    for the device: gaps inside the running graph;
  * ``host_idle_us``: inside an ``eld.pool.call`` but outside its read:
    the host's own work per call, which the device waits out;
  * ``boundary_idle_us``: in neither: between epochs.

The three sum to the trace's idle time.  Nothing is returned for a trace
without ``eld.pool.call`` spans (a program without them).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

EPOCH, CALL, READ = "eld.pool.epoch", "eld.pool.call", "eld.pool.read"

Intervals = List[Tuple[float, float]]


@dataclasses.dataclass
class Split:
    calls: int
    epochs: int
    host_us: float           # the call spans' time outside their reads
    host_idle_us: float
    graph_idle_us: float
    boundary_idle_us: float


def named(trace, name: str) -> Intervals:
    """The host events called ``name``, as (start, end) in order of start."""
    return sorted((t, t + d) for n, t, d in trace.host if n == name)


def union(intervals: Intervals) -> Intervals:
    out: Intervals = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intersect(xs: Intervals, ys: Intervals) -> Intervals:
    """The overlap of two unions of disjoint intervals."""
    xs, ys = union(xs), union(ys)
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals: Intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def split(trace) -> Optional[Split]:
    calls = named(trace, CALL)
    if not calls:
        return None
    reads = union(named(trace, READ))
    gaps = trace.gaps
    idle = length(gaps)
    graph = length(intersect(gaps, reads))
    in_calls = intersect(gaps, calls)
    host = length(in_calls) - length(intersect(in_calls, reads))
    return Split(calls=len(calls), epochs=len(named(trace, EPOCH)),
                 host_us=length(calls) - length(intersect(calls, reads)),
                 host_idle_us=host, graph_idle_us=graph,
                 boundary_idle_us=idle - host - graph)
