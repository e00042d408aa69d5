"""Reading a torch.profiler trace of warm pooled calls: the device's
kernels and busy time, the idle gaps and what the host was doing in them.

``profile_span(fn, path)`` runs ``fn`` under the profiler (CPU and CUDA
activity) between two synchronizes and writes the Chrome trace to
``path``; ``read(path)`` turns it into a ``Trace``, which the per-layer
metric readers and the result's ``breakdown`` read.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]  # (name, start us, duration us)
    busy_us: float       # union of the device's kernel, copy and set intervals
    window_us: float     # the device's span: its first operation's start to its last's end
    gaps: List[Tuple[float, float]]  # the device's idle intervals inside the span (us)
    host: List[Tuple[str, float, float]]  # host events (name, start us, duration us)

    def kernel_us(self, match) -> List[float]:
        """Durations of the kernels whose name ``match`` accepts."""
        return [d for name, _, d in self.kernels if match(name)]


def profile_span(fn, path: str, device) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


def read(path: str) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e and "ts" in e]
    return from_events(events)


def from_events(events) -> Trace:
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in DEVICE_CATS)
    if not device:
        return Trace([], 0.0, 0.0, [], [])
    # the span runs from the device's first operation to its last, so the
    # profiler's own start and stop on the host fall outside it
    start, end = device[0][0], max(b for _, b in device)
    busy, gaps, cursor = 0.0, [], start
    for a, b in device:
        if a > cursor:
            gaps.append((cursor, a))
        busy += max(0.0, b - max(a, cursor))
        cursor = max(cursor, b)
    kernels = [(str(e["name"]), float(e["ts"]), float(e["dur"])) for e in events
               if e.get("cat") == "kernel"]
    host = [(str(e["name"]), float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in HOST_CATS]
    return Trace(kernels, busy, end - start, gaps, host)


def gap_labels(trace: Trace) -> List[str]:
    """For each gap, the innermost host event (the shortest) running at
    its middle: one sweep over the host events in order of start."""
    hosts = sorted(trace.host, key=lambda e: e[1])
    order = sorted(range(len(trace.gaps)), key=lambda i: sum(trace.gaps[i]))
    labels, active, j = [""] * len(trace.gaps), [], 0
    for i in order:
        mid = 0.5 * sum(trace.gaps[i])
        while j < len(hosts) and hosts[j][1] <= mid:
            active.append(hosts[j])
            j += 1
        active = [e for e in active if e[1] + e[2] >= mid]
        labels[i] = min(active, key=lambda e: e[2])[0] if active else "host between events"
    return labels


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps summed
    by what the host was doing, each in seconds, at most ``top`` of each."""
    ops = defaultdict(float)
    for name, _, dur in trace.kernels:
        ops[name[:NAME_CHARS]] += dur * 1e-6
    idle = defaultdict(float)
    for (a, b), label in zip(trace.gaps, gap_labels(trace)):
        idle[label[:NAME_CHARS]] += (b - a) * 1e-6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
