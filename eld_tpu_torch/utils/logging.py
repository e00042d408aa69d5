"""Observability: running-mean meters, throughput, progress reporting
(counterpart of ``eld_tpu/utils/logging.py``), and the program's named
spans in a torch.profiler trace.

Spans (``span``), each at a boundary of the pooled train path's host
work, recorded only while a profiler records (``--profile``, or a
profiler of the caller's own):

  eld.epoch          one epoch of ``tools/train_syn.py::train_epochs``:
                     the rate, the train call, the eval check
  eld.pool.epoch     ``Engine.train_pool``, whole (args: the epoch)
  eld.pool.call      one iteration of its loop: call i's seeds and launch,
                     call i-1's drain (args: call i's first step)
  eld.pool.read      the drain's reads of the losses: the host waits for
                     the device
  eld.pool.report    the drain's history, throughput, meters, progress
                     and writer
  eld.epoch.end      ``Engine._end_epoch``: the saves
  eld.graph.bind     ``_GraphCall``: the binding's check
  eld.graph.seeds    the reseeds and the seed buffer's copy
  eld.graph.eager    a binding's first call, run eagerly
  eld.graph.capture  its capture
  eld.graph.replay   the input copies and the graph's launch
  eld.graph.outputs  the outputs' copies (the eager call's stream marks)
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time
from datetime import datetime

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str, args=None):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else one shared no-op context: with no profiler a span costs one
    check.  ``name`` is fixed; what varies goes in ``args`` (kept as its
    string)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name, None if args is None else str(args))


class AverageMeters:
    """Running means keyed by metric name."""

    def __init__(self):
        self.sums = {}
        self.counts = {}

    def update(self, new: dict):
        for k, v in new.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def __getitem__(self, key):
        return self.sums[key] / self.counts[key]

    def keys(self):
        return self.sums.keys()

    def as_dict(self):
        return {k: self[k] for k in self.keys()}

    def __str__(self):
        return " | ".join(f"{k}: {self[k]:.4f}" for k in sorted(self.keys()))


class ThroughputMeter:
    """Items/sec over a sliding window of ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self.items = []

    def tick(self, n_items: int = 1):
        self.times.append(time.perf_counter())
        self.items.append(n_items)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.items.pop(0)

    @property
    def items_per_sec(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return sum(self.items[1:]) / dt if dt > 0 else 0.0


def get_summary_writer(log_dir: str):
    """tensorboardX writer in a timestamped+hostname run dir; None if
    tensorboardX is not installed (logging is then terminal-only)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    run = datetime.now().strftime("%b%d_%H-%M-%S") + "_" + socket.gethostname()
    path = os.path.join(log_dir, run)
    os.makedirs(path, exist_ok=True)
    return SummaryWriter(path)


def write_loss(writer, prefix: str, meters: AverageMeters, iteration: int):
    if writer is None:
        return
    for key in meters.keys():
        writer.add_scalar(os.path.join(prefix, key), meters[key], iteration)


def progress(i: int, total: int, msg: str = "", stream=sys.stderr, every: int = 1):
    """Single-line progress report (terminal-size independent)."""
    if i % every and i != total - 1:
        return
    stream.write(f"\r  {i + 1}/{total} {msg}")
    if i == total - 1:
        stream.write("\n")
    stream.flush()
