"""Observability: running-mean meters, throughput, progress reporting
(counterpart of ``eld_tpu/utils/logging.py``)."""

from __future__ import annotations

import os
import socket
import sys
import time
from datetime import datetime


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
