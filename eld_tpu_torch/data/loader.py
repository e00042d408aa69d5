"""Prefetching batch loader and host->device placement (counterpart of
``eld_tpu/data/loader.py``).

The per-sample work (patch-store reads, flips) is NumPy/native code that
releases the GIL, so a thread pool with a bounded queue overlaps it with
the training step.  ``prefetch_to_device`` copies each batch from pinned
host memory to the device without blocking, keeping ``size`` batches in
flight ahead of the consumer.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as onp
import torch


def default_collate(items):
    """Stack array fields; keep the first value for non-array fields."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], onp.ndarray) and vals[0].dtype != object:
            out[k] = onp.stack(vals)
        elif isinstance(vals[0], (float, int, onp.floating, onp.integer)):
            out[k] = onp.asarray(vals)
        else:
            out[k] = vals if len(vals) > 1 else vals[0]
    return out


class Loader:
    """Iterates dict batches of NumPy arrays over a Dataset.

    ``shuffle`` uses a per-epoch seeded permutation (deterministic given
    ``seed`` and the epoch)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 2018, drop_last: bool = False,
                 collate: Callable = default_collate, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.collate = collate
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Pin the shuffle permutation to a training epoch (the Engine calls
        this each epoch, so a resumed run reproduces the order)."""
        self._epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return onp.random.default_rng(self.seed + self._epoch).permutation(n)
        return onp.arange(n)

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            # per-sample augmentation streams follow the same epoch
            self.dataset.set_epoch(self._epoch)
        idxs = self._indices()
        self._epoch += 1
        batches = [idxs[i:i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        if self.num_workers <= 0:
            for b in batches:
                yield self.collate([self.dataset[int(j)] for j in b])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer is gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # dataset errors must reach the consumer, or it blocks forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(lambda j: self.dataset[int(j)], b))
                        if not put(self.collate(items)):
                            return
            except Exception as e:  # noqa: BLE001 - re-raised consumer-side
                put(e)
                return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def to_device(batch: dict, device) -> dict:
    """NumPy array fields of ``batch`` -> tensors on ``device``.

    For a CUDA device the host copy is pinned and the transfer does not
    block the host; PyTorch's pinned-memory allocator keeps the host
    buffer until the copy has completed.  Non-array fields are dropped."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, onp.ndarray) or v.dtype == object:
            continue
        t = torch.from_numpy(onp.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(iterator, device, size: int = 2):
    """Wrap a host batch iterator so batch i+1's host->device copy overlaps
    batch i's compute; ``size`` batches are in flight."""
    pending = collections.deque()
    it = iter(iterator)
    for batch in it:
        pending.append(to_device(batch, device))
        if len(pending) >= size:
            break
    while pending:
        yield pending.popleft()
        nxt = next(it, None)
        if nxt is not None:
            pending.append(to_device(nxt, device))
