"""Prefetching batch loader and host->device placement (counterpart of
``eld_tpu/data/loader.py``).

The per-sample work (patch-store reads, flips) is NumPy/native code that
releases the GIL, so a thread pool with a bounded queue overlaps it with
the training step.  ``prefetch_to_device`` copies each batch from pinned
host memory to the device without blocking, keeping ``size`` batches in
flight ahead of the consumer.  ``readahead`` runs any iterator one or
more items ahead on a thread (eval's raw decodes), ``prefetched_map`` maps
a function over items on a thread pool in order (the serving CLI's
decodes), and ``pool_to_device`` puts a whole patch store on the device
for the pooled trainer.
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


def prefetched_map(fn, items, workers: int, window: int):
    """Ordered, bounded-in-flight background map: yields ``fn(item)`` in
    input order while up to ``window`` calls are queued on ``workers``
    threads (``workers <= 0``: a plain synchronous loop).

    An exception raised by ``fn`` is raised at its item's position, as in
    the synchronous loop, and the calls queued behind it are cancelled then
    (as they are when the consumer abandons the generator): no call starts
    on an item past the failing one; calls already running finish on their
    threads.  ``fn`` must be safe to call concurrently on distinct items
    (the native raw decoder and the patch-store reads are)."""
    if workers <= 0:
        for item in items:
            yield fn(item)
        return
    ex = ThreadPoolExecutor(max_workers=workers)
    futs: collections.deque = collections.deque()
    try:
        for item in items:
            futs.append(ex.submit(fn, item))
            if len(futs) >= window:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


class _Raised:
    """An exception the producer raised, as opposed to an exception object
    the iterator yielded as an ordinary item."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()  # end of the iteration; None is a legal item


def readahead(iterator, size: int = 2):
    """Run ``iterator`` on a background thread with a bounded queue.

    An exact pass-through: the same items in the same order, and an
    exception raised by the iterator is raised at its position.  Only
    when the producer runs changes: item i+1's host work (raw decode,
    packing) overlaps the consumer's device work on item i.  ``size <= 0``
    returns the iterator unchanged.  The thread stops when the consumer
    finishes or abandons the generator."""
    if size <= 0:
        return iterator

    def gen():
        q: queue.Queue = queue.Queue(maxsize=size)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in iterator:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
                put(_Raised(e))
                return
            put(_DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, _Raised):
                    raise item.exc
                yield item
        finally:
            stop.set()

    return gen()


def pool_to_device(store, device) -> torch.Tensor:
    """A whole patch store on ``device`` as one (P, H, W, C) tensor of the
    stored dtype (uint16 for the clean raw set: half the bytes of f32; the
    pooled train step normalizes on the device).

    The records are stacked into one host buffer, pinned when the device is
    a CUDA device, and copied once.  The SID clean set (1288 x 512^2 x 4
    uint16) is 2.70 GB."""
    device = torch.device(device)
    n = len(store)
    first = torch.from_numpy(onp.ascontiguousarray(store.record(0)))
    host = torch.empty((n, *first.shape), dtype=first.dtype,
                       pin_memory=device.type == "cuda")
    for i in range(n):
        host[i] = torch.from_numpy(onp.ascontiguousarray(store.record(i)))
    return host.to(device)
