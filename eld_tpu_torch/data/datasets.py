"""Dataset compositions for the synthetic-noise trainer (counterpart of
``eld_tpu/data/datasets.py``).

Items are dicts of channels-last (H, W, C) NumPy arrays on the host.  The
noise is synthesized on the device inside the train step, so the training
source is just clean patches.  The paired and eval datasets (SID, ELD,
sRGB stages) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as onp


class Dataset:
    """Minimal dataset protocol (len/getitem) + a no-op reset() hook."""

    def reset(self):
        pass

    def __getitem__(self, i):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError


class IndexedRNG:
    """Deterministic, thread-safe per-sample randomness.

    Every sample derives a fresh Generator from (base seed, epoch, index),
    so crop/augmentation draws do not depend on how the loader's threads
    are scheduled, and differ across epochs and across repeated visits of
    the same record.  The Loader pins the epoch via ``set_epoch``."""

    def __init__(self, rng=None):
        src = rng if isinstance(rng, onp.random.Generator) \
            else onp.random.default_rng(rng)
        self._seed = int(src.integers(0, 2**63 - 1))
        self.epoch = 0

    def at(self, index) -> onp.random.Generator:
        return onp.random.default_rng((self._seed, self.epoch, int(index)))


def _augment(rng, *imgs):
    """Joint random flip/flip/transpose (reference sid_dataset.py:137-145)."""
    out = list(imgs)
    if rng.integers(2):
        out = [onp.flip(x, axis=0) for x in out]
    if rng.integers(2):
        out = [onp.flip(x, axis=1) for x in out]
    if rng.integers(2):
        out = [onp.transpose(x, (1, 0, 2)) for x in out]
    return out


class CleanPatchDataset(Dataset):
    """Clean patches from a PatchStore, optionally augmented.

    ``device_normalize=True`` ships the raw uint16 records and lets the
    train step normalize on the device (flips/transposes commute with the
    scalar normalization)."""

    def __init__(self, store, size=None, repeat=1, augment=True, rng=None,
                 device_normalize=False):
        self.store = store
        self.size = size
        self.repeat = repeat
        self.augment = augment
        self._rng = IndexedRNG(rng)
        self.device_normalize = device_normalize

    def set_epoch(self, epoch: int):
        self._rng.epoch = int(epoch)

    def reset(self):
        self._rng.epoch += 1

    def __getitem__(self, i):
        idx = i % (self.size or len(self.store))
        x = self.store.record(idx) if self.device_normalize else self.store[idx]
        if self.augment:
            (x,) = _augment(self._rng.at(i), x)
        return {"clean": onp.ascontiguousarray(x)}

    def __len__(self):
        return int((self.size or len(self.store)) * self.repeat)
