"""Dataset compositions (counterpart of ``eld_tpu/data/datasets.py``).

Items are dicts of channels-last (H, W, C) NumPy arrays on the host.  The
noise is synthesized on the device inside the train step, so the training
source is just clean patches; ``SIDDataset`` and ``ELDEvalDataset`` read
paired raws for evaluation.  The sRGB stages (ISP) and the offline-noise
training datasets are not ported yet (ROADMAP.md queue 1 #7, #9).
"""

from __future__ import annotations

from os.path import join

import numpy as onp

from eld_tpu_torch.data import rawio
from eld_tpu_torch.data.pairs import compute_expo_ratio


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


class SIDDataset(Dataset):
    """Paired short/long raw loader (reference ``SIDDataset``): decode ->
    pack/normalize -> x ratio -> optional in-RAM memoization -> random
    512-crop + augment -> clip.  Crops and flips come from ``IndexedRNG``
    exactly as in eld_tpu, so the same seed gives the same items."""

    def __init__(self, datadir, paired_fns, size=None, augment=True, repeat=1,
                 cfa="bayer", memorize=True, stage_in="raw", stage_out="raw",
                 patch_size=512, rng=None):
        if stage_in == "srgb" or stage_out == "srgb":
            raise NotImplementedError("not ported yet: sRGB stages (ISP: ROADMAP.md "
                                      "queue 1 #9)")
        self.datadir = datadir
        self.paired_fns = list(paired_fns)[:size] if size else list(paired_fns)
        self.augment = augment
        self.repeat = repeat
        self.cfa = cfa
        self.memorize = memorize
        self.patch_size = patch_size
        self._rng = IndexedRNG(rng)
        self._cache = {}

    def set_epoch(self, epoch: int):
        self._rng.epoch = int(epoch)

    def reset(self):
        self._rng.epoch += 1

    def _load_target(self, target_fn):
        raw = rawio.imread(join(self.datadir, "long", target_fn))
        return raw.packed(), (raw.wb / raw.wb[1], raw.ccm)

    def _load_input(self, input_fn, ratio):
        return rawio.imread(join(self.datadir, "short", input_fn)).packed() * ratio

    def __getitem__(self, i):
        rng = self._rng.at(i)  # pre-modulo: repeats get distinct crops
        i = i % len(self.paired_fns)
        input_fn, target_fn = self.paired_fns[i][:2]
        ratio = compute_expo_ratio(input_fn, target_fn)

        if self.memorize:
            if target_fn not in self._cache:
                self._cache[target_fn] = self._load_target(target_fn)
            target, wbccm = self._cache[target_fn]
            if input_fn not in self._cache:
                self._cache[input_fn] = self._load_input(input_fn, ratio)
            inp = self._cache[input_fn]
        else:
            target, wbccm = self._load_target(target_fn)
            inp = self._load_input(input_fn, ratio)

        if self.augment:
            ps = self.patch_size
            # both bounds from the input frame (pairs are same-geometry)
            H, W = inp.shape[0], inp.shape[1]
            if H < ps or W < ps:
                raise ValueError(f"{input_fn}: frame {H}x{W} is smaller than "
                                 f"patch_size {ps}")
            # +1: an exactly-patch-sized frame crops at offset 0
            yy = int(rng.integers(0, H - ps + 1))
            xx = int(rng.integers(0, W - ps + 1))
            inp_c = inp[yy:yy + ps, xx:xx + ps]
            tgt_c = target[yy:yy + ps, xx:xx + ps]
            inp_c, tgt_c = _augment(rng, inp_c, tgt_c)
        else:
            inp_c, tgt_c = inp, target

        inp_c = onp.clip(inp_c, 0.0, 1.0)
        return {
            "input": onp.ascontiguousarray(inp_c, onp.float32),
            "target": onp.ascontiguousarray(tgt_c, onp.float32),
            "fn": input_fn,
            "cfa": self.cfa,
            "rawpath": join(self.datadir, "long", target_fn),
            "wb": onp.asarray(wbccm[0], onp.float32),
            "ccm": onp.asarray(wbccm[1], onp.float32),
            "ratio": onp.float32(ratio),
        }

    def __len__(self):
        return len(self.paired_fns) * self.repeat


class ELDEvalDataset(Dataset):
    """ELD dataset walker (reference ``ELDEvalDataset``): scenes x img_ids,
    the ground truth is the nearest of ids {1, 6, 11, 16}, and the
    amplification ratio comes from the EXIF iso*exposure of GT vs input."""

    GT_IDS = (1, 6, 11, 16)

    def __init__(self, basedir, camera_suffix, scenes, img_ids):
        self.basedir = basedir
        self.camera, self.suffix = camera_suffix
        self.scenes = list(scenes)
        self.img_ids = list(img_ids)

    def _path(self, scene, img_id):
        return join(self.basedir, self.camera, f"scene-{scene}", f"IMG_{img_id:04d}{self.suffix}")

    def __getitem__(self, i):
        scene = self.scenes[i // len(self.img_ids)]
        img_id = self.img_ids[i % len(self.img_ids)]
        gt_id = min(self.GT_IDS, key=lambda g: abs(img_id - g))

        input_path = self._path(scene, img_id)
        target_path = self._path(scene, gt_id)
        raw_t = rawio.imread(target_path)
        raw_i = rawio.imread(input_path)
        denom = raw_i.iso * raw_i.exposure
        if denom <= 0:
            raise ValueError(f"{input_path}: EXIF iso*exposure is {denom} — cannot derive "
                             "the amplification ratio (missing/corrupt EXIF)")
        ratio = (raw_t.iso * raw_t.exposure) / denom
        if ratio <= 0:
            raise ValueError(f"{target_path}: EXIF iso*exposure is "
                             f"{raw_t.iso * raw_t.exposure} — amplification ratio {ratio} "
                             "is degenerate (missing/corrupt EXIF)")

        inp = onp.clip(raw_i.packed() * ratio, 0.0, 1.0)
        tgt = onp.clip(raw_t.packed(), 0.0, 1.0)
        return {
            "input": onp.ascontiguousarray(inp, onp.float32),
            "target": onp.ascontiguousarray(tgt, onp.float32),
            "fn": input_path,
            "rawpath": target_path,
            "wb": raw_t.wb / raw_t.wb[1],
            "ccm": raw_t.ccm,
            "ratio": onp.float32(ratio),
        }

    def __len__(self):
        return len(self.scenes) * len(self.img_ids)
