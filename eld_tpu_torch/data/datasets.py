"""Dataset compositions (counterpart of ``eld_tpu/data/datasets.py``).

Items are channels-last (H, W, C) NumPy arrays on the host, or dicts of
them.  The noise is normally synthesized on the device inside the train
step, so the usual training source is just clean patches
(``CleanPatchDataset``); ``ELDTrainDataset`` zips paired stores
(``train_real``, ``--offline_noise``), ``SynDataset``/``ISPDataset`` add
host-side noise and the ISP, and ``SIDDataset`` / ``ELDEvalDataset`` read
paired raws.  The sRGB stages run the port's ISP on CPU tensors in the
loader's threads.
"""

from __future__ import annotations

from os.path import join
from typing import Sequence

import numpy as onp
import torch

from eld_tpu_torch.core import isp as _isp
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


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._cum = onp.cumsum([len(d) for d in self.datasets])

    def __getitem__(self, i):
        k = int(onp.searchsorted(self._cum, i, side="right"))
        prev = 0 if k == 0 else int(self._cum[k - 1])
        return self.datasets[k][i - prev]

    def __len__(self):
        return int(self._cum[-1])

    def reset(self):
        for d in self.datasets:
            d.reset()


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


def _srgb(packed, wb, ccm, crf):
    """Host-side raw -> sRGB of one (H, W, 4) image: the port's ISP on a CPU
    tensor, NumPy in and out."""
    out = _isp.raw2rgb(torch.from_numpy(onp.ascontiguousarray(packed, onp.float32)), wb, ccm,
                       crf=crf)
    return out.numpy()


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
    pack/normalize -> x ratio -> optional sRGB stage -> optional in-RAM
    memoization -> random 512-crop + augment -> clip.  Crops and flips come
    from ``IndexedRNG`` exactly as in eld_tpu, so the same seed gives the
    same items.  ``stage_in``/``stage_out`` "srgb" render the input/target
    through the ISP (the CRF ``crf`` if given, else gamma), the input with
    its own wb/ccm or, under ``gt_wb``, the target's."""

    def __init__(self, datadir, paired_fns, size=None, augment=True, repeat=1,
                 cfa="bayer", memorize=True, stage_in="raw", stage_out="raw",
                 gt_wb=False, crf=None, patch_size=512, rng=None):
        self.datadir = datadir
        self.paired_fns = list(paired_fns)[:size] if size else list(paired_fns)
        self.augment = augment
        self.repeat = repeat
        self.cfa = cfa
        self.memorize = memorize
        self.stage_in = stage_in
        self.stage_out = stage_out
        self.gt_wb = gt_wb
        self.crf = crf
        self.patch_size = patch_size
        self._rng = IndexedRNG(rng)
        self._cache = {}

    def set_epoch(self, epoch: int):
        self._rng.epoch = int(epoch)

    def reset(self):
        self._rng.epoch += 1

    def _load_target(self, target_fn):
        raw = rawio.imread(join(self.datadir, "long", target_fn))
        img = raw.packed()
        wb, ccm = raw.wb / raw.wb[1], raw.ccm
        if self.stage_out == "srgb":
            img = _srgb(img, wb, ccm, self.crf)
        return img, (wb, ccm)

    def _load_input(self, input_fn, ratio, wbccm):
        raw = rawio.imread(join(self.datadir, "short", input_fn))
        img = raw.packed() * ratio
        if self.stage_in == "srgb":
            wb, ccm = wbccm if self.gt_wb else (raw.wb / raw.wb[1], raw.ccm)
            img = _srgb(img, wb, ccm, self.crf)
        return img

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
                self._cache[input_fn] = self._load_input(input_fn, ratio, wbccm)
            inp = self._cache[input_fn]
        else:
            target, wbccm = self._load_target(target_fn)
            inp = self._load_input(input_fn, ratio, wbccm)

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


class SynDataset(Dataset):
    """Host-side noisy-image synthesis over a clean source (reference
    ``SynDataset``), for offline baking; online training synthesizes on the
    device instead.  ``num_burst`` repeats one parameter draw across burst
    frames, concatenated on channels."""

    def __init__(self, dataset, noise_maker, size=None, repeat=1, num_burst=1):
        self.dataset = dataset
        self.noise_maker = noise_maker
        self.size = size
        self.repeat = repeat
        self.num_burst = num_burst

    def __getitem__(self, i):
        i = i % (self.size or len(self.dataset))
        clean = self.dataset[i]
        if self.num_burst > 1:
            params = self.noise_maker._sample_params()
            frames = [self.noise_maker(clean, params=params) for _ in range(self.num_burst)]
            noisy = onp.concatenate(frames, axis=-1)
        else:
            noisy = self.noise_maker(clean)
        return onp.ascontiguousarray(onp.clip(noisy, 0.0, 1.0), onp.float32)

    def __len__(self):
        return int((self.size or len(self.dataset)) * self.repeat)


class ISPDataset(Dataset):
    """Optional host-side noise, then raw -> sRGB with each patch's stored
    (wb, ccm) (reference ``ISPDataset``).  The clean source carries
    ``meta['wb']``/``meta['ccm']`` (the PatchStore's aux arrays)."""

    def __init__(self, dataset, noise_maker=None, meta=None, crf=None):
        self.dataset = dataset
        self.noise_maker = noise_maker
        self.meta = meta if meta is not None else dataset.meta
        self.crf = crf

    def __getitem__(self, i):
        x = self.dataset[i]
        if self.noise_maker is not None:
            x = self.noise_maker(x)
        x = onp.clip(x, 0.0, 1.0)
        # the store says which record item i is: a modulo by the meta length
        # pairs the wrong wb/ccm when the store shows a smaller size
        if hasattr(self.dataset, "physical_index"):
            j = self.dataset.physical_index(i)
        else:
            j = i % len(self.meta["wb"])
        x = _srgb(x, self.meta["wb"][j], self.meta["ccm"][j], self.crf)
        return onp.ascontiguousarray(onp.clip(x, 0.0, 1.0), onp.float32)

    def __len__(self):
        return len(self.dataset)


class ELDTrainDataset(Dataset):
    """A clean target source zipped with one or more input sources,
    interleaved ``input_datasets[i % N][i // N]``, jointly augmented
    (reference ``ELDTrainDataset``; the paired stores of ``train_real`` and
    ``--offline_noise``)."""

    def __init__(self, target_dataset, input_datasets, size=None, augment=True, rng=None):
        self.target_dataset = target_dataset
        self.input_datasets = list(input_datasets)
        self.size = size
        self.augment = augment
        self._rng = IndexedRNG(rng)

    def set_epoch(self, epoch: int):
        self._rng.epoch = int(epoch)

    def reset(self):
        self._rng.epoch += 1
        for d in (self.target_dataset, *self.input_datasets):
            if hasattr(d, "reset"):
                d.reset()

    def __getitem__(self, i):
        n = len(self.input_datasets)
        inp = self.input_datasets[i % n][i // n]
        tgt = self.target_dataset[i // n]
        if self.augment:
            inp, tgt = _augment(self._rng.at(i), inp, tgt)
        return {
            "input": onp.ascontiguousarray(onp.clip(inp, 0.0, 1.0), onp.float32),
            "target": onp.ascontiguousarray(tgt, onp.float32),
        }

    def __len__(self):
        return self.size or len(self.target_dataset) * len(self.input_datasets)


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
