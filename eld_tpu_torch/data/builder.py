"""Offline dataset builder: packs raw files into PatchStore databases
(counterpart of ``eld_tpu/data/builder.py``; the same stores, byte for
byte in raw, so either package reads the other's).

The reference's LMDB recipes (``util/lmdb_data.py``): pack -> [x exposure
ratio] -> [host noise] -> [raw -> sRGB with the optional CRF] -> clip ->
uint16 -> center-crop to the stride grid -> non-overlapping patches ->
append, with each patch's (wb, ccm) in the aux sidecar.  The stores are
what ``train_syn`` (clean raw, sRGB, offline-noise) and ``train_real``
(paired input/target) read.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Sequence

import numpy as onp

from eld_tpu_torch.core.emor import load_crf
from eld_tpu_torch.data import rawio
from eld_tpu_torch.data.datasets import _srgb
from eld_tpu_torch.data.pairs import compute_expo_ratio, sid_pairs
from eld_tpu_torch.data.patchstore import PatchStoreWriter
from eld_tpu_torch.noise.host import HostNoiseModel
from eld_tpu_torch.noise.params import CAMERA_NAMES


def store_name(kind: str, stage: str = "raw", crf: bool = False,
               camera: Optional[str] = None) -> str:
    """The on-disk name of a store: ``kind`` "clean" (long exposures),
    "input"/"target" (the paired sides) or "syn" (offline noise of
    ``camera``, raw only), in the ``stage`` "raw" or "srgb" (``crf``: the
    calibrated CRF render)."""
    if kind == "syn":
        return f"SID_Sony_syn_Raw_{camera}.eps"
    side = "" if kind == "clean" else f"{kind}_"
    if stage == "srgb":
        return f"SID_Sony_{side}SRGB_CRF.eps" if crf else f"SID_Sony_{side}SRGB.eps"
    return f"SID_Sony_{side}Raw.eps"


def extract_patches(img: onp.ndarray, patch: int, stride: int) -> onp.ndarray:
    """(H, W, C) -> (N, patch, patch, C) grid patches, center-aligned (the
    builder's crop-to-grid + Data2Volume, lmdb_data.py:108-151).  An image
    smaller than a patch gives none."""
    H, W, C = img.shape
    ny = max((H - patch) // stride + 1, 0)
    nx = max((W - patch) // stride + 1, 0)
    crop_h = (ny - 1) * stride + patch
    crop_w = (nx - 1) * stride + patch
    y0 = (H - crop_h) // 2
    x0 = (W - crop_w) // 2
    img = img[y0 : y0 + crop_h, x0 : x0 + crop_w]
    out = onp.empty((ny * nx, patch, patch, C), img.dtype)
    k = 0
    for iy in range(ny):
        for ix in range(nx):
            out[k] = img[iy * stride : iy * stride + patch, ix * stride : ix * stride + patch]
            k += 1
    return out


def build_patch_db(
    fns: Sequence[str],
    targetdir: str,
    patch: int = 512,
    stride: int = 512,
    channels: int = 4,
    ratios: Optional[Sequence[float]] = None,
    srgb: bool = False,
    crf=None,
    uint16: bool = True,
    noise_maker=None,
    verbose: bool = True,
):
    """Pack raw files into a PatchStore at ``targetdir`` (created); refuses
    to overwrite a store."""
    if os.path.exists(join(targetdir, "data.bin")):
        raise FileExistsError(f"database already exists: {targetdir}")
    out_ch = 3 if srgb else channels
    dtype = onp.uint16 if uint16 else onp.float32

    with PatchStoreWriter(targetdir, (patch, patch, out_ch), dtype=dtype) as w:
        for i, fn in enumerate(fns):
            raw = rawio.imread(fn)
            x = raw.packed()
            wb = raw.wb / raw.wb[1]
            ccm = raw.ccm
            if ratios is not None:
                x = x * ratios[i]
            if noise_maker is not None:
                x = noise_maker(x)
            if srgb:
                x = _srgb(x, wb, ccm, crf)
            # clipped floats go to append(), whose float -> uint16 path rounds
            # (rint); a manual (x * 65535).astype would truncate
            x = onp.clip(x, 0.0, 1.0)
            n_before = w._count
            for p in extract_patches(x, patch, stride):
                w.append(p, wb=wb, ccm=ccm)
            if w._count == n_before and verbose:
                print(f"[w] {fn}: image smaller than patch size {patch}, skipped")
            if verbose:
                print(f"packed ({i + 1}/{len(fns)}): {fn} -> {w._count} patches total")
        if w._count == 0:
            raise ValueError(f"no patches produced: every input is smaller than patch={patch}")
    return targetdir


def _train_long_fns(sourcedir, num_samples=None):
    fns = sorted({fn[1] for fn in sid_pairs("train")})
    fns = [join(sourcedir, "long", fn) for fn in fns]
    return fns[:num_samples] if num_samples else fns


def create_sony_dataset(sourcedir, destdir, num_samples=None, patch=512, stride=512):
    """Clean long-exposure patches (reference create_sony_dataset, 232-248)."""
    return build_patch_db(_train_long_fns(sourcedir, num_samples),
                          join(destdir, store_name("clean")), patch=patch, stride=stride)


def create_sony_dataset_paired(sourcedir, destdir, num_samples=None):
    """Paired (input x ratio, target) stores (reference 251-272)."""
    fns = sorted(sid_pairs("train"))
    if num_samples:
        fns = fns[:num_samples]
    ratios = [compute_expo_ratio(a, b) for a, b in fns]
    build_patch_db([join(sourcedir, "short", a) for a, _ in fns],
                   join(destdir, store_name("input")), ratios=ratios)
    build_patch_db([join(sourcedir, "long", b) for _, b in fns],
                   join(destdir, store_name("target")))


def create_sony_dataset_srgb(sourcedir, destdir, num_samples=None, use_crf=True):
    """sRGB-domain clean patches, with the calibrated CRF by default
    (reference 275-303)."""
    crf = load_crf() if use_crf else None
    return build_patch_db(_train_long_fns(sourcedir, num_samples),
                          join(destdir, store_name("clean", "srgb", use_crf)),
                          srgb=True, crf=crf)


def create_sony_syn_dataset(sourcedir, destdir, camera_include: int,
                            noise_model: str = "g", num_samples=None, seed: int = 2019):
    """Offline-baked noisy patches of one camera, the reference's
    SID_Sony_syn_Raw_<camera> recipe (``train_syn --offline_noise``)."""
    camera = CAMERA_NAMES[camera_include]
    nm = HostNoiseModel(model=noise_model, include=camera_include,
                        rng=onp.random.default_rng(seed))
    return build_patch_db(_train_long_fns(sourcedir, num_samples),
                          join(destdir, store_name("syn", camera=camera)), noise_maker=nm)
