"""Calibrated camera noise parameters and their sampling, in PyTorch.

Counterpart of ``eld_tpu/noise/params.py``.  The bank is built from the
same calibration files, with the same ISO padding guard; sampling follows
the same semantics (camera uniform over the selected set, log K uniform,
log-linear scale profiles, ratio uniform, ISO uniform over the camera's
real calibrated settings) on an explicit ``torch.Generator``.  The bits
differ from ``jax.random``'s, so parity with the reference is in
distribution; ``NoiseParams`` can be built directly to replay parameters.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as onp
import torch

from eld_tpu_torch._paths import CAMERA_PARAMS_DIR

CAMERA_NAMES = ("CanonEOS5D4", "CanonEOS70D", "CanonEOS700D", "NikonD850", "SonyA7S2")
SATURATION_DEFAULT = 16383.0 - 800.0
N_ISO = 18


def _tensor_map(obj, fn):
    return type(obj)(**{f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class CameraParamsBank:
    """Stacked calibration data: (C,) per camera, (C, 18[, 4]) per ISO."""

    kmin: torch.Tensor
    kmax: torch.Tensor
    g_slope: torch.Tensor
    g_bias: torch.Tensor
    g_sigma: torch.Tensor
    G_slope: torch.Tensor
    G_bias: torch.Tensor
    G_sigma: torch.Tensor
    R_slope: torch.Tensor
    R_bias: torch.Tensor
    R_sigma: torch.Tensor
    g_shape: torch.Tensor      # (C, 18) per-ISO Tukey-lambda shape
    color_bias: torch.Tensor   # (C, 18, 4) per-ISO per-channel bias (DN)
    n_iso: torch.Tensor        # (C,) int64: real calibrated ISO count

    @property
    def num_cameras(self) -> int:
        return self.kmin.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kmin.device


def _select(names, include=None, exclude=None):
    names = list(names)
    if include is not None and exclude is not None:
        raise ValueError("pass include or exclude, not both")
    if include is not None:
        names = [names[include]]
    elif exclude is not None:
        skip = names[exclude]
        names = [n for n in names if n != skip]
    return names


def _pad_rows(a: onp.ndarray, n: int) -> onp.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = onp.repeat(a[-1:], n - a.shape[0], axis=0)
    return onp.concatenate([a, pad], axis=0)


def load_camera_params(
    cameras: Optional[Sequence[str]] = None,
    include: Optional[int] = None,
    exclude: Optional[int] = None,
    param_dir: Optional[str] = None,
    device="cpu",
) -> CameraParamsBank:
    """Load calibration .npy files into a stacked bank on ``device``.

    include/exclude index the camera list, as the reference CLI does."""
    names = _select(cameras or CAMERA_NAMES, include, exclude)
    param_dir = param_dir or CAMERA_PARAMS_DIR
    cols = {k: [] for k in (
        "kmin", "kmax", "g_slope", "g_bias", "g_sigma", "G_slope", "G_bias",
        "G_sigma", "R_slope", "R_bias", "R_sigma", "g_shape", "color_bias",
        "n_iso")}
    for name in names:
        raw = onp.load(os.path.join(param_dir, f"{name}_params.npy"), allow_pickle=True).item()
        prof = raw["Profile-1"]
        cols["kmin"].append(raw["Kmin"])
        cols["kmax"].append(raw["Kmax"])
        for tag, key in (("g", "g_scale"), ("G", "G_scale"), ("R", "R_scale")):
            cols[f"{tag}_slope"].append(prof[key]["slope"])
            cols[f"{tag}_bias"].append(prof[key]["bias"])
            cols[f"{tag}_sigma"].append(prof[key]["sigma"])
        g_shape = onp.asarray(raw["G_shape"], dtype=onp.float32)
        cb = onp.asarray(raw["color_bias"], dtype=onp.float32)
        # Cameras with fewer calibrated ISOs are edge-padded so the bank
        # stacks; sampling draws iso < n_iso so padding is never chosen.
        # Clamped to N_ISO because _pad_rows truncates longer files.
        cols["n_iso"].append(min(len(g_shape), cb.shape[0], N_ISO))
        cols["g_shape"].append(_pad_rows(g_shape[:, None], N_ISO)[:, 0])
        cols["color_bias"].append(_pad_rows(cb, N_ISO))
    arrs = {k: torch.from_numpy(onp.stack(v).astype(onp.int64 if k == "n_iso" else onp.float32))
            for k, v in cols.items()}
    arrs = {k: v.to(device) for k, v in arrs.items()}
    return CameraParamsBank(**arrs)


@dataclasses.dataclass
class NoiseParams:
    """Per-image noise parameters: every field is (N,), color_bias (N, 4)."""

    K: torch.Tensor                 # system gain (DN/e-)
    g_scale: torch.Tensor           # Gaussian read-noise scale (DN)
    G_scale: torch.Tensor           # Tukey-lambda read-noise scale (DN)
    G_shape: torch.Tensor           # Tukey-lambda shape (lambda)
    R_scale: torch.Tensor           # row-noise scale (DN)
    color_bias: torch.Tensor        # (N, 4) per-channel bias (DN)
    saturation_level: torch.Tensor  # white_point - black_level
    ratio: torch.Tensor             # exposure amplification


def sample_params_batch(
    gen: torch.Generator,
    bank: CameraParamsBank,
    batch_size: int,
    k_mode: str = "overridden",
    ratio_range=(100.0, 300.0),
    saturation_level: float = SATURATION_DEFAULT,
) -> NoiseParams:
    """Sample ``batch_size`` independent parameter sets on the bank's device.

    ``gen`` must live on that device (``torch.Generator(device=...)``)."""
    n, dev = batch_size, bank.device
    cam = torch.randint(0, bank.num_cameras, (n,), generator=gen, device=dev)
    if k_mode == "overridden":
        log_lo = torch.full((n,), math.log(0.1), device=dev)
        log_hi = torch.full((n,), math.log(30.0), device=dev)
    elif k_mode == "calibrated":
        log_lo, log_hi = torch.log(bank.kmin[cam]), torch.log(bank.kmax[cam])
    else:
        raise ValueError(f"unknown k_mode {k_mode!r}")
    log_K = log_lo + torch.rand(n, generator=gen, device=dev) * (log_hi - log_lo)

    def scale(slope, bias, sigma):
        eps = torch.randn(n, generator=gen, device=dev)
        return torch.exp(eps * sigma[cam] + slope[cam] * log_K + bias[cam])

    g_scale = scale(bank.g_slope, bank.g_bias, bank.g_sigma)
    G_scale = scale(bank.G_slope, bank.G_bias, bank.G_sigma)
    R_scale = scale(bank.R_slope, bank.R_bias, bank.R_sigma)
    # iso ~ U{0..n_iso[cam]-1}; the clamp guards f32 rounding of u*n up to n
    n_iso = bank.n_iso[cam]
    iso = (torch.rand(n, generator=gen, device=dev) * n_iso).long()
    iso = torch.minimum(iso, n_iso - 1)
    lo, hi = ratio_range
    ratio = lo + torch.rand(n, generator=gen, device=dev) * (hi - lo)
    return NoiseParams(
        K=torch.exp(log_K),
        g_scale=g_scale,
        G_scale=G_scale,
        G_shape=bank.g_shape[cam, iso],
        R_scale=R_scale,
        color_bias=bank.color_bias[cam, iso],
        saturation_level=torch.full((n,), saturation_level, device=dev),
        ratio=ratio,
    )


def sample_params(gen: torch.Generator, bank: CameraParamsBank, **kw) -> NoiseParams:
    """One parameter set: every field a scalar tensor (color_bias (4,))."""
    p = sample_params_batch(gen, bank, 1, **kw)
    return _tensor_map(p, lambda t: t[0])
