"""Raw -> sRGB ISP simulation on NHWC tensors (counterpart of
``eld_tpu/core/isp.py``; the reference's ``util/process.py:52-68``):

    white balance -> clip -> RGBG binning -> color correction matrix
    -> clip -> gamma 1/2.2 (with 8-bit quantization) OR calibrated CRF

Batched (N, H, W, 4) raw -> (N, H, W, 3) sRGB on any device.  The two
8-bit quantization points (``util/process.py:38`` and ``:82``) are kept
exactly: they truncate toward zero, they do not round.  The 3x3 color
product is written as elementwise sums, so no matmul path (and no TF32 on
the card) touches it, and the CRF's ``jnp.interp`` is a searchsorted plus
the same lerp, clamped to the first and last response value outside the
grid.
"""

from __future__ import annotations

import numpy as onp
import torch


def _tensor(x, device) -> torch.Tensor:
    """An f32 tensor on ``device`` from a tensor, an array or a list."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(onp.asarray(x, onp.float32), device=device)


def apply_gains(raw: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """White balance. raw: (N, H, W, 4), wb: (N, 4) in RGBG channel order."""
    return raw * wb[:, None, None, :]


def binning(raw: torch.Tensor) -> torch.Tensor:
    """RGBG -> linear RGB by averaging the two green planes."""
    g = 0.5 * (raw[..., 1] + raw[..., 3])
    return torch.stack([raw[..., 0], g, raw[..., 2]], dim=-1)


def apply_ccms(rgb: torch.Tensor, ccm: torch.Tensor) -> torch.Tensor:
    """Color correction. rgb: (N, H, W, 3), ccm: (N, 3, 3) cam->sRGB;
    out[..., i] = sum_j rgb[..., j] * ccm[i, j] (the reference's
    row-vector convention, ``util/process.py:22-31``)."""
    c = ccm[:, None, None]  # (N, 1, 1, 3, 3)
    out = [rgb[..., 0] * c[..., i, 0] + rgb[..., 1] * c[..., i, 1] + rgb[..., 2] * c[..., i, 2]
           for i in range(3)]
    return torch.stack(out, dim=-1)


def quantize_8bit(img: torch.Tensor) -> torch.Tensor:
    """Simulated 8-bit output: truncate x*255 toward zero, clamp, back to
    [0, 1] (torch's ``.int()`` in the reference)."""
    return torch.clamp(torch.trunc(img * 255.0), 0.0, 255.0) / 255.0


def gamma_compression(img: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Linear -> gamma space with 8-bit quantization."""
    return quantize_8bit(torch.clamp_min(img, 1e-8) ** (1.0 / gamma))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing 1-D ``xp``: the same bracket
    (searchsorted on the right, clamped to [1, K-1]), the same lerp, and
    fp[0] / fp[-1] outside the grid."""
    k = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, k - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx, df = xp[i] - x0, fp[i] - f0
    eps = float(onp.spacing(onp.finfo(onp.float32).eps))
    flat = dx.abs() <= eps
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def apply_crf(img: torch.Tensor, crf_e: torch.Tensor, crf_fs: torch.Tensor) -> torch.Tensor:
    """A camera response function by 1-D interpolation per channel, then
    the 8-bit quantization (``util/process.py:82``).

    img: (N, H, W, 3) linear RGB in [0, 1]; crf_e: (3, K) irradiance grid;
    crf_fs: (3, K) response per channel."""
    out = torch.stack([interp(img[..., c], crf_e[c], crf_fs[c]) for c in range(3)], dim=-1)
    return quantize_8bit(out)


def process(raw: torch.Tensor, wb: torch.Tensor, ccm: torch.Tensor, gamma: float = 2.2,
            crf=None) -> torch.Tensor:
    """Batched raw (RGBG, NHWC) -> sRGB.

    raw: (N, H, W, 4) in [0, 1]; wb: (N, 4); ccm: (N, 3, 3); crf: optional
    (E, fs) pair of (3, K) arrays or tensors."""
    x = torch.clamp(apply_gains(raw, wb), 0.0, 1.0)
    x = torch.clamp(apply_ccms(binning(x), ccm), 0.0, 1.0)
    if crf is None:
        return gamma_compression(x, gamma)
    return apply_crf(x, _tensor(crf[0], x.device), _tensor(crf[1], x.device))


def raw2rgb(packed: torch.Tensor, wb, ccm, crf=None, gamma: float = 2.2) -> torch.Tensor:
    """One image: (H, W, 4) -> (H, W, 3); wb (4,) is normalized by its
    green, ccm is the top-left 3x3 of what is given."""
    wb = _tensor(wb, packed.device)
    wb = wb / wb[1]
    ccm = _tensor(ccm, packed.device)[:3, :3]
    return process(packed[None], wb[None], ccm[None], gamma=gamma, crf=crf)[0]
