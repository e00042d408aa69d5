"""Spatio-Temporal Reduced-Reference Entropic Differencing (ST-RRED),
counterpart of ``eld_tpu/ops/strred.py`` in PyTorch.

The reference's video-quality branch calls ``skvideo.measure.strred``
(``util/index.py:5,88``).  skvideo is unmaintained (NumPy-2 incompatible,
absent from this image — the reference's own STRRED path cannot run here
either), so this is a from-the-paper implementation of

    R. Soundararajan and A. C. Bovik, "Video Quality Assessment by
    Reduced Reference Spatio-Temporal Entropic Differencing," IEEE
    TCSVT 2013.

Algorithm (per consecutive-frame pair):
  * take a bandpass subband of the frame (spatial stream) and of the
    frame difference (temporal stream) at a coarse scale;
  * model subband coefficients as a Gaussian Scale Mixture over 3x3
    blocks: covariance C over block vectors, per-block premultiplier
    s_i = w_i^T C^{-1} w_i / 9, local entropies
    h_i = 1/2 sum_j log2(2*pi*e*(s_i lambda_j + sigma_n^2));
  * scale entropies by log2(1+s) (and the temporal stream additionally
    by the spatial log2(1+s), suppressing entropy differences where the
    reference itself has little structure);
  * the per-frame spatial/temporal RRED indexes are the mean absolute
    scaled-entropy differences between reference and distorted; ST-RRED
    is the product of their temporal means.

Subband extractor: skvideo feeds frames through a band of Simoncelli's
sp5Filters steerable pyramid (level 4, first orientation).  The default
here is the same subband computed from the *analytic* steerable-pyramid
construction the sp5 tap tables approximate (``ops/steerable.py`` — the
tap tables themselves are verified unreachable offline, but the defining
frequency-domain math is exact and published).  Remaining differences vs
skvideo are numerical-tolerance, not structural: exact vs tap-approximated
frequency response, and periodic (FFT) vs reflected boundaries.  The
extractor stays PLUGGABLE (``strred(..., subband_fn=...)``); an isotropic
bandpass at the same scale (``isotropic_subband``) is kept for frames too
small for steerable level 4.  The entropic-differencing core — the metric
itself — follows the paper.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from eld_tpu_torch.ops.steerable import steerable_band

_BLK = 3
_SIGMA_NSQ = 0.1
_LEVELS = 3  # blur+decimate steps before the bandpass (scale 1/8)
_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur, zero-padded edges; x: (H, W)."""
    k = torch.tensor(_BINOMIAL, dtype=torch.float32, device=x.device) / 16.0
    x = F.conv2d(x[None, None], k.reshape(1, 1, 5, 1), padding=(2, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, 5), padding=(0, 2))
    return x[0, 0]


def isotropic_subband(frame: torch.Tensor) -> torch.Tensor:
    """Coarse-scale isotropic bandpass of one (H, W) frame (scale 1/8): the
    orientation-free extractor for frames too small for steerable level 4."""
    g = frame.float()
    for _ in range(_LEVELS):
        g = _blur(g)[::2, ::2]
    return g - _blur(g)


def _default_subband(frame: torch.Tensor) -> torch.Tensor:
    """skvideo's band: steerable level 4; isotropic below its min size."""
    h, w = frame.shape
    if min(h, w) >= 32:
        return steerable_band(frame, level=4, orientation=0)
    return isotropic_subband(frame)


def _est_params(y: torch.Tensor):
    """GSM local params over 3x3 blocks: (premultipliers s, entropies h)."""
    h, w = y.shape
    hc, wc = (h // _BLK) * _BLK, (w // _BLK) * _BLK
    if hc == 0 or wc == 0:
        # zero blocks: the mean/cov over an empty axis would be NaN
        raise ValueError(
            f"subband {h}x{w} has no full {_BLK}x{_BLK} blocks — frames "
            f"are too small for ST-RRED (luma must stay >= "
            f"{_BLK * 8} px after the pyramid's decimation)")
    y = y[:hc, :wc]
    b = (y.reshape(hc // _BLK, _BLK, wc // _BLK, _BLK)
          .permute(0, 2, 1, 3).reshape(-1, _BLK * _BLK))
    bc = b - b.mean(dim=0)
    cov = bc.T @ bc / b.shape[0]
    # one symmetric eigendecomposition gives the eigenvalues and the
    # pseudo-inverse (cov is PSD)
    lam_raw, vec = torch.linalg.eigh(cov)
    lam = torch.clamp_min(lam_raw, 0.0)
    inv_lam = torch.where(lam > 1e-12 * lam.max(), 1.0 / lam, torch.zeros_like(lam))
    cinv = (vec * inv_lam[None, :]) @ vec.T
    ss = torch.clamp_min(torch.einsum("ni,ij,nj->n", bc, cinv, bc) / (_BLK * _BLK), 0.0)
    ent = 0.5 * torch.sum(
        torch.log2(2.0 * math.pi * math.e * (ss[:, None] * lam[None, :] + _SIGMA_NSQ)), dim=1)
    return ss, ent


def _extract_info(frame1, frame2, subband_fn=None):
    """Scaled spatial/temporal entropy fields for one frame pair."""
    sb = subband_fn or _default_subband
    y = sb(frame1)
    yd = sb(frame1 - frame2)
    ss, ent = _est_params(y)
    ssd, entd = _est_params(yd)
    spatial = ent * torch.log2(1.0 + ss)
    temporal = entd * torch.log2(1.0 + ss) * torch.log2(1.0 + ssd)
    return spatial, temporal


def _strred_pair(r0, r1, d0, d1, subband_fn=None):
    sp_r, tp_r = _extract_info(r0, r1, subband_fn)
    sp_d, tp_d = _extract_info(d0, d1, subband_fn)
    return torch.stack([torch.mean(torch.abs(sp_r - sp_d)),
                        torch.mean(torch.abs(tp_r - tp_d)),
                        torch.abs(torch.mean(sp_r) - torch.mean(sp_d)),
                        torch.abs(torch.mean(tp_r) - torch.mean(tp_d))])


def strred(reference, distorted, subband_fn=None):
    """ST-RRED for (T, H, W) grayscale clips, T >= 2, on their device.

    ``subband_fn``: optional (H, W) -> coefficients extractor replacing
    the default analytic steerable band (level 4, first orientation —
    skvideo's choice; module docstring).

    Returns ``(per_frame, strred, strredsn)`` — the triple the reference
    unpacks from skvideo (``util/index.py:88``): ``per_frame`` is a (T-1,
    2) tensor of per-pair (spatial, temporal) RRED indexes, ``strred`` =
    mean(spatial) * mean(temporal), and ``strredsn`` the single-number
    (field-mean-first) variant.
    """
    ref = torch.as_tensor(reference).float()
    dis = torch.as_tensor(distorted).float()
    if ref.ndim != 3 or ref.shape != dis.shape:
        raise ValueError(f"expected matching (T, H, W) clips, got "
                         f"{tuple(ref.shape)} vs {tuple(dis.shape)}")
    if ref.shape[0] < 2:
        raise ValueError("ST-RRED needs at least 2 frames")
    pairs = torch.stack([_strred_pair(ref[t], ref[t + 1], dis[t], dis[t + 1], subband_fn)
                         for t in range(ref.shape[0] - 1)])
    srred, trred, srred_sn, trred_sn = pairs.unbind(dim=1)
    return (torch.stack([srred, trred], dim=1),
            float(srred.mean() * trred.mean()),
            float(srred_sn.mean() * trred_sn.mean()))
