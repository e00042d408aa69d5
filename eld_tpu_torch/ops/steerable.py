"""Analytic frequency-domain steerable pyramid subbands (counterpart of
``eld_tpu/ops/steerable.py``: its NumPy band masks, copied, applied with
``torch.fft`` on the frame's device).

The reference's video-quality branch feeds frames through a band of
Simoncelli's ``sp5Filters`` steerable pyramid (skvideo.measure.strred,
consumed at ``util/index.py:5,88``).  The sp5 9x9/17x17 tap tables are
numerically-optimized *approximations* of an exactly-specified ideal: the
polar-separable frequency response of Simoncelli & Freeman, "The Steerable
Pyramid: A Flexible Architecture for Multi-Scale Derivative Computation"
(ICIP 1995), with the raised-cosine radial windows and ``cos^(K-1)``
angular windows given in closed form in Portilla & Simoncelli, IJCV 2000,
appendix (the ``buildSFpyr`` construction of matlabPyrTools).  The tap
tables themselves are unreachable offline; the defining math is not.  This
module implements that math directly:

  radial (log-polar raised cosine, unit-power complementary pair)
      L(r) = cos(pi/2 * clip(log2(4 r / pi), 0, 1))      lowpass
      H(r) = cos(pi/2 * clip(log2(2 r / pi), -1, 0))     highpass
      L^2 + H^2 = 1 on the transition annulus [pi/4, pi/2]

  angular (K orientations, order N = K-1)
      G_k(t) = sqrt(c_N) * cos(t - pi k / K)^N,
      c_N = 2^(2N) (N!)^2 / (K (2N)!)     so  sum_k G_k^2 = 1

  band k at level n >= 1 (n = 1 is the finest bandpass; L(r/2) is the
  initial lowpass split whose complement H(r/2) is the pyramid's
  highpass residual)
      B[n,k](r, t) = (-i)^N * L(r/2) * H(2^(n-1) r)
                     * prod_{j<n-1} L(2^j r) * G_k(t)

applied in the 2-D Fourier domain and inverse-transformed; the ``(-i)^N``
phase with the odd-symmetric angular window makes the result exactly real
for odd N (sp5: N = 5, K = 6 orientations — matching skvideo's
``filtfile="sp5Filters"``).  The returned band is subsampled by
``2^(n-1)``, the sampling rate the pyramid stores that level at; the band
occupies the alias-free annulus [pi/4, pi] at that rate.

Differences vs the sp5 tap implementation are numerical-tolerance, not
structural: exact vs approximated frequency response, and periodic (FFT)
vs reflected boundary handling.  The construction's defining properties —
unit tight frame, steerability, orientation/scale selectivity — are
asserted by ``tests/test_steerable.py`` for eld_tpu's copy; the port's
band is held against eld_tpu's in ``tests/test_torch_ops.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

SP5_NBANDS = 6  # sp5Filters: 5th-order filters, 6 orientation bands


@lru_cache(maxsize=64)
def _radial_grids(h: int, w: int):
    """Radial frequency magnitude r and angle theta for an (h, w) FFT."""
    fy = np.fft.fftfreq(h)[:, None] * 2.0 * np.pi
    fx = np.fft.fftfreq(w)[None, :] * 2.0 * np.pi
    r = np.sqrt(fy * fy + fx * fx)
    theta = np.arctan2(fy, fx)
    return r, theta


def _lowpass(r: np.ndarray) -> np.ndarray:
    """L(r): 1 for r <= pi/4, 0 for r >= pi/2, raised-cosine between."""
    with np.errstate(divide="ignore"):
        x = np.log2(np.maximum(4.0 * r / np.pi, 1e-300))
    return np.cos(0.5 * np.pi * np.clip(x, 0.0, 1.0))


def _highpass(r: np.ndarray) -> np.ndarray:
    """H(r): 0 for r <= pi/4, 1 for r >= pi/2; L^2 + H^2 = 1."""
    with np.errstate(divide="ignore"):
        x = np.log2(np.maximum(2.0 * r / np.pi, 1e-300))
    return np.cos(0.5 * np.pi * np.clip(x, -1.0, 0.0))


def _angular(theta: np.ndarray, k: int, nbands: int) -> np.ndarray:
    """G_k(theta): normalized odd cos^(K-1) window; sum_k G_k^2 = 1."""
    order = nbands - 1
    const = (2.0 ** (2 * order)) * (math.factorial(order) ** 2) / (
        nbands * math.factorial(2 * order))
    return np.sqrt(const) * np.cos(theta - np.pi * k / nbands) ** order


def _radial_band(r: np.ndarray, level: int) -> np.ndarray:
    """H at ``level``'s scale times the lowpass chain above it (including
    the initial lo0 = L(r/2) split — only level 1's support reaches it)."""
    m = _highpass((2.0 ** (level - 1)) * r) * _lowpass(0.5 * r)
    for j in range(level - 1):
        m = m * _lowpass((2.0 ** j) * r)
    return m


@lru_cache(maxsize=64)
def _band_mask(h: int, w: int, level: int, orientation: int,
               nbands: int) -> np.ndarray:
    """Complex frequency mask for one oriented band (host-side constant)."""
    r, theta = _radial_grids(h, w)
    order = nbands - 1
    phase = (-1j) ** order
    mask = phase * _radial_band(r, level) * _angular(theta, orientation, nbands)
    return np.ascontiguousarray(mask.astype(np.complex64))


def steerable_band(frame: torch.Tensor, level: int = 4, orientation: int = 0,
                   nbands: int = SP5_NBANDS) -> torch.Tensor:
    """One oriented steerable-pyramid subband of an (H, W) frame.

    ``level`` >= 1 counts down from the finest bandpass (passband centered
    at radial frequency ``pi / 2 ** level``); ``orientation`` selects the
    ``cos^(K-1)`` lobe at angle ``pi * orientation / nbands``.  Returns the
    real-valued band subsampled by ``2 ** (level - 1)``, the rate the
    pyramid stores that level at.  Defaults match the band skvideo's
    STRRED extracts from sp5Filters (level 4, first orientation, 6 bands).
    The frequency mask is a cached host constant; the device work is one
    FFT/iFFT pair.
    """
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if not 0 <= orientation < nbands:
        raise ValueError(f"orientation must be in [0, {nbands}), got {orientation}")
    # the mask is Hermitian for every nbands, so the band is exactly real
    h, w = frame.shape
    d = 2 ** (level - 1)
    if min(h, w) < 4 * d:
        raise ValueError(
            f"frame {h}x{w} too small for steerable level {level} "
            f"(needs min dim >= {4 * d}); use a smaller level or the "
            f"isotropic extractor (eld_tpu_torch.ops.strred.isotropic_subband)")
    hc, wc = (h // d) * d, (w // d) * d
    x = frame[:hc, :wc].float()
    mask = torch.from_numpy(_band_mask(hc, wc, level, orientation, nbands)).to(x.device)
    band = torch.fft.ifft2(torch.fft.fft2(x) * mask).real
    return band[::d, ::d]
