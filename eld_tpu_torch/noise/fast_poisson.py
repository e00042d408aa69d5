"""Hybrid Poisson sampling for per-pixel shot-noise rates.

Counterpart of ``eld_tpu/noise/fast_poisson.py``, same algorithm:

  * lam <= SMALL_MAX: inverse-CDF search over a FIXED 40 terms of the
    PMF recursion, in linear space (p_{k+1} = p_k * (lam * 1/(k+1)) with
    f32 reciprocals), gated on p_k > 1e-12;
  * lam  > SMALL_MAX: round(lam + sqrt(lam) * N(0,1)), clamped at >= 0.

``poisson_small_from_uniform`` is the shared deterministic core; the CUDA
kernel (``csrc/noise_synth.cu``) runs the same loop per element.
"""

from __future__ import annotations

import numpy as onp
import torch

SMALL_MAX = 12.0
_N_TERMS = 40
# f32 reciprocals 1/(k+1), the same values the reference computes as an
# f32 scalar divide per term
_RECIP = [float(onp.float32(1.0) / onp.float32(k + 1)) for k in range(_N_TERMS)]


def poisson_small_from_uniform(lam_s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Poisson(lam_s) counts (float32) for lam_s <= SMALL_MAX given uniform
    draws ``u`` in (0, 1]: count = #{k : F(k) < u} over 40 PMF terms."""
    pk = torch.exp(-lam_s)
    cdf = pk
    count = torch.zeros_like(lam_s)
    for r in _RECIP:
        # the pk gate stops a u above the f32-saturated cdf running on
        live = (cdf < u) & (pk > 1e-12)
        count = count + live.to(count.dtype)
        pk = pk * (lam_s * r)
        cdf = cdf + pk
    return count


def poisson_from_draws(lam: torch.Tensor, u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The hybrid given its draws: uniform ``u`` (small branch) and
    standard normal ``n`` (large branch)."""
    lam = torch.clamp_min(lam.float(), 0.0)
    small = poisson_small_from_uniform(torch.clamp_max(lam, SMALL_MAX), u)
    large = torch.clamp_min(torch.round(lam + torch.sqrt(lam) * n), 0.0)
    return torch.where(lam > SMALL_MAX, large, small)


def fast_poisson(gen: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
    """Sample Poisson(lam) elementwise; returns float32 counts."""
    u = torch.clamp_min(torch.rand(lam.shape, generator=gen, device=lam.device), 1e-12)
    n = torch.randn(lam.shape, generator=gen, device=lam.device)
    return poisson_from_draws(lam, u, n)
