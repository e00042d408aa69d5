"""Physics-based raw noise formation model in plain PyTorch.

Counterpart of ``eld_tpu/noise/model.py``; per image, for clean y in [0,1]:

    y_dn = y * saturation_level / ratio            # clean signal in DN
    shot:  'P' z = Poisson(y_dn / K) * K           # hybrid or exact
           'p' z = y_dn + N(0,1) * sqrt(max(K*y_dn, 1e-10))
    read:  'g' z += N(0,1) * max(g_scale, 1e-10)
           'G' z += TL(lambda) * max(G_scale, 1e-10)   # Tukey-lambda
    row:   'r' z += N_row(0,1) * R_scale   # (R,G1) even rows, (B,G2) odd
    quant: 'q' z += U(-0.5, 0.5)
    bias:  'c' z += color_bias[channel]    # 4-channel Bayer only
    out  = z * ratio / saturation_level

It is split into a deterministic core, ``noise_core``, that takes every
random draw as an argument, and a thin sampling wrapper,
``synthesize``, that makes the draws on a ``torch.Generator``.  The core
is what the tests hold exactly against JAX (fed JAX's own draws) and
what the CUDA kernel's own draws are checked through; ``synthesize`` is
the kernel's plain version.  Images are NHWC throughout.
"""

from __future__ import annotations

from typing import Dict

import torch

from eld_tpu_torch.noise.fast_poisson import poisson_from_draws
from eld_tpu_torch.noise.params import NoiseParams

MODEL_ALIASES = {
    "eld": "PGrqc",  # full ELD model
    "ELD": "PGrqc",
}


def expand_model(model: str) -> str:
    """Resolve a model alias to its component characters."""
    return MODEL_ALIASES.get(model, model)


def tukey_lambda_from_uniform(u: torch.Tensor, lam) -> torch.Tensor:
    """Tukey-lambda inverse CDF Q(u; lam) = (u^lam - (1-u)^lam) / lam,
    with the logistic limit logit(u) at |lam| < 1e-6."""
    lam = torch.as_tensor(lam, dtype=u.dtype, device=u.device)
    small = torch.abs(lam) < 1e-6
    safe = torch.where(small, torch.ones_like(lam), lam)
    q = (torch.pow(u, safe) - torch.pow(1.0 - u, safe)) / safe
    logistic = torch.log(u) - torch.log1p(-u)
    return torch.where(small, logistic, q)


def tukey_lambda(gen: torch.Generator, shape, lam, device="cpu") -> torch.Tensor:
    """Sample the standard Tukey-lambda distribution via inverse CDF."""
    u = torch.rand(shape, generator=gen, device=device).clamp(1e-7, 1.0 - 1e-7)
    return tukey_lambda_from_uniform(u, lam)


def noise_core(clean: torch.Tensor, p: NoiseParams, model: str,
               draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Noisy image from clean (N, H, W, C) and per-image params (N,), given
    the draws the model's components consume (unclipped):

      'P': ``shot_counts`` (Poisson counts of y_dn/K), or ``poisson_u``
           (U(1e-12, 1)) with ``shot_n`` (N(0,1)) for the hybrid sampler
      'p': ``shot_n``        'g': ``read_n``       'G': ``tukey_u``
      'r': ``row_n`` (N, H, 2): (even, odd) draw per packed row
      'q': ``quant_u`` (U(-0.5, 0.5))
    Per-element draws have clean's shape."""
    model = expand_model(model)
    n, _, _, c = clean.shape

    def per_image(t):
        return t.reshape(n, 1, 1, 1)

    sat, ratio, K = per_image(p.saturation_level), per_image(p.ratio), per_image(p.K)
    y = clean.float() * sat / ratio

    if "P" in model:
        counts = draws.get("shot_counts")
        if counts is None:
            counts = poisson_from_draws(y / K, draws["poisson_u"], draws["shot_n"])
        z = counts * K
    elif "p" in model:
        z = y + draws["shot_n"] * torch.sqrt(torch.clamp_min(K * y, 1e-10))
    else:
        z = y

    if "g" in model:
        z = z + draws["read_n"] * torch.clamp_min(per_image(p.g_scale), 1e-10)
    if "G" in model:
        tl = tukey_lambda_from_uniform(draws["tukey_u"], per_image(p.G_shape))
        z = z + tl * torch.clamp_min(per_image(p.G_scale), 1e-10)

    if "r" in model:
        rows = draws["row_n"] * p.R_scale.reshape(n, 1, 1)  # (N, H, 2)
        if c == 4:  # packed (R, G1) on even sensor rows, (B, G2) on odd
            row_noise = rows[:, :, None, [0, 0, 1, 1]]
        else:       # non-Bayer layouts: one draw per packed row
            row_noise = rows[:, :, None, 0:1]
        z = z + row_noise

    if "q" in model:
        z = z + draws["quant_u"]

    if "c" in model and c == 4:
        # calibrated per Bayer channel; non-Bayer layouts skip it
        z = z + p.color_bias.reshape(n, 1, 1, -1)

    return z * ratio / sat


def sample_draws(gen: torch.Generator, clean: torch.Tensor, p: NoiseParams,
                 model: str, poisson: str = "fast") -> Dict[str, torch.Tensor]:
    """Draw what ``noise_core`` consumes for ``model`` on ``gen``."""
    model = expand_model(model)
    n, h, _, _ = clean.shape
    shape, dev = clean.shape, clean.device
    rand = lambda s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    randn = lambda s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    draws = {}
    if "P" in model:
        if poisson == "fast":
            draws["poisson_u"] = torch.clamp_min(rand(shape), 1e-12)
            draws["shot_n"] = randn(shape)
        elif poisson == "exact":
            lam = clean.float() * (p.saturation_level / p.ratio / p.K).reshape(n, 1, 1, 1)
            draws["shot_counts"] = torch.poisson(lam, generator=gen)
        else:
            raise ValueError(f"poisson must be 'fast' or 'exact', got {poisson!r}")
    elif "p" in model:
        draws["shot_n"] = randn(shape)
    if "g" in model:
        draws["read_n"] = randn(shape)
    if "G" in model:
        draws["tukey_u"] = rand(shape).clamp(1e-7, 1.0 - 1e-7)
    if "r" in model:
        draws["row_n"] = randn((n, h, 2))
    if "q" in model:
        draws["quant_u"] = rand(shape) - 0.5
    return draws


def synthesize(gen: torch.Generator, clean: torch.Tensor, params: NoiseParams,
               model: str = "g", clip: bool = True, poisson: str = "fast") -> torch.Tensor:
    """Batched noise synthesis: clean (N, H, W, C) + params (N,) -> noisy.

    ``gen`` lives on clean's device.  The plain version of the fused
    kernel (``noise/kernels.py``)."""
    noisy = noise_core(clean, params, model, sample_draws(gen, clean, params, model, poisson))
    return torch.clamp(noisy, 0.0, 1.0) if clip else noisy

