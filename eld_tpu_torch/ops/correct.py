"""Illuminance correction before metrics (counterpart of
``eld_tpu/ops/correct.py``; the reference's ``IlluminanceCorrect``,
``models/ELD_model.py:156-169``).

The prediction is clamped to [0, 1] and scaled by
alpha = <pred, source> / <pred, pred> over the pixels where
``source != 1`` (saturated source pixels are left out).  Where that
denominator is 0 (an all-zero prediction, or a fully saturated source)
alpha is 1 instead of the reference's 0/0 = NaN.
"""

from __future__ import annotations

import torch


def illuminance_correct(pred: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """One (H, W, C) image: pred corrected against source."""
    return illuminance_correct_batch(pred[None], source[None])[0]


def illuminance_correct_batch(pred: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) pred and source -> corrected pred, one alpha per item;
    a source of batch 1 is shared across the batch."""
    pred = pred.float().clamp(0.0, 1.0)
    source = source.float()
    if source.shape[0] == 1 and pred.shape[0] != 1:
        source = source.expand_as(pred)
    mask = (source != 1.0).float()
    num = (pred * source * mask).sum(dim=(1, 2, 3))
    den = (pred * pred * mask).sum(dim=(1, 2, 3))
    ok = den > 0.0
    alpha = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                        torch.ones_like(den))
    return alpha.reshape(-1, 1, 1, 1) * pred
