"""Pixel losses keyed by the reference's names, and ``MultipleLoss``, the
weighted-sum combinator (counterpart of ``eld_tpu/models/losses.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


_LOSSES = {"l1": l1_loss, "l2": l2_loss}


def init_loss(name: str) -> Callable:
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; have {sorted(_LOSSES)}")
    return _LOSSES[name]


class MultipleLoss:
    """Weighted sum of losses (reference ``MultipleLoss``, losses.py:4-14);
    equal weights summing to 1 by default."""

    def __init__(self, losses: Sequence[Callable], weight: Optional[Sequence[float]] = None):
        self.losses = list(losses)
        self.weight = list(weight) if weight else [1.0 / len(self.losses)] * len(self.losses)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for w, loss in zip(self.weight, self.losses):
            total = total + w * loss(pred, target)
        return total
