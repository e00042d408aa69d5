"""Pixel losses keyed by the reference's names (counterpart of
``eld_tpu/models/losses.py``)."""

from __future__ import annotations

from typing import Callable

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
