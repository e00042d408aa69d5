"""Network utilities (counterpart of ``eld_tpu/models/netutils.py``)."""

from __future__ import annotations

from torch import nn


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
