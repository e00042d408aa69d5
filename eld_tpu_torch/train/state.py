"""Train state: model + Adam + step/epoch counters.

Counterpart of ``eld_tpu/train/state.py``.  The reference's checkpoint
content (netG, optimizer state, epoch, iterations) lives in one object.
Adam is ``Adam(lr, betas=(beta1, 0.999))``; with ``weight_decay > 0`` it
is ``AdamW``, because eld_tpu uses optax's ``adamw``, whose decay is
decoupled from the gradient (``Adam(weight_decay=)`` would couple it).
The learning rate is a mutable hyperparameter of the param group, so the
reference's manual LR stepping needs no rebuild.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0    # iteration counter
    epoch: int = 0


def make_optimizer(params, lr: float = 1e-4, beta1: float = 0.9,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam(lr, betas=(beta1, 0.999), eps=1e-8) — optax's defaults; AdamW
    (decoupled decay) when ``weight_decay > 0``."""
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(beta1, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)


def create_train_state(model: nn.Module, lr: float = 1e-4, beta1: float = 0.9,
                       weight_decay: float = 0.0) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), lr, beta1, weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every param group (parity with
    ``Engine.set_learning_rate``)."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])
