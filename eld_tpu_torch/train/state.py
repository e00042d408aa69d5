"""Train state: model + Adam + step/epoch counters.

Counterpart of ``eld_tpu/train/state.py``.  The reference's checkpoint
content (netG, optimizer state, epoch, iterations) lives in one object.
Adam is ``Adam(lr, betas=(beta1, 0.999))``; with ``weight_decay > 0`` it
is ``AdamW``, because eld_tpu uses optax's ``adamw``, whose decay is
decoupled from the gradient (``Adam(weight_decay=)`` would couple it).
The learning rate is a mutable hyperparameter of the param group, so the
reference's manual LR stepping needs no rebuild.

On a card the optimizer is built ``capturable=True`` with its rate a
0-dim tensor on the parameters' device, on every path (per step, pooled,
data-parallel), so a CUDA graph can hold its step and all paths do the
same arithmetic.  ``set_learning_rate`` writes into that tensor, so a
replayed graph steps at the new rate.  On the CPU the rate is a float
(``capturable`` needs a card).  Checkpoints store the rate as a float
either way, and ``load_optimizer_state`` keeps the optimizer's own
``capturable`` setting and rate tensor.
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
    (decoupled decay) when ``weight_decay > 0``.  Parameters on a card
    get the capturable form, with the rate a 0-dim tensor beside them."""
    params = list(params)
    kw = dict(lr=float(lr), betas=(beta1, 0.999), eps=1e-8)
    device = params[0].device if params else torch.device("cpu")
    if device.type == "cuda":
        kw.update(lr=torch.tensor(float(lr), device=device), capturable=True)
    if weight_decay:
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def create_train_state(model: nn.Module, lr: float = 1e-4, beta1: float = 0.9,
                       weight_decay: float = 0.0) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), lr, beta1, weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every param group (parity with
    ``Engine.set_learning_rate``); a rate tensor is written in place, on
    its device's current stream."""
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with each group's rate as a float, the
    reference's ``opt_g`` layout."""
    sd = optimizer.state_dict()
    for group in sd["param_groups"]:
        group["lr"] = float(group["lr"])
    return sd


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved: dict):
    """Load ``saved`` (an ``opt_g``, from a card or from the CPU) into
    ``optimizer`` keeping its own ``capturable`` setting and rate tensor:
    the rate tensor is filled with the saved rate, and the step counters
    land where a capturable optimizer keeps them (the parameters' device)."""
    own = [(g["lr"], g.get("capturable", False)) for g in optimizer.param_groups]
    saved = {**saved, "param_groups": [{**g, "capturable": cap} for g, (_, cap)
                                       in zip(saved["param_groups"], own)]}
    optimizer.load_state_dict(saved)
    for group, (lr, _) in zip(optimizer.param_groups, own):
        value = float(group["lr"])
        group["lr"] = lr.fill_(value) if isinstance(lr, torch.Tensor) else value
