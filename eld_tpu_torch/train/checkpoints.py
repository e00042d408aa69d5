"""Checkpoints: save/find/load {netG, opt_g, epoch, iterations} as ``.pt``
(counterpart of ``eld_tpu/train/checkpoints.py``).

The file is the reference's ``.pt`` layout, so a released reference
checkpoint loads and the port's files load in the reference.  Names follow
eld_tpu's scheme with ``.pt`` in place of orbax's ``.ckpt``:

    model_<epoch:03d>_<iters:08d>.pt    numbered snapshots
    model_latest.pt                     every-epoch rolling save
    model_best_<key>_<name>.pt          best-on-eval save

Saves are synchronous: eld_tpu writes orbax checkpoints asynchronously,
which the port does not do yet (ROADMAP.md).  An orbax ``.ckpt`` directory
from eld_tpu is refused here; its params carry across as NumPy arrays
through ``compat/jax_params.flax_to_state_dict``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from eld_tpu_torch.train.state import TrainState

_NUMBERED = re.compile(r"model_(\d{3,})_(\d{8,})\.pt$")


def save_checkpoint(save_dir: str, state: TrainState, label: Optional[str] = None) -> str:
    """Write ``state``; ``label=None`` names the file from its counters.
    The file appears whole or not at all (written aside, then renamed)."""
    os.makedirs(save_dir, exist_ok=True)
    name = f"model_{label}.pt" if label else f"model_{state.epoch:03d}_{state.step:08d}.pt"
    path = os.path.join(save_dir, name)
    tmp = path + ".tmp"
    torch.save({"netG": state.model.state_dict(),
                "opt_g": state.optimizer.state_dict(),
                "epoch": state.epoch,
                "iterations": state.step}, tmp)
    os.replace(tmp, path)
    return path


def find_checkpoint(save_dir: str, epoch: Optional[int] = None) -> Optional[str]:
    """The numbered checkpoint of ``epoch`` (None if there is none); with no
    epoch, the newest numbered one, else model_latest.pt, else None."""
    if not os.path.isdir(save_dir):
        return None
    numbered = []
    for fn in os.listdir(save_dir):
        m = _NUMBERED.search(fn)
        if m:
            numbered.append((int(m.group(1)), int(m.group(2)), fn))
    if epoch is not None:
        hits = [t for t in numbered if t[0] == epoch]
        return os.path.join(save_dir, sorted(hits)[-1][2]) if hits else None
    if numbered:
        return os.path.join(save_dir, sorted(numbered)[-1][2])
    latest = os.path.join(save_dir, "model_latest.pt")
    return latest if os.path.exists(latest) else None


def _read(path: str, device) -> dict:
    if path.rstrip("/").endswith(".ckpt"):
        raise ValueError(
            f"{path} is an eld_tpu orbax checkpoint, which the port does not read: "
            "restore its params with eld_tpu (numpy arrays), convert them with "
            "eld_tpu_torch.compat.jax_params.flax_to_state_dict and save them as "
            "{'netG': state_dict} in a .pt file")
    return torch.load(path, map_location=device, weights_only=True)


def load_params(path: str, model: torch.nn.Module):
    """Load a ``.pt``'s network weights into ``model`` (on its device);
    returns the file's (epoch, iterations), 0 where it holds none."""
    ck = _read(path, next(model.parameters()).device)
    model.load_state_dict(ck["netG"])
    return int(ck.get("epoch", 0)), int(ck.get("iterations", 0))


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore params, and the optimizer state, epoch and iterations where
    the file holds them, into ``state`` (in place, on its device)."""
    ck = _read(path, next(state.model.parameters()).device)
    state.model.load_state_dict(ck["netG"])
    if "opt_g" in ck:
        state.optimizer.load_state_dict(ck["opt_g"])
    state.epoch = int(ck.get("epoch", 0))
    state.step = int(ck.get("iterations", 0))
    return state
