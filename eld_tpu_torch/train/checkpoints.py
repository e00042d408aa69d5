"""Checkpoints: save/find/load {netG, opt_g, epoch, iterations} as ``.pt``
(counterpart of ``eld_tpu/train/checkpoints.py``).

The file is the reference's ``.pt`` layout, so a released reference
checkpoint loads and the port's files load in the reference.  Names follow
eld_tpu's scheme with ``.pt`` in place of orbax's ``.ckpt``:

    model_<epoch:03d>_<iters:08d>.pt    numbered snapshots
    model_latest.pt                     every-epoch rolling save
    model_best_<key>_<name>.pt          best-on-eval save

``save_checkpoint(..., async_=True)`` (the Engine's default; eld_tpu
writes orbax checkpoints asynchronously too) copies the parameters and the
optimizer state to host memory before it returns and writes them on a
background thread, at most one write in flight.  The copy is what makes it
safe: torch's Adam updates the parameters in place, so a background
``torch.save`` of the live tensors would write a later step's weights, or
a torn mix of steps (eld_tpu's arrays are immutable, which is why orbax
can skip it).  ``wait_for_saves()`` blocks until the write has landed and
re-raises its error; so do the next save, every load, and the
interpreter's exit.  An orbax ``.ckpt`` directory from eld_tpu is refused
here; its params carry across as NumPy arrays through
``compat/jax_params.flax_to_state_dict``.
"""

from __future__ import annotations

import atexit
import os
import re
import threading
from typing import Optional

import torch

from eld_tpu_torch.train.state import TrainState, load_optimizer_state, optimizer_state_dict

_NUMBERED = re.compile(r"model_(\d{3,})_(\d{8,})\.pt$")


class _Writer:
    """One background checkpoint write at a time; its error is kept until
    ``wait`` raises it."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, payload: dict, path: str):
        self.wait()

        def write():
            try:
                _write(payload, path)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="checkpoint-writer")
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_WRITER = _Writer()
atexit.register(_WRITER.wait)


def wait_for_saves():
    """Block until the in-flight background write lands; re-raise its
    error if it failed."""
    _WRITER.wait()


def _write(payload: dict, path: str):
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _to_host(obj, devices: set):
    """A copy of ``obj`` (nested dicts/lists of tensors) in host memory.
    CUDA tensors are copied into pinned buffers on their devices' current
    streams, after whatever those streams have queued; their devices are
    added to ``devices`` for the caller to wait on."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cpu":
            return obj.detach().clone()
        devices.add(obj.device)
        host = torch.empty_like(obj, device="cpu", pin_memory=True)
        host.copy_(obj.detach(), non_blocking=True)
        return host
    if isinstance(obj, dict):
        return {k: _to_host(v, devices) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, devices) for v in obj)
    return obj


def checkpoint_path(save_dir: str, state: TrainState, label: Optional[str] = None) -> str:
    """Where ``save_checkpoint`` writes ``state``."""
    name = f"model_{label}.pt" if label else f"model_{state.epoch:03d}_{state.step:08d}.pt"
    return os.path.join(save_dir, name)


def save_checkpoint(save_dir: str, state: TrainState, label: Optional[str] = None,
                    async_: bool = False) -> str:
    """Write ``state``; ``label=None`` names the file from its counters.
    The file appears whole or not at all (written aside, then renamed).
    ``async_`` returns once the state is copied to host memory and writes
    it on the background thread (see the module docstring).  Either way
    an earlier background write lands first, so saves land in call order."""
    os.makedirs(save_dir, exist_ok=True)
    path = checkpoint_path(save_dir, state, label)
    payload = {"netG": state.model.state_dict(), "opt_g": optimizer_state_dict(state.optimizer),
               "epoch": state.epoch, "iterations": state.step}
    _WRITER.wait()
    if not async_:
        _write(payload, path)
        return path
    devices: set = set()
    payload = _to_host(payload, devices)
    for device in devices:
        torch.cuda.synchronize(device)
    _WRITER.submit(payload, path)
    return path


def find_checkpoint(save_dir: str, epoch: Optional[int] = None) -> Optional[str]:
    """The numbered checkpoint of ``epoch`` (None if there is none); with no
    epoch, the newest numbered one, else model_latest.pt, else None.  An
    in-flight save lands first."""
    wait_for_saves()
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
    wait_for_saves()
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
        load_optimizer_state(state.optimizer, ck["opt_g"])
    state.epoch = int(ck.get("epoch", 0))
    state.step = int(ck.get("iterations", 0))
    return state
