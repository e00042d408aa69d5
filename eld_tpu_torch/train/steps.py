"""The train step (counterpart of ``eld_tpu/train/steps.py::make_train_step``).

The flagship path is the synthetic-noise step: a batch of clean patches
arrives on the device; per-image noise parameters are sampled there, the
fused noise kernel synthesizes the noisy input, and the U-Net forward,
backward and Adam step follow.  Noise is applied outside autograd (it
needs no gradient), as in the JAX step.  Without a noise model the step
takes paired {"input", "target"} batches (the ``train_real`` path).

Randomness is a pure function of the step seed, which the Engine derives
from (cfg.seed, iteration) with ``fold_in``, so a resumed run sees the
same noise.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as onp
import torch
from torch import nn

from eld_tpu_torch.models.losses import init_loss
from eld_tpu_torch.noise.kernels import synthesize_kernel
from eld_tpu_torch.noise.model import synthesize
from eld_tpu_torch.noise.params import CameraParamsBank, sample_params_batch
from eld_tpu_torch.train.state import TrainState

NOISE_IMPLS = ("auto", "kernel", "plain")
_MASK64 = (1 << 64) - 1
# the same f32 reciprocals as PatchStore's normalization
_INV_U16 = float(onp.float32(1.0 / 65535.0))
_INV_U8 = float(onp.float32(1.0 / 255.0))


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that scrambles bits."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed derived from (seed, data), like ``jax.random.fold_in``."""
    return _mix64(_mix64(int(seed) & _MASK64) ^ (int(data) & _MASK64))


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """uint16/uint8 batches are normalized on the device (a quarter / half
    the bytes of f32 cross the host link)."""
    if x.dtype == torch.uint16:
        return x.to(torch.float32) * _INV_U16
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * _INV_U8
    return x


def make_train_step(
    model: nn.Module,
    loss: str = "l1",
    noise_model: Optional[str] = None,
    bank: Optional[CameraParamsBank] = None,
    k_mode: str = "overridden",
    noise_impl: str = "auto",
    autocast_dtype: Optional[torch.dtype] = None,
):
    """Build ``step(state, batch, seed) -> metrics``; updates ``state`` in place.

    With ``noise_model`` the batch is {"clean": (N, H, W, C)} and the noisy
    input is synthesized on the batch's device; otherwise {"input",
    "target"}.  ``noise_impl``: "auto" launches the fused kernel for CUDA
    tensors and runs the plain version for CPU tensors; "kernel" is the
    same (a CPU tensor has no kernel); "plain" runs the plain PyTorch
    version on any device.  ``autocast_dtype`` (e.g. torch.bfloat16) runs
    the U-Net under autocast over f32 parameters.
    """
    synthetic = noise_model is not None
    if synthetic and bank is None:
        raise ValueError("synthetic training needs a CameraParamsBank")
    if noise_impl not in NOISE_IMPLS:
        raise ValueError(f"noise_impl must be one of {NOISE_IMPLS}, got {noise_impl!r}")
    loss_fn = init_loss(loss)
    gens: Dict[torch.device, torch.Generator] = {}

    def generator(device, seed):
        gen = gens.get(device)
        if gen is None:
            gen = gens[device] = torch.Generator(device=device)
        return gen.manual_seed(seed)

    def make_noisy(seed, clean):
        nparams = sample_params_batch(generator(clean.device, fold_in(seed, 0)), bank,
                                      clean.shape[0], k_mode=k_mode)
        noise_seed = fold_in(seed, 1)
        if noise_impl == "plain":
            return synthesize(generator(clean.device, noise_seed), clean, nparams,
                              model=noise_model, clip=True)
        return synthesize_kernel(noise_seed, clean, nparams, model=noise_model, clip=True)

    def step(state: TrainState, batch, seed: int):
        if synthetic:
            clean = to_f32(batch["clean"]).contiguous()
            with torch.no_grad():
                noisy = make_noisy(seed, clean)
            target = clean
        else:
            noisy = to_f32(batch["input"])
            target = to_f32(batch["target"])

        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        autocast = (torch.autocast(noisy.device.type, dtype=autocast_dtype)
                    if autocast_dtype is not None else contextlib.nullcontext())
        with autocast:
            pred = state.model(noisy)
        loss_val = loss_fn(pred.float(), target)
        loss_val.backward()
        state.optimizer.step()
        state.step += 1
        return {"Pixel": loss_val.detach()}

    return step
