"""Train and eval steps (counterpart of ``eld_tpu/train/steps.py``).

The flagship path is the synthetic-noise step: a batch of clean patches
arrives on the device; per-image noise parameters are sampled there, the
fused noise kernel synthesizes the noisy input, and the U-Net forward,
backward and Adam step follow.  Noise is applied outside autograd (it
needs no gradient), as in the JAX step.  Without a noise model the step
takes paired {"input", "target"} batches (the ``train_real`` path).

``make_train_scan`` is the pooled form: K steps per call over a patch
pool that lives on the device, each step picking and augmenting its own
batch there.  ``make_eval_forward`` is the inference forward with the
edge-pad to the arch's alignment, or the 4-tile chop.

Randomness is a pure function of the step seed, which the Engine derives
from (cfg.seed, iteration) with ``fold_in``, so a resumed run sees the
same noise and the same picks.  Each step seed is split the same way
everywhere: ``fold_in(seed, 0)`` samples the noise parameters, 1 seeds
the noise, 2 the pool picks and 3 the augmentation masks.

Data parallelism (``shard=(rank, world)``, one rank per card): every rank
draws the GLOBAL batch's randomness from the step seed (the noise
parameters, and in the pool the picks and the augmentation masks) and
keeps its own rows (``parallel.mesh.rank_rows``), so the global batch is
the one-process run's.  The noise of a rank's rows is seeded with
``rank_noise_seed``.  The forward is a DistributedDataParallel wrapper,
which averages the gradients over the ranks; the reported loss is the
mean over ranks, reduced once per call.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as onp
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from eld_tpu_torch.models.losses import init_loss
from eld_tpu_torch.noise.kernels import synthesize_kernel
from eld_tpu_torch.noise.model import synthesize
from eld_tpu_torch.noise.params import CameraParamsBank, sample_params_batch, take_rows
from eld_tpu_torch.ops.chop import forward_chop
from eld_tpu_torch.parallel.mesh import rank_rows
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


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def rank_noise_seed(seed: int, rank: int = 0, world: int = 1) -> int:
    """The noise seed of ``rank``'s rows at step seed ``seed``:
    ``fold_in(seed, 1)`` in a one-rank run, and ``fold_in(fold_in(seed, 1),
    rank)`` under data parallelism, so each rank draws its own stream.
    Not ``seed + rank * c``: additive seeding is what made the TPU kernel
    replay streams (eld_tpu/noise/kernels.py:78-85)."""
    noise = fold_in(seed, 1)
    return noise if world == 1 else fold_in(noise, rank)


def global_mean(values: torch.Tensor, world: int = 1) -> torch.Tensor:
    """The mean over the ranks of each rank's ``values``, one all-reduce;
    ``values`` itself in a one-rank run."""
    if world == 1:
        return values
    out = values.detach().clone()
    dist.all_reduce(out)
    return out / world


def _make_local_step(loss, noise_model, bank, k_mode, noise_impl, autocast_dtype, forward, shard):
    """``step(state, batch, seed) -> loss``: one optimizer step on this
    rank's rows, returning the rank's own loss (detached, on the device)."""
    synthetic = noise_model is not None
    if synthetic and bank is None:
        raise ValueError("synthetic training needs a CameraParamsBank")
    if noise_impl not in NOISE_IMPLS:
        raise ValueError(f"noise_impl must be one of {NOISE_IMPLS}, got {noise_impl!r}")
    loss_fn = init_loss(loss)
    rank, world = shard
    gens: Dict[torch.device, torch.Generator] = {}

    def generator(device, seed):
        gen = gens.get(device)
        if gen is None:
            gen = gens[device] = torch.Generator(device=device)
        return gen.manual_seed(seed)

    def make_noisy(seed, clean):
        n = clean.shape[0] * world  # the global batch's parameters, then this rank's rows
        nparams = sample_params_batch(generator(clean.device, fold_in(seed, 0)), bank, n,
                                      k_mode=k_mode)
        if world > 1:
            nparams = take_rows(nparams, rank_rows(rank, world, n))
        noise_seed = rank_noise_seed(seed, rank, world)
        if noise_impl == "plain":
            return synthesize(generator(clean.device, noise_seed), clean, nparams,
                              model=noise_model, clip=True)
        return synthesize_kernel(noise_seed, clean, nparams, model=noise_model, clip=True)

    def step(state: TrainState, batch, seed: int) -> torch.Tensor:
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
        with _autocast(noisy.device, autocast_dtype):
            pred = (state.model if forward is None else forward)(noisy)
        loss_val = loss_fn(pred.float(), target)
        loss_val.backward()
        state.optimizer.step()
        state.step += 1
        return loss_val.detach()

    return step


def make_train_step(
    model: nn.Module,
    loss: str = "l1",
    noise_model: Optional[str] = None,
    bank: Optional[CameraParamsBank] = None,
    k_mode: str = "overridden",
    noise_impl: str = "auto",
    autocast_dtype: Optional[torch.dtype] = None,
    forward: Optional[nn.Module] = None,
    shard: tuple = (0, 1),
):
    """Build ``step(state, batch, seed) -> metrics``; updates ``state`` in place.

    With ``noise_model`` the batch is {"clean": (N, H, W, C)} and the noisy
    input is synthesized on the batch's device; otherwise {"input",
    "target"}.  ``noise_impl``: "auto" launches the fused kernel for CUDA
    tensors and runs the plain version for CPU tensors; "kernel" is the
    same (a CPU tensor has no kernel); "plain" runs the plain PyTorch
    version on any device.  ``autocast_dtype`` (e.g. torch.bfloat16) runs
    the U-Net under autocast over f32 parameters.

    ``shard=(rank, world)``: the batch holds this rank's N rows of a global
    batch of N * world, ``forward`` is the DistributedDataParallel wrapper
    of ``state.model`` the step calls (default: ``state.model``), and
    "Pixel" is the mean over the ranks (see the module docstring).
    """
    step = _make_local_step(loss, noise_model, bank, k_mode, noise_impl, autocast_dtype,
                            forward, shard)

    def reported(state: TrainState, batch, seed: int):
        return {"Pixel": global_mean(step(state, batch, seed), shard[1])}

    return reported


def augment_masks(generator: torch.Generator, n: int):
    """Three independent fair coins per sample: (H-flip, W-flip, transpose),
    each a bool tensor of shape (n,) on the generator's device."""
    return tuple(torch.rand((3, n), generator=generator, device=generator.device) < 0.5)


def augment_batch(imgs: Sequence[torch.Tensor], flip_h: torch.Tensor, flip_w: torch.Tensor,
                  transpose: torch.Tensor):
    """Per-sample joint flip/flip/transpose of (N, H, W, C) batches, given
    the three (N,) bool masks (eld_tpu's ``_augment_batch`` draws the same
    masks from its key).  The transpose applies to square patches only.
    Packed CFA planes flip without a channel reorder, as in the reference."""
    def where(mask, a, b):
        return torch.where(mask.reshape(-1, 1, 1, 1), a, b)

    out = [where(flip_h, x.flip(1), x) for x in imgs]
    out = [where(flip_w, x.flip(2), x) for x in out]
    if imgs[0].shape[1] == imgs[0].shape[2]:
        out = [where(transpose, x.transpose(1, 2), x) for x in out]
    return [x.contiguous() for x in out]


def _gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool[idx].  A uint16 pool is gathered through an int16 view of the
    same bytes, which is exact: CUDA's index kernels do not cover the
    unsigned 16-bit type in every torch release."""
    if pool.dtype == torch.uint16:
        return pool.view(torch.int16)[idx].view(torch.uint16)
    return pool[idx]


def pick_batch(pool: Dict[str, torch.Tensor], batch: int, seed: int,
               rows: Optional[slice] = None, augment: bool = True):
    """One step's batch from a device-resident pool: ``batch`` rows picked
    uniformly with replacement, the same rows from every entry (paired
    pools stay aligned), converted to f32, then jointly augmented (unless
    ``augment`` is false; the picks are the same either way).  With
    ``rows`` only those rows of the picked batch (a data-parallel rank's)
    are gathered and augmented."""
    first = next(iter(pool.values()))
    dev = first.device
    gen = torch.Generator(device=dev).manual_seed(fold_in(seed, 2))
    idx = torch.randint(0, first.shape[0], (batch,), generator=gen, device=dev)
    if rows is not None:
        idx = idx[rows]
    out = {k: to_f32(_gather_rows(v, idx)) for k, v in pool.items()}
    if not augment:
        return out
    masks = augment_masks(torch.Generator(device=dev).manual_seed(fold_in(seed, 3)), batch)
    if rows is not None:
        masks = tuple(m[rows] for m in masks)
    return dict(zip(out, augment_batch(list(out.values()), *masks)))


def make_train_scan(
    model: nn.Module,
    loss: str = "l1",
    noise_model: Optional[str] = None,
    bank: Optional[CameraParamsBank] = None,
    k_mode: str = "overridden",
    batch: int = 16,
    steps_per_call: int = 10,
    augment: bool = True,
    autocast_dtype: Optional[torch.dtype] = None,
    forward: Optional[nn.Module] = None,
    shard: tuple = (0, 1),
):
    """K train steps per call over a device-resident patch pool.

    Returns ``fn(state, pool, seeds) -> metrics``: ``pool`` is
    {"clean": (P, H, W, C)} for synthetic training or {"input", "target"}
    of equal P for paired training, usually uint16 (``pool_to_device``);
    ``seeds`` holds one seed per step.  Step j picks and augments its batch
    with ``pick_batch(pool, batch, seeds[j], augment=augment)`` and then is
    exactly ``make_train_step``'s step on that batch with ``seeds[j]``.
    ``augment=False`` keeps the picked patches as they are (the synthetic
    demo's scan-vs-per-step A/B, whose per-step arm never augments).  Metrics
    are the mean and the last of the K losses, left on the device.
    ``batch`` is the global batch; under ``shard=(rank, world)`` each step
    keeps the rank's rows of it, and the K losses are averaged over the
    ranks in one all-reduce per call.

    The K steps run as a host loop of eager launches.  They are not
    captured in a CUDA graph: the noise kernel takes its seed as a host
    argument, so a captured graph would replay one seed's noise every step.
    """
    step = _make_local_step(loss, noise_model, bank, k_mode, "auto", autocast_dtype, forward,
                            shard)
    rows = rank_rows(*shard, batch) if shard[1] > 1 else None

    def multi(state: TrainState, pool: Dict[str, torch.Tensor], seeds: Sequence[int]):
        if len(seeds) != steps_per_call:
            raise ValueError(f"{len(seeds)} seeds for {steps_per_call} steps per call")
        losses = torch.stack([step(state, pick_batch(pool, batch, seed, rows, augment), seed)
                              for seed in seeds])
        losses = global_mean(losses, shard[1])
        return {"Pixel": losses.mean(), "PixelLast": losses[-1]}

    return multi


def edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Replicate-pad the (H, W) dims of an NHWC batch up to (hp, wp), on
    the NCHW view."""
    h, w = x.shape[1], x.shape[2]
    if (hp, wp) == (h, w):
        return x
    padded = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="replicate")
    return padded.permute(0, 2, 3, 1)


def make_eval_forward(model: nn.Module, chop: bool = False,
                      autocast_dtype: Optional[torch.dtype] = None):
    """Inference ``fwd(x) -> pred`` on NHWC batches, without autograd.

    Without ``chop`` the frame is edge-padded on H and W up to the arch's
    alignment and the output cropped back, so full frames that are not a
    multiple of it (SID's 1424x2128 is 16- but not 32-aligned) run.  With
    ``chop`` the 4-tile forward runs, its tiles on the same alignment.
    ``autocast_dtype`` runs the model under autocast (``--bf16``)."""
    base = model.alignment()

    def apply(t):
        with _autocast(t.device, autocast_dtype):
            return model(t)

    @torch.no_grad()
    def fwd(x: torch.Tensor) -> torch.Tensor:
        if chop:
            return forward_chop(apply, x, base=base)
        h, w = x.shape[1], x.shape[2]
        hp, wp = -(-h // base) * base, -(-w // base) * base
        if (hp, wp) == (h, w):
            return apply(x)
        return apply(edge_pad(x, hp, wp))[:, :h, :w]

    return fwd
