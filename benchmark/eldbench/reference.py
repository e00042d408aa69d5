"""The plain reference of one pooled synthetic-noise train step, in plain
PyTorch and float32: what the program's step computes, written out from
the published description and the program's documented semantics, with
no code of the program, of ``jax`` or of ``eld_tpu``.

One step with step seed ``s`` (the Engine's ``fold_in(seed, iteration)``):

  * picks: ``batch`` rows of the uint16 pool, uniformly with replacement,
    from a device generator seeded ``fold_in(s, 2)``; the clean patch is
    ``u16 * float32(1/65535)``;
  * augmentation: three fair coins a row (H flip, W flip, transpose) from
    a generator seeded ``fold_in(s, 3)``, applied in that order;
  * noise parameters (ELD's calibrated camera model, one camera bank read
    from the calibration file) from a generator seeded ``fold_in(s, 0)``;
  * noise: the ELD model "PGrqc" (Poisson shot noise by the hybrid
    sampler, Tukey-lambda read noise, row noise, quantization, colour
    bias; no Gaussian read noise, whose scale is drawn all the same), its
    draws from Philox4x32-10 keyed by ``fold_in(s, 1)`` (and, on rank r
    of a data-parallel run, ``fold_in(fold_in(s, 1), r)`` for that rank's
    rows), clipped to [0, 1];
  * the model of the configuration's ``arch``: ``archs/<arch>.py``'s
    ``forward`` (the SID U-Net's is ``archs/unet.py``), its initial
    weights that module's ``make_weights``, drawn from
    ``weight_generator``;
  * the L1 loss against the clean patch, and Adam (beta2 0.999, eps 1e-8).

``precision`` "f32" is the reference; "bf16" the same under bfloat16
autocast, as the program computes; "fp8" is the control, the same
step with every convolution's (or matmul's) input and weight rounded to
float8 e4m3 and the gradient reaching its output rounded to float8 e5m2,
each with a per-tensor scale: ``_conv`` does so, and an architecture's
other products go through ``_fake_fp8`` and ``_GradFp8`` alike.
``fault`` plants one of the faults the comparison has to catch, in place
of the program: "half_batch" (the loss is the mean over the first half
of the rows) and "no_exchange" (rank ``rank`` steps on the gradient of
its own rows alone).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
INV_U16 = float(np.float32(1.0 / 65535.0))
SATURATION = 16383.0 - 800.0
N_ISO = 18
SMALL_MAX = 12.0
RECIP = [float(np.float32(1.0) / np.float32(k + 1)) for k in range(40)]
BETA2, EPS = 0.999, 1e-8


# ---- seeds ------------------------------------------------------------------

def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed from (seed, data): splitmix64's finalizer, twice."""
    return _mix64(_mix64(int(seed) & MASK64) ^ (int(data) & MASK64))


def noise_seed(step_seed: int, rank: int, world: int) -> int:
    s = fold_in(step_seed, 1)
    return s if world == 1 else fold_in(s, rank)


# ---- the initial weights ------------------------------------------------------

def weight_generator(seed: int, device) -> torch.Generator:
    """The generator an architecture's ``make_weights`` draws from, seeded
    from the run's ``seed`` apart from every other draw of the run."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, 0x5EED) >> 1)


# ---- the control's float8 rounding -------------------------------------------

def _fake_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) with a per-tensor scale
    that maps its largest magnitude to the type's largest, then back."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g, torch.float8_e5m2)


def _conv(x, w, b, precision, transpose=False, **kw):
    if precision == "fp8":
        # forward in e4m3, straight through to the unrounded tensors
        x = x + (_fake_fp8(x, torch.float8_e4m3fn) - x).detach()
        w = w + (_fake_fp8(w, torch.float8_e4m3fn) - w).detach()
    y = (F.conv_transpose2d if transpose else F.conv2d)(x, w, b, **kw)
    return _GradFp8.apply(y) if precision == "fp8" else y


# ---- noise parameters ----------------------------------------------------------

def camera_bank(path: str, device) -> Dict[str, torch.Tensor]:
    """One camera's calibration (the ELD release's ``<camera>_params.npy``)
    as (1, ...) tensors."""
    raw = np.load(path, allow_pickle=True).item()
    prof = raw["Profile-1"]
    g_shape = np.asarray(raw["G_shape"], np.float32)
    cb = np.asarray(raw["color_bias"], np.float32)
    n_iso = min(len(g_shape), cb.shape[0], N_ISO)

    def pad(a):
        return a[:N_ISO] if a.shape[0] >= N_ISO else np.concatenate(
            [a, np.repeat(a[-1:], N_ISO - a.shape[0], axis=0)])

    cols = {"g_shape": pad(g_shape), "color_bias": pad(cb), "n_iso": np.int64(n_iso)}
    for tag, key in (("g", "g_scale"), ("G", "G_scale"), ("R", "R_scale")):
        for part in ("slope", "bias", "sigma"):
            cols[f"{tag}_{part}"] = np.float32(prof[key][part])
    return {k: torch.as_tensor(np.asarray(v)[None]).to(device) for k, v in cols.items()}


def sample_params(gen: torch.Generator, bank, n: int) -> Dict[str, torch.Tensor]:
    """ELD's sampling, K "overridden" to log-uniform on [0.1, 30], ratio
    uniform on [100, 300], ISO uniform over the calibrated settings; the
    draws in the program's order on its generator."""
    dev = gen.device
    cam = torch.randint(0, 1, (n,), generator=gen, device=dev)
    lo, hi = math.log(0.1), math.log(30.0)
    log_k = lo + torch.rand(n, generator=gen, device=dev) * (hi - lo)

    def scale(tag):
        eps = torch.randn(n, generator=gen, device=dev)
        return torch.exp(eps * bank[f"{tag}_sigma"][cam] + bank[f"{tag}_slope"][cam] * log_k
                         + bank[f"{tag}_bias"][cam])

    g, big_g, r = scale("g"), scale("G"), scale("R")
    n_iso = bank["n_iso"][cam]
    iso = torch.minimum((torch.rand(n, generator=gen, device=dev) * n_iso).long(), n_iso - 1)
    ratio = 100.0 + torch.rand(n, generator=gen, device=dev) * 200.0
    return {"K": torch.exp(log_k), "g_scale": g, "G_scale": big_g, "R_scale": r,
            "G_shape": bank["g_shape"][cam, iso], "color_bias": bank["color_bias"][cam, iso],
            "sat": torch.full((n,), SATURATION, device=dev), "ratio": ratio}


# ---- Philox4x32-10 and the noise -------------------------------------------------

def _mulhilo(a: int, x: torch.Tensor):
    pl = a * (x & 0xFFFF)
    t = a * (x >> 16) + (pl >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (pl & 0xFFFF)


def philox(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
    return c0, c1, c2, c3


def _u01(x):
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def _box_muller(u1, u2):
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-7)))
    th = 6.283185307179586 * u2
    return r * torch.cos(th), r * torch.sin(th)


def _poisson(lam, u, n):
    lam = torch.clamp_min(lam, 0.0)
    lam_s = torch.clamp_max(lam, SMALL_MAX)
    pk = torch.exp(-lam_s)
    cdf, count = pk, torch.zeros_like(lam_s)
    for r in RECIP:
        count = count + ((cdf < u) & (pk > 1e-12)).to(count.dtype)
        pk = pk * (lam_s * r)
        cdf = cdf + pk
    large = torch.clamp_min(torch.round(lam + torch.sqrt(lam) * n), 0.0)
    return torch.where(lam > SMALL_MAX, large, count)


def eld_noise(seed: int, clean: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """ELD's "PGrqc" on clean (n, h, w, 4) in [0, 1], clipped to [0, 1]."""
    n, h, w, c = clean.shape
    key = (seed & MASK32, seed >> 32)
    idx = torch.arange(n * h * w * c, device=clean.device, dtype=torch.int64)
    zero = torch.zeros_like(idx)
    a = [_u01(x).reshape(clean.shape) for x in philox((idx & MASK32, idx >> 32, zero, zero), key)]
    del idx, zero
    rows = torch.arange(n * h, device=clean.device, dtype=torch.int64)
    rz = torch.zeros_like(rows)
    rr = philox((rows & MASK32, rows >> 32, rz + 2, rz), key)
    even, odd = _box_muller(_u01(rr[0]), _u01(rr[1]))

    def per_image(t):
        return t.reshape(n, 1, 1, 1)

    sat, ratio, k = per_image(p["sat"]), per_image(p["ratio"]), per_image(p["K"])
    y = clean * sat / ratio
    z = _poisson(y / k, torch.clamp_min(a[0], 1e-12), _box_muller(a[0], a[1])[0]) * k
    u = a[2].clamp(1e-7, 0.9999999)
    lam = per_image(p["G_shape"])
    small = torch.abs(lam) < 1e-6
    safe = torch.where(small, torch.ones_like(lam), lam)
    tl = torch.where(small, torch.log(u) - torch.log1p(-u),
                     (torch.pow(u, safe) - torch.pow(1.0 - u, safe)) / safe)
    z = z + tl * torch.clamp_min(per_image(p["G_scale"]), 1e-10)
    row = torch.stack([even, odd], -1).reshape(n, h, 2) * p["R_scale"].reshape(n, 1, 1)
    z = z + row[:, :, None, :, None].expand(-1, -1, 1, 2, 2).reshape(n, h, 1, 4)
    z = z + (a[3] - 0.5)
    z = z + p["color_bias"].reshape(n, 1, 1, 4)
    return torch.clamp(z * ratio / sat, 0.0, 1.0)


# ---- one step's batch -------------------------------------------------------------

def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def step_batch(pool: torch.Tensor, batch: int, step_seed: int, bank, world: int = 1,
               rows: Optional[slice] = None):
    """(noisy, clean) of the global batch of ``step_seed`` (or of its
    ``rows``), f32 NHWC on the pool's device."""
    dev = pool.device
    idx = torch.randint(0, pool.shape[0], (batch,),
                        generator=_generator(dev, fold_in(step_seed, 2)), device=dev)
    clean = pool.view(torch.int16)[idx].view(torch.uint16).to(torch.float32) * INV_U16
    flip_h, flip_w, tr = torch.rand((3, batch), generator=_generator(dev, fold_in(step_seed, 3)),
                                    device=dev) < 0.5

    def where(mask, a, b):
        return torch.where(mask.reshape(-1, 1, 1, 1), a, b)

    clean = where(flip_h, clean.flip(1), clean)
    clean = where(flip_w, clean.flip(2), clean)
    if clean.shape[1] == clean.shape[2]:
        clean = where(tr, clean.transpose(1, 2), clean)
    clean = clean.contiguous()
    params = sample_params(_generator(dev, fold_in(step_seed, 0)), bank, batch)
    per = batch // world
    noisy = torch.empty_like(clean)
    for r in range(world):
        sl = slice(r * per, (r + 1) * per)
        noisy[sl] = eld_noise(noise_seed(step_seed, r, world), clean[sl].contiguous(),
                              {k: v[sl] for k, v in params.items()})
    if rows is not None:
        return noisy[rows], clean[rows]
    return noisy, clean


# ---- the train steps -----------------------------------------------------------------

class Run:
    """The reference's training state: parameters and Adam's moments."""

    def __init__(self, weights: Dict[str, torch.Tensor], lr: float, beta1: float):
        self.p = {k: v.detach().clone() for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.beta1, self.t = lr, beta1, 0

    def adam(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, t = self.beta1, self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - BETA2 ** t)).add_(EPS)
            self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** t))


def grads_and_loss(forward, p, noisy, clean, precision="f32"):
    """The L1 loss over ``noisy``'s rows and its gradients, through the
    model ``forward(p, x, precision)``.  ``precision`` "bf16" runs it under
    bfloat16 autocast: the witness that the program's readings are
    bfloat16's own."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    with torch.autocast(noisy.device.type, dtype=torch.bfloat16, enabled=precision == "bf16"):
        pred = forward(leaves, noisy, precision)
    loss = torch.mean(torch.abs(pred.float() - clean))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), float(loss.detach())


def follow(forward, weights, pool, bank, batch: int, seeds: Sequence[int], lr: float,
           beta1: float, world: int = 1, precision: str = "f32", fault: Optional[str] = None,
           rank: int = 0) -> dict:
    """Train ``len(seeds)`` steps of the model ``forward(p, x, precision)``
    (an architecture's ``forward`` with its configuration bound) from
    ``weights``; returns each step's loss over the global batch, the first
    step's gradient and the parameters after the last step.  Float32
    products are float32's on the card: TF32 is off while it runs, as the
    program's own float32 path turns it off, and the caller's settings
    come back after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        run = Run(weights, lr, beta1)
        losses, first = [], None
        for seed in seeds:
            noisy, clean = step_batch(pool, batch, seed, bank, world)
            if fault == "half_batch":
                grads, loss = grads_and_loss(forward, run.p, noisy[: batch // 2],
                                             clean[: batch // 2], precision)
            elif fault == "no_exchange":
                per = batch // world
                sl = slice(rank * per, (rank + 1) * per)
                grads, _ = grads_and_loss(forward, run.p, noisy[sl], clean[sl], precision)
                loss = grads_and_loss(forward, run.p, noisy, clean, precision)[1]
            else:
                grads, loss = grads_and_loss(forward, run.p, noisy, clean, precision)
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            run.adam(grads)
            losses.append(loss)
            del noisy, clean, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"losses": losses, "grad1": first, "params": run.p}
