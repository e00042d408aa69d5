"""Synthetic convergence demo and arch quality A/B on the card (counterpart
of ``eld_tpu/tools/demo_synthetic.py``).

Trains a denoiser end to end on procedurally generated "scenes" with the
full ELD noise model, the clean set resident on the device, and reports
the PSNR gain of the denoiser over the noisy input on a held-out set: the
quality signal of the SID protocol without the (download-only) SID raws.
Each optimizer step synthesizes its noisy batch with the fused noise
kernel on a CUDA card (``make_train_step``'s "auto" noise), and the U-Net
runs under bf16 autocast over f32 parameters, as eld_tpu's demo computes
its U-Net in bf16.  On a card the step (or the ``--scan`` call) and the
held-out forward replay CUDA graphs from their second call; the first
two are left out of the timed window, and the record's
``graph_replays`` counts the replays of each.

Also the arch A/B harness: --arch unet / unet_s2d under identical data,
noise stream and step budget.

Seeds: step i is seeded ``fold_in(seed + 1, i)`` on both the per-step and
the ``--scan`` path (its batch is ``pick_batch``'s pick under that seed,
without augmentation), so the two arms train on the same batches and the
same noise.  The held-out noise is seeded 9000 + i (31000 + i for the
ratio sweep), as eld_tpu keys it; torch's generator gives other bits.

Usage:  python -m eld_tpu_torch.tools.demo_synthetic --steps 600 --arch unet
        (``--device cpu`` runs the plain noise version on the host)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as onp
import torch

from eld_tpu_torch.config import torch_device
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.model import apply_noise
from eld_tpu_torch.noise.params import NoiseParams, load_camera_params
from eld_tpu_torch.ops.metrics import psnr
from eld_tpu_torch.train.state import create_train_state, set_learning_rate
from eld_tpu_torch.train.steps import (
    fold_in,
    graph_replays,
    make_eval_forward,
    make_train_scan,
    make_train_step,
    pick_batch,
)


def make_scenes(rng, n, size=512):
    """Piecewise-smooth color fields + soft disks: enough structure for a
    denoiser to exploit, cheap to generate.  NumPy; byte-equal to
    eld_tpu's for the same ``rng``."""
    yy, xx = onp.mgrid[0:size, 0:size].astype(onp.float32) / size
    out = onp.empty((n, size, size, 4), onp.float32)
    for i in range(n):
        base = (rng.random(4)[None, None] * 0.5
                + yy[..., None] * (rng.random(4)[None, None] - 0.5) * 0.6
                + xx[..., None] * (rng.random(4)[None, None] - 0.5) * 0.6)
        for _ in range(6):
            cy, cx = rng.random(2)
            r = 0.05 + 0.2 * rng.random()
            amp = (rng.random(4)[None, None] - 0.5) * 0.8
            mask = onp.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / r**2))
            base = base + mask[..., None] * amp
        out[i] = onp.clip(base, 0.02, 0.98)
    return out


def make_scenes_device(gen: torch.Generator, n, size=512, chunk=16):
    """The same scene family drawn on ``gen``'s device, ``chunk`` scenes per
    call (a bounded working set of 6 disk masks per scene).  It has the
    distribution of ``make_scenes`` (uniform base, gradients, disk
    centres, radii and amplitudes), not its bits."""
    dev = gen.device
    grid = torch.arange(size, device=dev, dtype=torch.float32) / size
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    parts = []
    for lo in range(0, n, chunk):
        c = min(chunk, n - lo)
        rand = lambda *s: torch.rand((c, *s), generator=gen, device=dev)  # noqa: E731
        base_c, gy, gx = rand(4), rand(4), rand(4)
        cyx, r, amp = rand(6, 2), 0.05 + 0.2 * rand(6), (rand(6, 4) - 0.5) * 0.8
        base = (base_c[:, None, None] * 0.5
                + yy[None, ..., None] * (gy[:, None, None] - 0.5) * 0.6
                + xx[None, ..., None] * (gx[:, None, None] - 0.5) * 0.6)
        d2 = ((yy[None, None] - cyx[..., 0, None, None]) ** 2
              + (xx[None, None] - cyx[..., 1, None, None]) ** 2)      # (c, 6, H, W)
        masks = torch.exp(-d2 / (r[..., None, None] ** 2))
        base = base + torch.einsum("bkhw,bkc->bhwc", masks, amp)
        parts.append(torch.clamp(base, 0.02, 0.98))
    return torch.cat(parts)


def calibrated_params(bank, ratio, cam=0, iso=9, k_q=0.5) -> NoiseParams:
    """Deterministic full-ELD NoiseParams of one image at the CALIBRATED
    operating point: K at quantile ``k_q`` of the camera's calibrated
    [Kmin, Kmax], read/row scales on the calibrated log-linear profiles at
    that K (no sigma draw), Tukey-lambda shape and color bias at ISO index
    ``iso``."""
    log_k = (1 - k_q) * torch.log(bank.kmin[cam]) + k_q * torch.log(bank.kmax[cam])

    def scale(slope, bias):
        return torch.exp(slope[cam] * log_k + bias[cam])

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=bank.device)  # noqa: E731
    return NoiseParams(
        K=torch.exp(log_k),
        g_scale=scale(bank.g_slope, bank.g_bias),
        G_scale=scale(bank.G_slope, bank.G_bias),
        G_shape=bank.g_shape[cam, iso],
        R_scale=scale(bank.R_slope, bank.R_bias),
        color_bias=bank.color_bias[cam, iso],
        saturation_level=f32(15583.0),
        ratio=f32(ratio),
    )


def heldout_psnr(fwd, holdout, params, model, seed0):
    """(noisy PSNRs, denoised PSNRs) over the held-out scenes, image i
    noised with ``model`` on a generator seeded ``seed0 + i``."""
    npsnr, dpsnr = [], []
    for i in range(holdout.shape[0]):
        gen = torch.Generator(device=holdout.device).manual_seed(seed0 + i)
        noisy = torch.clamp(apply_noise(gen, holdout[i], params, model), 0, 1)
        den = torch.clamp(fwd(noisy[None])[0].float(), 0, 1)
        npsnr.append(float(psnr(noisy, holdout[i], 1.0)))
        dpsnr.append(float(psnr(den, holdout[i], 1.0)))
    return npsnr, dpsnr


def ratio_sweep(fwd, holdout, bank, ratios=(100, 200, 300)):
    """Held-out denoised PSNR across an exposure-ratio sweep with the FULL
    calibrated ELD noise model ('PGrqc'), the hardest synthetic protocol
    available without real SID raws."""
    out = {}
    for ratio in ratios:
        npsnr, dpsnr = heldout_psnr(fwd, holdout, calibrated_params(bank, ratio), "PGrqc", 31000)
        out[f"x{ratio}"] = {"noisy_psnr": round(onp.mean(npsnr), 2),
                            "denoised_psnr": round(onp.mean(dpsnr), 2)}
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", type=str, default="unet")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--n_train", type=int, default=48)
    p.add_argument("--noise", type=str, default="eld")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the noise kernel runs on a CUDA card, the plain "
                        "noise version on the CPU")
    p.add_argument("--ratio_sweep", action="store_true",
                   help="add a calibrated full-ELD exposure-ratio sweep eval")
    p.add_argument("--lr_decay", action="store_true",
                   help="apply the reference's step schedule scaled to the "
                        "budget: x0.5 at 50%% and x0.1 at 90%% of steps "
                        "(train_syn.py:99-105, epochs 100/180 of 200)")
    p.add_argument("--scan", type=int, default=0, metavar="K",
                   help="run K optimizer steps per call via make_train_scan "
                        "(picks/noise/update all on the device, no augmentation) "
                        "instead of one call per step")
    p.add_argument("--sample", choices=["pick", "perm"], default="pick",
                   help="per-step batch sampling: 'pick' = with-replacement "
                        "draws (make_train_scan's pool semantics); 'perm' = "
                        "epoch permutation over the clean set (the reference "
                        "loader's semantics, train_syn.py:100-113 + "
                        "DataLoader(shuffle=True)).  perm needs the per-step "
                        "path (not --scan) and batch | n_train")
    ns = p.parse_args(argv)
    if ns.scan and ns.lr_decay and (
            (ns.steps // 2) % ns.scan or (ns.steps * 9 // 10) % ns.scan):
        # the schedule is applied at call boundaries; when the 50%/90%
        # boundaries are call-aligned the scanned schedule is IDENTICAL to
        # the per-step path's, so the scan-vs-loader quality A/B compares
        # like with like
        sys.exit("--scan with --lr_decay needs the 50% and 90% step "
                 f"boundaries launch-aligned: steps={ns.steps} scan={ns.scan} "
                 f"puts them at {ns.steps // 2}/{ns.steps * 9 // 10} "
                 "(both must be multiples of scan)")
    if ns.sample == "perm":
        if ns.scan:
            sys.exit("--sample perm needs the per-step path (drop --scan); "
                     "the scanned trainer's pool semantics IS with-"
                     "replacement picks — that difference is what the "
                     "scan-vs-perm quality A/B measures")
        if ns.n_train % ns.batch:
            sys.exit(f"--sample perm needs batch | n_train "
                     f"({ns.batch} does not divide {ns.n_train})")

    device = torch_device(ns.device)
    rng = onp.random.default_rng(ns.seed)
    if ns.n_train * ns.size * ns.size * 16 > 2 ** 27:  # >128 MB of clean f32
        # big clean sets are drawn on the device: no host-to-device copy
        gen = torch.Generator(device=device).manual_seed(ns.seed)
        train_clean = make_scenes_device(gen, ns.n_train, ns.size)
    else:
        train_clean = torch.from_numpy(make_scenes(rng, ns.n_train, ns.size)).to(device)
    holdout = torch.from_numpy(make_scenes(onp.random.default_rng(777), 4, ns.size)).to(device)

    bank = load_camera_params(include=4, device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(ns.seed)
        model = build_arch(ns.arch, 4, 4).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, lr=ns.lr)
    step = make_train_step(model, noise_model=ns.noise, bank=bank,
                           autocast_dtype=torch.bfloat16)
    pool = {"clean": train_clean}

    perm_rng = onp.random.default_rng(ns.seed + 2)
    perm_order = onp.empty((0,), onp.int64)

    def pick_perm(i):
        """Epoch-permutation sampling: each scene appears exactly once per
        n_train/batch steps, in a freshly shuffled order per epoch — the
        reference DataLoader(shuffle=True) semantics."""
        nonlocal perm_order
        lo = (i * ns.batch) % ns.n_train
        if lo == 0:
            perm_order = perm_rng.permutation(ns.n_train)
        return train_clean[torch.from_numpy(perm_order[lo:lo + ns.batch]).to(device)]

    def step_seed(i):
        return fold_in(ns.seed + 1, i)

    def lr_at(i):
        if not ns.lr_decay:
            return ns.lr
        frac = i / max(ns.steps, 1)
        return ns.lr * (1.0 if frac < 0.5 else 0.5 if frac < 0.9 else 0.1)

    def run_step(i):
        if ns.lr_decay and lr_at(i) != lr_at(i - 1):
            set_learning_rate(state, lr_at(i))
        seed = step_seed(i)
        clean = (pick_perm(i) if ns.sample == "perm"
                 else pick_batch(pool, ns.batch, seed, augment=False)["clean"])
        return step(state, {"clean": clean}, seed)

    # warm up (first call: cuDNN plans, the kernel's build) outside the timed region
    m = {"Pixel": torch.zeros(())}
    if ns.scan > 0:
        # augment=False: the per-step arm never augments, so the
        # scan-vs-per-step quality A/B must not hand the scan arm a free
        # flip/transpose advantage (train_pool keeps augmenting)
        scan_fn = make_train_scan(model, noise_model=ns.noise, bank=bank, batch=ns.batch,
                                  steps_per_call=ns.scan, augment=False,
                                  autocast_dtype=torch.bfloat16)
        n_calls = max(ns.steps // ns.scan, 1)

        def call(i):
            return scan_fn(state, pool, [step_seed(i * ns.scan + j) for j in range(ns.scan)])

        # untimed: the first call and, where calls remain to time, the second
        # (on a card it captures the CUDA graph that the later calls replay)
        warm = 2 if n_calls > 2 else 1
        for i in range(n_calls):
            # the LR schedule at call boundaries: the guard above makes the
            # 50%/90% steps call-aligned, so every optimizer step sees the
            # per-step path's rate
            if i and ns.lr_decay and lr_at(i * ns.scan) != lr_at((i - 1) * ns.scan):
                set_learning_rate(state, lr_at(i * ns.scan))
            m = call(i)
            if i and (i * ns.scan) % 100 < ns.scan:
                print(f"step {i * ns.scan}: loss {float(m['Pixel']):.4f}", file=sys.stderr)
            if i + 1 == warm:
                _sync(device)
                t0 = time.perf_counter()
        _sync(device)
        train_time = max(time.perf_counter() - t0, 1e-9)
        timed_patches = max(n_calls - warm, 0) * ns.scan * ns.batch
    elif ns.steps > 0:
        # untimed: the first step and, where steps remain to time, the second
        # (on a card it captures the CUDA graph that the later steps replay)
        warm = 2 if ns.steps > 2 else 1
        for i in range(warm):
            m = run_step(i)
        _sync(device)
        t0 = time.perf_counter()
        for i in range(warm, ns.steps):
            m = run_step(i)
            if i % 100 == 0:
                print(f"step {i}: loss {float(m['Pixel']):.4f}", file=sys.stderr)
        _sync(device)
        train_time = max(time.perf_counter() - t0, 1e-9)
        timed_patches = max(ns.steps - warm, 0) * ns.batch
    else:
        train_time = 1e-9
        timed_patches = 0

    # held-out denoising gain at fixed mid/heavy ELD-like levels
    fwd = make_eval_forward(model, autocast_dtype=torch.bfloat16)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    gains = {}
    for tag, (K, g) in {"mid": (4.0, 8.0), "heavy": (10.0, 20.0)}.items():
        np_ = NoiseParams(K=f32(K), g_scale=f32(g), G_scale=f32(g / 2), G_shape=f32(0.09),
                          R_scale=f32(2.0), color_bias=torch.zeros(4, device=device),
                          saturation_level=f32(15583.0), ratio=f32(200.0))
        npsnr, dpsnr = heldout_psnr(fwd, holdout, np_, "PGrq", 9000)
        gs = [d - n for n, d in zip(npsnr, dpsnr)]
        gains[tag] = {"noisy_psnr": round(onp.mean(npsnr), 2),
                      "denoised_psnr": round(onp.mean(dpsnr), 2),
                      "gain_db": round(onp.mean(gs), 2)}

    result = {
        "arch": ns.arch, "steps": ns.steps, "scan": ns.scan,
        "sample": ns.sample, "lr_decay": ns.lr_decay,
        "train_wall_s": round(train_time, 1),
        "train_patches_per_sec": round(timed_patches / train_time, 1),
        "final_loss": round(float(m["Pixel"]), 4),
        **{f"{k}_{kk}": vv for k, v in gains.items() for kk, vv in v.items()},
    }
    if ns.ratio_sweep:
        sweep = ratio_sweep(fwd, holdout, bank)
        result.update({f"{k}_{kk}": vv for k, v in sweep.items() for kk, vv in v.items()})
    # on a card the train step (or pooled call) and the forward replay CUDA graphs
    result["graph_replays"] = {"train": graph_replays(scan_fn if ns.scan > 0 else step),
                               "eval": graph_replays(fwd)}
    print(json.dumps(result))
    return result


def cli() -> int:
    """Console-script entry: main()'s return value is data, not an exit
    status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
