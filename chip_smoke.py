#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (eld_tpu_torch) once on an NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, one line or block of output each; any failure exits non-zero:
  0. environment: torch/CUDA versions, the card's name and power limit;
  1. build the fused noise kernel from eld_tpu_torch/csrc and check its
     Philox generator against the Random123 known answer;
  2. the kernel against its plain PyTorch version at the slice's shape
     (8, 512, 512, 4): exact against noise_core fed the kernel's own draws,
     per-image moments, Poisson histograms, row structure, seeds, range,
     and both times (CUDA events);
  3. the slice: eld_tpu_torch.tools.train_syn.main over a PatchStore of 32
     smooth 512x512x4 patches, --noise eld --include 4 -b 8 --bf16, 3
     epochs = 12 optimizer steps through the kernel; then the U-Net on the
     card against the same weights on the CPU, and step times with the
     kernel and with the plain noise path;
and prints the kernels' JSON line, the card line, and a last JSON line
{"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SLICE_SHAPE = (8, 512, 512, 4)
SEED = 2018


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[reps // 2]


# ---- phase 0 ------------------------------------------------------------

def phase0():
    import torch

    print(f"[0] python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "eld_tpu_torch")):
        fail(f"no eld_tpu_torch package beside {__file__}: run it from the repository")
    card = card_line()
    print(f"[0] card: {card}  ({torch.cuda.device_count()} visible)", flush=True)
    return card


# ---- phase 1 ------------------------------------------------------------

def phase1():
    import ctypes

    from eld_tpu_torch.noise import kernels

    t0 = time.perf_counter()
    lib = kernels.load_library()
    secs = time.perf_counter() - t0
    ctr = (ctypes.c_uint32 * 4)(0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)
    key = (ctypes.c_uint32 * 2)(0xA4093822, 0x299F31D0)
    out = (ctypes.c_uint32 * 4)()
    lib.eld_philox4x32_10(ctypes.addressof(ctr), ctypes.addressof(key), ctypes.addressof(out))
    want = [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]  # Random123 kat_vectors
    check(list(out) == want, f"Philox known answer: got {[hex(x) for x in out]}")
    print(f"[1] built and loaded noise_synth in {secs:.2f} s; Philox4x32-10 known answer ok",
          flush=True)


# ---- phase 2 ------------------------------------------------------------

def _tv_distance(counts, pmf):
    import numpy as np

    vals, n = np.unique(counts, return_counts=True)
    emp = dict(zip(vals.astype(np.int64).tolist(), (n / counts.size).tolist()))
    support = set(emp) | set(np.nonzero(pmf > 1e-12)[0].tolist())
    return 0.5 * sum(abs(emp.get(k, 0.0) - (pmf[k] if k < len(pmf) else 0.0)) for k in support)


def phase2(card):
    import numpy as np
    import scipy.stats as sps
    import torch

    from eld_tpu_torch.noise.kernels import kernel_draws, synthesize_kernel
    from eld_tpu_torch.noise.model import noise_core, synthesize
    from eld_tpu_torch.noise.params import NoiseParams, load_camera_params, sample_params_batch

    dev = torch.device("cuda")
    n = SLICE_SHAPE[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bank = load_camera_params(include=4, device=dev)
    clean = torch.rand(SLICE_SHAPE, generator=gen, device=dev)
    params = sample_params_batch(gen, bank, n)

    # (a) exact: the kernel equals noise_core fed the kernel's own draws.
    # Every operation is the same IEEE f32 operation in the same order, so
    # the tolerance is 1e-5 (a Poisson count flip would exceed it).
    max_err = 0.0
    for model in ("g", "pg", "Pg", "eld", "Pgrqc"):
        seed = 0x1234_5678_9ABC_DEF0
        out = synthesize_kernel(seed, clean, params, model, clip=False)
        ref = noise_core(clean, params, model, kernel_draws(seed, clean.shape, model, dev))
        err = float((out - ref).abs().max())
        check(err <= 1e-5, f"kernel vs noise_core({model}) max |err| {err}")
        max_err = max(max_err, err)
    print(f"[2a] kernel == noise_core on its own draws for g pg Pg eld Pgrqc: "
          f"max |err| {max_err:.3g} (tol 1e-5)", flush=True)

    # (b) moments per image against the plain version, with the bounds of
    # tests/test_pallas_noise.py: mean within 6 standard errors (+ the row
    # term), std ratio within 15%
    for model in ("g", "pg", "Pg", "eld"):
        e_k = (synthesize_kernel(7, clean, params, model) - clean).double()
        e_p = (synthesize(gen, clean, params, model) - clean).double()
        for i in range(n):
            se = max(float(e_p[i].std()) / math.sqrt(e_p[i].numel()) * 6, 1e-4)
            if "r" in model or model == "eld":
                se += 6 * float(params.R_scale[i] * params.ratio[i] / params.saturation_level[i]) \
                    / math.sqrt(2 * SLICE_SHAPE[1])
            dmean = abs(float(e_k[i].mean()) - float(e_p[i].mean()))
            rstd = float(e_k[i].std()) / max(float(e_p[i].std()), 1e-6)
            check(dmean < se and abs(rstd - 1) < 0.15, f"moments {model} image {i}: "
                  f"dmean {dmean:.3g} (< {se:.3g}), std ratio {rstd:.4f}")
    print("[2b] per-image moments match the plain version for g pg Pg eld", flush=True)

    # (c) Poisson counts on constant images (K = sat = ratio = 1, so the
    # output is the count).  lam <= 12 is the exact 40-term inverse CDF:
    # TV to scipy's Poisson < 0.01.  Above 12 the hybrid is the normal
    # approximation round(N(lam, lam)) clamped at 0, by design (its TV to
    # the Poisson is 0.036 at 12.1 and 0.018 at 50, the same in the JAX
    # reference): TV to that target < 0.01, and mean / variance within the
    # bounds of tests/test_noise.py (0.5% / 2%).
    ones = torch.ones(n, device=dev)
    fixed = NoiseParams(K=ones, g_scale=ones, G_scale=ones, G_shape=ones * 0.1,
                        R_scale=ones, color_bias=torch.zeros(n, 4, device=dev),
                        saturation_level=ones, ratio=ones)
    ks = np.arange(0, 400)
    for lam in (0.5, 3.0, 11.9, 12.1, 50.0):
        x = torch.full(SLICE_SHAPE, lam, device=dev)
        for name, out in (("kernel", synthesize_kernel(11, x, fixed, "P", clip=False)),
                          ("plain", synthesize(gen, x, fixed, "P", clip=False))):
            c = out.double().cpu().numpy().ravel()
            check(np.all(c == np.round(c)) and c.min() >= 0, f"{name} P counts not integral")
            if lam <= 12:
                target = sps.poisson(lam).pmf(ks)
            else:
                sd = math.sqrt(lam)
                target = sps.norm.cdf(ks + 0.5, lam, sd) - sps.norm.cdf(ks - 0.5, lam, sd)
                target[0] = sps.norm.cdf(0.5, lam, sd)
                check(abs(c.mean() / lam - 1) < 5e-3 and abs(c.var() / lam - 1) < 2e-2,
                      f"{name} P lam={lam}: mean {c.mean():.4f} var {c.var():.4f}")
            tv = _tv_distance(c, target)
            tv_poisson = _tv_distance(c, sps.poisson(lam).pmf(ks))
            check(tv < 0.01, f"{name} P lam={lam}: TV {tv:.4f} >= 0.01")
            print(f"[2c] {name:6s} P lam={lam:5.1f}: TV to target {tv:.4f}, "
                  f"to Poisson {tv_poisson:.4f}", flush=True)

    # (d) row structure under model 'r' on a constant image: the noise is
    # constant along each packed row; channels (0,1) share one draw and
    # (2,3) the other
    half = torch.full(SLICE_SHAPE, 0.5, device=dev)
    e = synthesize_kernel(3, half, params, "r", clip=False) - half
    check(bool((e == e[:, :, :1, :]).all()), "row noise varies along a row")
    check(bool((e[..., 0] == e[..., 1]).all() and (e[..., 2] == e[..., 3]).all()),
          "row noise: channel pairs (0,1) / (2,3) differ")
    frac_same = float((e[..., 0] == e[..., 2]).float().mean())
    check(frac_same < 1e-3, f"row noise: even/odd draws equal on {frac_same:.3%}")
    print("[2d] row noise constant along rows; (0,1) even draw, (2,3) odd draw", flush=True)

    # (e) seeds: same seed bit-identical, different (consecutive) seeds differ
    a = synthesize_kernel(100, clean, params, "eld", clip=False)
    b = synthesize_kernel(100, clean, params, "eld", clip=False)
    c = synthesize_kernel(101, clean, params, "eld", clip=False)
    check(bool(torch.equal(a, b)), "same seed gave different output")
    same = float((a == c).float().mean())
    check(same < 1e-3, f"seeds 100 and 101 agree on {same:.3%} of elements")
    print(f"[2e] same seed bit-identical; seeds 100/101 agree on {same:.4%} of elements",
          flush=True)

    # (f) range
    dark = torch.zeros(SLICE_SHAPE, device=dev)
    clipped = synthesize_kernel(5, dark, params, "eld", clip=True)
    raw = synthesize_kernel(5, dark, params, "eld", clip=False)
    check(float(clipped.min()) >= 0 and float(clipped.max()) <= 1, "clip=True out of [0,1]")
    check(float(raw.min()) < 0, "clip=False lost the sub-zero noise floor")
    print("[2f] clip=True in [0,1]; clip=False keeps values below zero", flush=True)

    # (g) times at the slice's shape, full model, clip=True
    ms = cuda_ms(lambda: synthesize_kernel(9, clean, params, "eld"))
    plain_ms = cuda_ms(lambda: synthesize(gen, clean, params, "eld"))
    print(f"[2g] eld {tuple(SLICE_SHAPE)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 20, CUDA events) on {card}", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


# ---- phase 3 ------------------------------------------------------------

def _write_store(path, count=32, size=512, seed=SEED):
    """Smooth uint16 patches: a few random low-frequency sinusoids each."""
    import numpy as np

    from eld_tpu_torch.data.patchstore import PatchStoreWriter

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size, dtype=np.float32),
                         np.linspace(0, 1, size, dtype=np.float32), indexing="ij")
    with PatchStoreWriter(path, (size, size, 4), np.uint16) as w:
        for _ in range(count):
            img = np.empty((size, size, 4), np.float32)
            for ch in range(4):
                fy, fx, ph = rng.uniform(0.5, 4), rng.uniform(0.5, 4), rng.uniform(0, 6.3)
                img[..., ch] = 0.5 + 0.4 * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
            w.append(img * rng.uniform(0.05, 1.0))


def phase3(card):
    import torch

    from eld_tpu_torch.models import build_arch
    from eld_tpu_torch.noise.kernels import synthesize_kernel
    from eld_tpu_torch.tools import train_syn

    with tempfile.TemporaryDirectory() as tmp:
        _write_store(os.path.join(tmp, "SID_Sony_Raw.eps"))
        argv = ["--traindir", tmp, "--checkpoints_dir", os.path.join(tmp, "ck"),
                "--name", "smoke", "--noise", "eld", "--include", "4", "-b", "8", "--bf16",
                "--epochs", "3", "--no-log", "--no-verbose", "--seed", str(SEED),
                "--nThreads", "4", "--device", "cuda"]
        synthesize_kernel.launches = 0
        t0 = time.perf_counter()
        engine = train_syn.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = synthesize_kernel.launches

    steps = engine.iterations
    losses = [h[1]["Pixel"] for h in engine.history]
    print(f"[3] train_syn: {steps} steps in {wall:.2f} s (build of the model, data "
          f"loading and first-call set-up included); noise kernel launches {launches}",
          flush=True)
    for it, vals, _ in engine.history:
        print(f"[3]   step {it:2d}  loss {vals['Pixel']:.6f}", flush=True)
    check(steps == 12, f"expected 12 optimizer steps, got {steps}")
    check(launches == steps, f"noise kernel launched {launches} times for {steps} steps")
    check(all(math.isfinite(v) for v in losses) and len(losses) == steps, "non-finite loss")

    t_first, t_last = engine.history[0][2], engine.history[-1][2]
    rate = 8 * (steps - 1) / (t_last - t_first)
    print(f"[3] {rate:.1f} patches/s over steps 2..{steps} (host clock at each loss read, "
          f"epoch boundaries included) on {card}", flush=True)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        init = build_arch("unet", 4, 4, base_width=32, skip_mode="split")
    moved = max(float((p.detach().cpu() - init.state_dict()[k]).abs().max())
                for k, p in engine.model.state_dict().items())
    finite = all(bool(torch.isfinite(p).all()) for p in engine.model.parameters())
    check(finite and moved > 0, f"parameters: finite={finite}, max move {moved}")
    print(f"[3] parameters finite and moved (max |delta| {moved:.3g})", flush=True)

    # the trained U-Net on the card (f32, TF32 off) against the same
    # weights on the CPU; tolerance 1e-4 for cuDNN's other summation order
    model = engine.model.eval()
    x = torch.rand((1, 64, 64, 4), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_gpu = model(x.cuda()).cpu()
        cpu_model = build_arch("unet", 4, 4, base_width=32, skip_mode="split")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        y_cpu = cpu_model(x)
    err = float((y_gpu - y_cpu).abs().max())
    check(y_gpu.shape == (1, 64, 64, 4) and bool(torch.isfinite(y_gpu).all()) and err < 1e-4,
          f"U-Net on the card vs CPU: max |err| {err}")
    print(f"[3] U-Net forward on the card == CPU within {err:.3g} (tol 1e-4)", flush=True)
    return {"launches": launches, "steps": steps, "rate": rate}


def phase3b(card):
    """Step time at the slice's shape with the kernel and with the plain
    noise path, in turns (plain, kernel, kernel, plain)."""
    import numpy as np
    import torch

    from eld_tpu_torch.models import build_arch
    from eld_tpu_torch.noise.params import load_camera_params
    from eld_tpu_torch.train.state import create_train_state
    from eld_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    bank = load_camera_params(include=4, device=dev)
    rng = np.random.default_rng(SEED)
    batch = {"clean": torch.from_numpy(
        rng.integers(0, 65535, SLICE_SHAPE, dtype=np.uint16)).to(dev)}
    model = build_arch("unet", 4, 4, skip_mode="split").to(dev).to(
        memory_format=torch.channels_last)
    state = create_train_state(model)
    steps = {impl: make_train_step(model, noise_model="eld", bank=bank, noise_impl=impl,
                                   autocast_dtype=torch.bfloat16)
             for impl in ("plain", "kernel")}
    results = {"plain": [], "kernel": []}
    for impl in ("plain", "kernel", "kernel", "plain"):
        for i in range(3):
            steps[impl](state, batch, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            steps[impl](state, batch, 100 + i)
        torch.cuda.synchronize()
        results[impl].append((time.perf_counter() - t0) / 10 * 1e3)
    print(f"[3b] train step ms (bf16, batch 8, 512^2, 10 steps each, plain/kernel/kernel/plain): "
          f"plain {results['plain']}, kernel {results['kernel']} on {card}", flush=True)


def main():
    card = phase0()
    phase1()
    k = phase2(card)
    s = phase3(card)
    phase3b(card)

    import torch

    from eld_tpu_torch.noise.kernels import REPLACES, SOURCE_PATH

    kernels = {"kernels": [{
        "name": "noise_synth", "route": "cuda", "source": SOURCE_PATH, "replaces": REPLACES,
        "launches": s["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
