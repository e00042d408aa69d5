#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (eld_tpu_torch) once on an NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, one line or block of output each; any failure exits non-zero:
  0. environment: torch/CUDA versions, the card's name and power limit;
  1. build the fused noise kernel from eld_tpu_torch/csrc and check its
     Philox generator against the Random123 known answer;
  2. the kernel against its plain PyTorch version: exact against
     noise_core fed the kernel's own draws for ten models at the slice's
     shape (8, 512, 512, 4), a ragged, a one-pixel-wide, a 9-channel
     and a 1100-pixel-wide shape; per-image moments, Poisson histograms,
     row structure, seeds, range at the slice's shape; its registers and
     spills (nvcc -Xptxas -v); on uniform and on smooth input, the
     wrapper's time (as in earlier runs) and the kernel's alone (CUDA
     events), and its bound from the bytes and the f32 operations;
  3. the slice: eld_tpu_torch.tools.train_syn.main over a PatchStore of 32
     smooth 512x512x4 patches, --noise eld --include 4 -b 8 --bf16 --scan 0
     (the per-step loader), 3 epochs = 12 optimizer steps through the
     kernel; then the U-Net on the card against the same weights on the
     CPU, and step times with the kernel and with the plain noise path;
  4. train_syn at its defaults: --scan left to auto (it must resolve to
     10, the pooled trainer), 128 smooth patches held on the card, 2 epochs
     of 16 steps (calls of 10 and 6) for unet and 1 epoch for unet_s2d, the
     periodic SID eval on the indoor-15 ratio-100/300 names, and the pooled
     per-step time beside phase 3b's;
  5. the eval stack: the eval forward on the card against the CPU (pad and
     chop, unet and unet_s2d), test_sid on the card against the CPU over
     SID-geometry rawpacks, test_eld full-frame with --chop, and
     full-frame eval-forward times;
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
# every component alone, the two shot/read pairs, the full model and its alias
MODELS = ("g", "p", "pg", "Pg", "G", "r", "q", "c", "eld", "Pgrqc")
# the slice's shape; ragged (odd H and W); one pixel per row; 9 channels;
# rows wider than a block (several pixels per thread)
KERNEL_SHAPES = (SLICE_SHAPE, (3, 37, 53, 4), (2, 5, 1, 4), (2, 33, 31, 9), (1, 3, 1100, 4))
H100_BYTES_PER_S = 3.35e12  # HBM3 of the H100 SXM
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM


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


def cuda_ms(fn, reps: int = 20, spin: bool = False) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    one warm-up call.  With ``spin`` the card first spins for ~1 ms, so the
    call is queued whole before it runs and the interval holds its device
    work alone, not the host's time to issue it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(2_000_000)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[reps // 2]


def kernel_only(lib, seed, clean, params, model, clip):
    """A call of ``lib``'s kernel alone on ``clean``: the parameter rows are
    packed and the output allocated once, outside the call."""
    import torch

    from eld_tpu_torch.noise import kernels

    n, h, w, c = clean.shape
    packed = kernels.pack_params(params, n)
    out = torch.empty_like(clean)
    stream = torch.cuda.current_stream().cuda_stream
    args = (clean.data_ptr(), out.data_ptr(), packed.data_ptr(), n, h, w, c,
            kernels.model_flags(model), int(clip), seed, stream)

    def call():
        rc = lib.eld_noise_synth(*args)
        check(rc == 0, f"launch failed ({rc})")
        return out

    return call


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

    from eld_tpu_torch.noise import kernels
    from eld_tpu_torch.noise.kernels import kernel_draws, synthesize_kernel
    from eld_tpu_torch.noise.model import noise_core, synthesize
    from eld_tpu_torch.noise.params import NoiseParams, load_camera_params, sample_params_batch
    from eld_tpu_torch.train.steps import to_f32

    dev = torch.device("cuda")
    n = SLICE_SHAPE[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bank = load_camera_params(include=4, device=dev)
    clean = torch.rand(SLICE_SHAPE, generator=gen, device=dev)
    params = sample_params_batch(gen, bank, n)

    # (a) exact: the kernel equals noise_core fed the kernel's own draws,
    # for every model at every shape.  Every operation is the same IEEE f32
    # operation in the same order, so the tolerance is 1e-5 (a Poisson count
    # flip would exceed it) and 0 is expected.
    max_err = 0.0
    seed = 0x1234_5678_9ABC_DEF0
    for shape in KERNEL_SHAPES:
        if shape == SLICE_SHAPE:
            x, p = clean, params
        else:
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            x = torch.rand(shape, generator=g, device=dev)
            p = sample_params_batch(g, bank, shape[0])
        err = 0.0
        for model in MODELS:
            out = synthesize_kernel(seed, x, p, model, clip=False)
            ref = noise_core(x, p, model, kernel_draws(seed, shape, model, dev))
            e = float((out - ref).abs().max())
            check(e <= 1e-5, f"kernel vs noise_core({model}) at {shape}: max |err| {e}")
            err = max(err, e)
        max_err = max(max_err, err)
        print(f"[2a] {shape}: kernel == noise_core on its own draws for {' '.join(MODELS)}: "
              f"max |err| {err:.3g} (tol 1e-5)", flush=True)

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

    # (g) registers and spills, and times at the slice's shape, full model,
    # clip=True, on uniform input and on the smooth patches the trainers see
    with tempfile.TemporaryDirectory() as tmp:
        _, report = _build_verbose(os.path.join(HERE, kernels.SOURCE_PATH), tmp)
    for r in report:
        print(f"[2g] {r['kernel']}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B (nvcc -Xptxas -v)",
              flush=True)
    if not report:
        print("[2g] registers and spills: not in the build log", flush=True)
    # ms / ms_smooth: the wrapper (checks, parameter packing, launch) as
    # earlier runs timed it; kernel_ms*: the kernel alone, host issue time
    # kept out of the interval
    smooth = to_f32(_smooth_u16(n, dev))  # as the trainers normalize it
    lib = kernels.load_library()
    t = {"ms": cuda_ms(lambda: synthesize_kernel(9, clean, params, "eld")),
         "ms_smooth": cuda_ms(lambda: synthesize_kernel(9, smooth, params, "eld")),
         "kernel_ms": cuda_ms(kernel_only(lib, 9, clean, params, "eld", True), spin=True),
         "kernel_ms_smooth": cuda_ms(kernel_only(lib, 9, smooth, params, "eld", True),
                                     spin=True),
         "plain_ms": cuda_ms(lambda: synthesize(gen, clean, params, "eld"))}
    bytes_ms = _noise_bytes_ms(SLICE_SHAPE)
    ops_ms = {name: _noise_ops_ms(9, x, params) for name, x in (("uniform", clean),
                                                                ("smooth", smooth))}
    bound_ms = max(bytes_ms, ops_ms["uniform"])
    bound_by = "bytes" if bytes_ms >= ops_ms["uniform"] else "operations"
    print(f"[2g] eld {tuple(SLICE_SHAPE)} (median of 20, CUDA events): wrapper "
          f"{t['ms']:.4f} ms on uniform input, {t['ms_smooth']:.4f} ms on smooth patches; "
          f"kernel alone {t['kernel_ms']:.4f} / {t['kernel_ms_smooth']:.4f} ms; plain "
          f"{t['plain_ms']:.4f} ms; bound by bytes {bytes_ms:.4f} ms, by f32 operations "
          f"{ops_ms['uniform']:.4f} / {ops_ms['smooth']:.4f} ms; on {card}", flush=True)
    return {"max_abs_err": max_err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
            "ops_ms": ops_ms["uniform"]}


def _noise_bytes_ms(shape) -> float:
    """K1's time by bytes: each byte of the clean batch and the (N, 12)
    parameter rows read once, each output byte written once, at the
    H100's memory rate."""
    nbytes = 2 * math.prod(shape) * 4 + shape[0] * 12 * 4
    return nbytes / H100_BYTES_PER_S * 1e3


def _noise_ops_ms(seed, clean, params) -> float:
    """K1's time by f32 operations for model 'eld' (PGrqc, C = 4, clip on)
    on this input and seed, at the H100's float32 peak.  Each IEEE
    operation, min/max, compare, int-to-float conversion and transcendental
    in noise_synth.cu counts once: 31 per element outside the shot draw,
    then per element either the small-lam Poisson step (4, plus 6 per loop
    term; the loop runs once per count) or the large-lam Box-Muller branch
    (14).  The Philox generator's integer work has no rate in that table
    and is left out, so this is a least time."""
    import torch

    from eld_tpu_torch.noise.fast_poisson import SMALL_MAX, poisson_small_from_uniform
    from eld_tpu_torch.noise.kernels import kernel_draws

    n = clean.shape[0]
    draws = kernel_draws(seed, clean.shape, "eld", clean.device)
    y = clean * params.saturation_level.reshape(n, 1, 1, 1) / params.ratio.reshape(n, 1, 1, 1)
    lam = torch.clamp_min(y / params.K.reshape(n, 1, 1, 1), 0.0)
    small = lam <= SMALL_MAX
    counts = poisson_small_from_uniform(lam * small, draws["poisson_u"])
    ops = 31 * lam.numel() + float((4 + 6 * counts)[small].sum()) + 14 * int((~small).sum())
    return ops / H100_F32_OPS_PER_S * 1e3


def _smooth_u16(count, dev):
    """``count`` of _write_store's smooth 512x512x4 patches on the card,
    quantized to uint16 as the store keeps them."""
    import numpy as np
    import torch

    imgs = np.stack(list(_smooth_patches(count)))
    return torch.from_numpy(np.clip(np.rint(imgs * 65535), 0, 65535).astype(np.uint16)).to(dev)


def _build_verbose(src, out_dir):
    """Build ``src`` with the package's nvcc flags plus ptxas's report into
    ``out_dir``; returns the library's path and, per kernel, its registers
    and spill bytes as the build log gives them."""
    import re

    from eld_tpu_torch import _build

    lib = os.path.join(out_dir, "lib" + os.path.basename(src)[:-3] + ".so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                           src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"nvcc failed on {src}:\n{log}")
    report, fn, spills = [], None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = _kernel_name(m.group(1)), (None, None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report.append({"kernel": fn, "registers": int(m.group(1)),
                           "spill_stores": spills[0], "spill_loads": spills[1]})
            fn = None
    return lib, report


def _kernel_name(mangled: str) -> str:
    import re

    m = re.search(r"noise_synth_kernel(ILb([01])E)?", mangled)
    if not m:
        return mangled
    return "noise_synth_kernel" + {"1": "<true>", "0": "<false>"}.get(m.group(2) or "", "")


# ---- phase 3 ------------------------------------------------------------

def _smooth_patches(count, size=512, seed=SEED):
    """Smooth float32 (size, size, 4) patches in [0, 1]: a few random
    low-frequency sinusoids each, times a random exposure."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size, dtype=np.float32),
                         np.linspace(0, 1, size, dtype=np.float32), indexing="ij")
    for _ in range(count):
        img = np.empty((size, size, 4), np.float32)
        for ch in range(4):
            fy, fx, ph = rng.uniform(0.5, 4), rng.uniform(0.5, 4), rng.uniform(0, 6.3)
            img[..., ch] = 0.5 + 0.4 * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
        yield img * rng.uniform(0.05, 1.0)


def _write_store(path, count=32, size=512, seed=SEED):
    """A uint16 PatchStore of _smooth_patches."""
    import numpy as np

    from eld_tpu_torch.data.patchstore import PatchStoreWriter

    with PatchStoreWriter(path, (size, size, 4), np.uint16) as w:
        for img in _smooth_patches(count, size, seed):
            w.append(img)


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
                "--nThreads", "4", "--device", "cuda", "--scan", "0"]
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
    return results["kernel"]


# ---- phase 4 ------------------------------------------------------------

def _smooth_mosaic(shape, rng):
    """A smooth uint16 scene in the 14-bit range above the black level."""
    import numpy as np

    yy, xx = np.meshgrid(np.linspace(0, 1, shape[0], dtype=np.float32),
                         np.linspace(0, 1, shape[1], dtype=np.float32), indexing="ij")
    img = 0.5 + 0.4 * np.sin(2 * np.pi * (rng.uniform(1, 3) * yy + rng.uniform(1, 3) * xx))
    return (2048 + img * 14000).astype(np.uint16)


def _write_sid_eval(root):
    """The SID indoor-15 files of ratios 100 and 300, as DNG bytes under
    their .ARW names (the native raw decoder reads the TIFF container
    whatever the extension): one smooth 1024x1024 scene, its packed frame
    just large enough for the protocol's 512 center crop."""
    import numpy as np

    from eld_tpu_torch.data.pairs import eval_pairs_by_ratio
    from tests.tiff_fixture import make_dng

    gt = _smooth_mosaic((1024, 1024), np.random.default_rng(SEED))
    long_bytes = make_dng(gt, iso=100, exposure=10)
    pairs = eval_pairs_by_ratio()
    for ratio in (100, 300):
        dark = (512 + (gt.astype(np.float32) - 512) / ratio).astype(np.uint16)
        short_bytes = make_dng(dark, iso=100, exposure=10 / ratio)
        for short, long_ in pairs[ratio]:
            for sub, fn, data in (("short", short, short_bytes), ("long", long_, long_bytes)):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                with open(os.path.join(root, sub, fn), "wb") as f:
                    f.write(data)
    return root


def phase4(card, tmp, step_ms):
    """train_syn at its defaults (the pooled trainer) on unet and unet_s2d,
    with the periodic eval; returns the engines, the kernel launches and
    the optimizer steps."""
    import torch

    from eld_tpu_torch.data import rawio
    from eld_tpu_torch.data.loader import pool_to_device
    from eld_tpu_torch.data.patchstore import PatchStore
    from eld_tpu_torch.models import build_arch
    from eld_tpu_torch.noise.kernels import synthesize_kernel
    from eld_tpu_torch.tools import train_syn
    from eld_tpu_torch.train.steps import fold_in, make_train_scan

    check(rawio._load_native() is not None, "the native raw decoder (librawio.so) did not load")
    traindir = os.path.join(tmp, "train")
    os.makedirs(traindir)
    _write_store(os.path.join(traindir, "SID_Sony_Raw.eps"), count=128)
    evaldir = _write_sid_eval(os.path.join(tmp, "sid"))
    pool = {"clean": pool_to_device(PatchStore(os.path.join(traindir, "SID_Sony_Raw.eps")),
                                    "cuda")}
    check(pool["clean"].dtype == torch.uint16, f"pool dtype {pool['clean'].dtype}")
    print(f"[4] pool: {tuple(pool['clean'].shape)} uint16, "
          f"{pool['clean'].numel() * 2 / 1e6:.1f} MB on the card", flush=True)

    engines, launches_total, steps_total = {}, 0, 0
    for arch, epochs in (("unet", 2), ("unet_s2d", 1)):
        argv = ["--traindir", traindir, "--evaldir", evaldir,
                "--checkpoints_dir", os.path.join(tmp, "ck"), "--name", arch, "--netG", arch,
                "--noise", "eld", "--include", "4", "-b", "8", "--bf16",
                "--epochs", str(epochs), "--eval_every", str(epochs), "--no-verbose",
                "--seed", str(SEED), "--nThreads", "4", "--device", "cuda"]
        synthesize_kernel.launches = 0
        t0 = time.perf_counter()
        engine = train_syn.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = synthesize_kernel.launches
        launches_total += launches
        steps = engine.iterations
        steps_total += steps
        calls = [h[0] for h in engine.history]
        print(f"[4] {arch}: train_syn with --scan auto: {steps} steps in {wall:.2f} s (pool "
              f"copy, eval and checkpoints included); calls ended at steps {calls}; noise "
              f"kernel launches {launches}", flush=True)
        check(calls == [10, 16, 26, 32][:2 * epochs],
              f"{arch}: --scan auto did not give calls of 10 and 6 steps: {calls}")
        check(steps == 16 * epochs, f"{arch}: expected {16 * epochs} steps, got {steps}")
        check(launches == steps, f"{arch}: noise kernel launched {launches} times for {steps} steps")
        losses = [v for h in engine.history for v in h[1].values()]
        check(all(math.isfinite(v) for v in losses), f"{arch}: non-finite loss {losses}")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            init = build_arch(arch, 4, 4, base_width=32, skip_mode="split").state_dict()
        moved = max(float((p.detach().cpu() - init[k]).abs().max())
                    for k, p in engine.model.state_dict().items())
        check(moved > 0, f"{arch}: parameters did not move")
        names = [(e, name) for e, name, _ in engine.eval_history]
        check(names == [(epochs, "sid_eval_100"), (epochs, "sid_eval_300")],
              f"{arch}: the periodic eval did not run: {engine.eval_history}")
        for _, name, res in engine.eval_history:
            check(all(math.isfinite(v) for v in res.values()), f"{arch} {name}: {res}")
            print(f"[4]   periodic eval {name}: " +
                  ", ".join(f"{k} {v:.4f}" for k, v in sorted(res.items())), flush=True)

        # per-call rate, host clock around calls that end in a synchronize
        scan = make_train_scan(engine.model, noise_model="eld", bank=engine.bank, batch=8,
                               steps_per_call=10, autocast_dtype=torch.bfloat16)
        rates, per_step = [], []
        for call in range(4):
            seeds = [fold_in(SEED, 10_000 + 10 * call + j) for j in range(10)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scan(engine.state, pool, seeds)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if call:  # the first call is a warm-up
                rates.append(80 / dt)
                per_step.append(dt / 10 * 1e3)
        print(f"[4] {arch}: pooled calls of 10 steps (bf16, batch 8, 512^2): "
              f"{', '.join(f'{r:.1f}' for r in rates)} patches/s; per step "
              f"{', '.join(f'{m:.2f}' for m in per_step)} ms (phase 3b, per-step "
              f"path, batch on the card: {', '.join(f'{m:.2f}' for m in step_ms)} ms) "
              f"on {card}", flush=True)
        engines[arch] = engine
    return engines, launches_total, steps_total


# ---- phase 5 ------------------------------------------------------------

def _write_rawpack(path, mosaic, iso, exposure):
    import numpy as np

    np.savez(path, mosaic=mosaic, black_level=np.float32(512), iso=float(iso),
             exposure=float(exposure), wb=np.array([2.0, 1.0, 1.5, 1.0], np.float32))


def phase5(card, tmp, engines):
    import copy

    import numpy as np
    import torch

    from eld_tpu_torch.models import build_arch
    from eld_tpu_torch.tools import test_eld, test_sid
    from eld_tpu_torch.train.steps import make_eval_forward

    # (a) the eval forward on the card (f32, TF32 off) against the same
    # weights on the CPU, on a frame aligned to neither 16 nor 32
    x = torch.from_numpy(np.random.default_rng(SEED).random((1, 232, 344, 4),
                                                            dtype=np.float32))
    for arch, engine in engines.items():
        cpu_model = build_arch(arch, 4, 4, base_width=32, skip_mode="split")
        cpu_model.load_state_dict({k: v.cpu() for k, v in engine.model.state_dict().items()})
        for chop in (False, True):
            card_out = make_eval_forward(engine.model, chop=chop)(x.cuda()).cpu()
            cpu_out = make_eval_forward(cpu_model, chop=chop)(x)
            err = float((card_out - cpu_out).abs().max())
            check(card_out.shape == x.shape and bool(torch.isfinite(card_out).all())
                  and err < 1e-4, f"eval forward {arch} chop={chop}: max |err| {err}")
            print(f"[5a] eval forward {arch} {'chop' if chop else 'pad'} (1, 232, 344, 4): "
                  f"card == CPU within {err:.3g} (tol 1e-4)", flush=True)

    # (b) test_sid over SID-geometry rawpacks, on the card and on the CPU
    ckpt = os.path.join(tmp, "ck", "unet", "model_latest.pt")
    check(os.path.exists(ckpt), f"phase 4 left no {ckpt}")
    rng = np.random.default_rng(SEED + 1)
    gt = _smooth_mosaic((2848, 4256), rng)
    sid = os.path.join(tmp, "sid_full")
    os.makedirs(os.path.join(sid, "short"))
    os.makedirs(os.path.join(sid, "long"))
    pairs = [("00001_00_0.1s.npz", "00001_00_10s.npz", 100),
             ("00001_00_0.033s.npz", "00001_00_10s.npz", 300)]
    _write_rawpack(os.path.join(sid, "long", pairs[0][1]), gt, 100, 10)
    for short, _, ratio in pairs:
        dark = (512 + (gt.astype(np.float32) - 512) / ratio).astype(np.uint16)
        _write_rawpack(os.path.join(sid, "short", short), dark, 100, 10 / ratio)
    pairs_file = os.path.join(tmp, "pairs.txt")
    with open(pairs_file, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in pairs)
    results = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        results[device] = test_sid.main([
            "--datadir", sid, "--pairs", pairs_file, "--model_path", ckpt, "--device", device,
            "--checkpoints_dir", os.path.join(tmp, "ck_eval"), "--no-log", "--no-verbose"])
        print(f"[5b] test_sid on {device}: {time.perf_counter() - t0:.2f} s; " + "; ".join(
            f"ratio {r}: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(m.items()))
            for r, m in sorted(results[device].items())), flush=True)
    for ratio in (100, 300):
        got, want = results["cuda"][ratio], results["cpu"][ratio]
        check(all(math.isfinite(v) for v in got.values()), f"test_sid ratio {ratio}: {got}")
        dpsnr = max(abs(got[k] - want[k]) for k in ("PSNR", "PSNR_in"))
        dssim = max(abs(got[k] - want[k]) for k in ("SSIM", "SSIM_in"))
        check(dpsnr <= 0.01 and dssim <= 1e-4,
              f"test_sid ratio {ratio}: card vs CPU |dPSNR| {dpsnr}, |dSSIM| {dssim}")
        print(f"[5b] ratio {ratio}: card == CPU within {dpsnr:.3g} dB PSNR, {dssim:.3g} SSIM "
              f"(tol 0.01 / 1e-4)", flush=True)

    # (c) test_eld: full frames (crop=False) through the 4-tile chop
    scene = os.path.join(tmp, "eld", "SonyA7S2", "scene-1")
    os.makedirs(scene)
    dark = (512 + (gt.astype(np.float32) - 512) / 100).astype(np.uint16)
    for img_id in (6, 11, 16):
        _write_rawpack(os.path.join(scene, f"IMG_{img_id:04d}.npz"), gt, 800, 1.0)
    for img_id in (4, 9, 14, 5, 10, 15):
        _write_rawpack(os.path.join(scene, f"IMG_{img_id:04d}.npz"), dark, 800, 0.01)
    t0 = time.perf_counter()
    eld = test_eld.main(["--datadir", os.path.join(tmp, "eld"), "--include", "4",
                         "--suffix", ".npz", "--scenes", "1", "--chop", "--model_path", ckpt,
                         "--device", "cuda", "--checkpoints_dir", os.path.join(tmp, "ck_eval"),
                         "--no-log", "--no-verbose"])
    check(sorted(eld) == [("SonyA7S2", "x100"), ("SonyA7S2", "x200")], f"test_eld: {eld}")
    for key, res in sorted(eld.items()):
        check(all(math.isfinite(v) for v in res.values()), f"test_eld {key}: {res}")
        print(f"[5c] test_eld {key[0]} {key[1]} (1424x2128 full frames, --chop): " +
              ", ".join(f"{k} {v:.4f}" for k, v in sorted(res.items())), flush=True)
    print(f"[5c] test_eld: {time.perf_counter() - t0:.2f} s for 6 items", flush=True)

    # (d) full-frame eval-forward times, unet (the phase-4 weights)
    model = copy.deepcopy(engines["unet"].model).eval()
    frame = torch.rand((1, 1424, 2128, 4), generator=torch.Generator().manual_seed(SEED)).cuda()
    times = {}
    for dtype in (None, torch.bfloat16):
        for chop in (False, True):
            fwd = make_eval_forward(model, chop=chop, autocast_dtype=dtype)
            times[("bf16" if dtype else "f32", "chop" if chop else "pad")] = \
                cuda_ms(lambda: fwd(frame), reps=5)
    print("[5d] full-frame (1, 1424, 2128, 4) unet eval forward ms (median of 5, CUDA "
          "events): " + ", ".join(f"{d} {c} {ms:.2f}" for (d, c), ms in times.items()) +
          f" on {card}", flush=True)


def main():
    check(len(sys.argv) == 1, f"unknown arguments {sys.argv[1:]}")
    card = phase0()
    phase1()
    k = phase2(card)
    s = phase3(card)
    step_ms = phase3b(card)
    with tempfile.TemporaryDirectory() as tmp:
        engines, pooled_launches, pooled_steps = phase4(card, tmp, step_ms)
        phase5(card, tmp, engines)

    import torch

    from eld_tpu_torch.noise.kernels import REPLACES, SOURCE_PATH

    launches = s["launches"] + pooled_launches
    kernels = {"kernels": [{
        "name": "noise_synth", "route": "cuda", "source": SOURCE_PATH, "replaces": REPLACES,
        "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "ms_smooth": k["ms_smooth"], "kernel_ms": k["kernel_ms"],
        "kernel_ms_smooth": k["kernel_ms_smooth"], "ops_ms": k["ops_ms"],
        "launches_per_step": launches / (s["steps"] + pooled_steps)}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
