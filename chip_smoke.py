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
     shape (8, 512, 512, 4), a ragged, a one-pixel-wide, a 9-channel, a
     1100-pixel-wide, the sRGB stage's (8, 512, 512, 3) and a ragged
     1-channel shape; per-image moments, Poisson histograms, row
     structure, seeds, range at the slice's shape; its registers and
     spills (nvcc -Xptxas -v); on uniform and on smooth input, the
     wrapper's time (as in earlier runs) and the kernel's alone (CUDA
     events), and its bound from the bytes and the f32 operations; the
     kernel alone at C = 3;
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
  6. the serving path and paired / sRGB training at full width, unet on
     full SID frames (1424x2128x4 packed): (a) the ISP (process, raw2rgb;
     gamma and the CRF) on the card against the CPU, and its ms; (b)
     export_model from phase 4's .pt (f32, int8, f32 --chop), each
     artifact on the card against the eager forward, the int8 denoised
     PSNR within 0.05 dB of f32 and the int8 output against the f32 output
     (at least 40 dB), export seconds and sizes; (c) denoise --batch 2
     --io_threads 2 over two DNG and two rawpack full frames from the .pt
     and the f32 and int8 artifacts, then over 32 frames (those four linked
     eight times each; frames/s without the network's load, the device's
     idle share under torch.profiler), the host's decode, PNG and npz write
     ms per frame, --save_raw, two frames against --device cpu; (d) test_sid --stage_eval srgb --crf on the
     card against the CPU; (e) the builder's paired, clean, syn and sRGB
     stores from SID-named full frames, then one epoch at batch 8 of
     train_real, train_syn --offline_noise (--scan auto: 10) and train_syn
     --stage_in/--stage_out srgb (--scan auto: 0; the kernel at C = 3, one
     launch per step);
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
SRGB_SHAPE = (8, 512, 512, 3)  # the sRGB training stage's batches
# the slice's shape; ragged (odd H and W); one pixel per row; 9 channels;
# rows wider than a block (several pixels per thread); the sRGB stage's
# 3 channels; one ragged channel
KERNEL_SHAPES = (SLICE_SHAPE, (3, 37, 53, 4), (2, 5, 1, 4), (2, 33, 31, 9), (1, 3, 1100, 4),
                 SRGB_SHAPE, (3, 37, 53, 1))
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
    # C = 3 (the sRGB stage): the kernel's scalar path, on uniform input
    g3 = torch.Generator(device=dev).manual_seed(SEED + 2)
    clean3 = torch.rand(SRGB_SHAPE, generator=g3, device=dev)
    t["kernel_ms_c3"] = cuda_ms(kernel_only(lib, 9, clean3, params, "eld", True), spin=True)
    bound_c3 = max(_noise_bytes_ms(SRGB_SHAPE), _noise_ops_ms(9, clean3, params))
    print(f"[2g] eld {tuple(SLICE_SHAPE)} (median of 20, CUDA events): wrapper "
          f"{t['ms']:.4f} ms on uniform input, {t['ms_smooth']:.4f} ms on smooth patches; "
          f"kernel alone {t['kernel_ms']:.4f} / {t['kernel_ms_smooth']:.4f} ms; plain "
          f"{t['plain_ms']:.4f} ms; bound by bytes {bytes_ms:.4f} ms, by f32 operations "
          f"{ops_ms['uniform']:.4f} / {ops_ms['smooth']:.4f} ms; on {card}", flush=True)
    print(f"[2g] eld {SRGB_SHAPE} (C = 3, scalar path): kernel alone {t['kernel_ms_c3']:.4f} "
          f"ms on uniform input; bound {bound_c3:.4f} ms (bytes "
          f"{_noise_bytes_ms(SRGB_SHAPE):.4f}) on {card}", flush=True)
    return {"max_abs_err": max_err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
            "ops_ms": ops_ms["uniform"], "bound_ms_c3": bound_c3}


def _noise_bytes_ms(shape) -> float:
    """K1's time by bytes: each byte of the clean batch and the (N, 12)
    parameter rows read once, each output byte written once, at the
    H100's memory rate."""
    nbytes = 2 * math.prod(shape) * 4 + shape[0] * 12 * 4
    return nbytes / H100_BYTES_PER_S * 1e3


def _noise_ops_ms(seed, clean, params) -> float:
    """K1's time by f32 operations for model 'eld' (PGrqc, clip on) on this
    input and seed, at the H100's float32 peak.  Each IEEE operation,
    min/max, compare, int-to-float conversion and transcendental in
    noise_synth.cu counts once: 31 per element outside the shot draw (30
    where C != 4, which adds no color bias),
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
    per_element = 31 if clean.shape[-1] == 4 else 30
    ops = (per_element * lam.numel() + float((4 + 6 * counts)[small].sum())
           + 14 * int((~small).sum()))
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
    """The eval stack; returns the SID-geometry rawpacks, their pair list
    and phase 4's unet checkpoint for phase 6."""
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
    return {"sid": sid, "pairs": pairs_file, "ckpt": ckpt}


# ---- phase 6 ------------------------------------------------------------

FULL_FRAME = (1424, 2128)  # SID Sony, packed
FULL_MOSAIC = (2 * FULL_FRAME[0], 2 * FULL_FRAME[1])
# a camera -> sRGB matrix as DNG files give it (the fixture's, rounded)
CCM = ((3.08, -1.537, -0.543), (-0.921, 1.876, 0.045), (0.053, -0.204, 1.151))
INT8_VS_F32_DB = 40.0  # floor of PSNR(int8 artifact's output, f32 artifact's output)
LONG_FRAMES = 32  # the steady-state serving run: the four inputs linked 8 times each


def _codes_close(got, ref, what):
    """8-bit renders in [0, 1]: codes equal except at most 0.1% of values,
    which differ by one (a value within an ulp of a code boundary); returns
    the share that differs."""
    import numpy as np

    codes = np.rint((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) * 255)
    share = float((codes != 0).mean())
    check(np.abs(codes).max() <= 1 and share <= 1e-3,
          f"{what}: codes differ by up to {np.abs(codes).max()} on {share:.3%}")
    return share


def _png_codes_close(a, b, what):
    import numpy as np

    from eld_tpu_torch.utils.images import load_png

    return _codes_close(load_png(a).astype(np.float64) / 255, load_png(b) / 255.0, what)


def phase6a(card):
    """The ISP on a full frame on the card against the CPU, gamma and CRF."""
    import numpy as np
    import torch

    from eld_tpu_torch.core import emor, isp

    rng = np.random.default_rng(SEED + 2)
    frames = torch.from_numpy(rng.random((2, *FULL_FRAME, 4), dtype=np.float32))
    wb = torch.tensor([[2.0, 1.0, 1.6, 1.0], [1.8, 1.0, 2.1, 1.0]])
    ccm = torch.tensor(CCM).expand(2, 3, 3)
    crf_cpu = emor.load_crf()
    crf_card = tuple(torch.from_numpy(a).cuda() for a in crf_cpu)
    times = {}
    for render, crf, crf_dev in (("gamma", None, None), ("crf", crf_cpu, crf_card)):
        cpu = isp.process(frames, wb, ccm, crf=crf)
        got = isp.process(frames.cuda(), wb.cuda(), ccm.cuda(), crf=crf_dev).cpu()
        share = _codes_close(got, cpu, f"ISP process {render}")
        one_cpu = isp.raw2rgb(frames[0], wb[0] * 512, CCM, crf=crf)
        x = frames[0].cuda()
        one = isp.raw2rgb(x, wb[0] * 512, CCM, crf=crf_dev).cpu()
        share_one = _codes_close(one, one_cpu, f"ISP raw2rgb {render}")
        times[render] = cuda_ms(lambda: isp.raw2rgb(x, wb[0], CCM, crf=crf_dev), reps=10)
        print(f"[6a] ISP {render} {(2, *FULL_FRAME, 4)} and one frame: card == CPU but "
              f"{share:.4%} / {share_one:.4%} of 8-bit codes, each by one", flush=True)
    print(f"[6a] raw2rgb full frame {(*FULL_FRAME, 4)} ms (median of 10, CUDA events): gamma "
          f"{times['gamma']:.3f}, crf {times['crf']:.3f} on {card}", flush=True)
    return times


def _noisy_frame(seed):
    """A smooth full frame in [0, 1] and its ELD-noised copy on the card
    (SonyA7S2 parameters), for the artifact checks."""
    import numpy as np
    import torch

    from eld_tpu_torch.noise.kernels import synthesize_kernel
    from eld_tpu_torch.noise.params import load_camera_params, sample_params_batch

    rng = np.random.default_rng(seed)
    planes = [(_smooth_mosaic(FULL_FRAME, rng).astype(np.float32) - 2048) / 14000
              for _ in range(4)]
    clean = torch.from_numpy(np.stack(planes, -1)[None]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = sample_params_batch(gen, load_camera_params(include=4, device="cuda"), 1)
    return clean, synthesize_kernel(seed, clean.contiguous(), params, "eld", clip=True)


def phase6b(card, tmp, ckpt):
    """export_model at full frame (f32, int8, f32 --chop), each artifact on
    the card against the eager forward; the int8 PSNR gate."""
    import torch

    from eld_tpu_torch import export
    from eld_tpu_torch.models import build_arch
    from eld_tpu_torch.ops.metrics import psnr
    from eld_tpu_torch.tools import export_model
    from eld_tpu_torch.train.checkpoints import load_params
    from eld_tpu_torch.train.steps import make_eval_forward

    h, w = FULL_FRAME
    arts = {}
    for tag, extra in (("f32", []), ("int8", ["--quantize", "int8"]), ("chop", ["--chop"])):
        path = os.path.join(tmp, f"unet_{tag}.eldx")
        t0 = time.perf_counter()
        export_model.main(["--model_path", ckpt, "--height", str(h), "--width", str(w),
                           "--device", "cuda", "--out", path] + extra)
        arts[tag] = {"path": path, "export_s": time.perf_counter() - t0,
                     "mb": os.path.getsize(path) / 1e6}
    model = build_arch("unet", 4, 4, base_width=32, skip_mode="split").cuda()
    model = model.to(memory_format=torch.channels_last)
    load_params(ckpt, model)
    model.eval()
    clean, noisy = _noisy_frame(SEED + 3)
    eager = {"f32": make_eval_forward(model), "chop": make_eval_forward(model, chop=True),
             "int8": export.serving_module(model, quantize="int8")}
    outs = {}
    for tag, art in arts.items():
        fn, meta = export.load_denoiser(art["path"], "cuda")
        check(meta["quantize"] == ("int8" if tag == "int8" else None)
              and meta["chop"] == (tag == "chop"), f"artifact {tag} meta {meta}")
        with torch.no_grad():
            want = eager[tag](noisy)
        outs[tag] = fn(noisy)
        err = float((outs[tag] - want).abs().max())
        check(outs[tag].shape == noisy.shape and err <= 1e-4,
              f"artifact {tag} vs the eager forward: max |err| {err}")
        art["err"] = err
        art["ms"] = cuda_ms(lambda: fn(noisy), reps=5)
        art["eager_ms"] = cuda_ms(lambda: eager[tag](noisy), reps=5)
        print(f"[6b] export_model {tag}: {art['export_s']:.2f} s, {art['mb']:.2f} MB; on the "
              f"card == eager forward within {err:.3g} (tol 1e-4); forward ms (median of 5, "
              f"CUDA events) artifact {art['ms']:.2f}, eager {art['eager_ms']:.2f}", flush=True)
    db = {tag: float(psnr(outs[tag].clamp(0, 1), clean, 1.0)) for tag in ("f32", "int8")}
    delta = abs(db["f32"] - db["int8"])
    check(delta <= 0.05, f"int8 denoised PSNR {db['int8']:.4f} vs f32 {db['f32']:.4f} dB")
    # phase 4's network barely denoises, so the delta above cannot show
    # quantization harm; the int8 output against the f32 output can: 40 dB
    # is an RMS difference of 1% of full scale
    vs_f32 = float(psnr(outs["int8"].clamp(0, 1), outs["f32"].clamp(0, 1), 1.0))
    diff = float((outs["int8"] - outs["f32"]).abs().max())
    check(vs_f32 >= INT8_VS_F32_DB, f"int8 artifact vs f32 artifact: {vs_f32:.2f} dB "
          f"(floor {INT8_VS_F32_DB}), max |diff| {diff}")
    noisy_db = float(psnr(noisy.clamp(0, 1), clean, 1.0))
    print(f"[6b] on an ELD-noised full frame (noisy input {noisy_db:.4f} dB): denoised PSNR f32 "
          f"{db['f32']:.4f} dB, int8 {db['int8']:.4f} dB, delta {delta:.4f} dB (gate 0.05); "
          f"int8 output vs f32 output {vs_f32:.2f} dB (floor {INT8_VS_F32_DB}), max |diff| "
          f"{diff:.3g}; on {card}", flush=True)
    return arts, {"psnr_delta_db": delta, "psnr_f32_db": db["f32"], "psnr_int8_db": db["int8"],
                  "psnr_noisy_db": noisy_db, "int8_vs_f32_db": vs_f32, "int8_vs_f32_max": diff}


def _device_busy_ms(prof):
    """Device time summed over a torch.profiler run's events (one stream,
    so no overlap); None where the profiler recorded none."""
    total = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages())
    return total / 1e3 if total > 0 else None


def _median_s(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def phase6c(card, tmp, ckpt, arts):
    """denoise over four full-frame raws (two DNG, two rawpacks) from the
    .pt and the artifacts, then over LONG_FRAMES of them (the steady state,
    device idle under torch.profiler); the host's decode and write times per
    frame; two frames against the CPU."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eld_tpu_torch import export
    from eld_tpu_torch.data import rawio
    from eld_tpu_torch.models import build_arch
    from eld_tpu_torch.tools import denoise
    from eld_tpu_torch.train.checkpoints import load_params
    from eld_tpu_torch.utils.images import load_png, save_png
    from tests.tiff_fixture import make_dng

    rng = np.random.default_rng(SEED + 4)
    inputs = os.path.join(tmp, "serve")
    pair = os.path.join(tmp, "serve_pair")
    long_dir = os.path.join(tmp, "serve_long")
    for d in (inputs, pair, long_dir):
        os.makedirs(d)
    for i in range(4):
        gt = _smooth_mosaic(FULL_MOSAIC, rng)
        dark = (512 + (gt.astype(np.float32) - 512) / 100).astype(np.uint16)
        if i < 2:
            path = os.path.join(inputs, f"IMG_{i:04d}.dng")
            data = make_dng(dark, iso=100, exposure=0.1)
            for d in (inputs, pair):
                with open(os.path.join(d, os.path.basename(path)), "wb") as f:
                    f.write(data)
        else:
            _write_rawpack(os.path.join(inputs, f"IMG_{i:04d}.npz"), dark, 100, 0.1)
    names = sorted(os.listdir(inputs))
    for k in range(LONG_FRAMES):
        ext = os.path.splitext(names[k % 4])[1]
        os.link(os.path.join(inputs, names[k % 4]), os.path.join(long_dir, f"IMG_{k:04d}{ext}"))
    decode = []
    for fn in names:
        t0 = time.perf_counter()
        rawio.imread(os.path.join(inputs, fn)).packed()
        decode.append((time.perf_counter() - t0) * 1e3)

    def run(tag, source, extra=(), device="cuda", directory=inputs):
        out = os.path.join(tmp, f"denoised_{tag}")
        argv = ["--input", directory, "--ratio", "100", "--batch", "2", "--io_threads", "2",
                "--device", device, "--out", out, *source, *extra]
        t0 = time.perf_counter()
        res = denoise.main(argv)
        wall = time.perf_counter() - t0
        check(len(res) == len(os.listdir(directory)), f"denoise {tag}: {len(res)} records")
        return res, wall

    sources = {"pt": ["--model_path", ckpt], "f32": ["--artifact", arts["f32"]["path"]],
               "int8": ["--artifact", arts["int8"]["path"]]}
    # the network's load, timed apart: the CLI's wall holds it once a run
    load_s = {}
    for tag in ("f32", "int8"):
        t0 = time.perf_counter()
        export.load_denoiser(arts[tag]["path"], "cuda")
        load_s[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_params(ckpt, build_arch("unet", 4, 4, base_width=32, skip_mode="split").cuda())
    load_s["pt"] = time.perf_counter() - t0
    fps, fps_long = {}, {}
    for tag, source in sources.items():
        _, wall = run(tag, source)
        fps[tag] = 4 / wall
    for tag, source in sources.items():
        _, wall = run(f"long_{tag}", source, directory=long_dir)
        fps_long[tag] = LONG_FRAMES / (wall - load_s[tag])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = run("profiled", sources["pt"], directory=long_dir)
        torch.cuda.synchronize()
    busy = _device_busy_ms(prof)
    idle = "not measured" if busy is None else f"{1 - busy / (wall * 1e3):.1%}"
    print(f"[6c] denoise --batch 2 --io_threads 2 on {card}: 4 full frames (2 DNG, 2 rawpacks, "
          f"pipeline fill and drain, load included): " +
          ", ".join(f"{t} {fps[t]:.2f}" for t in sources) + f" frames/s; {LONG_FRAMES} frames "
          f"(the 4 linked {LONG_FRAMES // 4} times), without the network's load: " +
          ", ".join(f"{t} {fps_long[t]:.2f} frames/s (load {load_s[t]:.2f} s)" for t in sources) +
          f"; .pt over {LONG_FRAMES} frames under torch.profiler: {wall:.2f} s wall "
          f"(load included), device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}, idle {idle}", flush=True)

    saved = {tag: run(f"raw_{tag}", sources[tag], ["--save_raw"])[0] for tag in ("pt", "f32")}
    # the host's work per frame, one thread, median of 3: a frame's PNG as
    # denoise hands it to save_png, and its .npz
    rec = saved["pt"][0]
    rgb = load_png(rec["output"]).astype(np.float32)
    npz = dict(np.load(rec["raw_output"]))
    png_ms = _median_s(lambda: save_png(os.path.join(tmp, "t.png"), rgb)) * 1e3
    npz_ms = _median_s(lambda: np.savez_compressed(os.path.join(tmp, "t.npz"), **npz)) * 1e3
    print(f"[6c] host per full frame, one thread: decode {np.mean(decode):.1f} ms (mean of 4), "
          f"PNG write {png_ms:.1f} ms, npz write {npz_ms:.1f} ms (median of 3) on {card}",
          flush=True)
    cpu, cpu_wall = run("cpu", sources["pt"], ["--save_raw"], device="cpu", directory=pair)
    by_input = {os.path.basename(r["input"]): r for r in saved["pt"]}
    worst = {"npz": 0.0, "png": 0.0}
    for rec in cpu:
        card_rec = by_input[os.path.basename(rec["input"])]
        a, b = np.load(card_rec["raw_output"])["packed"], np.load(rec["raw_output"])["packed"]
        err = float(np.abs(a - b).max())
        check(np.isfinite(a).all() and err <= 1e-4, f"denoise card vs CPU npz: {err}")
        worst["npz"] = max(worst["npz"], err)
        worst["png"] = max(worst["png"], _png_codes_close(card_rec["output"], rec["output"],
                                                          "denoise card vs CPU PNG"))
    for a, b in zip(saved["pt"], saved["f32"]):
        err = float(np.abs(np.load(a["raw_output"])["packed"]
                           - np.load(b["raw_output"])["packed"]).max())
        check(err <= 1e-4, f"denoise .pt vs f32 artifact npz: {err}")
    print(f"[6c] card vs CPU ({cpu_wall:.2f} s on the CPU for 2 frames): npz within "
          f"{worst['npz']:.3g} (tol 1e-4), PNG codes differ on {worst['png']:.4%} (<= 0.1%, by "
          f"one); .pt == f32 artifact within 1e-4 on the card", flush=True)
    return {"frames_per_s_4": fps, "frames_per_s_long_without_load": fps_long,
            "long_frames": LONG_FRAMES, "load_s": load_s, "device_busy_ms_long": busy,
            "profiled_wall_s_long": wall, "decode_ms_per_frame": float(np.mean(decode)),
            "png_write_ms_per_frame": png_ms, "npz_write_ms_per_frame": npz_ms}


def phase6d(card, tmp, p5):
    """test_sid --stage_eval srgb --crf on the card against the CPU."""
    from eld_tpu_torch.tools import test_sid

    results = {}
    for device in ("cuda", "cpu"):
        results[device] = test_sid.main([
            "--datadir", p5["sid"], "--pairs", p5["pairs"], "--model_path", p5["ckpt"],
            "--device", device, "--stage_eval", "srgb", "--crf", "--checkpoints_dir",
            os.path.join(tmp, "ck_srgb"), "--no-log", "--no-verbose"])
    for ratio in (100, 300):
        got, want = results["cuda"][ratio], results["cpu"][ratio]
        check(all(math.isfinite(v) for v in got.values()), f"sRGB test_sid {ratio}: {got}")
        dpsnr = max(abs(got[k] - want[k]) for k in ("PSNR", "PSNR_in"))
        dssim = max(abs(got[k] - want[k]) for k in ("SSIM", "SSIM_in"))
        check(dpsnr <= 0.01 and dssim <= 1e-4,
              f"sRGB test_sid ratio {ratio}: card vs CPU |dPSNR| {dpsnr}, |dSSIM| {dssim}")
        print(f"[6d] test_sid --stage_eval srgb --crf ratio {ratio}: " +
              ", ".join(f"{k} {v:.4f}" for k, v in sorted(got.items())) +
              f"; card == CPU within {dpsnr:.3g} dB, {dssim:.3g} SSIM (tol 0.01 / 1e-4)",
              flush=True)


def phase6e(card, tmp):
    """The builder's paired, clean, syn and sRGB stores from SID-named full
    frames, then train_real, train_syn --offline_noise and the sRGB stage,
    one epoch each at batch 8 on the card."""
    import numpy as np

    from eld_tpu_torch.data import builder
    from eld_tpu_torch.data.pairs import sid_pairs
    from eld_tpu_torch.data.patchstore import PatchStore
    from eld_tpu_torch.noise.kernels import synthesize_kernel
    from eld_tpu_torch.tools import train_real, train_syn
    from tests.tiff_fixture import make_dng

    src, dest = os.path.join(tmp, "sid_train"), os.path.join(tmp, "train6")
    for sub in ("short", "long"):
        os.makedirs(os.path.join(src, sub))
    rng = np.random.default_rng(SEED + 5)
    longs = sorted({p[1] for p in sid_pairs("train")})[:12]
    pairs = sorted(sid_pairs("train"))[:2]
    scenes = {}
    for fn in sorted(set(longs) | {b for _, b in pairs}):
        scenes[fn] = _smooth_mosaic(FULL_MOSAIC, rng)
        with open(os.path.join(src, "long", fn), "wb") as f:
            f.write(make_dng(scenes[fn], iso=100, exposure=10))
    for a, b in pairs:
        expo = float(a.split("_")[-1][:-5])
        dark = (512 + (scenes[b].astype(np.float32) - 512) * expo / 10).astype(np.uint16)
        with open(os.path.join(src, "short", a), "wb") as f:
            f.write(make_dng(dark, iso=100, exposure=expo))
    t0 = time.perf_counter()
    builder.create_sony_dataset_paired(src, dest, num_samples=2)
    builder.create_sony_dataset(src, dest, num_samples=12)
    builder.create_sony_syn_dataset(src, dest, 4, num_samples=12, seed=SEED)
    builder.create_sony_dataset_srgb(src, dest, num_samples=2)
    build_s = time.perf_counter() - t0
    counts = {name: (len(PatchStore(os.path.join(dest, name))),
                     PatchStore(os.path.join(dest, name)).shape)
              for name in sorted(os.listdir(dest))}
    per = (FULL_FRAME[0] // 512) * (FULL_FRAME[1] // 512)  # 8 patches of 512^2 a frame
    srgb_store = builder.store_name("clean", "srgb", crf=True)
    want = {builder.store_name("input"): 2 * per, builder.store_name("target"): 2 * per,
            builder.store_name("clean"): 12 * per,
            builder.store_name("syn", camera="SonyA7S2"): 12 * per, srgb_store: 2 * per}
    check({k: v[0] for k, v in counts.items()} == want, f"builder stores: {counts}")
    check(counts[srgb_store][1] == (512, 512, 3), f"sRGB store {counts}")
    print(f"[6e] builder: {len(longs)} long + {len(pairs)} short full frames -> " +
          ", ".join(f"{k} {n}x{s}" for k, (n, s) in counts.items()) +
          f" in {build_s:.2f} s (host)", flush=True)

    batch = 8
    common = ["--traindir", dest, "--evaldir", os.path.join(tmp, "no_eval"), "-b", str(batch),
              "--bf16", "--epochs", "1", "--no-log", "--no-verbose", "--seed", str(SEED),
              "--nThreads", "4", "--device", "cuda", "--include", "4"]
    runs = {"train_real": (train_real.main, ["--checkpoints_dir", os.path.join(tmp, "ck_r")]),
            "offline_noise": (train_syn.main, ["--offline_noise", "--checkpoints_dir",
                                               os.path.join(tmp, "ck_o")]),
            "srgb": (train_syn.main, ["--stage_in", "srgb", "--stage_out", "srgb", "--crf",
                                      "--noise", "eld", "--checkpoints_dir",
                                      os.path.join(tmp, "ck_s")])}
    # the per-step loader records every step, the pooled trainer (--scan
    # auto: 10) every call: 2 steps, 12 steps in calls of 10 and 2, 2 steps
    paired_steps, pooled_steps = 2 * per // batch, 12 * per // batch
    want_calls = {"train_real": list(range(paired_steps)),
                  "offline_noise": sorted({min(k, pooled_steps)
                                           for k in range(10, pooled_steps + 10, 10)}),
                  "srgb": list(range(paired_steps))}
    srgb_launches = 0
    for name, (fn, extra) in runs.items():
        synthesize_kernel.launches = 0
        t0 = time.perf_counter()
        engine = fn(common + extra)
        wall = time.perf_counter() - t0
        launches = synthesize_kernel.launches
        calls = [h[0] for h in engine.history]
        losses = [v for h in engine.history for v in h[1].values()]
        check(calls == want_calls[name], f"{name}: steps/calls {calls}, "
              f"want {want_calls[name]} (--scan auto: 10 pooled, 0 for sRGB)")
        check(all(math.isfinite(v) for v in losses), f"{name}: non-finite loss {losses}")
        check(launches == (engine.iterations if name == "srgb" else 0),
              f"{name}: noise kernel launched {launches} times for {engine.iterations} steps")
        if name == "srgb":
            srgb_launches = launches
            check(engine.model.conv1_1.in_channels == 3, "sRGB stage built a 4-channel U-Net")
        print(f"[6e] {name}: {engine.iterations} steps in {wall:.2f} s (set-up included); "
              f"losses {', '.join(f'{v:.5f}' for v in losses)}; noise kernel launches "
              f"{launches}", flush=True)
    return srgb_launches, paired_steps


def main():
    check(len(sys.argv) == 1, f"unknown arguments {sys.argv[1:]}")
    card = phase0()
    phase1()
    k = phase2(card)
    s = phase3(card)
    step_ms = phase3b(card)
    with tempfile.TemporaryDirectory() as tmp:
        engines, pooled_launches, pooled_steps = phase4(card, tmp, step_ms)
        p5 = phase5(card, tmp, engines)
        secs = {"start": time.perf_counter()}
        isp_ms = phase6a(card)
        secs["6a"] = time.perf_counter()
        arts, int8 = phase6b(card, tmp, p5["ckpt"])
        secs["6b"] = time.perf_counter()
        serving = phase6c(card, tmp, p5["ckpt"], arts)
        secs["6c"] = time.perf_counter()
        phase6d(card, tmp, p5)
        secs["6d"] = time.perf_counter()
        srgb_launches, srgb_steps = phase6e(card, tmp)
        secs["6e"] = time.perf_counter()
        marks = list(secs.values())
        print(f"[6] phase 6: {marks[-1] - marks[0]:.1f} s (" + ", ".join(
            f"{k} {b - a:.1f} s" for k, a, b in zip(list(secs)[1:], marks, marks[1:])) + ")",
            flush=True)
        print("[6] " + json.dumps({
            "isp_ms": isp_ms, "denoise": serving, "int8": int8,
            "export": {k: {f: v[f] for f in ("export_s", "mb", "ms", "eager_ms", "err")}
                       for k, v in arts.items()}}), flush=True)

    import torch

    from eld_tpu_torch.noise.kernels import REPLACES, SOURCE_PATH

    launches = s["launches"] + pooled_launches + srgb_launches
    kernels = {"kernels": [{
        "name": "noise_synth", "route": "cuda", "source": SOURCE_PATH, "replaces": REPLACES,
        "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "ms_smooth": k["ms_smooth"], "kernel_ms": k["kernel_ms"],
        "kernel_ms_smooth": k["kernel_ms_smooth"], "ops_ms": k["ops_ms"],
        "kernel_ms_c3": k["kernel_ms_c3"], "bound_ms_c3": k["bound_ms_c3"],
        "launches_per_step": launches / (s["steps"] + pooled_steps + srgb_steps)}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
