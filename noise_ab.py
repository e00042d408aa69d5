#!/usr/bin/env python3
"""Hold the noise kernel against another version of its source on an NVIDIA GPU.

Run from the repository root, with one CUDA card visible, on a source with
the same C interface as eld_tpu_torch/csrc/noise_synth.cu, e.g. that of an
earlier commit kept out of git under scratch_chip/:

    mkdir -p scratch_chip
    git show <commit>:eld_tpu_torch/csrc/noise_synth.cu > scratch_chip/noise_synth_old.cu
    python3 noise_ab.py scratch_chip/noise_synth_old.cu

It builds both sources (nvcc -Xptxas -v) and prints their registers, spills
and static SASS instruction counts, writing both SASS listings to
build/eld_tpu_torch/ (noise_synth_sass_{other,this}.txt); holds the two
outputs equal bit for bit (ten models, clip on and off, chip_smoke.py's
phase-2a shapes); then times both at (8, 512, 512, 4), model 'eld', clip
on, on uniform input and on the trainers' smooth patches, in turns (other,
this, this, other), by three yardsticks:

  wrapper  the wrapper's work (checks, parameter packing, launch), median
           of 20 CUDA-event intervals: how chip_smoke.py's `ms` times K1;
  kernel   the kernel alone, the card spun ~1 ms before each interval so
           that host issue time stays out: chip_smoke.py's `kernel_ms`;
  profiler torch.profiler's device time per launch, mean of up to 20.

and this kernel alone by noise component.  The last line is one JSON
object with every number.  Any failure exits non-zero.  It imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

from chip_smoke import (HERE, KERNEL_SHAPES, MODELS, SEED, SLICE_SHAPE, _build_verbose,
                        _kernel_name, _noise_bytes_ms, _smooth_u16, check, cuda_ms, kernel_only,
                        phase0)

TURNS = ("other", "this", "this", "other")


def profiled_ms(fn, name: str, calls: int = 20) -> float:
    """Device time per launch of the kernels whose name holds ``name``, by
    torch.profiler over ``calls`` calls of ``fn``: the mean over the
    launches it recorded, which now and then miss one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name in e.key]
    total = sum(getattr(e, "device_time_total", None) or e.cuda_time_total for e in rows)
    count = sum(e.count for e in rows)
    check(0 < count <= calls, f"profiler saw {count} launches of {name} for {calls} calls")
    return total / count / 1e3


def sass_counts(lib_path, out_path):
    """Static SASS instruction count per kernel of a built library
    (cuobjdump -sass), the listing written to ``out_path``."""
    from eld_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    with open(out_path, "w") as f:
        f.write(proc.stdout)
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            counts[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    return counts


def speedup(t) -> str:
    """The range of other/this over the turns' readings."""
    return f"{min(t['other']) / max(t['this']):.2f}-{max(t['other']) / min(t['this']):.2f}x"


def main():
    import ctypes

    import torch

    from eld_tpu_torch._paths import BUILD_DIR
    from eld_tpu_torch.noise import kernels
    from eld_tpu_torch.noise.params import load_camera_params, sample_params_batch
    from eld_tpu_torch.train.steps import to_f32

    check(len(sys.argv) == 2, "usage: noise_ab.py OTHER.cu")
    card = phase0()
    dev = torch.device("cuda")
    os.makedirs(BUILD_DIR, exist_ok=True)
    libs, build = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for who, src in (("other", os.path.abspath(sys.argv[1])),
                         ("this", os.path.join(HERE, kernels.SOURCE_PATH))):
            os.makedirs(os.path.join(tmp, who))
            path, regs = _build_verbose(src, os.path.join(tmp, who))
            sass = sass_counts(path, os.path.join(BUILD_DIR, f"noise_synth_sass_{who}.txt"))
            libs[who] = kernels.bind(ctypes.CDLL(path))
            build[who] = {"ptxas": regs, "sass_instructions": sass}
            print(f"[ab] {who} ({src}): {regs}; static SASS instructions {sass}", flush=True)

        bank = load_camera_params(include=4, device=dev)
        for shape in KERNEL_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            x = torch.rand(shape, generator=gen, device=dev)
            p = sample_params_batch(gen, bank, shape[0])
            for model in MODELS:
                for clip in (False, True):
                    a = kernels.launch(libs["other"], 77, x, p, model, clip)
                    b = kernels.launch(libs["this"], 77, x, p, model, clip)
                    check(bool(torch.equal(a, b)), f"outputs differ: {shape} {model} clip={clip}: "
                          f"{int((a != b).sum())} elements, max |d| {float((a - b).abs().max())}")
            print(f"[ab] {shape}: bit-identical for {' '.join(MODELS)}, clip on and off",
                  flush=True)

        gen = torch.Generator(device=dev).manual_seed(SEED)
        inputs = {"uniform": torch.rand(SLICE_SHAPE, generator=gen, device=dev),
                  "smooth": to_f32(_smooth_u16(SLICE_SHAPE[0], dev))}
        params = sample_params_batch(gen, bank, SLICE_SHAPE[0])

        def wrapper(lib, x):
            def call():
                kernels._check(x, params)
                return kernels.launch(lib, 9, x, params, "eld", True)
            return call

        times = {}
        for name, x in inputs.items():
            t = {"wrapper": {"other": [], "this": []}, "kernel": {"other": [], "this": []}}
            for who in TURNS:
                t["wrapper"][who].append(cuda_ms(wrapper(libs[who], x)))
                t["kernel"][who].append(
                    cuda_ms(kernel_only(libs[who], 9, x, params, "eld", True), spin=True))
            t["profiler"] = {who: profiled_ms(kernel_only(libs[who], 9, x, params, "eld", True),
                                              "noise_synth_kernel") for who in ("other", "this")}
            times[name] = t
            print(f"[ab] eld {SLICE_SHAPE} {name} (ms, turns other/this/this/other): wrapper "
                  f"other {t['wrapper']['other']} this {t['wrapper']['this']} "
                  f"({speedup(t['wrapper'])}); kernel alone other {t['kernel']['other']} this "
                  f"{t['kernel']['this']} ({speedup(t['kernel'])}); torch.profiler other "
                  f"{t['profiler']['other']:.4f} this {t['profiler']['this']:.4f} "
                  f"({t['profiler']['other'] / t['profiler']['this']:.2f}x); on {card}",
                  flush=True)
        per_model = {
            model: {name: cuda_ms(kernel_only(libs["this"], 9, x, params, model, True), spin=True)
                    for name, x in inputs.items()}
            for model in ("q", "r", "g", "G", "P", "Pg", "eld")}
        print("[ab] this kernel alone by model, ms (uniform / smooth): " + ", ".join(
            f"{m} {v['uniform']:.4f} / {v['smooth']:.4f}" for m, v in per_model.items()),
            flush=True)
    print(json.dumps({"ab": {"card": card, "shape": SLICE_SHAPE,
                             "bytes_ms": _noise_bytes_ms(SLICE_SHAPE), "build": build,
                             "eld_ms": times, "this_kernel_ms_by_model": per_model}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
