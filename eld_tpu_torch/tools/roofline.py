"""Roofline / MFU report for the fused train step on the card (counterpart
of ``eld_tpu/tools/roofline.py``).

Builds the fused synthetic-noise train step (noise + forward + backward +
Adam) for a given arch/config, counts its FLOPs and bytes per step
(``step_cost``, the counterpart of XLA's ``cost_analysis()``), prints the
arithmetic intensity against the card's ridge point and the bandwidth
floor, and, unless ``--no-run``, the measured step time with achieved
TFLOP/s (MFU) and GB/s against peak.  On a card the timed steps replay
the step's CUDA graph (``steps.make_train_step``): the counted step is
the eager first call and the warmup holds the capture, both outside the
timed window; the record's ``graph`` and ``graph_replays`` say so.

Usage:
  python -m eld_tpu_torch.tools.roofline --arch unet_s2d --batch 16 --bf16
  python -m eld_tpu_torch.tools.roofline --arch unet --skip_mode split --no-run
  python -m eld_tpu_torch.tools.roofline --no-run --device cpu   # counts only

Peaks default to the NVIDIA H100 SXM5 80GB data sheet (dense): 989.4
TFLOP/s in bf16 under --bf16, 66.9 TFLOP/s in float32 under --f32 (TF32
is off, so f32 convolutions stay off the tensor cores), 3350 GB/s of
HBM3; --peak_tflops / --peak_gbs override them.  eld_tpu's --aot and
--mesh_data > 1 compile against TPU topology descriptors
(``eld_tpu/tools/aot.py``) and are refused here.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as onp
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from eld_tpu_torch.config import torch_device
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.kernels import PARAM_STRIDE, synthesize_kernel
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train.state import create_train_state
from eld_tpu_torch.train.steps import graph_replays, make_train_step

H100_BF16_TFLOPS = 989.4  # dense bf16 tensor math, H100 SXM5 80GB
H100_F32_TFLOPS = 66.9    # float32 outside the tensor cores, H100 SXM5 80GB
H100_HBM_GBS = 3350.0     # HBM3, H100 SXM5 80GB
# eld_tpu's --noise_impl names for the two noise paths
IMPL_NAMES = {"pallas": "kernel", "jnp": "plain"}
# allocations that move no bytes
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every tensor input and output of each aten op
    that runs under it, views and bare allocations excluded: the traffic of
    unfused eager ops, each reading its inputs once and writing its outputs
    once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def k1_bytes(shape) -> int:
    """The bytes one K1 launch must move: the batch read, the batch written
    and the (N, 12) f32 parameter rows."""
    n, h, w, c = shape
    return 2 * n * h * w * c * 4 + n * PARAM_STRIDE * 4


def step_cost(step, state, batch, seed: int = 0) -> dict:
    """FLOPs and bytes of one step, counted while ``step(state, batch,
    seed)`` runs once (it updates ``state`` like any step).

    FLOPs are ``torch.utils.flop_counter``'s: convolutions and their
    backward (no input gradient for the first conv, whose input needs
    none), and any matmul; elementwise ops, pooling, the loss and Adam
    count none.  Bytes are ``ByteCounter``'s op-level traffic, which is
    more than a fused program moves.  The hand-written kernels of the
    models (the conv epilogue, MDTA, the LayerNorm) are operators of the
    dispatcher, which ``ByteCounter`` counts once each, by their inputs and
    outputs, on the card as on the CPU.  K1 is launched through ctypes
    outside any operator, so no counter sees it: each K1 launch during the
    step adds ``k1_bytes`` of the batch, reported alone as
    ``k1_bytes_per_step``.  ``k1_launches`` is the launches in the counted
    step; 0 means the noise took the plain path, whose ops both counters
    see."""
    before = synthesize_kernel.launches
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        step(state, batch, seed)
    launches = synthesize_kernel.launches - before
    k1 = launches * k1_bytes(batch["clean"].shape)
    return {"flops_per_step": float(flops.get_total_flops()),
            "bytes_per_step": float(nbytes.bytes + k1),
            "k1_bytes_per_step": float(k1), "k1_launches": launches}


def build_model(arch: str, device: torch.device, **kw):
    """``build_arch(arch, 4, 4, **kw)`` with weights from
    ``torch.manual_seed(0)``, on ``device`` (channels_last on a card)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_arch(arch, 4, 4, **kw)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def build_step(ns):
    """(state, step, batch) of the train step ``ns`` describes, on
    ``ns.device``: bf16 autocast over f32 parameters unless ``--f32``, clean
    patches from ``numpy.random.default_rng(0)``."""
    device = torch_device(ns.device)
    model = build_model(ns.arch, device, base_width=ns.base_width, remat=ns.remat,
                        skip_mode=ns.skip_mode, upsample=ns.upsample,
                        skip_dtype=torch.bfloat16 if ns.skip_bf16 else None)
    state = create_train_state(model)
    step = make_train_step(model, loss="l1", noise_model=ns.noise,
                           bank=load_camera_params(device=device),
                           noise_impl=IMPL_NAMES.get(ns.noise_impl, ns.noise_impl),
                           autocast_dtype=torch.bfloat16 if ns.bf16 else None)
    clean = onp.random.default_rng(0).random((ns.batch, ns.patch, ns.patch, 4),
                                             dtype=onp.float32)
    return state, step, {"clean": torch.from_numpy(clean).to(device)}


def sync(device: torch.device):
    """Wait for the card (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def platform(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in W from nvidia-smi (None on the CPU)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                          "-i", str(device.index or 0)], capture_output=True, text=True)
    if out.returncode != 0:
        return None
    return float(out.stdout.strip().splitlines()[0])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="unet_s2d")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--patch", type=int, default=512)
    p.add_argument("--noise", default="eld")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--skip_mode", default="split", choices=["concat", "split"])
    p.add_argument("--upsample", default="convt", choices=["convt", "d2s"])
    p.add_argument("--skip_bf16", action="store_true")
    p.add_argument("--base_width", type=int, default=32)
    p.add_argument("--noise_impl", default="auto",
                   choices=["auto", "kernel", "plain", *IMPL_NAMES],
                   help="kernel: K1 on the card; plain: the PyTorch noise model "
                        "(eld_tpu's pallas / jnp are accepted for these)")
    p.add_argument("--aot", metavar="TOPOLOGY", default=None,
                   help="refused: eld_tpu's TPU-topology compile (ROADMAP #16)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="refused above 1: eld_tpu's --aot mesh step (ROADMAP #16)")
    p.add_argument("--peak_tflops", type=float, default=None,
                   help=f"peak TFLOP/s at the compute dtype (default: H100 SXM5 80GB, "
                        f"{H100_BF16_TFLOPS} bf16 / {H100_F32_TFLOPS} f32)")
    p.add_argument("--peak_gbs", type=float, default=H100_HBM_GBS,
                   help="peak memory GB/s (default: H100 SXM5 80GB HBM3)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--no-run", dest="run", action="store_false",
                   help="count FLOPs and bytes only (one untimed step)")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ns = p.parse_args(argv)
    if ns.aot:
        p.error("--aot compiles against an offline TPU topology (eld_tpu/tools/aot.py), "
                "which the port drops (ROADMAP #16)")
    if ns.mesh_data > 1:
        p.error("--mesh_data > 1 is eld_tpu's --aot mesh step over TPU topology chips, "
                "which the port drops (ROADMAP #16)")
    peak_tflops = ns.peak_tflops or (H100_BF16_TFLOPS if ns.bf16 else H100_F32_TFLOPS)

    state, step, data = build_step(ns)
    device = data["clean"].device
    cost = step_cost(step, state, data)
    flops, nbytes = cost["flops_per_step"], cost["bytes_per_step"]
    intensity = flops / nbytes if nbytes else float("nan")
    ridge = peak_tflops * 1e12 / (ns.peak_gbs * 1e9)
    floor_ms = nbytes / (ns.peak_gbs * 1e9) * 1e3
    rec = {
        "arch": ns.arch, "batch": ns.batch, "patch": ns.patch,
        "noise": ns.noise, "bf16": ns.bf16, "remat": ns.remat,
        "skip_mode": ns.skip_mode, "upsample": ns.upsample,
        "skip_bf16": ns.skip_bf16,
        "noise_impl": "kernel" if cost["k1_launches"] else "plain",
        "platform": platform(device), "power_limit_w": power_limit_w(device),
        "flops_per_step": flops, "bytes_per_step": nbytes,
        "k1_bytes_per_step": cost["k1_bytes_per_step"],
        "arith_intensity_flop_per_byte": round(intensity, 1),
        "ridge_flop_per_byte": round(ridge, 1),
        "bound": "hbm" if intensity < ridge else "compute",
        "bw_floor_ms": round(floor_ms, 2),
        "steps": state.step,  # optimizer steps taken so far: the counted one
        # the timed steps replay the step's CUDA graph on a card
        "graph": False, "graph_replays": 0,
    }
    print(f"[roofline] {ns.arch} b{ns.batch} {ns.patch}^2 "
          f"{'bf16' if ns.bf16 else 'f32'} ({rec['noise_impl']} noise): {flops/1e12:.3f} TF, "
          f"{nbytes/1e9:.2f} GB, intensity {intensity:.0f} FLOP/B "
          f"(ridge {ridge:.0f}) -> {rec['bound']}-bound, "
          f"floor {floor_ms:.1f} ms/step", file=sys.stderr)

    if ns.run:
        for i in range(3):
            step(state, data, i)
        sync(device)
        t0 = time.perf_counter()
        for i in range(ns.steps):
            step(state, data, 100 + i)
        sync(device)
        dt = (time.perf_counter() - t0) / ns.steps
        rec.update({
            "step_ms": round(dt * 1e3, 2),
            "patches_per_sec": round(ns.batch / dt, 2),
            "achieved_tflops": round(flops / dt / 1e12, 2),
            "mfu_pct": round(flops / dt / (peak_tflops * 1e12) * 100, 1),
            "achieved_gbs": round(nbytes / dt / 1e9, 1),
            "hbm_pct": round(nbytes / dt / (ns.peak_gbs * 1e9) * 100, 1),
        })
        rec["steps"] = state.step  # counted, warmup and timed
        rec["graph_replays"] = graph_replays(step)
        rec["graph"] = rec["graph_replays"] > 0
        print(f"[roofline] measured {rec['step_ms']} ms/step = "
              f"{rec['patches_per_sec']} patches/s | "
              f"{rec['achieved_tflops']} TFLOP/s ({rec['mfu_pct']}% of peak) | "
              f"{rec['achieved_gbs']} GB/s ({rec['hbm_pct']}% of HBM) on "
              f"{rec['platform']}", file=sys.stderr)
    print(json.dumps(rec))
    return rec


def cli() -> int:
    """Console-script entry: main()'s return value is data, not an exit
    status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
