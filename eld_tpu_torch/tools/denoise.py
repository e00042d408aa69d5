"""Denoise raw files end to end: the serving CLI, no ground truth
(counterpart of ``eld_tpu/tools/denoise.py``).

Point it at raw files (any format ``data/rawio`` decodes: ARW, CR2, NEF,
DNG, TIFF, rawpack), give the amplification ratio, and get denoised sRGB
PNGs (and, with ``--save_raw``, the denoised packed raw as ``.npz``).  The
network comes from the port's ``.pt`` checkpoint (``--model_path``) or
from a ``.eldx`` artifact (``--artifact``, ``eld_tpu_torch.export``), which
needs no model flags.  It runs on ``--device`` (the card by default; asking
for it without one raises).

Protocol:
  * the input is black/white-normalized, packed, x ratio, clipped: the
    eval path's preprocessing (``SIDDataset``);
  * ``--correct`` (default on) applies illuminance correction against the
    amplified input (there is no ground truth at inference); a fully
    saturated input keeps the uncorrected output;
  * frames are edge-padded to the network's alignment (an artifact: to its
    static geometry) and cropped back, so any sensor geometry works.

Serving is pipelined: raw decodes run ahead of the device on
``--io_threads`` threads, and the PNG/npz writes run on as many background
threads, at most 2 x ``--io_threads`` of them in flight; a failed write
fails the run, at the latest before the summary line (``--io_threads 0``
is the synchronous path).  ``--batch N`` forwards same-geometry frames
together.

Usage:
  python -m eld_tpu_torch.tools.denoise --input ./short/ --ratio 100 \\
      --model_path model_best.pt --out ./denoised
  python -m eld_tpu_torch.tools.denoise --input IMG_0004.ARW --ratio 200 \\
      --artifact sid_denoiser.eldx --out ./denoised --save_raw
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import torch
import torch.nn.functional as F

from eld_tpu_torch.config import torch_device
from eld_tpu_torch.core import isp
from eld_tpu_torch.core.emor import load_crf
from eld_tpu_torch.data import rawio
from eld_tpu_torch.data.loader import prefetched_map
from eld_tpu_torch.export import load_denoiser
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.ops.correct import illuminance_correct
from eld_tpu_torch.train.checkpoints import load_params
from eld_tpu_torch.train.steps import make_eval_forward
from eld_tpu_torch.utils.images import save_png

RAW_EXTS = (".arw", ".cr2", ".nef", ".dng", ".tif", ".tiff", ".npz", ".rawpack")


def _list_inputs(path: str):
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.lower().endswith(RAW_EXTS))
        if not files:
            raise FileNotFoundError(f"{path}: no raw files ({RAW_EXTS})")
        return files
    return [path]


def _aligned_forward(fwd, x: torch.Tensor, base: int = 16, target=None) -> torch.Tensor:
    """Edge-pad H and W up to the network alignment (or to an artifact's
    static ``target`` geometry), forward, crop back."""
    _, h, w, _ = x.shape
    if target is not None:
        hp, wp = target
        if h > hp or w > wp:
            raise SystemExit(f"frame is {h}x{w} packed but the artifact was exported for "
                             f"{hp}x{wp}: re-export with --height/--width (the artifact's "
                             "spatial dims are static)")
    else:
        hp, wp = -(-h // base) * base, -(-w // base) * base
    if (hp, wp) != (h, w):
        x = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="replicate")
        x = x.permute(0, 2, 3, 1).contiguous()
    return fwd(x)[:, :h, :w]


class Writes:
    """Output writes on ``threads`` background threads (inline with 0), at
    most ``limit`` in flight: ``submit`` waits while the limit is reached.
    A failed write is raised by the next ``submit`` or by ``close``, which
    waits for every write."""

    def __init__(self, threads: int, limit: int):
        self._pool = ThreadPoolExecutor(max_workers=threads) if threads > 0 else None
        self._slots = threading.Semaphore(limit)
        self._futures = []

    def _raise_failed(self, wait: bool):
        """Drop the finished writes (with ``wait``: all, waiting for them)
        and raise the first of them that failed."""
        finished = [f for f in self._futures if wait or f.done()]
        self._futures = [f for f in self._futures if f not in finished]
        for fut in finished:
            fut.result()

    def submit(self, fn, *args, **kwargs):
        if self._pool is None:
            fn(*args, **kwargs)
            return
        self._raise_failed(wait=False)
        self._slots.acquire()
        fut = self._pool.submit(fn, *args, **kwargs)
        fut.add_done_callback(lambda _: self._slots.release())
        self._futures.append(fut)

    def close(self):
        if self._pool is None:
            return
        self._pool.shutdown(wait=True)
        self._raise_failed(wait=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="raw file or directory of raw files")
    amp = p.add_mutually_exclusive_group(required=True)
    amp.add_argument("--ratio", type=float,
                     help="fixed amplification ratio (target_expo/input_expo, e.g. 100 or 300)")
    amp.add_argument("--target_exposure", type=float,
                     help="derive each file's ratio from its own EXIF: ratio = (target_iso * "
                          "target_exposure) / (iso * exposure)")
    p.add_argument("--target_iso", type=float, default=100.0,
                   help="ISO paired with --target_exposure (default 100)")
    p.add_argument("--batch", type=int, default=1,
                   help="forward same-geometry frames together in batches of this size")
    p.add_argument("--io_threads", type=int, default=2,
                   help="decode raw files ahead of the device and write the outputs on this "
                        "many threads each, at most 2x this many writes in flight; the "
                        "outputs are on disk at the summary line; 0 = synchronous")
    p.add_argument("--out", required=True, help="output directory")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model_path", help="the port's .pt checkpoint")
    src.add_argument("--artifact", help=".eldx serving artifact (eld_tpu_torch.export)")
    p.add_argument("--arch", default="unet")
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--base_width", type=int, default=32)
    p.add_argument("--bf16", action="store_true", help="bf16 autocast (checkpoint path)")
    p.add_argument("--skip_mode", choices=["concat", "split"], default="split",
                   help="decoder skip handling; 'split' is an exact re-parameterization of "
                        "the same checkpoint")
    p.add_argument("--upsample", choices=["convt", "d2s"], default="convt")
    p.add_argument("--chop", action="store_true",
                   help="4-tile chopped forward (checkpoint path; artifacts bake their own)")
    p.add_argument("--no-correct", dest="correct", action="store_false",
                   help="skip illuminance correction against the input")
    p.add_argument("--crf", action="store_true",
                   help="render with the calibrated CRF instead of gamma")
    p.add_argument("--save_raw", action="store_true",
                   help="also write the denoised packed raw as .npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the network and the ISP run: cuda, cuda:N or cpu")
    ns = p.parse_args(argv)
    if ns.io_threads < 0:
        p.error("--io_threads must be >= 0")

    pad_target, base = None, 16
    if ns.artifact:
        baked = {"--chop": ns.chop, "--arch": ns.arch != "unet",
                 "--base_width": ns.base_width != 32, "--bf16": ns.bf16,
                 "--skip_mode": ns.skip_mode != "split", "--upsample": ns.upsample != "convt"}
        wrong = [k for k, v in baked.items() if v]
        if wrong:
            p.error(f"{' '.join(wrong)}: model shape/arch flags are baked at export time "
                    "for artifacts; re-export instead")
    device = torch_device(ns.device)
    os.makedirs(ns.out, exist_ok=True)

    if ns.artifact:
        fwd, meta = load_denoiser(ns.artifact, device)
        pad_target = (meta["height"], meta["width"])
        if ns.batch > 1 and not meta.get("symbolic_batch", True):
            p.error("--batch > 1 needs a symbolic-batch artifact; this one was exported "
                    "with --static_batch (batch pinned to 1)")
    else:
        model = build_arch(ns.arch, ns.channels, ns.channels, base_width=ns.base_width,
                           skip_mode=ns.skip_mode, upsample=ns.upsample).to(device)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        load_params(ns.model_path, model)
        fwd = make_eval_forward(model.eval(), chop=ns.chop,
                                autocast_dtype=torch.bfloat16 if ns.bf16 else None)
        base = model.alignment()

    crf = None
    if ns.crf:
        crf = tuple(torch.from_numpy(a).to(device) for a in load_crf())

    def ratio_for(path, raw) -> float:
        if ns.ratio is not None:
            return float(ns.ratio)
        denom = raw.iso * raw.exposure
        if denom <= 0:
            raise SystemExit(f"{path}: EXIF iso*exposure is {denom}; cannot derive the ratio "
                             "for --target_exposure (use --ratio instead)")
        return (ns.target_iso * ns.target_exposure) / denom

    results = []
    used_names = set()
    writes = Writes(ns.io_threads, limit=2 * max(ns.io_threads, 1))

    def out_path(path, suffix):
        """Collision-safe output name (IMG_0001.ARW beside IMG_0001.dng
        must not overwrite each other's outputs)."""
        stem = os.path.splitext(os.path.basename(path))[0]
        name, n = f"{stem}_denoised{suffix}", 2
        while name in used_names:
            name = f"{stem}_denoised_{n}{suffix}"
            n += 1
        used_names.add(name)
        return os.path.join(ns.out, name)

    def serve(group):
        """Forward a same-geometry group in one call, then finish each frame
        (correction, ISP render, writes) on its own."""
        xb = torch.from_numpy(onp.stack([g["x"] for g in group])).to(device)
        preds = _aligned_forward(fwd, xb, base=base, target=pad_target)
        for i, (g, pred) in enumerate(zip(group, preds)):
            if ns.correct:
                corrected = illuminance_correct(pred, xb[i])
                if bool(torch.isfinite(corrected).all()):
                    pred = corrected
                else:
                    print(f"[w] {g['path']}: input fully saturated at ratio {g['ratio']:g}; "
                          "skipping illuminance correction", file=sys.stderr)
            pred = pred.float().clamp(0.0, 1.0)
            raw = g["raw"]
            rgb = isp.raw2rgb(pred, raw.wb, raw.ccm, crf=crf).cpu().numpy()
            png = out_path(g["path"], ".png")
            writes.submit(save_png, png, rgb * 255.0)
            rec = {"input": g["path"], "output": png, "ratio": g["ratio"]}
            if ns.save_raw:
                npz = out_path(g["path"], ".npz")
                writes.submit(onp.savez_compressed, npz, packed=pred.cpu().numpy(),
                              wb=raw.wb, ccm=raw.ccm)
                rec["raw_output"] = npz
            print(json.dumps(rec), file=sys.stderr)
            results.append(rec)

    def decode_one(path):
        """The host half of a frame (decode, pack, amplify, clip), run on
        the prefetch threads while the device serves the previous group."""
        raw = rawio.imread(path)
        ratio = ratio_for(path, raw)
        return {"path": path, "raw": raw, "x": onp.clip(raw.packed() * ratio, 0.0, 1.0),
                "ratio": ratio}

    try:
        window = max(2 * ns.batch, 2 * max(ns.io_threads, 1))
        pending = {}  # packed shape -> same-geometry frames waiting for a batch
        for g in prefetched_map(decode_one, _list_inputs(ns.input), ns.io_threads, window):
            group = pending.setdefault(g["x"].shape, [])
            group.append(g)
            if len(group) >= ns.batch:
                serve(pending.pop(g["x"].shape))
        for shape in list(pending):
            serve(pending.pop(shape))
    except BaseException:
        # the run fails with the loop's error; a failed write is reported too
        try:
            writes.close()
        except Exception as e:  # noqa: BLE001 - reported beside the error raised
            print(f"[e] an output write failed as well: {e!r}", file=sys.stderr)
        raise
    writes.close()
    print(json.dumps({"count": len(results), "out": ns.out}))
    return results


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
