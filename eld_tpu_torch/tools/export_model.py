"""Export a trained denoiser to a self-contained serving artifact
(counterpart of ``eld_tpu/tools/export_model.py``).

Reads the port's ``.pt`` (the reference layout the Engine writes) and
writes a ``.eldx`` artifact (``eld_tpu_torch.export``), traced on
``--device``; the artifact serves on the card or on the CPU.  eld_tpu's
orbax ``.ckpt`` directories are refused.

Usage:
  python -m eld_tpu_torch.tools.export_model --arch unet \\
      --model_path checkpoints/sid_eld/model_latest.pt \\
      --height 1424 --width 2128 --chop --out sid_denoiser.eldx
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from eld_tpu_torch.config import torch_device
from eld_tpu_torch.export import save_denoiser
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.train.checkpoints import load_params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", "--netG", dest="arch", type=str, default="unet",
                   help="the network (the trainers' --netG): unet, unet_s2d, unet_s2d4, "
                        "restormer, uformer")
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--out_channels", type=int, default=None)
    p.add_argument("--base_width", type=int, default=32,
                   help="the first level's width: the U-Net's level 0, Restormer's dim, "
                        "Uformer's embed_dim (must match the checkpoint)")
    p.add_argument("--model_path", type=str, required=True, help="the port's .pt checkpoint")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--chop", action="store_true",
                   help="trace the reference 4-tile chopped forward into the artifact")
    p.add_argument("--bf16", action="store_true", help="bf16 compute inside the artifact")
    p.add_argument("--skip_mode", choices=["concat", "split"], default="split",
                   help="decoder skip handling; 'split' is an exact re-parameterization of "
                        "the same checkpoint")
    p.add_argument("--upsample", choices=["convt", "d2s"], default="convt")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the export is traced: cuda, cuda:N or cpu")
    p.add_argument("--static_batch", action="store_true",
                   help="export with the batch pinned to 1 instead of symbolic")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="weight-only per-channel int8 weights, dequantized in the graph")
    p.add_argument("--out", type=str, required=True)
    ns = p.parse_args(argv)

    device = torch_device(ns.device)
    out_ch = ns.out_channels if ns.out_channels is not None else ns.channels
    model = build_arch(ns.arch, ns.channels, out_ch, base_width=ns.base_width,
                       skip_mode=ns.skip_mode, upsample=ns.upsample).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    epoch, iters = load_params(ns.model_path, model)
    meta = save_denoiser(ns.out, model, ns.height, ns.width, ns.channels, chop=ns.chop,
                         quantize=ns.quantize, bf16=ns.bf16, symbolic_batch=not ns.static_batch,
                         extra_meta={"arch": ns.arch, "base_width": ns.base_width,
                                     "source": ns.model_path, "epoch": epoch,
                                     "iterations": iters})
    print(json.dumps(meta), file=sys.stderr)
    print(ns.out)
    return meta


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
