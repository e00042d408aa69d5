"""Synthetic-noise training CLI — the flagship entry point (counterpart of
``eld_tpu/tools/train_syn.py``, raw-domain path).

Clean patches stream from a PatchStore as uint16; on the device each
step samples calibrated noise parameters, synthesizes the noisy input
with the fused CUDA kernel, and trains the U-Net under the reference's
LR schedule (1e-4 -> 5e-5 @100 -> 1e-5 @180).  Only the per-step loader
is ported: ``--scan`` stays 0 until the pooled trainer lands.

Usage:
  python -m eld_tpu_torch.tools.train_syn --name sid_eld --noise eld --include 4 \\
      --traindir ./data/Train -b 8 --bf16
"""

from __future__ import annotations

import argparse
import os
import sys
from os.path import join

import numpy as onp

from eld_tpu_torch import config as config_mod
from eld_tpu_torch.data.datasets import CleanPatchDataset
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.data.patchstore import PatchStore
from eld_tpu_torch.train.engine import Engine


def lr_for_epoch(epoch: int) -> float:
    """The reference schedule (train_syn.py:99-105) as a function of the
    epoch, so resumed runs land on the right rate."""
    if epoch < 100:
        return 1e-4
    if epoch < 180:
        return 5e-5
    return 1e-5


def _refuse_unported(ns, cfg):
    """Raise for the options this trainer does not implement yet; each
    message names the ROADMAP.md queue-1 item that brings it."""
    missing = []
    if ns.scan > 0:
        missing.append("--scan K > 0 (pooled trainer: queue 1 #6)")
    if ns.offline_noise:
        missing.append("--offline_noise (paired train_real: queue 1 #7)")
    if cfg.stage_in == "srgb" or cfg.stage_out == "srgb":
        missing.append("sRGB stages (ISP: queue 1 #9)")
    if cfg.multihost or cfg.mesh_data > 1 or cfg.mesh_spatial > 1:
        missing.append("--multihost / --mesh_* > 1 (parallel: queue 1 #13)")
    if not cfg.noise:
        missing.append("paired training without --noise (train_real: queue 1 #7)")
    if cfg.resume or cfg.model_path:
        missing.append("--resume / --model_path (Engine.load: queue 1 #10)")
    if cfg.profile:
        missing.append("--profile (torch.profiler with the bench: queue 1 #15)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--traindir", type=str, default="./data/Train")
    pre.add_argument("--evaldir", type=str, default="./data/SID/Sony")
    pre.add_argument("--epochs", type=int, default=200)
    pre.add_argument("--offline_noise", action="store_true")
    pre.add_argument("--eval_every", type=int, default=20)
    pre.add_argument("--scan", type=int, default=0, metavar="K",
                     help="optimizer steps per launch over a device-resident "
                          "pool; only 0 (the per-step loader) is ported")
    ns, rest = pre.parse_known_args(argv)
    cfg = config_mod.parse(rest, train=True)
    _refuse_unported(ns, cfg)

    store = PatchStore(join(ns.traindir, "SID_Sony_Raw.eps"), size=cfg.max_dataset_size)
    # raw uint16 to the device; normalization happens in the train step
    train_ds = CleanPatchDataset(store, device_normalize=True,
                                 rng=onp.random.default_rng(cfg.seed))
    train_loader = Loader(train_ds, batch_size=cfg.batch_size, shuffle=True,
                          num_workers=cfg.n_threads, seed=cfg.seed, drop_last=True)
    if os.path.isdir(ns.evaldir):
        print(f"[i] eval is not ported yet (ROADMAP.md queue 1 #8-#11); "
              f"{ns.evaldir} is not used", file=sys.stderr)

    engine = Engine(cfg)
    print(f"[i] using noise model {cfg.noise!r} (on-device)")
    while engine.epoch < ns.epochs:
        engine.set_learning_rate(lr_for_epoch(engine.epoch))
        engine.train(train_loader)
    return engine


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
