"""Synthetic-noise training CLI — the flagship entry point (counterpart of
``eld_tpu/tools/train_syn.py``).

Clean patches come from a PatchStore as uint16; on the device each step
samples calibrated noise parameters, synthesizes the noisy input with the
fused CUDA kernel, and trains the U-Net under the reference's LR schedule
(1e-4 -> 5e-5 @100 -> 1e-5 @180).  By default (``--scan -1``) the whole
clean set is put on the device once and the pooled trainer runs 10 steps
per call, picking and augmenting its batches there; ``--scan 0`` is the
per-step host loader.  Every ``--eval_every`` epochs the model is scored
on the SID indoor-15 subsets of ratio 100 and 300 under ``--evaldir``.

Two other sources:
  * ``--offline_noise``: pre-baked noisy patches (``SID_Sony_syn_Raw_<camera>
    .eps``, ``build_dataset syn``) paired with the clean store, no noise
    model in the step; pooled as {"input", "target"} under ``--scan`` auto,
    both stores counted in the pool's size;
  * the sRGB stages (``--stage_in/--stage_out srgb``): 3-channel clean
    patches of ``SID_Sony_SRGB[_CRF].eps`` through the per-step loader
    (``--scan`` auto gives 0), the noise synthesized on them by the kernel
    at C = 3.

Data-parallel over N cards: one rank per card, ``-b`` the global batch
(each rank trains on ``-b / N`` rows of it, and holds the whole pool).
``--mesh_data N`` launches the N ranks from this one command (-1, the
default, is every visible card from ``--device``'s on), and ``main``
returns rank 0's ``parallel.launch.RunRecord``; or under torchrun:
  torchrun --nproc_per_node N -m eld_tpu_torch.tools.train_syn ... --multihost

Usage:
  python -m eld_tpu_torch.tools.train_syn --name sid_eld --noise eld --include 4 \\
      --traindir ./data/Train --evaldir ./data/SID/Sony -b 8 --bf16
"""

from __future__ import annotations

import argparse
import os
import sys
from os.path import join

import numpy as onp
import torch

from eld_tpu_torch import config as config_mod
from eld_tpu_torch.core.emor import load_crf
from eld_tpu_torch.data.builder import store_name
from eld_tpu_torch.data.datasets import CleanPatchDataset, ELDTrainDataset, SIDDataset
from eld_tpu_torch.data.loader import Loader, pool_to_device
from eld_tpu_torch.data.pairs import eval_pairs_by_ratio
from eld_tpu_torch.data.patchstore import PatchStore
from eld_tpu_torch.noise.params import CAMERA_NAMES
from eld_tpu_torch.parallel.launch import run_ranks
from eld_tpu_torch.parallel.multihost import all_hosts_agree, maybe_initialize_multihost
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.utils.logging import span

AUTO_SCAN = 10


def lr_for_epoch(epoch: int) -> float:
    """The reference schedule (train_syn.py:99-105) as a function of the
    epoch, so resumed runs land on the right rate."""
    if epoch < 100:
        return 1e-4
    if epoch < 180:
        return 5e-5
    return 1e-5


def device_memory_bytes(device) -> int:
    """Memory of the card, or of the host for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def pool_budget_bytes(memory_bytes: int) -> int:
    """How large a device-resident pool may be: half the device's memory.
    The other half is left to what runs beside the pool: the train step's
    working set (a few GB at batch 8 on 512^2 patches), the full-frame
    eval forward of the periodic eval, and the caching allocator's slack.
    On an 80 GB H100 that admits 40 GB, so the SID clean set
    (1288 x 512^2 x 4 x 2 B = 2.70 GB) is pooled with room to spare."""
    return memory_bytes // 2


def resolve_scan(scan: int, pool_bytes: int, budget_bytes: int, srgb: bool) -> int:
    """``--scan`` as given when >= 0; auto (-1): 0 for the sRGB stages,
    else AUTO_SCAN when the pool fits the budget, else 0 (per-step loader)."""
    if scan >= 0:
        return scan
    if srgb:
        return 0
    if pool_bytes > budget_bytes:
        print(f"[i] clean pool is {pool_bytes / 1e9:.2f} GB > {budget_bytes / 1e9:.2f} GB "
              "pool budget; using the per-step loader (pass --scan K to override)",
              file=sys.stderr)
        return 0
    return AUTO_SCAN


def srgb_stage(cfg) -> bool:
    """Whether the run trains in sRGB (on 3-channel patches)."""
    return cfg.stage_in == "srgb" or cfg.stage_out == "srgb"


def eval_loaders(evaldir: str, cfg) -> dict:
    """Loaders of the SID indoor-15 pairs of ratio 100 and 300, in the
    run's stages (and CRF), or {} when a file of them is missing under
    ``evaldir``.  The ranks decide together: the eval enters collectives,
    so one rank missing the data must not leave the others waiting in the
    merge."""
    try:
        loaders = _eval_loaders(evaldir, cfg)
    except (OSError, ValueError) as e:  # eval data is optional during training
        loaders = {}
        print(f"[i] eval datasets unavailable: {e}", file=sys.stderr)
    if not all_hosts_agree(bool(loaders)) and loaders:
        print("[w] eval disabled: not every rank has both eval ratios", file=sys.stderr)
        loaders = {}
    return loaders


def _eval_loaders(evaldir: str, cfg) -> dict:
    crf = load_crf() if cfg.crf else None
    pairs = eval_pairs_by_ratio()
    loaders = {}
    for ratio in (100, 300):
        for short, long_ in pairs[ratio]:
            for path in (join(evaldir, "short", short), join(evaldir, "long", long_)):
                if not os.path.exists(path):
                    raise FileNotFoundError(path)
        ds = SIDDataset(evaldir, pairs[ratio], augment=False, memorize=False,
                        stage_in=cfg.stage_in, stage_out=cfg.stage_out, gt_wb=cfg.gt_wb,
                        crf=crf, rng=onp.random.default_rng(cfg.seed))
        loaders[ratio] = Loader(ds, batch_size=1, num_workers=0)
    return loaders


def train_epochs(engine: Engine, epochs: int, eval_every: int, evals: dict, train_loader,
                 pool=None, steps_per_epoch: int = 0, scan: int = 0):
    """Train to ``epochs`` under the reference schedule, from the pool with
    ``scan`` steps per call or else from ``train_loader``, scoring on the
    eval loaders every ``eval_every`` epochs.  Under a profiler each epoch
    is a span (``eld.epoch``)."""
    while engine.epoch < epochs:
        with span("eld.epoch", engine.epoch):
            engine.set_learning_rate(lr_for_epoch(engine.epoch))
            if pool is not None:
                engine.train_pool(pool, steps_per_epoch, steps_per_call=scan)
            else:
                engine.train(train_loader)
            if engine.epoch % eval_every == 0 and evals:
                try:
                    engine.eval(evals[100], dataset_name="sid_eval_100", correct=True)
                    engine.eval(evals[300], dataset_name="sid_eval_300", correct=True)
                except Exception as e:  # noqa: BLE001 - a failed eval does not stop training
                    if engine.world > 1:
                        # the ranks cannot go on safely after control flow
                        # diverged inside a collective section
                        raise
                    print(f"[w] eval failed: {e}", file=sys.stderr)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--traindir", type=str, default="./data/Train")
    pre.add_argument("--evaldir", type=str, default="./data/SID/Sony")
    pre.add_argument("--epochs", type=int, default=200)
    pre.add_argument("--offline_noise", action="store_true")
    pre.add_argument("--eval_every", type=int, default=20)
    pre.add_argument("--scan", type=int, default=-1, metavar="K",
                     help="optimizer steps per call over the clean set held on the "
                          "device; 0: the per-step host loader; -1 (default): "
                          f"{AUTO_SCAN} when the uint16 pool fits half the device's "
                          "memory, else 0")
    ns, rest = pre.parse_known_args(argv)
    cfg = config_mod.parse(rest, train=True)
    launched = run_ranks(main, argv, cfg)
    if launched is not None:
        return launched
    shard = maybe_initialize_multihost(cfg)

    if srgb_stage(cfg):
        stores = {"clean": PatchStore(join(ns.traindir, store_name("clean", "srgb", cfg.crf)),
                                      size=cfg.max_dataset_size)}
        train_ds = CleanPatchDataset(stores["clean"], rng=onp.random.default_rng(cfg.seed))
    elif ns.offline_noise:
        camera = CAMERA_NAMES[4 if cfg.include is None else cfg.include]
        stores = {"input": PatchStore(join(ns.traindir, store_name("syn", camera=camera)),
                                      size=cfg.max_dataset_size),
                  "target": PatchStore(join(ns.traindir, store_name("clean")),
                                       size=cfg.max_dataset_size)}
        train_ds = ELDTrainDataset(stores["target"], [stores["input"]],
                                   rng=onp.random.default_rng(cfg.seed))
        cfg.noise = ""  # paired: the noise is in the input store
    elif not cfg.noise:
        raise ValueError("--noise '' trains on nothing but clean patches: give a noise model, "
                         "or --offline_noise, or use train_real for paired stores")
    else:
        stores = {"clean": PatchStore(join(ns.traindir, store_name("clean")),
                                      size=cfg.max_dataset_size)}
        # raw uint16 to the device; normalization happens in the train step
        train_ds = CleanPatchDataset(stores["clean"], device_normalize=True,
                                     rng=onp.random.default_rng(cfg.seed))
    train_loader = Loader(train_ds, batch_size=cfg.batch_size, shuffle=True,
                          num_workers=cfg.n_threads, seed=cfg.seed, drop_last=True, shard=shard)
    evals = eval_loaders(ns.evaldir, cfg)
    engine = Engine(cfg)
    print(f"[i] using noise model {cfg.noise!r} (on-device)" if cfg.noise
          else "[i] paired mode (pre-baked noise)")
    pool_bytes = sum(len(s) * int(onp.prod(s.shape)) * onp.dtype(s.dtype).itemsize
                     for s in stores.values())
    scan = resolve_scan(ns.scan, pool_bytes,
                        pool_budget_bytes(device_memory_bytes(engine.device)),
                        srgb=srgb_stage(cfg))
    pool, steps_per_epoch = None, 0
    if scan > 0:
        print(f"[i] pooled trainer: {len(train_ds)} items ({pool_bytes / 1e9:.2f} GB) on "
              f"{engine.device}, {scan} steps per call")
        # the stores already show --max_dataset_size
        pool = {k: pool_to_device(s, engine.device) for k, s in stores.items()}
        steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    train_epochs(engine, ns.epochs, ns.eval_every, evals, train_loader, pool, steps_per_epoch,
                 scan)
    return engine


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
