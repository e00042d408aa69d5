"""Paired real-data training CLI (counterpart of
``eld_tpu/tools/train_real.py``; the reference's ``train_real.py``).

Input and target both come from pre-packed patch stores (the input
already x ratio at pack time: ``build_dataset paired``), no noise model
anywhere, the per-step loader, the same LR schedule as ``train_syn``, and
the same periodic SID eval.

Usage (data-parallel over N cards: ``--mesh_data N`` launches one rank per
card from this command and returns rank 0's ``parallel.launch.RunRecord``,
or ``torchrun --nproc_per_node N -m eld_tpu_torch.tools.train_real ...
--multihost``):
  python -m eld_tpu_torch.tools.train_real --name sid_paired --traindir ./data/Train -b 8
"""

from __future__ import annotations

import argparse
import sys
from os.path import join

import numpy as onp

from eld_tpu_torch import config as config_mod
from eld_tpu_torch.data.builder import store_name
from eld_tpu_torch.data.datasets import ELDTrainDataset
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.data.patchstore import PatchStore
from eld_tpu_torch.parallel.launch import run_ranks
from eld_tpu_torch.parallel.multihost import maybe_initialize_multihost
from eld_tpu_torch.tools.train_syn import eval_loaders, train_epochs
from eld_tpu_torch.train.engine import Engine


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--traindir", type=str, default="./data/Train")
    pre.add_argument("--evaldir", type=str, default="./data/SID/Sony")
    pre.add_argument("--epochs", type=int, default=200)
    pre.add_argument("--eval_every", type=int, default=20)
    ns, rest = pre.parse_known_args(argv)
    cfg = config_mod.parse(rest, train=True)
    launched = run_ranks(main, argv, cfg)
    if launched is not None:
        return launched
    cfg.noise = ""  # paired
    shard = maybe_initialize_multihost(cfg)

    input_store = PatchStore(join(ns.traindir, store_name("input", cfg.stage_in, cfg.crf)))
    target_store = PatchStore(join(ns.traindir, store_name("target", cfg.stage_out, cfg.crf)))
    train_ds = ELDTrainDataset(target_store, [input_store], rng=onp.random.default_rng(cfg.seed))
    train_loader = Loader(train_ds, batch_size=cfg.batch_size, shuffle=True,
                          num_workers=cfg.n_threads, seed=cfg.seed, drop_last=True, shard=shard)
    evals = eval_loaders(ns.evaldir, cfg)
    engine = Engine(cfg)
    train_epochs(engine, ns.epochs, ns.eval_every, evals, train_loader)
    return engine


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
