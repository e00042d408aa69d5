"""ELD dataset evaluation CLI (counterpart of ``eld_tpu/tools/test_eld.py``,
the reference's ``test_ELD.py``).

10 scenes x {CanonEOS70D, CanonEOS700D, NikonD850, SonyA7S2} (or one
camera via --include), img ids [4, 9, 14] (x100) and [5, 10, 15] (x200),
full-frame metrics with illuminance correction and the amplification
ratio from EXIF.

Full frames fit one card; ``--mesh_spatial S`` (in place of ``--chop``)
splits each frame's height over S cards with halo windows.  With
``--mesh_data N`` (launched from this command; -1, the default, is every
visible card from ``--device``'s on) or under ``torchrun --nproc_per_node N
... --multihost`` each rank scores every N-th item and the metrics are
merged.

Usage:
  python -m eld_tpu_torch.tools.test_eld --name sid_eld --datadir ./data/ELD --chop
"""

from __future__ import annotations

import argparse
import sys

from eld_tpu_torch import config as config_mod
from eld_tpu_torch.data.datasets import ELDEvalDataset
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.parallel.launch import run_ranks
from eld_tpu_torch.parallel.multihost import maybe_initialize_multihost
from eld_tpu_torch.train.engine import Engine

CAMERAS = ["CanonEOS5D4", "CanonEOS70D", "CanonEOS700D", "NikonD850", "SonyA7S2"]
SUFFIXES = [".CR2", ".CR2", ".CR2", ".nef", ".ARW"]
IMG_IDS_SETS = {"x100": [4, 9, 14], "x200": [5, 10, 15]}


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--datadir", type=str, default="./data/ELD")
    pre.add_argument("--savedir", type=str, default=None)
    pre.add_argument("--scenes", type=int, default=10)
    pre.add_argument("--suffix", type=str, default=None,
                     help="override the per-camera raw suffix (e.g. .dng or .npz for "
                          "converted raws)")
    pre.add_argument("--level", choices=list(IMG_IDS_SETS), default=None,
                     help="evaluate only this amplification level (default: both)")
    ns, rest = pre.parse_known_args(argv)
    cfg = config_mod.parse(rest, train=False)
    launched = run_ranks(main, argv, cfg)
    if launched is not None:
        return launched
    if not (cfg.resume or cfg.model_path):
        cfg.resume = True
    maybe_initialize_multihost(cfg)

    if cfg.include is not None:
        cameras = [(CAMERAS[cfg.include], SUFFIXES[cfg.include])]
    else:
        cameras = list(zip(CAMERAS[1:], SUFFIXES[1:]))  # default: the 4-camera set
    if ns.suffix:
        cameras = [(cam, ns.suffix) for cam, _ in cameras]
    levels = {ns.level: IMG_IDS_SETS[ns.level]} if ns.level else IMG_IDS_SETS

    engine = Engine(cfg)
    scenes = list(range(1, ns.scenes + 1))
    results = {}
    for level, img_ids in levels.items():
        for camera, suffix in cameras:
            print(f"Eval camera {camera} {level}")
            ds = ELDEvalDataset(ns.datadir, (camera, suffix), scenes=scenes, img_ids=img_ids)
            loader = Loader(ds, batch_size=1, num_workers=0)
            res = engine.eval(loader, dataset_name=f"eld_eval_{camera}_{level}",
                              savedir=ns.savedir, correct=True, crop=False)
            results[(camera, level)] = res.as_dict()
            print(f"  {camera} {level}: {res}")
    return results


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
