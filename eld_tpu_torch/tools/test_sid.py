"""SID Sony evaluation CLI (counterpart of ``eld_tpu/tools/test_sid.py``,
the reference's ``test_SID.py``).

Scores the 15-indoor-scene subset bucketed by exposure ratio {100, 250,
300} on the center 512x512 crop with illuminance correction (the crop
leaves out the fixed-pattern noise region the reference documents), or
the pairs of a ``--pairs`` file.

Usage:
  python -m eld_tpu_torch.tools.test_sid --name sid_eld --datadir ./data/SID/Sony \\
      --model_path checkpoints/sid_eld/model_200_00257600.pt
"""

from __future__ import annotations

import argparse
import sys

import numpy as onp

from eld_tpu_torch import config as config_mod
from eld_tpu_torch.core.emor import load_crf
from eld_tpu_torch.data.datasets import SIDDataset
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.data.pairs import eval_pairs_by_ratio
from eld_tpu_torch.train.engine import Engine


def parse_pairs_file(path: str) -> dict:
    """Parse a 'short_fn long_fn ratio' pair list into ratio buckets.
    Blank and '#' lines are skipped; a malformed line exits naming
    file:line."""
    buckets: dict = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) < 3:
                raise SystemExit(f"{path}:{lineno}: expected 'short_fn long_fn ratio', "
                                 f"got {line.rstrip()!r}")
            try:
                ratio = int(float(parts[2]))
            except ValueError:
                raise SystemExit(f"{path}:{lineno}: ratio {parts[2]!r} is not a number "
                                 "(line format: 'short_fn long_fn ratio')")
            buckets.setdefault(ratio, []).append((parts[0], parts[1]))
    return buckets


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--datadir", type=str, default="./data/SID/Sony")
    pre.add_argument("--savedir", type=str, default=None)
    pre.add_argument("--pairs", type=str, default=None,
                     help="custom pair list: one 'short_fn long_fn ratio' line per item "
                          "(in place of the vendored indoor-15 subset)")
    ns, rest = pre.parse_known_args(argv)
    cfg = config_mod.parse(rest, train=False)
    if not (cfg.resume or cfg.model_path):
        cfg.resume = True

    engine = Engine(cfg)
    crf = load_crf() if cfg.crf else None
    buckets = parse_pairs_file(ns.pairs) if ns.pairs else eval_pairs_by_ratio()
    results = {}
    for ratio, pairs in buckets.items():
        print(f"Eval ratio {ratio}")
        ds = SIDDataset(ns.datadir, pairs, memorize=False, augment=False,
                        stage_in=cfg.stage_in, stage_out=cfg.stage_out, gt_wb=cfg.gt_wb,
                        crf=crf, rng=onp.random.default_rng(cfg.seed))
        loader = Loader(ds, batch_size=1, num_workers=0)
        res = engine.eval(loader, dataset_name=f"sid_eval_{ratio}", savedir=ns.savedir,
                          correct=True, crop=True)
        results[ratio] = res.as_dict()
        print(f"  ratio {ratio}: {res}")
    return results


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
