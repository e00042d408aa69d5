"""Dataset-building CLI: runs the builder's recipes (counterpart of
``eld_tpu/tools/build_dataset.py``; the reference's ``util/lmdb_data.py``).

Usage:
  python -m eld_tpu_torch.tools.build_dataset clean  --sourcedir ./data/SID/Sony --destdir ./data/Train
  python -m eld_tpu_torch.tools.build_dataset paired --sourcedir ./data/SID/Sony --destdir ./data/Train
  python -m eld_tpu_torch.tools.build_dataset srgb   --sourcedir ./data/SID/Sony --destdir ./data/Train
  python -m eld_tpu_torch.tools.build_dataset syn    --include 4 --noise g ...
"""

from __future__ import annotations

import argparse
import sys

from eld_tpu_torch.data import builder


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("recipe", choices=["clean", "paired", "srgb", "syn"])
    p.add_argument("--sourcedir", type=str, default="./data/SID/Sony")
    p.add_argument("--destdir", type=str, default="./data/Train")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--patch", type=int, default=512)
    p.add_argument("--stride", type=int, default=512)
    p.add_argument("--include", type=int, default=4)
    p.add_argument("--noise", type=str, default="g")
    p.add_argument("--no-crf", dest="crf", action="store_false")
    ns = p.parse_args(argv)

    if ns.recipe == "clean":
        builder.create_sony_dataset(ns.sourcedir, ns.destdir, ns.num_samples,
                                    patch=ns.patch, stride=ns.stride)
    elif ns.recipe == "paired":
        builder.create_sony_dataset_paired(ns.sourcedir, ns.destdir, ns.num_samples)
    elif ns.recipe == "srgb":
        builder.create_sony_dataset_srgb(ns.sourcedir, ns.destdir, ns.num_samples, ns.crf)
    else:
        builder.create_sony_syn_dataset(ns.sourcedir, ns.destdir, ns.include, ns.noise,
                                        ns.num_samples)


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
