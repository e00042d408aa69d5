"""Dataset visualizer — renders (input, target) pairs to PNG files
(counterpart of ``eld_tpu/tools/vis_data.py``; its PNGs are byte-equal).

Headless replacement for the reference's cv2.imshow viewer
(``vis_data.py:73-85``): instead of an interactive window it writes
side-by-side previews (4-channel raw binned to RGB) into --outdir.

Usage:
  python -m eld_tpu_torch.tools.vis_data --store ./data/Train/SID_Sony_Raw.eps -n 8
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as onp

from eld_tpu_torch.data.patchstore import PatchStore
from eld_tpu_torch.noise.host import HostNoiseModel
from eld_tpu_torch.utils.images import save_png


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--store", type=str, required=True, help="PatchStore dir")
    p.add_argument("--outdir", type=str, default="./vis")
    p.add_argument("-n", type=int, default=8)
    p.add_argument("--noise", type=str, default=None,
                   help="apply a host noise model (e.g. 'eld') for preview")
    p.add_argument("--seed", type=int, default=0)
    ns = p.parse_args(argv)

    store = PatchStore(ns.store)
    os.makedirs(ns.outdir, exist_ok=True)
    nm = None
    if ns.noise:
        nm = HostNoiseModel(model=ns.noise, rng=onp.random.default_rng(ns.seed))

    for i in range(min(ns.n, len(store))):
        clean = store[i]
        panels = [clean]
        if nm is not None:
            panels.insert(0, onp.clip(nm(clean), 0, 1))
        strip = onp.concatenate(panels, axis=1)
        save_png(os.path.join(ns.outdir, f"{i:04d}.png"), strip * 255.0)
    print(f"[i] wrote {min(ns.n, len(store))} previews to {ns.outdir}")


def cli() -> int:
    """Console-script entry: main()'s return value is data, not an exit
    status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
