"""Convert camera raws that the native decoder cannot parse into ``.npz``
rawpacks (counterpart of ``eld_tpu/tools/convert_raw.py``).

Vendor-compressed formats (Sony ARW 2.3 lossy, Canon CR2 lossless JPEG)
need a one-time conversion on a machine with rawpy/LibRaw installed; the
rawpacks then feed every pipeline of either package.  rawpy is imported
only when a file is converted.

Usage (on a machine with rawpy):
  python -m eld_tpu_torch.tools.convert_raw ./data/SID/Sony/**/*.ARW --outdir ./data/rawpacks
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from fractions import Fraction

import numpy as onp

from eld_tpu_torch.data.rawio import RawFile, save_rawpack


def _exif_number(tags, key: str, default: float) -> float:
    """An EXIF rational or number ("1/100", "100") as a float; ``default``
    where the tag is missing or does not parse."""
    try:
        return float(Fraction(str(tags.get(key, default)).strip()))
    except (ValueError, ZeroDivisionError):
        return default


def convert_one(path: str, outdir: str) -> str:
    import rawpy

    iso, expo = 100.0, 1.0
    try:
        import exifread
    except ImportError:
        exifread = None
    if exifread is not None:
        with open(path, "rb") as f:
            tags = exifread.process_file(f)
        expo = _exif_number(tags, "EXIF ExposureTime", 1.0)
        iso = _exif_number(tags, "EXIF ISOSpeedRatings", 100.0)

    with rawpy.imread(path) as raw:
        pattern = onp.asarray(raw.raw_pattern, onp.uint8)
        wb = onp.asarray(raw.camera_whitebalance, onp.float32)
        try:
            ccm = onp.asarray(raw.rgb_camera_matrix, onp.float32)[:3, :3]
        except AttributeError:
            ccm = onp.asarray(raw.color_matrix, onp.float32)[:3, :3]
        rf = RawFile(
            mosaic=onp.asarray(raw.raw_image_visible, onp.uint16),
            black_level=onp.asarray(raw.black_level_per_channel, onp.float32),
            white_level=float(raw.white_level),
            cfa_pattern=pattern,
            wb=wb,
            ccm=ccm,
            iso=iso,
            exposure=expo,
        )
    out = os.path.join(outdir, os.path.splitext(os.path.basename(path))[0] + ".npz")
    save_rawpack(out, rf)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("patterns", nargs="+")
    p.add_argument("--outdir", type=str, required=True)
    ns = p.parse_args(argv)
    os.makedirs(ns.outdir, exist_ok=True)
    fns = sorted(set(sum((glob.glob(pat, recursive=True) for pat in ns.patterns), [])))
    outs = []
    for i, fn in enumerate(fns):
        outs.append(convert_one(fn, ns.outdir))
        print(f"({i + 1}/{len(fns)}) {fn} -> {outs[-1]}")
    return outs


def cli() -> int:
    """Console-script style entry: main()'s return value is data, not an
    exit status."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
