"""Filename-pair lists and exposure-ratio arithmetic (a copy of
``eld_tpu/data/pairs.py``; the vendored SID Sony pair lists are read from
``eld_tpu/data_files/pairs`` by path)."""

from __future__ import annotations

import os

from eld_tpu_torch._paths import PAIRS_DIR


def read_paired_fns(filename: str):
    """Parse 'a b [extra...]' lines into tuples.  Bare names resolve against
    the vendored pair lists."""
    if not os.path.exists(filename):
        cand = os.path.join(PAIRS_DIR, filename)
        if os.path.exists(cand):
            filename = cand
    with open(filename) as f:
        return [tuple(line.strip().split(" ")) for line in f if line.strip()]


def read_expo_time(fn: str) -> float:
    """Exposure seconds encoded in SID filenames like 00001_00_0.04s.ARW."""
    stem = os.path.splitext(fn.split("_")[-1])[0]
    if not stem.endswith("s"):
        raise ValueError(f"{fn}: no '<seconds>s' exposure field in name")
    return float(stem[:-1])


def compute_expo_ratio(input_fn: str, target_fn: str, cap: float = 300.0) -> float:
    return min(read_expo_time(target_fn) / read_expo_time(input_fn), cap)


def sid_pairs(split: str):
    """Vendored SID Sony splits: 'train' | 'val' | 'test' | 'indoor15' | 'paired'."""
    names = {
        "train": "Sony_train.txt",
        "val": "Sony_val.txt",
        "test": "Sony_test.txt",
        "indoor15": "SID_Sony_15_paired.txt",
        "paired": "SID_Sony_paired.txt",
    }
    return read_paired_fns(names[split])


def eval_pairs_by_ratio(ratios=(100, 250, 300)):
    """The reference's eval protocol: the 15-indoor-scene subset bucketed by
    exposure ratio (its third column)."""
    indoor = sid_pairs("indoor15")
    return {r: [(fn[0], fn[1]) for fn in indoor if int(fn[2]) == r] for r in ratios}
