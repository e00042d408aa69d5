"""Halo-sharded full-frame inference over the local cards (counterpart of
``eld_tpu/parallel/spatial.py``).

The frame's height is split into S slabs, one per card: each card runs the
network on its slab plus an overlap window (``halo``) and keeps only its
own rows, which are stitched on the input's device.  The window arithmetic is
eld_tpu's: H is edge-padded up to ``S * base`` and W up to ``base``,
windows are clamped at the true frame borders (border cards see the real
image edge, as the 4-tile chop's corner-anchored tiles do), and the
output is cropped back.  Only the input window crosses to each card; the
activations, ~100x larger, stay on the card that computes them.

eld_tpu runs this as one ``shard_map`` program over the mesh's ``spatial``
axis; here the host issues each card's window in turn, and the cards run
concurrently because CUDA launches do not wait.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from eld_tpu_torch.train.steps import edge_pad


def spatial_halo(base: int = 16, min_shave: int = 10) -> int:
    """Overlap size: >= min_shave, rounded up to the network alignment
    (the chop shave's arithmetic, ELD_model.py:438-442)."""
    return math.ceil(min_shave / base) * base


def make_spatial_forward(apply: Callable[[torch.Tensor], torch.Tensor],
                         devices: Sequence, halo: Optional[int] = None, base: int = 16):
    """``fwd(x) -> pred`` for NHWC frames, H split over ``devices``.

    ``apply`` runs the network on a window that lies on one of ``devices``
    (the caller keeps a replica of the network on each card; ``apply``
    picks the one on the window's device).  ``devices`` may repeat a
    device.  ``base`` is the network's spatial alignment
    (``model.alignment()``).  The output lies on the input's device."""
    devices = [torch.device(d) for d in devices]
    s = len(devices)
    halo = spatial_halo(base) if halo is None else halo
    quantum = s * base

    @torch.no_grad()
    def fwd(x: torch.Tensor) -> torch.Tensor:
        h, w, home = x.shape[1], x.shape[2], x.device
        hp = -(-h // quantum) * quantum
        wp = -(-w // base) * base
        x = edge_pad(x, hp, wp)
        slab = hp // s
        win = min(hp, slab + 2 * halo)
        rows = []
        for i, dev in enumerate(devices):
            start = min(max(i * slab - halo, 0), hp - win)
            out = apply(x[:, start:start + win].to(dev, non_blocking=True))
            offset = i * slab - start
            rows.append(out[:, offset:offset + slab])
        return torch.cat([r.to(home) for r in rows], dim=1)[:, :h, :w]

    return fwd
