"""Tiled ("chopped") full-frame inference (counterpart of
``eld_tpu/ops/chop.py``).

The reference's full-resolution eval splits a frame into 4 overlapping
tiles and stitches their non-overlapping quadrants
(``models/ELD_model.py:434-467``; the released ELD eval runs use it via
``--chop``).  The 4 tiles are equal-sized, so they run as one batch of
4N through a single forward; the tile arithmetic (shave >= 10 rounded up
to the net's alignment) and the stitch slices are eld_tpu's.
"""

from __future__ import annotations

import math

import torch


def chop_geometry(h: int, w: int, base: int = 16, min_shave: int = 10):
    """Tile geometry: returns (h_size, w_size, h_half, w_half)."""
    h_half, w_half = h // 2, w // 2
    shave_h = math.ceil(h_half / base) * base - h_half
    shave_w = math.ceil(w_half / base) * base - w_half
    if shave_h < min_shave:
        shave_h += base
    if shave_w < min_shave:
        shave_w += base
    hs, ws = h_half + shave_h, w_half + shave_w
    if hs > h or ws > w:
        # tiles would exceed the frame: corner anchoring then duplicates
        # tile 0 and the stitch slices go empty/ragged — refuse clearly
        raise ValueError(
            f"frame {h}x{w} is too small to 4-tile chop at base={base} "
            f"(tiles would be {hs}x{ws}); run the plain forward instead")
    return hs, ws, h_half, w_half


def forward_chop(apply_fn, x: torch.Tensor, base: int = 16, min_shave: int = 10):
    """4-tile chopped forward; apply_fn: (N,H,W,C) -> (N,H,W,C'), x NHWC."""
    n, h, w, c = x.shape
    hs, ws, hh, wh = chop_geometry(h, w, base, min_shave)
    tiles = torch.stack([x[:, 0:hs, 0:ws], x[:, 0:hs, w - ws:w],
                         x[:, h - hs:h, 0:ws], x[:, h - hs:h, w - ws:w]])  # (4, N, hs, ws, C)
    outs = apply_fn(tiles.reshape(4 * n, hs, ws, c))
    outs = outs.reshape(4, n, hs, ws, outs.shape[-1])
    top = torch.cat([outs[0][:, 0:hh, 0:wh], outs[1][:, 0:hh, ws - (w - wh):]], dim=2)
    bot = torch.cat([outs[2][:, hs - (h - hh):, 0:wh],
                     outs[3][:, hs - (h - hh):, ws - (w - wh):]], dim=2)
    return torch.cat([top, bot], dim=1)
