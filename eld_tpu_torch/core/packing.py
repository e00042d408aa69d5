"""CFA <-> planar packing (a copy of ``eld_tpu/core/packing.py``, carried
here because importing eld_tpu imports JAX).  Packing runs on NumPy
arrays (the host data pipeline); the unpackers take NumPy arrays or torch
tensors (the demosaic runs them on the device).

Channel conventions follow the ELD reference so calibrated noise
parameters and metrics line up: Bayer -> 4 channels (R, G1, B, G2), X-Trans
-> 9 channels on a 6x6 super-cell.  Images are channels-last (H, W, C).
"""

from __future__ import annotations

import numpy as onp
import torch

WHITE_POINT = 16383  # 14-bit sensors used by SID / ELD


def pack_bayer(cfa, offsets=((0, 0), (0, 1), (1, 1), (1, 0))):
    """Pack an (H, W) Bayer mosaic into (H//2, W//2, 4) float32 planes;
    ``offsets`` are the (row, col) cell positions of (R, G1, B, G2)."""
    H = cfa.shape[0] - cfa.shape[0] % 2
    W = cfa.shape[1] - cfa.shape[1] % 2
    return onp.stack([cfa[r:H:2, c:W:2] for (r, c) in offsets], axis=-1).astype(onp.float32)


def _zeros(like, shape):
    """f32 zeros of ``shape`` beside ``like``: a tensor on its device, or
    a NumPy array."""
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    return onp.zeros(shape, dtype=onp.float32)


def unpack_bayer(img, offsets=((0, 0), (0, 1), (1, 1), (1, 0))):
    """Inverse of :func:`pack_bayer`: (h, w, 4) -> (2h, 2w) f32 mosaic."""
    h, w = img.shape[0], img.shape[1]
    cfa = _zeros(img, (2 * h, 2 * w))
    for ch, (r, c) in enumerate(offsets):
        cfa[r::2, c::2] = img[..., ch]
    return cfa


# X-Trans 6x6 super-cell sampling map, channel -> list of
# (mosaic_row_offset, mosaic_col_offset, out_row_parity, out_col_parity).
# Channels 0..4 sample 4 positions each into a 2x2 sub-grid of the
# (H//3, W//3) output; channels 5..8 sample one position on a 3x3 grid.
_XTRANS_QUAD = {
    0: [(0, 0, 0, 0), (0, 4, 0, 1), (3, 1, 1, 0), (3, 3, 1, 1)],  # R
    1: [(0, 2, 0, 0), (0, 5, 0, 1), (3, 2, 1, 0), (3, 5, 1, 1)],  # G
    2: [(0, 1, 0, 0), (0, 3, 0, 1), (3, 0, 1, 0), (3, 4, 1, 1)],  # B
    3: [(1, 2, 0, 0), (2, 5, 0, 1), (5, 2, 1, 0), (4, 5, 1, 1)],  # R
    4: [(2, 2, 0, 0), (1, 5, 0, 1), (4, 2, 1, 0), (5, 5, 1, 1)],  # B
}
_XTRANS_TRI = {5: (1, 0), 6: (1, 1), 7: (2, 0), 8: (2, 1)}  # G planes

# channel -> CFA color code (0=R, 1=G, 2=B) for the 9 packed planes
_XTRANS_CHANNEL_COLOR = {0: 0, 1: 1, 2: 2, 3: 0, 4: 2, 5: 1, 6: 1, 7: 1, 8: 1}


def xtrans_pattern() -> onp.ndarray:
    """The canonical 6x6 X-Trans CFA pattern (codes 0=R 1=G 2=B) that
    :func:`pack_xtrans` assumes, derived from its own sampling maps."""
    pat = onp.full((6, 6), 255, onp.uint8)
    for ch, quads in _XTRANS_QUAD.items():
        for (mr, mc, _pr, _pc) in quads:
            pat[mr, mc] = _XTRANS_CHANNEL_COLOR[ch]
    for ch, (mr, mc) in _XTRANS_TRI.items():
        for dr in (0, 3):
            for dc in (0, 3):
                pat[mr + dr, mc + dc] = _XTRANS_CHANNEL_COLOR[ch]
    if (pat == 255).any():
        raise AssertionError("X-Trans sampling maps leave a cell uncovered")
    return pat


def pack_xtrans(cfa):
    """Pack an (H, W) X-Trans mosaic into (H//3, W//3, 9) float32 planes."""
    H = (cfa.shape[0] // 6) * 6
    W = (cfa.shape[1] // 6) * 6
    h, w = H // 3, W // 3
    chans = []
    for ch in range(9):
        if ch in _XTRANS_QUAD:
            quads = {(pr, pc): cfa[mr:H:6, mc:W:6] for (mr, mc, pr, pc) in _XTRANS_QUAD[ch]}
            top = onp.stack([quads[(0, 0)], quads[(0, 1)]], axis=-1).reshape(h // 2, w)
            bot = onp.stack([quads[(1, 0)], quads[(1, 1)]], axis=-1).reshape(h // 2, w)
            plane = onp.stack([top, bot], axis=1).reshape(h, w)
        else:
            mr, mc = _XTRANS_TRI[ch]
            plane = cfa[mr:H:3, mc:W:3]
        chans.append(plane)
    return onp.stack(chans, axis=-1).astype(onp.float32)


def unpack_xtrans(img):
    """Inverse of :func:`pack_xtrans`: (h, w, 9) -> (3h, 3w) f32 mosaic."""
    h, w = img.shape[0], img.shape[1]
    H, W = 3 * h, 3 * w
    cfa = _zeros(img, (H, W))
    for ch in range(9):
        if ch in _XTRANS_QUAD:
            for (mr, mc, pr, pc) in _XTRANS_QUAD[ch]:
                cfa[mr:H:6, mc:W:6] = img[pr::2, pc::2, ch]
        else:
            mr, mc = _XTRANS_TRI[ch]
            cfa[mr:H:3, mc:W:3] = img[..., ch]
    return cfa


def normalize_bayer(packed, black_level, white_point=WHITE_POINT):
    """Black/white-level normalize packed raw to [0, 1]; ``black_level`` is
    per packed channel."""
    black = onp.asarray(black_level, dtype=onp.float32).reshape(1, 1, -1)
    return onp.clip((packed - black) / (white_point - black), 0.0, 1.0)


def crop_center(img, cropx, cropy):
    """Center crop a (..., H, W, C) array or tensor to (cropy, cropx)."""
    y, x = img.shape[-3], img.shape[-2]
    if y < cropy or x < cropx:
        # a negative start would silently wrap into a misaligned short
        # crop and corrupt downstream metrics
        raise ValueError(
            f"crop_center: image {y}x{x} is smaller than the requested "
            f"{cropy}x{cropx} crop (eval items must be at least crop-sized; "
            "pass crop=False for small frames)")
    sx = x // 2 - cropx // 2
    sy = y // 2 - cropy // 2
    return img[..., sy:sy + cropy, sx:sx + cropx, :]
