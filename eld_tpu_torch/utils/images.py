"""PNG read/write: PIL when available, a self-contained codec otherwise
(a copy of ``eld_tpu/utils/images.py``)."""

from __future__ import annotations

import struct
import zlib

import numpy as onp

try:
    from PIL import Image as _PILImage
except ImportError:  # pragma: no cover
    _PILImage = None


def save_png(path: str, img: onp.ndarray):
    """Write an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8-able image.

    4-channel packed-raw arrays are previewed by RGBG binning to RGB.
    """
    arr = onp.asarray(img)
    if arr.dtype != onp.uint8:
        arr = onp.clip(arr, 0, 255).astype(onp.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 4:  # packed raw preview: RGBG -> RGB
        arr = onp.stack(
            [arr[..., 0], ((arr[..., 1].astype(onp.uint16) + arr[..., 3]) // 2).astype(onp.uint8), arr[..., 2]],
            axis=-1,
        )
    h, w, c = arr.shape
    if _PILImage is not None:
        _PILImage.fromarray(arr.squeeze() if c == 1 else arr).save(path)
        return
    color_type = {1: 0, 3: 2}[c if c in (1, 3) else 3]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def load_png(path: str) -> onp.ndarray:
    """Read back PNGs written by save_png (8-bit, non-interlaced)."""
    if _PILImage is not None:
        arr = onp.asarray(_PILImage.open(path))
        return arr[..., None] if arr.ndim == 2 else arr
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h, ct = 8, b"", 0, 0, 0
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ct = struct.unpack(">IIBB", payload[:10])
            assert depth == 8
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    c = {0: 1, 2: 3, 6: 4}[ct]
    raw = zlib.decompress(idat)
    stride = w * c
    out = onp.empty((h, w, c), onp.uint8)
    prev = onp.zeros(stride, onp.int32)
    for i in range(h):
        ft = raw[i * (stride + 1)]
        line = onp.frombuffer(
            raw[i * (stride + 1) + 1 : (i + 1) * (stride + 1)], onp.uint8
        ).astype(onp.int32)
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub
            cur = line.copy()
            for j in range(c, stride):
                cur[j] = (cur[j] + cur[j - c]) & 0xFF
        elif ft == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ft == 3:  # Average
            cur = line.copy()
            for j in range(stride):
                left = cur[j - c] if j >= c else 0
                cur[j] = (cur[j] + ((left + prev[j]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            cur = line.copy()
            for j in range(stride):
                a = cur[j - c] if j >= c else 0
                b = prev[j]
                cc = prev[j - c] if j >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[j] = (cur[j] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {ft}")
        out[i] = cur.astype(onp.uint8).reshape(w, c)
        prev = cur
    return out
