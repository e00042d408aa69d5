"""Raw file access: the native TIFF/EXIF decoder and ``.npz`` rawpacks (a
copy of ``eld_tpu/data/rawio.py``; importing eld_tpu imports JAX).

``RawFile`` exposes what the pipeline needs from a raw: the visible
mosaic, per-channel black level, white level, CFA pattern, camera white
balance, the cam -> sRGB matrix and EXIF iso/exposure.

Backends, by extension:
  1. ``.npz`` / ``.rawpack`` rawpacks — pre-decoded raws (mosaic +
     metadata), as ``eld_tpu.tools.convert_raw`` or a test writes them;
  2. anything else goes to the native ``librawio.so`` shipped in
     ``eld_tpu/data_files/native`` (found by path): DNG and DNG-tagged
     TIFF, Sony ARW 2.3, Canon CR2 and lossless Nikon NEF.

Field conventions: ``black_level`` is in PACKED channel order (R,G1,B,G2)
on every backend; ``ccm`` is always cam->sRGB (DNG ColorMatrix tags are
converted via :func:`ccm_from_colormatrix`).
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as onp

from eld_tpu_torch._paths import RAWIO_LIB
from eld_tpu_torch.core.packing import pack_bayer, pack_xtrans, xtrans_pattern

_NATIVE_PATH = RAWIO_LIB

RIO_E_UNSUPPORTED_COMPRESSION = -3


@functools.lru_cache(maxsize=None)
def _load_native():
    """The native decoder, loaded at first use; None where it does not load."""
    if not os.path.exists(_NATIVE_PATH):
        return None
    try:
        lib = ctypes.CDLL(_NATIVE_PATH)
    except OSError:
        return None
    lib.rio_open.restype = ctypes.c_void_p
    lib.rio_open.argtypes = [ctypes.c_char_p]
    for fn in ("rio_iso", "rio_exposure", "rio_white_level"):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("rio_width", "rio_height", "rio_compression", "rio_bits"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.rio_black_level.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.rio_cfa_pattern.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.rio_wb.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.rio_ccm.restype = ctypes.c_int
    lib.rio_ccm.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.rio_has_black.restype = ctypes.c_int
    lib.rio_has_black.argtypes = [ctypes.c_void_p]
    lib.rio_read_raw.restype = ctypes.c_int
    lib.rio_read_raw.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16)]
    lib.rio_close.argtypes = [ctypes.c_void_p]
    try:
        lib.rio_warnings.restype = ctypes.c_uint32
        lib.rio_warnings.argtypes = [ctypes.c_void_p]
        lib.rio_cfa_dim.restype = ctypes.c_uint32
        lib.rio_cfa_dim.argtypes = [ctypes.c_void_p]
        lib.rio_cfa_pattern_full.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_uint8)]
    except AttributeError:  # stale .so without the symbols
        lib.rio_warnings = None
    return lib


WHITE_POINT = 16383

# sRGB (D65) -> XYZ primaries, the constant dcraw/LibRaw use
_XYZ_FROM_SRGB = onp.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], onp.float64)


def ccm_from_colormatrix(cm: onp.ndarray) -> onp.ndarray:
    """DNG ColorMatrix (XYZ -> camera) -> cam -> sRGB matrix.

    The dcraw/LibRaw ``cam_xyz_coeff`` recipe: cam_from_srgb = CM @
    XYZ_FROM_SRGB, rows normalized to 1 (white preservation), then
    pseudo-inverted.  Matches the semantics of the customized rawpy's
    ``rgb_camera_matrix`` the reference consumes (util/process.py:90)."""
    cam_from_srgb = onp.asarray(cm, onp.float64) @ _XYZ_FROM_SRGB
    rows = cam_from_srgb.sum(axis=1, keepdims=True)
    rows[rows == 0] = 1.0
    cam_from_srgb = cam_from_srgb / rows
    return onp.linalg.pinv(cam_from_srgb).astype(onp.float32)


def _pattern_offsets(pattern: onp.ndarray):
    """(row, col) of R, G1, B, G2 inside the 2x2 CFA cell."""
    out = []
    for code in (0, 1, 2, 3):
        pos = onp.argwhere(pattern == code)
        if len(pos) == 0:  # some files use 1 for both greens
            greens = onp.argwhere(pattern == 1)
            pos = greens[1:2] if code == 3 and len(greens) > 1 else pos
        if len(pos) == 0:  # corrupted/non-Bayer pattern: reject cleanly
            raise UnsupportedRawError(
                f"CFA pattern {pattern.tolist()} lacks color code {code} — "
                "not a decodable 2x2 Bayer mosaic")
        out.append(tuple(int(v) for v in pos[0]))
    return tuple(out)


@dataclass
class RawFile:
    """Decoded raw: mosaic + the metadata the pipeline consumes."""

    mosaic: onp.ndarray            # (H, W) uint16 visible area
    black_level: onp.ndarray       # (4,) in PACKED channel order (R,G1,B,G2)
    white_level: float
    cfa_pattern: onp.ndarray       # (2, 2) codes 0=R 1=G 2=B 3=G2
    wb: onp.ndarray                # (4,) RGBG camera white balance gains
    ccm: onp.ndarray               # (3, 3) cam -> sRGB matrix
    iso: float
    exposure: float
    cfa: str = "bayer"

    def pattern_offsets(self):
        """(row, col) of R, G1, B, G2 inside the 2x2 CFA cell — the
        pack order contract (reference ``pack_raw_bayer``,
        ``dataset/sid_dataset.py:175-189``)."""
        return _pattern_offsets(self.cfa_pattern)

    def packed(self) -> onp.ndarray:
        """Black/white-normalized packed planes in [0,1], channels-last —
        the reference's ``pack_raw_bayer`` / ``pack_raw_xtrans`` output."""
        if not self.white_level > float(onp.max(self.black_level)):
            # a division by <= 0 would clip sign-flipped garbage into [0,1]
            raise UnsupportedRawError(
                f"white level {self.white_level} <= black level "
                f"{self.black_level.tolist()} — corrupt level metadata")
        if self.cfa == "bayer":
            offs = self.pattern_offsets()
            out = pack_bayer(self.mosaic.astype(onp.float32), offsets=offs)
            black = self.black_level.reshape(1, 1, 4).astype(onp.float32)
            out = (out - black) / (self.white_level - black)
        else:
            # pack_xtrans samples the canonical X-Trans 6x6 layout; a file
            # whose visible area starts at a different phase would silently
            # land R/B samples in the wrong planes — refuse instead.
            if self.cfa_pattern.shape != (6, 6):
                # a missing/Bayer-shaped pattern must not BYPASS the
                # phase check — packing at an unknown phase is exactly
                # the silent R/B-plane corruption this guard prevents
                raise UnsupportedRawError(
                    f"cfa='xtrans' needs a (6, 6) cfa_pattern to verify "
                    f"the phase; got shape {self.cfa_pattern.shape}")
            if not onp.array_equal(self.cfa_pattern, xtrans_pattern()):
                raise UnsupportedRawError(
                    "X-Trans CFA phase differs from the canonical layout "
                    "pack_xtrans assumes; re-crop the visible area to the "
                    f"canonical phase first (got pattern\n{self.cfa_pattern})")
            # scalar black for X-Trans (the reference hardcodes 1024 for the
            # Fuji X-T2, sid_dataset.py:202; we take the file's level)
            b = float(self.black_level[0])
            im = (self.mosaic.astype(onp.float32) - b) / (self.white_level - b)
            out = pack_xtrans(im)
        return onp.clip(out, 0.0, 1.0)


class UnsupportedRawError(RuntimeError):
    pass


def _open_native(path: str) -> RawFile:
    lib = _load_native()
    h = lib.rio_open(path.encode())
    if not h:
        raise UnsupportedRawError(f"rawio could not parse {path}")
    try:
        comp = lib.rio_compression(h)
        W, H = lib.rio_width(h), lib.rio_height(h)
        mosaic = onp.empty((H, W), onp.uint16)
        rc = lib.rio_read_raw(h, mosaic.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if rc == RIO_E_UNSUPPORTED_COMPRESSION:
            raise UnsupportedRawError(
                f"{path}: vendor-compressed raw (compression={comp}) this "
                "decoder does not handle (Sony ARW 2.3, Canon CR2, and "
                "lossless Nikon NEF decode natively; this file is another "
                "variant) — convert to uncompressed DNG first "
                "(eld_tpu.tools.convert_raw, or 'dnglab convert' / Adobe DNG "
                "Converter with compression off)")
        if rc != 0:
            raise UnsupportedRawError(f"{path}: raw decode failed (rc={rc})")
        if not lib.rio_has_black(h):
            raise UnsupportedRawError(
                f"{path}: no black-level metadata — vendor raws store levels "
                "in maker notes this decoder does not parse for this format; "
                "convert to DNG first (eld_tpu.tools.convert_raw)")
        black_cells = (ctypes.c_double * 4)()
        lib.rio_black_level(h, black_cells)
        warn_bits = lib.rio_warnings(h) if lib.rio_warnings is not None else 0
        if warn_bits:
            import warnings as _w

            msgs = []
            if warn_bits & 1:
                msgs.append("ARW2 tone-curve tag (0x7010) missing — using the "
                            "default linear x4 expansion; values MAY be on a "
                            "wrong tone scale")
            if warn_bits & 2:
                # the native layer defaults per format (512 for ARW — the
                # A7S2 value the reference hardcodes — 400 for NEF/D850);
                # report the value actually applied
                msgs.append("no black-level tag — defaulting to the format's "
                            f"documented level ({black_cells[0]:.0f})")
            _w.warn(f"{path}: " + "; ".join(msgs), stacklevel=3)
        cfa_dim = int(lib.rio_cfa_dim(h)) if lib.rio_warnings is not None else 2
        if cfa_dim == 6:  # X-Trans
            full = (ctypes.c_uint8 * 36)()
            lib.rio_cfa_pattern_full(h, full)
            pattern = onp.asarray(full, onp.uint8).reshape(6, 6)
            # the X-Trans path normalizes with a scalar black (the
            # reference hardcodes 1024, sid_dataset.py:202)
            black = onp.full(4, float(black_cells[0]), onp.float32)
            kind = "xtrans"
        else:
            cfa = (ctypes.c_uint8 * 4)()
            lib.rio_cfa_pattern(h, cfa)
            pattern = onp.asarray(cfa, onp.uint8).reshape(2, 2)
            # DNG BlackLevel is CFA-cell row-major; remap to packed channel
            # order (R, G1, B, G2) via the pattern
            cells = onp.asarray(black_cells, onp.float64).reshape(2, 2)
            black = onp.empty(4, onp.float32)
            for ch, (r0, c0) in enumerate(_pattern_offsets(pattern)):
                black[ch] = cells[r0, c0]
            kind = "bayer"
        wb = (ctypes.c_double * 4)()
        lib.rio_wb(h, wb)
        cm = (ctypes.c_double * 9)()
        has_ccm = lib.rio_ccm(h, cm) == 0
        if has_ccm:
            ccm = ccm_from_colormatrix(onp.asarray(cm, onp.float64).reshape(3, 3))
        else:
            ccm = onp.eye(3, dtype=onp.float32)
        white = lib.rio_white_level(h) or WHITE_POINT
        return RawFile(
            mosaic=mosaic,
            black_level=black,
            white_level=float(white),
            cfa_pattern=pattern,
            wb=onp.asarray(wb, onp.float32),
            ccm=ccm,
            iso=lib.rio_iso(h),
            exposure=lib.rio_exposure(h),
            cfa=kind,
        )
    finally:
        lib.rio_close(h)


def _open_rawpack(path: str) -> RawFile:
    z = onp.load(path, allow_pickle=False)
    # accept a scalar or per-channel black level; broadcast to the (4,)
    # contract (RawFile.packed reshapes to (1,1,4) — a short array would
    # crash there with an opaque reshape error instead of here)
    black = onp.asarray(z["black_level"], onp.float32).reshape(-1)
    if black.size == 1:
        black = onp.full(4, black[0], onp.float32)
    elif black.size < 4:
        raise ValueError(
            f"{path}: black_level has {black.size} entries; need a "
            "scalar or one per packed channel (4)")
    return RawFile(
        mosaic=onp.asarray(z["mosaic"], onp.uint16),
        black_level=black[:4],
        white_level=float(z.get("white_level", WHITE_POINT)),
        cfa_pattern=onp.asarray(z.get("cfa_pattern", [[0, 1], [3, 2]]), onp.uint8),
        wb=onp.asarray(z.get("wb", [1, 1, 1, 1]), onp.float32),
        ccm=onp.asarray(z.get("ccm", onp.eye(3)), onp.float32),
        iso=float(z.get("iso", 100.0)),
        exposure=float(z.get("exposure", 1.0)),
        cfa=str(z.get("cfa", "bayer")),
    )


def save_rawpack(path: str, raw: RawFile):
    onp.savez_compressed(
        path,
        mosaic=raw.mosaic,
        black_level=raw.black_level,
        white_level=raw.white_level,
        cfa_pattern=raw.cfa_pattern,
        wb=raw.wb,
        ccm=raw.ccm,
        iso=raw.iso,
        exposure=raw.exposure,
        cfa=raw.cfa,
    )


def imread(path: str) -> RawFile:
    """Open a raw file; resolves backend by extension/availability."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.lower().endswith((".npz", ".rawpack")):
        return _open_rawpack(path)
    if _load_native() is None:
        raise UnsupportedRawError(
            "native librawio not built (run `make -C native`) and "
            f"{path} is not a .npz rawpack")
    return _open_native(path)


def metainfo(path: str):
    """(iso, exposure) pair — parity with ``sid_dataset.py:21-34``."""
    raw = imread(path)
    return raw.iso, raw.exposure
