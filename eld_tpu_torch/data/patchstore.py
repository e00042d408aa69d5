"""PatchStore — the training-patch database (counterpart of
``eld_tpu/data/patchstore.py``, same on-disk format).

A flat binary record file (4096-byte header + tightly packed fixed-size
records) plus an ``aux.npz`` sidecar for per-record metadata.  Reads go
through the native library ``libpatchstore.so`` shipped in
``eld_tpu/data_files/native`` (found by path) when it loads, and through a
NumPy memmap reader of the same format otherwise; a store written by
either package reads identically in the other.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
from typing import Optional

import numpy as onp

from eld_tpu_torch._paths import PATCHSTORE_LIB

_DTYPE_CODES = {onp.uint16: 1, onp.float32: 2, onp.uint8: 3}
_CODE_DTYPES = {1: onp.uint16, 2: onp.float32, 3: onp.uint8}
_HEADER_BYTES = 4096



@functools.lru_cache(maxsize=None)
def _load_native():
    """The native library, loaded at first use (None if it will not load)."""
    if not os.path.exists(PATCHSTORE_LIB):
        return None
    try:
        lib = ctypes.CDLL(PATCHSTORE_LIB)
    except OSError:
        return None
    lib.ps_open.restype = ctypes.c_void_p
    lib.ps_open.argtypes = [ctypes.c_char_p]
    lib.ps_count.restype = ctypes.c_uint64
    lib.ps_count.argtypes = [ctypes.c_void_p]
    lib.ps_dtype.restype = ctypes.c_uint32
    lib.ps_dtype.argtypes = [ctypes.c_void_p]
    lib.ps_ndim.restype = ctypes.c_uint32
    lib.ps_ndim.argtypes = [ctypes.c_void_p]
    lib.ps_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.ps_get.restype = ctypes.c_int
    lib.ps_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
    lib.ps_get_f32.restype = ctypes.c_int
    lib.ps_get_f32.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.ps_get_batch_f32.restype = ctypes.c_int
    lib.ps_get_batch_f32.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.ps_close.argtypes = [ctypes.c_void_p]
    lib.psw_create.restype = ctypes.c_void_p
    lib.psw_create.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64)
    ]
    lib.psw_append.restype = ctypes.c_int
    lib.psw_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.psw_finish.restype = ctypes.c_int
    lib.psw_finish.argtypes = [ctypes.c_void_p]
    return lib



def _check_rc(rc: int):
    if rc != 0:
        raise OSError(f"libpatchstore call failed with code {rc}")


def _data_bin(path: str) -> str:
    return os.path.join(path, "data.bin")


class PatchStore:
    """Read side. ``size``/``repeat`` virtualize length like the reference's
    ``LMDBDataset(size=..., repeat=...)`` (``dataset/lmdb_dataset.py:22-23``).
    """

    def __init__(self, path: str, size: Optional[int] = None, repeat: float = 1,
                 use_native: bool = True):
        self.path = path
        bin_path = _data_bin(path)
        if not os.path.exists(bin_path):
            raise FileNotFoundError(bin_path)
        self._h = None
        if use_native and _load_native() is not None:
            self._h = _load_native().ps_open(bin_path.encode())
            self._h = self._h or None
        if self._h is not None:
            self._count = int(_load_native().ps_count(self._h))
            ndim = _load_native().ps_ndim(self._h)
            dims = (ctypes.c_uint64 * ndim)()
            _load_native().ps_dims(self._h, dims)
            self.shape = tuple(int(d) for d in dims)
            self.dtype = _CODE_DTYPES[_load_native().ps_dtype(self._h)]
        else:
            # NumPy memmap fallback over the same format.  The header is
            # file-controlled: validate it (same bounds as the native
            # reader) so corruption/truncation raises instead of feeding
            # garbage geometry to the memmap.
            hdr = onp.fromfile(bin_path, dtype=onp.uint8, count=_HEADER_BYTES)
            if len(hdr) < _HEADER_BYTES:
                raise ValueError(f"{bin_path}: truncated patchstore header")
            magic = hdr[:4].view(onp.uint32)[0]
            if magic != 0x31535045:
                raise ValueError(f"{bin_path}: bad patchstore magic {magic:#x}")
            dtype_code, ndim = (int(v) for v in hdr[4:12].view(onp.uint32)[:2])
            if dtype_code not in _CODE_DTYPES or not 1 <= ndim <= 8:
                raise ValueError(
                    f"{bin_path}: bad header (dtype code {dtype_code}, ndim {ndim})")
            dims = hdr[16:80].view(onp.uint64)[:ndim]
            self._count = int(hdr[80:88].view(onp.uint64)[0])
            self.shape = tuple(int(d) for d in dims)
            self.dtype = _CODE_DTYPES[dtype_code]
            record_bytes = int(onp.prod(self.shape, dtype=onp.uint64)) * \
                onp.dtype(self.dtype).itemsize
            need = _HEADER_BYTES + self._count * record_bytes
            have = os.path.getsize(bin_path)
            if record_bytes == 0 or any(d == 0 for d in self.shape) or have < need:
                raise ValueError(
                    f"{bin_path}: header claims {self._count} records of shape "
                    f"{self.shape} ({need} bytes) but the file has {have}")
            self._mm = onp.memmap(bin_path, dtype=self.dtype, mode="r",
                                  offset=_HEADER_BYTES,
                                  shape=(self._count, *self.shape))
        if size is not None and size > self._count:
            # length virtualization SHRINKS the visible subset (reference
            # LMDBDataset semantics); a larger size would index past the
            # physical records (garbage from the native reader under -O)
            raise ValueError(
                f"{path}: size={size} exceeds the store's {self._count} "
                "records (use repeat= to lengthen epochs)")
        self.length = size or self._count
        self.repeat = repeat
        self.meta = self._load_aux()

    def _load_aux(self):
        aux = os.path.join(self.path, "aux.npz")
        if os.path.exists(aux):
            return dict(onp.load(aux, allow_pickle=False))
        return {}

    def __len__(self):
        return int(self.length * self.repeat)

    def physical_index(self, index: int) -> int:
        """The record number a (size/repeat-virtualized) item index maps to,
        which is also its row in the aux ``meta`` arrays."""
        return int(index) % self.length

    def record(self, index: int) -> onp.ndarray:
        """Raw record at index (original dtype)."""
        index = index % self.length
        if self._h is not None:
            out = onp.empty(self.shape, self.dtype)
            rc = _load_native().ps_get(self._h, index, out.ctypes.data_as(ctypes.c_void_p))
            _check_rc(rc)
            return out
        return onp.array(self._mm[index])

    def __getitem__(self, index: int) -> onp.ndarray:
        """Record as float32 in [0,1] (uint16/uint8 scaled), like the
        reference's uint16 path (``dataset/lmdb_dataset.py:38-39``)."""
        index = index % self.length
        if self._h is not None:
            out = onp.empty(self.shape, onp.float32)
            rc = _load_native().ps_get_f32(
                self._h, index, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            _check_rc(rc)
            return out
        x = onp.asarray(self._mm[index], onp.float32)
        # multiply by the f32 reciprocal, bit-identical to the native reader
        if self.dtype == onp.uint16:
            x = x * onp.float32(1.0 / 65535.0)
        elif self.dtype == onp.uint8:
            x = x * onp.float32(1.0 / 255.0)
        return x

    def batch(self, indices, n_threads: int = 0) -> onp.ndarray:
        """Multithreaded native batch fetch -> (n, *shape) float32."""
        idxs = onp.asarray([i % self.length for i in indices], onp.uint64)
        out = onp.empty((len(idxs), *self.shape), onp.float32)
        if self._h is not None:
            rc = _load_native().ps_get_batch_f32(
                self._h,
                idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                len(idxs),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n_threads,
            )
            _check_rc(rc)
            return out
        for j, i in enumerate(idxs):
            out[j] = self[int(i)]
        return out

    @property
    def native(self) -> bool:
        return self._h is not None

    def close(self):
        if self._h is not None:
            _load_native().ps_close(self._h)
            self._h = None

    def __repr__(self):
        return f"PatchStore({self.path!r}, n={self._count}, shape={self.shape}, native={self.native})"


class PatchStoreWriter:
    """Write side (used by the dataset builder CLI)."""

    def __init__(self, path: str, shape, dtype=onp.uint16, use_native: bool = True):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = onp.dtype(dtype).type
        self._aux = {}
        self._count = 0
        bin_path = _data_bin(path)
        code = _DTYPE_CODES[self.dtype]
        self._wh = None
        if use_native and _load_native() is not None:
            dims = (ctypes.c_uint64 * len(self.shape))(*self.shape)
            self._wh = _load_native().psw_create(bin_path.encode(), code, len(self.shape), dims)
            self._wh = self._wh or None
        if self._wh is None:
            self._f = open(bin_path, "wb")
            hdr = onp.zeros(_HEADER_BYTES, onp.uint8)
            hdr[:4].view(onp.uint32)[0] = 0x31535045
            hdr[4:12].view(onp.uint32)[:2] = [code, len(self.shape)]
            hdr[16:16 + 8 * len(self.shape)].view(onp.uint64)[:] = self.shape
            self._f.write(hdr.tobytes())

    def append(self, record: onp.ndarray, **aux):
        record = onp.asarray(record)
        if (onp.issubdtype(record.dtype, onp.floating)
                and not onp.issubdtype(self.dtype, onp.floating)):
            # Symmetric with the read side (uint16 -> float32 / 65535):
            # accept floats in [0, 1] and quantize, instead of silently
            # truncating 0.x to 0 via the integer cast.
            scale = onp.iinfo(self.dtype).max
            record = onp.clip(onp.rint(record * scale), 0, scale)
        record = onp.ascontiguousarray(record, dtype=self.dtype)
        if record.shape != self.shape:
            raise ValueError(f"record shape {record.shape} != store shape {self.shape}")
        if self._wh is not None:
            rc = _load_native().psw_append(self._wh, record.ctypes.data_as(ctypes.c_void_p))
            _check_rc(rc)
        else:
            self._f.write(record.tobytes())
        for k, v in aux.items():
            self._aux.setdefault(k, []).append(onp.asarray(v))
        self._count += 1

    def finish(self):
        if self._wh is not None:
            rc = _load_native().psw_finish(self._wh)
            _check_rc(rc)
            self._wh = None
        else:
            # patch count into the header
            self._f.flush()
            self._f.seek(80)
            self._f.write(onp.asarray([self._count], onp.uint64).tobytes())
            self._f.close()
        if self._aux:
            onp.savez(os.path.join(self.path, "aux.npz"),
                      **{k: onp.stack(v) for k, v in self._aux.items()})
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump({"count": self._count, "shape": list(self.shape),
                       "dtype": onp.dtype(self.dtype).name, "version": 1}, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
