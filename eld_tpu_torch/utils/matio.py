"""MATLAB .mat ingestion: structs -> nested dicts, cell arrays -> lists
(a copy of ``eld_tpu/utils/matio.py``, which needs no JAX).

Parity with the reference's ``util/util.py:278-326`` ``loadmat`` (used by
its auxiliary calibration workflows, not the ELD train/eval main path):
``scipy.io.loadmat`` returns MATLAB structs as opaque ``mat_struct``
objects; this converts top-level structs into plain dicts, recursing so
struct fields become dicts and any ndarray field (cell arrays included)
becomes a nested list — the exact conversion rules of the reference
implementation, so downstream code ports unchanged.
"""

from __future__ import annotations

import numpy as onp
import scipy.io as spio

try:  # scipy >= 1.8 re-exports; the deep path is the legacy location
    from scipy.io.matlab import mat_struct as _MatStruct
except ImportError:  # pragma: no cover - legacy scipy
    from scipy.io.matlab.mio5_params import mat_struct as _MatStruct


def _todict(matobj) -> dict:
    out = {}
    for name in matobj._fieldnames:
        elem = getattr(matobj, name)
        if isinstance(elem, _MatStruct):
            out[name] = _todict(elem)
        elif isinstance(elem, onp.ndarray):
            out[name] = _tolist(elem)
        else:
            out[name] = elem
    return out


def _tolist(arr) -> list:
    out = []
    for elem in arr:
        if isinstance(elem, _MatStruct):
            out.append(_todict(elem))
        elif isinstance(elem, onp.ndarray):
            out.append(_tolist(elem))
        else:
            out.append(elem)
    return out


def loadmat(filename: str) -> dict:
    """Load a .mat file, converting MATLAB structs to nested dicts.

    Top-level structs become dicts; inside a struct, nested structs
    become dicts and ndarrays (numeric or cell) become nested lists.
    Non-struct top-level entries (plain arrays, scipy's ``__header__``
    metadata) pass through unchanged, as in the reference.
    """
    data = spio.loadmat(filename, struct_as_record=False, squeeze_me=True)
    return {k: _todict(v) if isinstance(v, _MatStruct) else v
            for k, v in data.items()}
