"""EMoR radiometric calibration: basis loading, the calibrated CRF, fitting
(a copy of ``eld_tpu/core/emor.py``, which is NumPy only).

The EMoR model ("Empirical Model of Response", Grossberg & Nayar) writes a
camera response function (CRF) as f(E) = f0(E) + sum_i c_i * h_i(E), with
f0 and the h_i a PCA basis sampled on a 1024-point irradiance grid E.  The
basis (``emor.txt``) and the calibrated SonyA7S2 response
(``CRF_SonyA7S2_5.txt``, one curve per RGB channel) are read from
``eld_tpu/data_files/emor`` by path.
"""

from __future__ import annotations

import functools
import os

import numpy as onp

from eld_tpu_torch._paths import EMOR_DIR


def _read_curve_block(lines):
    return onp.array(" ".join(l.strip() for l in lines).split(), dtype=onp.float32)


def read_emor(path=None):
    """Parse emor.txt: returns (E, f0, hs) with E, f0 shape (1024,), hs (25, 1024).

    File layout: a name line then 256 lines of 4 values per curve
    (reference parser: ``util/process.py:132-152``)."""
    path = path or os.path.join(EMOR_DIR, "emor.txt")
    with open(path) as f:
        lines = f.readlines()
    k = 1
    E = _read_curve_block(lines[k : k + 256])
    k += 257
    f0 = _read_curve_block(lines[k : k + 256])
    hs = []
    for _ in range(25):
        k += 257
        hs.append(_read_curve_block(lines[k : k + 256]))
    return E, f0, onp.stack(hs)


def read_dorf(path):
    """Parse a DoRF database file: returns (names, Es, Bs) lists."""
    with open(path) as f:
        lines = f.readlines()
    names = [l.strip() for l in lines[0::6]]
    Es = [onp.array(l.strip().split(), dtype=onp.float32) for l in lines[3::6]]
    Bs = [onp.array(l.strip().split(), dtype=onp.float32) for l in lines[5::6]]
    return names, Es, Bs


@functools.lru_cache(maxsize=4)
def load_crf(name="SonyA7S2_5"):
    """A calibrated CRF as (E, fs): E (3, 1024) grid, fs (3, 1024) response
    (the reference's ``load_CRF``, ``util/process.py:168-175``, which tiles
    the shared EMoR grid across the 3 channels)."""
    fs = onp.loadtxt(os.path.join(EMOR_DIR, f"CRF_{name}.txt")).astype(onp.float32)
    E, _, _ = read_emor()
    return onp.tile(E[None], (3, 1)), fs


def fit_emor_coeffs(irradiance, brightness, num_coeffs=5, emor_path=None):
    """Fit EMoR coefficients to paired (irradiance, brightness) samples:
    c = H(x) @ (y - f0(x)) / n * 1024, the reference calibration's
    estimator (``EMoR/EMoR.py:189``).  Returns (coeffs, f_est) with f_est
    the reconstructed (1024,) curve."""
    E, f0, hs = read_emor(emor_path)
    x = onp.asarray(irradiance, dtype=onp.float32)
    y = onp.asarray(brightness, dtype=onp.float32)
    f0_x = onp.interp(x, E, f0)
    H_x = onp.stack([onp.interp(x, E, h) for h in hs[:num_coeffs]])
    coeffs = H_x @ (y - f0_x) / len(x) * len(E)
    f_est = f0 + coeffs @ hs[:num_coeffs]
    return coeffs, f_est


def invert_crf(E, fs):
    """Numerically invert a CRF: (B_grid, E_of_B) per channel for
    brightness -> irradiance lookup; each response is made monotone first."""
    outs = []
    for c in range(fs.shape[0]):
        b = onp.maximum.accumulate(fs[c])
        outs.append((b, E[c] if E.ndim == 2 else E))
    return outs
