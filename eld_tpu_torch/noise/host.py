"""Host-side (NumPy) noise model, the offline-baking twin of the device path
(a copy of ``eld_tpu/noise/host.py``, which is NumPy only).

The same equations as ``noise/model.py`` (reference ``noise.py:148-225``),
run on the CPU with ``numpy.random``.  The dataset builder uses it for the
pre-baked ``SID_Sony_syn_Raw_<camera>.eps`` store that ``train_syn
--offline_noise`` reads.  A callable like the reference's ``NoiseModel``:
a clean packed image (channels last) and optional explicit params in, the
noisy image out.  The calibration files are read from
``eld_tpu/data_files/camera_params`` by path.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as onp

from eld_tpu_torch._paths import CAMERA_PARAMS_DIR
from eld_tpu_torch.noise.model import MODEL_ALIASES
from eld_tpu_torch.noise.params import CAMERA_NAMES, SATURATION_DEFAULT, _select


class HostNoiseModel:
    def __init__(
        self,
        model: str = "g",
        cameras: Optional[Sequence[str]] = None,
        include: Optional[int] = None,
        exclude: Optional[int] = None,
        k_mode: str = "overridden",
        param_dir: Optional[str] = None,
        rng: Optional[onp.random.Generator] = None,
    ):
        self.model = MODEL_ALIASES.get(model, model)
        self.k_mode = k_mode
        self.cameras = _select(cameras or CAMERA_NAMES, include, exclude)
        self.rng = rng or onp.random.default_rng()
        self.camera_params = {
            name: onp.load(os.path.join(param_dir or CAMERA_PARAMS_DIR, f"{name}_params.npy"),
                           allow_pickle=True).item()
            for name in self.cameras
        }

    def _sample_params(self):
        rng = self.rng
        camera = self.cameras[rng.integers(len(self.cameras))]
        cp = self.camera_params[camera]
        prof = cp["Profile-1"]

        if self.k_mode == "overridden":
            log_K = rng.uniform(onp.log(1e-1), onp.log(30))
        elif self.k_mode == "calibrated":
            log_K = rng.uniform(onp.log(cp["Kmin"]), onp.log(cp["Kmax"]))
        else:
            raise ValueError(f"unknown k_mode {self.k_mode!r} "
                             "(use 'overridden' or 'calibrated')")

        def scale(key):
            p = prof[key]
            return onp.exp(rng.standard_normal() * p["sigma"] + p["slope"] * log_K + p["bias"])

        g_shape = onp.asarray(cp["G_shape"], onp.float32)
        cb = onp.asarray(cp["color_bias"], onp.float32)
        iso = int(rng.integers(min(len(g_shape), cb.shape[0])))
        return {
            "K": onp.exp(log_K),
            "g_scale": scale("g_scale"),
            "G_scale": scale("G_scale"),
            "R_scale": scale("R_scale"),
            "G_shape": float(g_shape[iso]),
            "color_bias": cb[iso],
            "saturation_level": SATURATION_DEFAULT,
            "ratio": rng.uniform(100, 300),
        }

    def __call__(self, y: onp.ndarray, params: Optional[dict] = None) -> onp.ndarray:
        """y: (H, W, C) clean packed raw in [0, 1]. Returns noisy (unclipped)."""
        p = params if params is not None else self._sample_params()
        rng = self.rng
        model = self.model

        y = y.astype(onp.float32) * p["saturation_level"] / p["ratio"]

        if "P" in model:
            z = rng.poisson(y / p["K"]).astype(onp.float32) * p["K"]
        elif "p" in model:
            z = y + rng.standard_normal(y.shape).astype(onp.float32) * onp.sqrt(
                onp.maximum(p["K"] * y, 1e-10))
        else:
            z = y.copy()

        if "g" in model:
            z = z + rng.standard_normal(y.shape).astype(onp.float32) * max(p["g_scale"], 1e-10)
        if "G" in model:
            lam = p["G_shape"]
            u = rng.uniform(1e-7, 1 - 1e-7, y.shape).astype(onp.float32)
            if abs(lam) < 1e-6:
                tl = onp.log(u) - onp.log1p(-u)
            else:
                tl = (u**lam - (1 - u) ** lam) / lam
            z = z + tl * max(p["G_scale"], 1e-10)
        if "r" in model:
            rows = rng.standard_normal((y.shape[0], 1, 2)).astype(onp.float32) * p["R_scale"]
            if y.shape[-1] == 4:
                z = z + onp.concatenate(
                    [rows[..., 0:1], rows[..., 0:1], rows[..., 1:2], rows[..., 1:2]], axis=-1)
            else:
                z = z + rows[..., 0:1]
        if "q" in model:
            z = z + rng.uniform(-0.5, 0.5, y.shape).astype(onp.float32)
        if "c" in model and y.shape[-1] == 4:
            # calibrated per Bayer channel; non-Bayer layouts skip it
            z = z + onp.asarray(p["color_bias"], onp.float32).reshape(1, 1, -1)

        return z * p["ratio"] / p["saturation_level"]
