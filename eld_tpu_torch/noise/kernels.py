"""The fused noise-synthesis kernel (CUDA C++ for Hopper), its wrapper and
its plain version.

``synthesize_kernel`` is the port of ``eld_tpu/noise/kernels.py::
synthesize_pallas``: the whole shot / read / row / quantization / bias
chain in one read and one write of the batch (``csrc/noise_synth.cu``).
On a CUDA tensor it launches the kernel on the current stream, or raises;
on a CPU tensor it runs the plain version, ``noise/model.py::synthesize``.

The kernel draws its random numbers from Philox4x32-10 keyed by the step
seed.  ``kernel_draws`` recomputes those same draws in PyTorch, so the
kernel can be held element by element against ``noise_core`` fed with
them (``chip_smoke.py`` does so on the card).
"""

from __future__ import annotations

import ctypes

import torch

from eld_tpu_torch import _build
from eld_tpu_torch.noise.model import expand_model, synthesize
from eld_tpu_torch.noise.params import NoiseParams

SOURCES = ("noise_synth.cu",)
SOURCE_PATH = "eld_tpu_torch/csrc/noise_synth.cu"
REPLACES = "eld_tpu/noise/kernels.py:182"
_COMPONENT_FLAGS = {"P": 1, "p": 2, "g": 4, "G": 8, "r": 16, "q": 32, "c": 64}
PARAM_STRIDE = 12
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def model_flags(model: str) -> int:
    """Component characters -> the kernel's model bitmask."""
    flags = 0
    for ch in expand_model(model):
        if ch not in _COMPONENT_FLAGS:
            raise ValueError(f"unknown noise component {ch!r} in model {model!r}")
        flags |= _COMPONENT_FLAGS[ch]
    return flags


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument types on a loaded build of the
    kernel's source (this one, or another with the same C interface)."""
    lib.eld_noise_synth.restype = ctypes.c_int
    lib.eld_noise_synth.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.eld_philox4x32_10.restype = None
    lib.eld_philox4x32_10.argtypes = [ctypes.c_void_p] * 3
    lib.eld_cuda_error_string.restype = ctypes.c_char_p
    lib.eld_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's shared library."""
    lib = _build.load("noise_synth", SOURCES)
    if not hasattr(lib, "_eld_bound"):
        bind(lib)
        lib._eld_bound = True
    return lib


def pack_params(params: NoiseParams, n: int) -> torch.Tensor:
    """Per-image parameter rows (n, 12): K g G lam R sat ratio cb0..cb3 0."""
    dev = params.K.device
    cols = [params.K, params.g_scale, params.G_scale, params.G_shape, params.R_scale,
            params.saturation_level, params.ratio]
    cols = [c.reshape(n, 1).float() for c in cols]
    cb = params.color_bias.reshape(n, -1)[:, :4].float()
    pad = torch.zeros((n, PARAM_STRIDE - len(cols) - cb.shape[1]), device=dev)
    return torch.cat(cols + [cb, pad], dim=1).contiguous()


def _check(clean: torch.Tensor, params: NoiseParams):
    if clean.dtype != torch.float32:
        raise TypeError(f"clean must be float32, got {clean.dtype}")
    # any C, as the TPU kernel: C == 4 is packed Bayer (row draw per channel
    # pair, color bias); any other C takes one row draw per packed row and
    # no bias (the kernel's scalar path)
    if clean.ndim != 4 or clean.shape[-1] < 1:
        raise ValueError(f"clean must be (N, H, W, C) with C >= 1, got {tuple(clean.shape)}")
    if not clean.is_contiguous():
        raise ValueError("clean must be contiguous (NHWC)")
    for name in ("K", "g_scale", "G_scale", "G_shape", "R_scale", "color_bias",
                 "saturation_level", "ratio"):
        t = getattr(params, name)
        if t.device != clean.device:
            raise ValueError(f"params.{name} is on {t.device}, clean on {clean.device}")
        if t.shape[0] != clean.shape[0]:
            raise ValueError(f"params.{name} has {t.shape[0]} rows for a batch of {clean.shape[0]}")


def launch(lib: ctypes.CDLL, seed: int, clean: torch.Tensor, params: NoiseParams,
           model: str, clip: bool) -> torch.Tensor:
    """One launch of ``lib``'s kernel on a CUDA tensor, on the current
    stream; raises if the launch fails.  Counts nothing: the count belongs
    to ``synthesize_kernel``, the entry point of the port."""
    flags = model_flags(model)
    n, h, w, c = clean.shape
    out = torch.empty_like(clean)
    packed = pack_params(params, n)
    with torch.cuda.device(clean.device):
        stream = torch.cuda.current_stream(clean.device).cuda_stream
        rc = lib.eld_noise_synth(clean.data_ptr(), out.data_ptr(), packed.data_ptr(),
                                 n, h, w, c, flags, int(bool(clip)), int(seed) & _MASK64, stream)
    if rc != 0:
        raise RuntimeError(f"noise_synth kernel launch failed: "
                           f"{lib.eld_cuda_error_string(rc).decode()} ({rc})")
    return out


def synthesize_kernel(seed: int, clean: torch.Tensor, params: NoiseParams,
                      model: str = "PGrqc", clip: bool = True) -> torch.Tensor:
    """Fused noise synthesis: clean (N, H, W, C) f32 + params (N,) -> noisy.

    ``seed`` is a 64-bit integer, distinct per step.  CUDA tensors launch
    the kernel (and count the launch in ``synthesize_kernel.launches``);
    CPU tensors run the plain version on a generator seeded with ``seed``.
    """
    _check(clean, params)
    seed = int(seed) & _MASK64
    if clean.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed)
        return synthesize(gen, clean, params, model=model, clip=clip)
    if clean.device.type != "cuda":
        raise ValueError(f"no noise kernel for device {clean.device}")
    out = launch(load_library(), seed, clean, params, model, clip)
    synthesize_kernel.launches += 1
    return out


synthesize_kernel.launches = 0


# ---- the kernel's random draws, recomputed in PyTorch -------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586


def _mulhilo(a: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of a * x for uint32 values held in int64,
    in 16-bit limbs so no intermediate overflows."""
    pl = a * (x & 0xFFFF)
    t = a * (x >> 16) + (pl >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (pl & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words; ``ctr`` is four
    tensors (or ints), ``key`` two ints.  Returns four tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def _u01(x: torch.Tensor) -> torch.Tensor:
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def _box_muller(u1, u2):
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-7)))
    th = _TWO_PI * u2
    return r * torch.cos(th), r * torch.sin(th)


def kernel_draws(seed: int, shape, model: str, device="cpu"):
    """The draws the kernel makes for ``seed``, in ``noise_core``'s layout."""
    model = expand_model(model)
    n, h, w, c = shape
    seed = int(seed) & _MASK64
    key = (seed & _MASK32, seed >> 32)
    idx = torch.arange(n * h * w * c, device=device, dtype=torch.int64)
    lo, hi = idx & _MASK32, idx >> 32
    zero = torch.zeros_like(idx)
    a = [_u01(x).reshape(shape) for x in philox4x32_10((lo, hi, zero, zero), key)]
    shot_cos, shot_sin = _box_muller(a[0], a[1])
    draws = {}
    if "P" in model:
        draws["poisson_u"] = torch.clamp_min(a[0], 1e-12)
        draws["shot_n"] = shot_cos
    elif "p" in model:
        draws["shot_n"] = shot_cos
    if "g" in model:
        if "P" in model:
            b = philox4x32_10((lo, hi, zero + 1, zero), key)
            draws["read_n"] = _box_muller(_u01(b[0]), _u01(b[1]))[0].reshape(shape)
        elif "p" in model:
            draws["read_n"] = shot_sin
        else:
            draws["read_n"] = shot_cos
    if "G" in model:
        draws["tukey_u"] = a[2].clamp(1e-7, 0.9999999)
    if "r" in model:
        rows = torch.arange(n * h, device=device, dtype=torch.int64)
        rz = torch.zeros_like(rows)
        r = philox4x32_10((rows & _MASK32, rows >> 32, rz + 2, rz), key)
        even, odd = _box_muller(_u01(r[0]), _u01(r[1]))
        draws["row_n"] = torch.stack([even, odd], dim=-1).reshape(n, h, 2)
    if "q" in model:
        draws["quant_u"] = a[3] - 0.5
    return draws
