"""Restormer's BiasFree LayerNorm as one hand-written kernel each way
(``csrc/layernorm.cu``), its wrapper and its plain version.

``biasfree_layernorm(x, weight)`` normalises each pixel of an (N, C, H, W)
tensor over its C channels without centring it:

    y = x / sqrt(var_c(x) + 1e-5) * weight,   var biased (``unbiased=False``),

in f32 and rounded once to ``x``'s dtype.  Under bf16 autocast that is the
rounding the next 1x1 conv's cast applied to the f32 norm before, so the
step's arithmetic is unchanged.  Its gradient, with m the channel mean and
r = 1 / sqrt(var + 1e-5):

    gx = r · w · gy - (r³ / C) · (x - m) · Σ_c(gy · w · x)   (x's dtype),
    gw = Σ_{N, H, W}(gy · x · r)                              (f32).

The backward keeps only ``x`` and recomputes m and r from it.

On a card (bf16 or f32 ``x``, C a multiple of 8 and a pixel of at most
2 KiB: 1024 bf16 or 512 f32 channels) the forward is one pass that reads x
once and writes y once, the backward one pass that reads x and gy and
writes gx, plus a small kernel that adds the weight gradient's per-block
rows in a fixed order (no float atomics: the same shape on the same card
gives the same bits).  Any other card tensor is
refused with a ``ValueError``.  On the CPU the plain version runs:
``plain_forward``, the formula the model ran before, in PyTorch ops, and
``plain_backward``, the kernel's algebra in PyTorch ops.  Each way is one
operator of the dispatcher (``eld_tpu_torch::biasfree_layernorm`` and
``eld_tpu_torch::biasfree_layernorm_backward``), so ``torch.export``
records the call and a served artifact runs the kernel on a card.

``biasfree_layernorm.launches`` counts one per forward and one per backward
run on the card (a replayed CUDA graph adds its own, ``_build.counted``).
The kernels are named ``bfln_fwd``, ``bfln_bwd`` and
``bfln_wsum``, so a trace reader finds them inside a replayed graph.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from eld_tpu_torch import _build

EPS = 1e-5
CHANNEL_MULTIPLE = 8  # the channels the kernels take: a multiple of this ...
MAX_PIXEL_BYTES = 2048  # ... in a pixel of at most this (csrc/layernorm.cu's kMaxChunks)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_p, _i64, _i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = _build.Library("layernorm", ("layernorm.cu",), {
    "eld_bfln_blocks": (_i, [_i64, _i, _i, _i, ctypes.POINTER(_i)]),
    "eld_bfln_fwd": (_i, [_p, _p, _p, _i64, _i, _i, _i, _p]),
    "eld_bfln_bwd": (_i, [_p, _p, _p, _p, _p, _p, _i64, _i, _i, _i, _p]),
}, "eld_bfln_error_string")


# ---- the plain version -------------------------------------------------------

def plain_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The composition the model ran before, rounded to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x / torch.sqrt(var + EPS) * weight.reshape(1, -1, 1, 1)).to(dtype)


def plain_backward(gy: torch.Tensor, x: torch.Tensor,
                   weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx in ``x``'s dtype, gw in f32), by the kernels' algebra."""
    xf, g = x.float(), gy.float()
    centred = xf - xf.mean(1, keepdim=True)
    r = 1 / torch.sqrt(centred.square().mean(1, keepdim=True) + EPS)
    gw_y = g * weight.float().reshape(1, -1, 1, 1)
    dot = (gw_y * xf).sum(1, keepdim=True)
    gx = r * gw_y - r ** 3 / x.shape[1] * centred * dot
    return gx.to(x.dtype), (g * xf * r).sum((0, 2, 3))


# ---- the kernels ---------------------------------------------------------------

def on_card(x: torch.Tensor) -> bool:
    """True where the kernels run ``x``, False for a CPU tensor (the plain
    version); a ``ValueError`` for a card tensor they do not take."""
    if x.device.type == "cpu":
        return False
    c = x.shape[1]
    if (x.device.type != "cuda" or x.dtype not in _DTYPES or c % CHANNEL_MULTIPLE
            or c * x.dtype.itemsize > MAX_PIXEL_BYTES):
        raise ValueError(
            f"the BiasFree LayerNorm kernels take float32 or bfloat16 x on a card with a "
            f"multiple of {CHANNEL_MULTIPLE} channels, at most {MAX_PIXEL_BYTES} bytes a pixel; "
            f"got {x.dtype} with {c} channels on {x.device}")
    return True


def _dense(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as dense NHWC (no copy where it is), on a 16-byte boundary."""
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % 16:
        raise ValueError(f"the BiasFree LayerNorm kernels take tensors on 16-byte boundaries; "
                         f"{name} starts at {t.data_ptr():#x}")
    return t


def _blocks(lib: ctypes.CDLL, pixels: int, c: int, dtype: int, backward: bool) -> int:
    blocks = ctypes.c_int(0)
    rc = lib.eld_bfln_blocks(pixels, c, dtype, int(backward), ctypes.byref(blocks))
    LIBRARY.check(lib, rc, "grid")
    return blocks.value


def launch_forward(lib: ctypes.CDLL, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One forward launch on the current stream.  Counts nothing."""
    n, c, h, w = x.shape
    x = _dense("x", x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    wf = weight.float().contiguous()
    dtype = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        blocks = _blocks(lib, n * h * w, c, dtype, False)
        rc = lib.eld_bfln_fwd(x.data_ptr(), wf.data_ptr(), y.data_ptr(), n * h * w, c, dtype,
                              blocks, torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(lib, rc, "forward")
    return y


def launch_backward(lib: ctypes.CDLL, gy: torch.Tensor, x: torch.Tensor,
                    weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One backward run (two launches) on the current stream: (gx, gw).
    Counts nothing."""
    n, c, h, w = x.shape
    if gy.shape != x.shape:
        raise ValueError(f"gy must be {tuple(x.shape)}, got {tuple(gy.shape)}")
    x, gy = _dense("x", x), _dense("gy", gy.to(x.dtype))
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    wf = weight.float().contiguous()
    gw = torch.empty(c, dtype=torch.float32, device=x.device)
    dtype = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        blocks = _blocks(lib, n * h * w, c, dtype, True)
        partial = torch.empty((blocks, c), dtype=torch.float32, device=x.device)
        rc = lib.eld_bfln_bwd(x.data_ptr(), gy.data_ptr(), wf.data_ptr(), gx.data_ptr(),
                              partial.data_ptr(), gw.data_ptr(), n * h * w, c, dtype, blocks,
                              torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(lib, rc, "backward")
    return gx, gw


def _check(x: torch.Tensor, weight: torch.Tensor):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if weight.shape != (x.shape[1],):
        raise ValueError(f"weight must be ({x.shape[1]},) for x of {x.shape[1]} channels, "
                         f"got {tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError(f"weight is on {weight.device}, x on {x.device}")


# ---- the two operators ------------------------------------------------------------

@torch.library.custom_op("eld_tpu_torch::biasfree_layernorm", mutates_args=())
def _forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    if not on_card(x):
        with torch.autocast(x.device.type, enabled=False):  # f32 inside, also under autocast
            return plain_forward(x, weight)
    y = launch_forward(LIBRARY.load(), x, weight)
    biasfree_layernorm.launches += 1
    return y


@_forward.register_fake
def _(x, weight):
    return torch.empty_like(x)


@torch.library.custom_op("eld_tpu_torch::biasfree_layernorm_backward", mutates_args=())
def _backward(gy: torch.Tensor, x: torch.Tensor,
              weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not on_card(x):
        with torch.autocast(x.device.type, enabled=False):
            return plain_backward(gy, x, weight)
    gx, gw = launch_backward(LIBRARY.load(), gy, x, weight)
    biasfree_layernorm.launches += 1
    return gx, gw


@_backward.register_fake
def _(gy, x, weight):
    return torch.empty_like(x), x.new_empty((x.shape[1],), dtype=torch.float32)


def _save_x(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _gradients(ctx, gy):
    x, weight = ctx.saved_tensors
    gx, gw = _backward(gy, x, weight)
    return gx, gw.to(weight.dtype)


_forward.register_autograd(_gradients, setup_context=_save_x)


@_build.counted
def biasfree_layernorm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The BiasFree LayerNorm over the channels of (N, C, H, W) ``x`` with the
    (C,) ``weight``: (N, C, H, W) in ``x``'s dtype, one pass each way on the
    card."""
    _check(x, weight)
    return _forward(x, weight)
