"""The 3x3 depthwise convolutions of Restormer and of Uformer's LeFF as one
hand-written kernel each way (``csrc/dwconv.cu``), its wrapper and its
plain version.

``depthwise_conv3x3(x, conv)`` runs ``conv``, an ``nn.Conv2d`` of C
groups over C channels with a 3x3 kernel, padding 1, stride 1 and an
optional bias (Restormer's ``qkv_dwconv`` and ``dwconv`` have none,
Uformer's LeFF ``dwconv`` one), on (N, C, H, W) ``x``:

    y = F.conv2d(x, k, b, padding=1, groups=C),   k = conv.weight, (C, 1, 3, 3),

with k and b rounded to ``x``'s dtype, as bf16 autocast rounded them for
cuDNN, and f32 sums (the bias added last) rounded once to ``x``'s dtype.
Its gradient, with taps d of the 3x3 window:

    gx(q)    = Σ_d gy(q - d) · k[d]            (x's dtype; the flipped stencil),
    gw[c, d] = Σ_q x(q) · gy(q - d)            (f32),
    gb[c]    = Σ_q gy(q)                       (f32, with a bias),

all from one window of gy around each pixel q, so the backward is one pass
over x and gy.  The backward keeps only ``x`` and the weight.

On a card (bf16 ``x``, C even) the forward is one pass that reads x once and
writes y once, the backward one pass that reads x and gy and writes gx, plus
a small kernel that adds the weight gradient's per-block rows in a fixed
order (no float atomics: the same shape on the same card gives the same
bits).  The kernels plan their tiles from the C, H and W they are given.
Any other card tensor is refused with a ``ValueError``, as is, on any
device, a ``conv`` that is not this function (another kernel size, padding,
stride, dilation or group count, or a weight or bias on another device).
On the CPU the plain version runs: ``plain_forward``, ``F.conv2d`` in
``x``'s dtype, and ``plain_backward``, the kernels' algebra in PyTorch
ops.  Each way is one operator of the dispatcher (``eld_tpu_torch::depthwise_conv3x3`` and
``eld_tpu_torch::depthwise_conv3x3_backward``), so ``torch.export`` records
the call and a served artifact runs the kernel on a card.

``depthwise_conv3x3.launches`` counts one per forward and one per backward
run on the card (a replayed CUDA graph adds its own, ``_build.counted``).
The kernels are named ``dwconv3_fwd``, ``dwconv3_bwd`` and
``dwconv3_wsum``, so a trace reader finds them inside a replayed graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eld_tpu_torch import _build

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = _build.Library("dwconv", ("dwconv.cu",), {
    "eld_dwconv3_plan": (_i, [_i, _i, _i, _i, _i, ctypes.POINTER(_i), ctypes.POINTER(_i)]),
    "eld_dwconv3_fwd": (_i, [_p, _p, _p, _p, _i, _i, _i, _i, _i, _p]),
    "eld_dwconv3_bwd": (_i, [_p] * 8 + [_i, _i, _i, _i, _i, _p]),
}, "eld_dwconv3_error_string")
TAPS = 9


# ---- the plain version -------------------------------------------------------

def plain_forward(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d`` in ``x``'s dtype, dense channels-last."""
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(x, weight.to(x.dtype), b, padding=1, groups=x.shape[1])
    return y.contiguous(memory_format=torch.channels_last)


def plain_backward(gy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                   with_bias: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx in ``x``'s dtype, dense channels-last; gw in f32; gb in f32, or
    an empty tensor without a bias), by the kernels' algebra."""
    c, (h, w) = x.shape[1], x.shape[2:]
    g, xf = gy.float(), x.float()
    k = weight.to(x.dtype).float()
    gx = F.conv2d(g, k.flip((2, 3)), padding=1, groups=c)
    padded = F.pad(g, (1, 1, 1, 1))  # tap (i, j) reads gy(q - d), d = (i - 1, j - 1)
    gw = torch.stack([(xf * padded[:, :, 2 - i:2 - i + h, 2 - j:2 - j + w]).sum((0, 2, 3))
                      for i in range(3) for j in range(3)], 1)
    gb = g.sum((0, 2, 3)) if with_bias else g.new_empty((0,))
    return (gx.to(x.dtype).contiguous(memory_format=torch.channels_last),
            gw.reshape(c, 1, 3, 3), gb)


# ---- the kernels ---------------------------------------------------------------

def on_card(x: torch.Tensor) -> bool:
    """True where the kernels run ``x``, False for a CPU tensor (the plain
    version); a ``ValueError`` for a card tensor they do not take."""
    if x.device.type == "cpu":
        return False
    c = x.shape[1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or c % 2:
        raise ValueError(f"the depthwise 3x3 kernels take bfloat16 x on a card with an even "
                         f"number of channels; got {x.dtype} with {c} channels on {x.device}")
    return True


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as dense NHWC on a 16-byte boundary (the kernels read it in
    16-byte pieces), copied only where it is not."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t.clone(memory_format=torch.channels_last) if t.data_ptr() % 16 else t


def _plan(lib: ctypes.CDLL, shape, backward: bool) -> Tuple[int, int]:
    """(pixel rows a band, tiles): the kernels' plan for (N, C, H, W)."""
    n, c, h, w = shape
    rows, tiles = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.eld_dwconv3_plan(n, h, w, c, int(backward), ctypes.byref(rows), ctypes.byref(tiles))
    LIBRARY.check(lib, rc, "plan")
    return rows.value, tiles.value


def launch_forward(lib: ctypes.CDLL, x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One forward launch on the current stream.  Counts nothing."""
    n, c, h, w = x.shape
    x = _dense(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    wf = weight.float().contiguous()
    bf = None if bias is None else bias.float().contiguous()
    with torch.cuda.device(x.device):
        rows, _ = _plan(lib, x.shape, False)
        rc = lib.eld_dwconv3_fwd(x.data_ptr(), wf.data_ptr(), None if bf is None else bf.data_ptr(),
                                 y.data_ptr(), n, h, w, c, rows,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(lib, rc, "forward")
    return y


def launch_backward(lib: ctypes.CDLL, gy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                    with_bias: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward run (two launches, three with a bias) on the current
    stream: (gx, gw, gb or an empty tensor).  Counts nothing."""
    n, c, h, w = x.shape
    if gy.shape != x.shape:
        raise ValueError(f"gy must be {tuple(x.shape)}, got {tuple(gy.shape)}")
    x, gy = _dense(x), _dense(gy.to(x.dtype))
    f32 = dict(dtype=torch.float32, device=x.device)
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    wf = weight.float().contiguous()
    gw = torch.empty((c, 1, 3, 3), **f32)
    gb = torch.empty((c,) if with_bias else (0,), **f32)
    with torch.cuda.device(x.device):
        rows, tiles = _plan(lib, x.shape, True)
        partial = torch.empty((tiles, c * TAPS), **f32)
        partial_b = torch.empty((tiles, c), **f32) if with_bias else None
        rc = lib.eld_dwconv3_bwd(x.data_ptr(), gy.data_ptr(), wf.data_ptr(), gx.data_ptr(),
                                 partial.data_ptr(), gw.data_ptr(),
                                 None if partial_b is None else partial_b.data_ptr(),
                                 gb.data_ptr() if with_bias else None, n, h, w, c, rows,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(lib, rc, "backward")
    return gx, gw, gb


def _check(x: torch.Tensor, conv: nn.Conv2d):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    got = dict(in_channels=conv.in_channels, out_channels=conv.out_channels,
               groups=conv.groups, kernel_size=conv.kernel_size, padding=conv.padding,
               stride=conv.stride, dilation=conv.dilation, padding_mode=conv.padding_mode)
    want = dict(in_channels=c, out_channels=c, groups=c, kernel_size=(3, 3), padding=(1, 1),
                stride=(1, 1), dilation=(1, 1), padding_mode="zeros")
    wrong = {k: v for k, v in got.items() if v != want[k]}
    if wrong:
        raise ValueError(f"the depthwise 3x3 convolution of {c} channels needs "
                         f"{ {k: want[k] for k in wrong} }, got {wrong}")
    for name, t in (("weight", conv.weight), ("bias", conv.bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"the {name} is on {t.device}, x on {x.device}")


# ---- the two operators ------------------------------------------------------------

@torch.library.custom_op("eld_tpu_torch::depthwise_conv3x3", mutates_args=())
def _forward(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if not on_card(x):
        with torch.autocast(x.device.type, enabled=False):  # x's dtype, also under autocast
            return plain_forward(x, weight, bias)
    y = launch_forward(LIBRARY.load(), x, weight, bias)
    depthwise_conv3x3.launches += 1
    return y


@_forward.register_fake
def _(x, weight, bias):
    return torch.empty_like(x, memory_format=torch.channels_last)


@torch.library.custom_op("eld_tpu_torch::depthwise_conv3x3_backward", mutates_args=())
def _backward(gy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
              with_bias: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not on_card(x):
        with torch.autocast(x.device.type, enabled=False):
            return plain_backward(gy, x, weight, with_bias)
    grads = launch_backward(LIBRARY.load(), gy, x, weight, with_bias)
    depthwise_conv3x3.launches += 1
    return grads


@_backward.register_fake
def _(gy, x, weight, with_bias):
    return (torch.empty_like(x, memory_format=torch.channels_last),
            x.new_empty(weight.shape, dtype=torch.float32),
            x.new_empty((x.shape[1] if with_bias else 0,), dtype=torch.float32))


def _save_x(ctx, inputs, output):
    x, weight, bias = inputs
    ctx.save_for_backward(x, weight)
    ctx.bias_dtype = None if bias is None else bias.dtype


def _gradients(ctx, gy):
    x, weight = ctx.saved_tensors
    with_bias = ctx.bias_dtype is not None
    gx, gw, gb = _backward(gy, x, weight, with_bias)
    return gx, gw.to(weight.dtype), gb.to(ctx.bias_dtype) if with_bias else None


_forward.register_autograd(_gradients, setup_context=_save_x)


@_build.counted
def depthwise_conv3x3(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv``, a 3x3 depthwise ``nn.Conv2d`` (padding 1, stride 1, with
    or without a bias), on (N, C, H, W) ``x``: (N, C, H, W) in ``x``'s
    dtype, dense channels-last, one pass each way on the card."""
    _check(x, conv)
    return _forward(x, conv.weight, conv.bias)
