"""The epilogue of the U-Net's 3x3 convolutions as one hand-written kernel
each way (``csrc/conv_epilogue.cu``), its wrapper and its plain version.

``bias_lrelu(z, bias, z2=None)`` is ``leaky_relu(z [+ z2] + bias, 0.2)``
for convolution outputs ``z`` (and ``z2``, the `split` decoder's second
half) computed without their bias: the sum and the activation in f32,
rounded once to ``z``'s dtype.  ``bias`` is the f32 parameter as it is,
with no autocast cast.  Its gradient: ``gz = gy * (y > 0 ? 1 : 0.2)`` in
``gy``'s dtype, the same for ``z2``, and ``gbias`` the f32 sum of the f32
``gz`` over N, H and W.  The backward reads only ``y``, the tensor the next
convolution keeps for its own backward anyway, so the pre-activation is
not kept.

On a CUDA tensor one kernel runs each way (the backward's bias sum is a
second, small kernel; no float atomics, so the same shape on the same card
gives the same bits), or the wrapper raises: z (and z2) must be bf16 or
f32 and dense NHWC (the ``channels_last`` view of the conv's output).  On
a CPU tensor the plain version runs the same formulas in PyTorch ops.
Each way is one operator of the dispatcher (``eld_tpu_torch::bias_lrelu``
and ``eld_tpu_torch::lrelu_bias_backward``), so ``torch.export`` records
the call, and a served artifact runs the kernel on the card too.  Under
``no_grad`` or ``inference_mode`` nothing is saved.

``bias_lrelu.launches`` counts one per forward and one per backward run on
the card (a replayed CUDA graph adds its own, ``_build.counted``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from eld_tpu_torch import _build

SLOPE = 0.2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = {}  # by card index

_p, _i64, _i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = _build.Library("conv_epilogue", ("conv_epilogue.cu",), {
    "eld_bias_lrelu_fwd": (_i, [_p, _p, _p, _p, _i64, _i, _i, _i, _p]),
    "eld_lrelu_bias_bwd": (_i, [_p, _p, _p, _p, _p, _i64, _i, _i, _i, _p]),
    "eld_epilogue_blocks_per_sm": (_i, []),
}, "eld_epilogue_error_string")


# ---- the plain version -------------------------------------------------------

def plain_forward(z: torch.Tensor, bias: torch.Tensor,
                  z2: Optional[torch.Tensor] = None) -> torch.Tensor:
    t = z.float() if z2 is None else z.float() + z2.float()
    return F.leaky_relu(t + bias.float().reshape(1, -1, 1, 1), SLOPE).to(z.dtype)


def plain_backward(gy: torch.Tensor, y: torch.Tensor):
    """(gz in gy's dtype, gbias in f32)."""
    g = gy.float()
    gz = torch.where(y > 0, g, g * SLOPE)
    return gz.to(gy.dtype), gz.sum((0, 2, 3))


# ---- the kernels ---------------------------------------------------------------

def _max_blocks(lib: ctypes.CDLL, device: torch.device) -> int:
    """One wave of the kernels' blocks on ``device``: the rows of the
    backward's workspace."""
    blocks = _MAX_BLOCKS.get(device.index)
    if blocks is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = _MAX_BLOCKS[device.index] = sms * lib.eld_epilogue_blocks_per_sm()
    return blocks


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_forward(lib: ctypes.CDLL, z: torch.Tensor, bias: torch.Tensor,
                   z2: Optional[torch.Tensor]) -> torch.Tensor:
    """One forward launch on the current stream.  Counts nothing."""
    n, c, h, w = z.shape
    y = torch.empty_like(z, memory_format=torch.channels_last)
    b = bias.float().contiguous()
    with torch.cuda.device(z.device):
        rc = lib.eld_bias_lrelu_fwd(z.data_ptr(), None if z2 is None else z2.data_ptr(),
                                    b.data_ptr(), y.data_ptr(), n * h * w, c,
                                    _DTYPES[z.dtype], _max_blocks(lib, z.device), _stream(z))
    LIBRARY.check(lib, rc, "forward")
    return y


def launch_backward(lib: ctypes.CDLL, gy: torch.Tensor, y: torch.Tensor):
    """One backward run (two launches) on the current stream: (gz, gbias).
    Counts nothing."""
    n, c, h, w = y.shape
    if gy.shape != y.shape or gy.dtype != y.dtype:
        raise ValueError(f"gy must match y: {tuple(gy.shape)} {gy.dtype} against "
                         f"{tuple(y.shape)} {y.dtype}")
    gy = gy.contiguous(memory_format=torch.channels_last)
    gz = torch.empty_like(y, memory_format=torch.channels_last)
    gbias = torch.empty(c, dtype=torch.float32, device=y.device)
    blocks = _max_blocks(lib, y.device)
    partial = torch.empty((blocks, c), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.eld_lrelu_bias_bwd(gy.data_ptr(), y.data_ptr(), gz.data_ptr(),
                                    partial.data_ptr(), gbias.data_ptr(), n * h * w, c,
                                    _DTYPES[y.dtype], blocks, _stream(y))
    LIBRARY.check(lib, rc, "backward")
    return gz, gbias


def _check(z: torch.Tensor, bias: torch.Tensor, z2: Optional[torch.Tensor]):
    if z.ndim != 4:
        raise ValueError(f"z must be (N, C, H, W), got {tuple(z.shape)}")
    if bias.shape != (z.shape[1],):
        raise ValueError(f"bias must be ({z.shape[1]},) for z of {z.shape[1]} channels, "
                         f"got {tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, z.dtype):
        raise TypeError(f"bias must be float32 (or z's {z.dtype}), got {bias.dtype}")
    if bias.device != z.device:
        raise ValueError(f"bias is on {bias.device}, z on {z.device}")
    if z2 is not None and (z2.shape != z.shape or z2.dtype != z.dtype
                           or z2.device != z.device):
        raise ValueError(f"z2 must match z: {tuple(z2.shape)} {z2.dtype} on {z2.device} "
                         f"against {tuple(z.shape)} {z.dtype} on {z.device}")


def _check_card(z: torch.Tensor, z2: Optional[torch.Tensor]):
    if z.dtype not in _DTYPES:
        raise TypeError(f"the conv epilogue kernel takes float32 or bfloat16, got {z.dtype}")
    for name, t in (("z", z), ("z2", z2)):
        if t is not None and not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be dense NHWC (channels_last), got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


# ---- the two operators ------------------------------------------------------------
# Registered with the dispatcher so that ``torch.export`` records each call
# as one node, and a served artifact runs the kernel where the tensors are
# on the card, as the model does.

@torch.library.custom_op("eld_tpu_torch::bias_lrelu", mutates_args=())
def _forward(z: torch.Tensor, bias: torch.Tensor, z2: Optional[torch.Tensor]) -> torch.Tensor:
    if z.device.type == "cpu":
        return plain_forward(z, bias, z2)
    if z.device.type != "cuda":
        raise ValueError(f"no conv epilogue kernel for device {z.device}")
    _check_card(z, z2)
    y = launch_forward(LIBRARY.load(), z, bias, z2)
    bias_lrelu.launches += 1
    return y


@_forward.register_fake
def _(z, bias, z2):
    return torch.empty_like(z)


@torch.library.custom_op("eld_tpu_torch::lrelu_bias_backward", mutates_args=())
def _backward(gy: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if y.device.type == "cpu":
        return plain_backward(gy, y)
    gz, gbias = launch_backward(LIBRARY.load(), gy, y)
    bias_lrelu.launches += 1
    return gz, gbias


@_backward.register_fake
def _(gy, y):
    return torch.empty_like(gy), gy.new_empty((y.shape[1],), dtype=torch.float32)


def _save_y(ctx, inputs, output):
    ctx.save_for_backward(output)
    ctx.split = inputs[2] is not None


def _gradients(ctx, gy):
    (y,) = ctx.saved_tensors
    gz, gbias = _backward(gy, y)
    return gz, gbias, gz if ctx.split else None


_forward.register_autograd(_gradients, setup_context=_save_y)


@_build.counted
def bias_lrelu(z: torch.Tensor, bias: torch.Tensor,
               z2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``leaky_relu(z [+ z2] + bias, 0.2)`` over (N, C, H, W) convolution
    outputs without their bias, one pass each way on the card."""
    _check(z, bias, z2)
    return _forward(z, bias, z2)
