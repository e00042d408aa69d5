"""SID-style 5-level U-Net denoiser as a ``torch.nn.Module``.

Counterpart of ``eld_tpu/models/unet.py`` and of the reference's
``models/arch/Unet.py``: two 3x3 convs + LeakyReLU(0.2) per level,
encoder widths w..16w with 2x2 max-pooling, 2x2 stride-2 transposed-conv
upsampling with skip concatenation, a 1x1 output conv; 7,760,484
parameters at w = 32, 4 -> 4 channels.

Parameters carry the reference's names (``conv1_1`` ... ``conv10_1``,
``upv6`` ... ``upv9``) in torch's OIHW / IOHW layout, so a reference
``.pt`` loads with ``load_state_dict``, and torch's default init is the
reference's init.  ``forward`` takes and returns NHWC like the Flax
model; inside, ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
a ``channels_last`` NCHW view, which cuDNN takes without a copy.

Each 3x3 convolution runs without its bias; the bias, the `split`
decoder's sum and LeakyReLU follow as one epilogue, one hand-written
kernel each way on the card (``models/epilogue.py``).  The parameters
and their names stay the reference's.

The options of the Flax model are kept, each an exact re-parameterization
of the same weights except ``skip_dtype``:
  * ``skip_mode="split"``: the decoder's first conv runs as two convs over
    the two halves of its kernel, so the concatenated tensor is never
    materialized;
  * ``upsample="d2s"``: the transposed conv as a 1x1 conv to 4x channels
    followed by depth-to-space (``pixel_shuffle``);
  * ``remat``: each level under ``torch.utils.checkpoint`` in training;
  * ``skip_dtype``: the encoder skips stored in a narrower dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eld_tpu_torch.models.epilogue import LIBRARY as _EPILOGUE, bias_lrelu


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, C*b*b), channel order (di, dj, c) as
    eld_tpu's (``pixel_unshuffle`` would give (c, di, dj))."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block, c * block * block)


def depth_to_space(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C*b*b) -> (N, H*b, W*b, C), channel order (di, dj, c)."""
    n, h, w, cbb = x.shape
    c = cbb // (block * block)
    x = x.reshape(n, h, w, block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * block, w * block, c)


def _conv3x3(x, weight):
    """A 3x3 convolution without its bias, on the channels_last view of
    ``x`` (a copy only where ``x`` is not already one), so that the output
    is dense NHWC, as ``bias_lrelu``'s kernel takes it."""
    return F.conv2d(x.contiguous(memory_format=torch.channels_last), weight, None, padding=1)


def _conv_pair(x, c1: nn.Conv2d, c2: nn.Conv2d):
    y = bias_lrelu(_conv3x3(x, c1.weight), c1.bias)
    return bias_lrelu(_conv3x3(y, c2.weight), c2.bias)


def _split_conv_pair(up, skip, c1: nn.Conv2d, c2: nn.Conv2d):
    """conv(cat([up, skip])) == conv_a(up) + conv_b(skip), kernel sliced on
    its input channels — exact up to summation order; the sum is part of
    the epilogue."""
    ca = up.shape[1]
    y = bias_lrelu(_conv3x3(up, c1.weight[:, :ca]), c1.bias, _conv3x3(skip, c1.weight[:, ca:]))
    return bias_lrelu(_conv3x3(y, c2.weight), c2.bias)


def _d2s_upsample(x, up: nn.ConvTranspose2d):
    """2x2/stride-2 transposed conv as a 1x1 conv + depth-to-space.

    torch's ConvTranspose2d with kernel == stride has no overlapping taps:
    y[n, o, 2i+di, 2j+dj] = sum_c x[n, c, i, j] W[c, o, di, dj] + b[o];
    pixel_shuffle reads channel o*4 + di*2 + dj, hence the (o, di, dj)
    order of the 1x1 kernel."""
    w = up.weight  # (in, out, 2, 2)
    k = w.permute(1, 2, 3, 0).reshape(w.shape[1] * 4, w.shape[0], 1, 1)
    z = F.pixel_shuffle(F.conv2d(x, k), 2)
    return z + up.bias.reshape(1, -1, 1, 1)


class UNetSeeInDark(nn.Module):
    KERNEL_LIBRARIES = (_EPILOGUE,)  # the libraries its card path launches

    def __init__(self, in_channels: int = 4, out_channels: int = 4, base_width: int = 32,
                 remat: bool = False, skip_mode: str = "concat", upsample: str = "convt",
                 skip_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if skip_mode not in ("concat", "split"):
            raise ValueError(f"skip_mode must be 'concat' or 'split', got {skip_mode!r}")
        if upsample not in ("convt", "d2s"):
            raise ValueError(f"upsample must be 'convt' or 'd2s', got {upsample!r}")
        self.remat = remat
        self.skip_mode = skip_mode
        self.upsample = upsample
        self.skip_dtype = skip_dtype
        w = base_width
        widths = [w, 2 * w, 4 * w, 8 * w, 16 * w]
        prev = in_channels
        for lvl, width in enumerate(widths, start=1):
            setattr(self, f"conv{lvl}_1", nn.Conv2d(prev, width, 3, padding=1))
            setattr(self, f"conv{lvl}_2", nn.Conv2d(width, width, 3, padding=1))
            prev = width
        for lvl, width in zip(range(6, 10), widths[3::-1]):
            setattr(self, f"upv{lvl}", nn.ConvTranspose2d(2 * width, width, 2, stride=2))
            setattr(self, f"conv{lvl}_1", nn.Conv2d(2 * width, width, 3, padding=1))
            setattr(self, f"conv{lvl}_2", nn.Conv2d(width, width, 3, padding=1))
        self.conv10_1 = nn.Conv2d(w, out_channels, 1)

    def _run(self, fn, *args):
        if self.remat and self.training and torch.is_grad_enabled():
            # the U-Net draws no random numbers, so there is no RNG state to
            # replay in the recompute (and reading it breaks CUDA graph capture)
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C_in) with H, W multiples of 16 -> (N, H, W, C_out)."""
        in_dtype = x.dtype
        t = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
        skips = []
        for lvl in range(1, 6):
            t = self._run(_conv_pair, t, getattr(self, f"conv{lvl}_1"),
                          getattr(self, f"conv{lvl}_2"))
            if lvl < 5:
                skips.append(t if self.skip_dtype is None else t.to(self.skip_dtype))
                t = F.max_pool2d(t, 2)
        for lvl in range(6, 10):
            up = getattr(self, f"upv{lvl}")
            t = _d2s_upsample(t, up) if self.upsample == "d2s" else up(t)
            skip = skips[9 - lvl].to(t.dtype)
            c1, c2 = getattr(self, f"conv{lvl}_1"), getattr(self, f"conv{lvl}_2")
            if self.skip_mode == "split":
                t = self._run(_split_conv_pair, t, skip, c1, c2)
            else:
                t = self._run(_conv_pair, torch.cat([t, skip], dim=1), c1, c2)
        out = self.conv10_1(t)
        return out.permute(0, 2, 3, 1).to(in_dtype)

    @staticmethod
    def alignment() -> int:
        """Spatial alignment required by the 4 pooling levels (16 px)."""
        return 16
