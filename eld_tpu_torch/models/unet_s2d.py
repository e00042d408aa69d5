"""Space-to-depth U-Net variant (counterpart of ``eld_tpu/models/unet_s2d.py``).

Each ``block`` x ``block`` spatial cell is moved into channels before the
U-Net and moved back after it, so every conv runs one pyramid level lower
with ``block**2`` times the channels.  The channel order is eld_tpu's
(di, dj, c) (``models/unet.py::space_to_depth``), so a Flax ``unet_s2d``
checkpoint carries across through ``compat/jax_params.py`` unchanged:
the inner network has the same parameter names as ``unet``.
"""

from __future__ import annotations

import torch

from eld_tpu_torch.models.unet import UNetSeeInDark, depth_to_space, space_to_depth


class UNetS2D(UNetSeeInDark):
    """The SID U-Net in space-to-depth coordinates; NHWC in and out."""

    def __init__(self, in_channels: int = 16, out_channels: int = 16, block: int = 2, **kw):
        super().__init__(in_channels=in_channels, out_channels=out_channels, **kw)
        self.block = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(super().forward(space_to_depth(x, self.block)), self.block)

    def alignment(self) -> int:
        """The U-Net's 16 px in block-reduced coordinates: 32 for block 2.
        eld_tpu's staticmethod returns 32 for block 4 too, which leaves the
        block-4 decoder with frames it cannot concatenate; here it is 64."""
        return 16 * self.block


def unet_s2d(in_channels: int = 4, out_channels: int = 4, block: int = 2, **kw) -> UNetS2D:
    b2 = block * block
    return UNetS2D(in_channels=in_channels * b2, out_channels=out_channels * b2, block=block,
                   **kw)
