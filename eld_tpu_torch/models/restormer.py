"""Restormer (Zamir, Arora, Khan, Hayat, Khan, Yang, "Restormer: Efficient
Transformer for High-Resolution Image Restoration", CVPR 2022,
arXiv:2111.09881) as a ``torch.nn.Module``, after the authors'
``basicsr/models/archs/restormer_arch.py`` at the settings of their
denoising options (``LayerNorm_type: BiasFree``, no conv bias).

A 4-level encoder-decoder of transformer blocks, each
``x + MDTA(LN(x))`` then ``x + GDFN(LN(x))``:

  * LN: the BiasFree LayerNorm over channels at each pixel,
    ``x / sqrt(var(x) + 1e-5) * weight`` (var biased, x not centred), one
    hand-written kernel each way on the card (``models/layernorm.py``);
  * MDTA: a 1x1 conv to q, k, v, a 3x3 depthwise conv, the transposed
    attention of ``models/mdta.py`` (one hand-written kernel each way on
    the card), a 1x1 conv out;
  * GDFN: a 1x1 conv to twice the hidden width, a 3x3 depthwise conv,
    ``gelu(x1) * x2`` (exact GELU), a 1x1 conv out.

Both depthwise convs run as one hand-written kernel each way on the card
(``models/dwconv.py``); their weights stay the ``nn.Conv2d`` modules'.

Levels of ``dim``, 2, 4 and 8 ``dim`` channels with ``heads`` [1, 2, 4, 8]
and [4, 6, 6, 8] blocks; a 3x3 conv and ``pixel_unshuffle(2)`` down, a 3x3
conv and ``pixel_shuffle(2)`` up (torch's (c, di, dj) channel order),
skips concatenated (1x1 reductions at levels 3 and 2, none at level 1,
which runs at 2 ``dim``), 4 refinement blocks, a 3x3 output conv and
``+ input``.  At ``dim`` 48 and 4 -> 4 channels: 44 blocks, 26,112,964
parameters.

Parameters carry the authors' ``state_dict`` names
(``encoder_level1.0.attn.qkv_dwconv.weight``, ``...norm1.body.weight``,
``...attn.temperature``, ...).  ``forward`` takes and returns NHWC like
the U-Nets; inside, ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor
is a ``channels_last`` NCHW view, and the network stays channels-last.
``remat`` checkpoints each transformer block in training.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eld_tpu_torch.models.dwconv import LIBRARY as _DWCONV, depthwise_conv3x3
from eld_tpu_torch.models.layernorm import LIBRARY as _LAYERNORM, biasfree_layernorm
from eld_tpu_torch.models.mdta import LIBRARY as _MDTA, mdta

NUM_BLOCKS = (4, 6, 6, 8)
REFINEMENT_BLOCKS = 4
HEADS = (1, 2, 4, 8)
FFN_EXPANSION = 2.66


def _cl(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a dense channels-last NCHW tensor (no copy where it is one)."""
    return x.contiguous(memory_format=torch.channels_last)


class _BiasFreeLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class LayerNorm(nn.Module):
    """The BiasFree LayerNorm over the channels of each pixel, in f32 and
    rounded to x's dtype (``models/layernorm.py``: one kernel each way on
    the card)."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = _BiasFreeLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return biasfree_layernorm(x, self.body.weight)


class Attention(nn.Module):
    """MDTA: q, k, v by a 1x1 conv and a 3x3 depthwise conv, the transposed
    attention, a 1x1 conv out."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, kernel_size=1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, kernel_size=3, padding=1, groups=dim * 3,
                                    bias=False)
        self.project_out = nn.Conv2d(dim, dim, kernel_size=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = depthwise_conv3x3(self.qkv(x), self.qkv_dwconv)  # dense channels-last
        out = mdta(qkv.permute(0, 2, 3, 1), self.temperature, self.num_heads)
        return self.project_out(out.permute(0, 3, 1, 2))


class FeedForward(nn.Module):
    """GDFN: a 1x1 conv to 2 x hidden, a 3x3 depthwise conv, gelu(x1) * x2, a
    1x1 conv out."""

    def __init__(self, dim: int, expansion: float):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = nn.Conv2d(dim, hidden * 2, kernel_size=1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, kernel_size=3, padding=1,
                                groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, kernel_size=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = depthwise_conv3x3(self.project_in(x), self.dwconv).chunk(2, dim=1)
        return self.project_out(_cl(F.gelu(x1) * x2))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_c, dim, kernel_size=3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat // 2, kernel_size=3, padding=1,
                                            bias=False), nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _cl(self.body(x))


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat * 2, kernel_size=3, padding=1,
                                            bias=False), nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _cl(self.body(x))


class Restormer(nn.Module):
    KERNEL_LIBRARIES = (_MDTA, _LAYERNORM, _DWCONV)  # the libraries its card path launches
    SPATIAL_HALO = False  # its attention reduces over every pixel: no halo carries it

    def __init__(self, in_channels: int = 4, out_channels: int = 4, dim: int = 48,
                 num_blocks: Sequence[int] = NUM_BLOCKS,
                 num_refinement_blocks: int = REFINEMENT_BLOCKS,
                 heads: Sequence[int] = HEADS, ffn_expansion_factor: float = FFN_EXPANSION,
                 remat: bool = False):
        super().__init__()
        if in_channels != out_channels:
            raise ValueError(f"Restormer adds its input to its output: in_channels "
                             f"({in_channels}) must equal out_channels ({out_channels})")
        self.remat = remat

        def level(width, n, h):
            return nn.Sequential(*[TransformerBlock(width, h, ffn_expansion_factor)
                                   for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(in_channels, dim)
        self.encoder_level1 = level(dim, num_blocks[0], heads[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = level(dim * 2, num_blocks[1], heads[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = level(dim * 4, num_blocks[2], heads[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = level(dim * 8, num_blocks[3], heads[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, kernel_size=1, bias=False)
        self.decoder_level3 = level(dim * 4, num_blocks[2], heads[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, kernel_size=1, bias=False)
        self.decoder_level2 = level(dim * 2, num_blocks[1], heads[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = level(dim * 2, num_blocks[0], heads[0])
        self.refinement = level(dim * 2, num_refinement_blocks, heads[0])
        self.output = nn.Conv2d(dim * 2, out_channels, kernel_size=3, padding=1, bias=False)

    def _blocks(self, level: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for block in level:
            if self.remat and self.training and torch.is_grad_enabled():
                # no block draws random numbers, so there is no RNG state to
                # replay in the recompute (and reading it breaks CUDA graph capture)
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) with H, W multiples of 8 -> (N, H, W, C)."""
        inp = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
        enc1 = self._blocks(self.encoder_level1, self.patch_embed(_cl(inp)))
        enc2 = self._blocks(self.encoder_level2, self.down1_2(enc1))
        enc3 = self._blocks(self.encoder_level3, self.down2_3(enc2))
        t = self._blocks(self.latent, self.down3_4(enc3))
        t = self.reduce_chan_level3(torch.cat([self.up4_3(t), enc3], 1))
        t = self._blocks(self.decoder_level3, t)
        t = self.reduce_chan_level2(torch.cat([self.up3_2(t), enc2], 1))
        t = self._blocks(self.decoder_level2, t)
        t = self._blocks(self.decoder_level1, torch.cat([self.up2_1(t), enc1], 1))
        t = self._blocks(self.refinement, t)
        out = self.output(t) + inp
        return out.permute(0, 2, 3, 1).to(x.dtype)

    @staticmethod
    def alignment() -> int:
        """Spatial alignment required by the 3 downsamplings (8 px)."""
        return 8
