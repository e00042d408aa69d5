"""Uformer (Wang, Cun, Bao, Zhou, Liu, Li, "Uformer: A General U-Shaped
Transformer for Image Restoration", CVPR 2022, arXiv:2106.03106) as a
``torch.nn.Module``, after the authors' ``model.py`` (class ``Uformer``)
at the settings of their ``Uformer_B``: ``token_projection='linear'``,
``token_mlp='leff'``, ``shift_flag`` and ``modulator`` on, window 8, MLP
ratio 4, qkv bias.

A U-shaped network of LeWin blocks over token maps, each
``x + proj(W-MSA(LN1(x)))`` then ``x + LeFF(LN2(x))``:

  * LN: ``nn.LayerNorm`` over the channels of each token (with bias, eps
    1e-5);
  * W-MSA: q from ``to_q`` and k, v from ``to_kv`` (Linears with bias, run
    as one GEMM on the concatenated weights), multi-head attention inside
    each 8 x 8 window with heads of 32 channels, a learned relative-position
    bias from a (15², heads) table and, in every odd block of a layer (not
    the bottleneck, whose map is one window at the authors' 128² crop), a
    cyclic shift by 4 with Swin's region mask; in the decoder's blocks a
    learned modulator (an ``nn.Embedding(64, C)``) added to every window's
    tokens before ``to_q``/``to_kv``.  The attention is
    ``models/wmsa.py::window_attention``, one hand-written kernel each way
    on the card, which takes the shift and the partition as its addressing
    and the modulator as the exact table ``m · W_qkvᵀ``;
  * LeFF: ``linear1`` (C -> 4C) and GELU, a 3x3 depthwise conv with bias
    (``models/dwconv.py``, one kernel each way on the card) and GELU,
    ``linear2`` (4C -> C).  GELU is exact.

Around the blocks: ``input_proj`` a 3x3 conv and LeakyReLU 0.01; four
``dowsample`` (the authors' spelling) 4x4 convs of stride 2, C -> 2C; the
bottleneck ``conv`` at 16C; four ``upsample`` 2x2 transposed convs of
stride 2; the decoder's levels take ``cat([up, skip])``; ``output_proj``
a 3x3 conv from 2C, and ``+ input``.  Depths [1, 2, 8, 8, 2, 8, 8, 2, 1]
and heads [1, 2, 4, 8, 16, 16, 8, 4, 2] at ``embed_dim`` 32: 40 blocks,
every head 32 channels, 50,881,811 parameters at 4 -> 4 (50,880,946 at the
published 3 -> 3).

Parameters carry the authors' ``state_dict`` names
(``encoderlayer_0.blocks.0.attn.relative_position_bias_table``,
``...attn.qkv.to_q.weight``, ``...mlp.linear1.0.weight``,
``decoderlayer_0.blocks.0.modulator.weight``, ...); the authors' buffer
``relative_position_index`` is a non-persistent buffer here, so a
``state_dict`` holds parameters alone.  Departures: tokens stay (N, H, W,
C) throughout (Linear and LayerNorm act on the last axis; the convs see
``permute(0, 3, 1, 2)``, a channels-last view), so H and W are known
where the authors' LeFF and projections take ``sqrt(H·W)``: the same on
square crops, and any H and W that are multiples of ``alignment()``
run.  No stochastic depth (the authors' ``drop_path_rate`` 0.1).
``remat`` checkpoints each block in training.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eld_tpu_torch.models.dwconv import LIBRARY as _DWCONV, depthwise_conv3x3
from eld_tpu_torch.models.wmsa import LIBRARY as _WMSA, window_attention

DEPTHS = (1, 2, 8, 8, 2, 8, 8, 2, 1)
HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)
WIN = 8
MLP_RATIO = 4
ENCODER = ("encoderlayer_0", "encoderlayer_1", "encoderlayer_2", "encoderlayer_3")
DECODER = ("decoderlayer_0", "decoderlayer_1", "decoderlayer_2", "decoderlayer_3")
# (name, width in embed_dim) of the nine layers in the network's order
LAYERS = tuple(zip(ENCODER + ("conv",) + DECODER, (1, 2, 4, 8, 16, 16, 8, 4, 2)))


def relative_position_index(win: int) -> torch.Tensor:
    """Swin's (win², win²) index into the (2 win - 1)² table: (Δh + win - 1)
    · (2 win - 1) + (Δw + win - 1), Δ the query's position less the key's."""
    coords = torch.stack(torch.meshgrid(torch.arange(win), torch.arange(win), indexing="ij"))
    rel = (coords.flatten(1)[:, :, None] - coords.flatten(1)[:, None, :]) + (win - 1)
    return rel[0] * (2 * win - 1) + rel[1]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """A conv's (N, C, H, W) output as the (N, H, W, C) token map (a view
    where the output is channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class LinearProjection(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, 2 * dim)

    def weight(self) -> torch.Tensor:
        return torch.cat([self.to_q.weight, self.to_kv.weight])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3C), channels q | k | v, by one GEMM."""
        return F.linear(x, self.weight(), torch.cat([self.to_q.bias, self.to_kv.bias]))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, win: int):
        super().__init__()
        self.num_heads, self.win = num_heads, win
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * win - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(win),
                             persistent=False)
        self.qkv = LinearProjection(dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self) -> torch.Tensor:
        """The (heads, win², win²) relative-position bias in f32."""
        tok = self.win ** 2
        idx = self.relative_position_index.reshape(-1)
        table = self.relative_position_bias_table.float()
        return table[idx].reshape(tok, tok, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, modulator: Optional[torch.Tensor],
                shift: int) -> torch.Tensor:
        table = None
        with torch.autocast(x.device.type, enabled=False):  # the bias and the table in f32
            bias = self.bias()
            if modulator is not None:
                table = modulator.float() @ self.qkv.weight().float().t()
        out = window_attention(self.qkv(x), bias, table, self.num_heads, shift)
        return self.proj(out)


class LeFF(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden), nn.GELU())
        self.dwconv = nn.Sequential(nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
                                    nn.GELU())
        self.linear2 = nn.Sequential(nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.linear1(x).permute(0, 3, 1, 2)  # a channels-last NCHW view
        t = F.gelu(depthwise_conv3x3(t, self.dwconv[0]))
        return self.linear2(t.permute(0, 2, 3, 1))


class LeWinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, win: int, shift: int, modulator: bool):
        super().__init__()
        self.shift = shift
        self.modulator = nn.Embedding(win * win, dim) if modulator else None
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, win)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = LeFF(dim, MLP_RATIO * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = None if self.modulator is None else self.modulator.weight
        x = x + self.attn(self.norm1(x), m, self.shift)
        return x + self.mlp(self.norm2(x))


class BasicUformerLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, win: int, shift: bool,
                 modulator: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            LeWinTransformerBlock(dim, num_heads, win, win // 2 if shift and i % 2 else 0,
                                  modulator)
            for i in range(depth)])


class Uformer(nn.Module):
    KERNEL_LIBRARIES = (_WMSA, _DWCONV)  # the libraries its card path launches
    SPATIAL_HALO = False  # a window's attention crosses any halo a slab could carry

    def __init__(self, in_channels: int = 4, out_channels: int = 4, embed_dim: int = 32,
                 depths: Sequence[int] = DEPTHS, num_heads: Sequence[int] = HEADS,
                 win_size: int = WIN, remat: bool = False):
        super().__init__()
        if in_channels != out_channels:
            raise ValueError(f"Uformer adds its input to its output: in_channels "
                             f"({in_channels}) must equal out_channels ({out_channels})")
        self.remat, self.win = remat, win_size
        d = embed_dim
        self.input_proj = nn.Module()
        self.input_proj.proj = nn.Sequential(nn.Conv2d(in_channels, d, 3, padding=1),
                                             nn.LeakyReLU(0.01))
        self.output_proj = nn.Module()
        self.output_proj.proj = nn.Sequential(nn.Conv2d(2 * d, out_channels, 3, padding=1))
        ups = ((16, 8), (16, 4), (8, 2), (4, 1))  # the upsamplings' widths in embed_dim
        for i, (name, width) in enumerate(LAYERS):  # registered in the authors' order
            if i > 4:
                self.add_module(f"upsample_{i - 5}", self._up(ups[i - 5][0] * d, ups[i - 5][1] * d))
            # the bottleneck's map is one window at the authors' crop: it never shifts
            layer = BasicUformerLayer(width * d, depths[i], num_heads[i], win_size,
                                      shift=name != "conv", modulator=name in DECODER)
            self.add_module(name, layer)
            if i < 4:
                self.add_module(f"dowsample_{i}", self._down(width * d))

    @staticmethod
    def _down(c: int) -> nn.Module:
        m = nn.Module()
        m.conv = nn.Sequential(nn.Conv2d(c, 2 * c, 4, stride=2, padding=1))
        return m

    @staticmethod
    def _up(c_in: int, c_out: int) -> nn.Module:
        m = nn.Module()
        m.deconv = nn.Sequential(nn.ConvTranspose2d(c_in, c_out, 2, stride=2))
        return m

    def _layer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for block in getattr(self, name).blocks:
            if self.remat and self.training and torch.is_grad_enabled():
                # no block draws random numbers, so there is no RNG state to
                # replay in the recompute (and reading it breaks CUDA graph capture)
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) with H, W multiples of ``alignment()`` -> (N, H, W, C)."""
        inp = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
        y = _tokens(self.input_proj.proj(inp))
        skips = []
        for i, name in enumerate(ENCODER):
            y = self._layer(name, y)
            skips.append(y)
            y = _tokens(getattr(self, f"dowsample_{i}").conv(y.permute(0, 3, 1, 2)))
        y = self._layer("conv", y)
        for i, name in enumerate(DECODER):
            up = _tokens(getattr(self, f"upsample_{i}").deconv(y.permute(0, 3, 1, 2)))
            y = self._layer(name, torch.cat([up, skips[3 - i]], -1))
        out = self.output_proj.proj(y.permute(0, 3, 1, 2)) + inp
        return out.permute(0, 2, 3, 1).to(x.dtype)

    def alignment(self) -> int:
        """Spatial alignment: a whole window at the bottleneck, after 4
        stride-2 downsamplings (128 px at window 8)."""
        return 16 * self.win
