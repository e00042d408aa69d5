"""Restormer (Zamir, Arora, Khan, Hayat, Khan, Yang, CVPR 2022,
arXiv:2111.09881; the authors' ``basicsr/models/archs/restormer_arch.py``
at ``Denoising/Options/RealDenoising_Restormer.yml``'s settings: a
BiasFree LayerNorm, no conv bias), the port's ``--netG restormer``.

A 4-level encoder-decoder of transformer blocks ``x + MDTA(LN(x))``,
``x + GDFN(LN(x))``: MDTA a 1x1 conv to q, k, v, a 3x3 depthwise conv,
per head ``softmax(temperature * normalize(q) normalize(k)^T) v`` over
the channels (a c x c attention reduced over every pixel), a 1x1 conv
out; GDFN a 1x1 conv to twice ``int(width * ffn_expansion_factor)``, a
3x3 depthwise conv, ``gelu(x1) * x2``, a 1x1 conv out.  Down: a 3x3 conv
to half the channels and ``pixel_unshuffle(2)``; up: a 3x3 conv to twice
and ``pixel_shuffle(2)``; the skips concatenated, reduced by a 1x1 conv
at levels 3 and 2; refinement blocks; a 3x3 output conv and ``+ input``.

The configuration keys read here: ``dim``, ``num_blocks``,
``num_refinement_blocks``, ``heads``, ``ffn_expansion_factor``,
``in_channels`` and ``out_channels``.  ``forward`` checkpoints each block
(``torch.utils.checkpoint``), so that the float32 backward at the cell's
batch holds the blocks' inputs and one block's activations at a time:
the same mathematics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from eldbench import reference

LN_EPS = 1e-5
# the bytes of one channel-pixel of a block's attention: q, k, v read and out written forward
# (8), dOut, v, q, k read and dv, dq, dk written backward (14), all bf16
MDTA_BYTES_PER_CHANNEL_PIXEL = 22


def levels(config) -> List[Tuple[str, int, int, int, int]]:
    """(name, width, blocks, heads, scale) of each level of transformer
    blocks in the network's order; ``scale`` is the level's pixel pitch."""
    d, nb, hd = config["dim"], config["num_blocks"], config["heads"]
    return [("encoder_level1", d, nb[0], hd[0], 1), ("encoder_level2", 2 * d, nb[1], hd[1], 2),
            ("encoder_level3", 4 * d, nb[2], hd[2], 4), ("latent", 8 * d, nb[3], hd[3], 8),
            ("decoder_level3", 4 * d, nb[2], hd[2], 4), ("decoder_level2", 2 * d, nb[1], hd[1], 2),
            ("decoder_level1", 2 * d, nb[0], hd[0], 1),
            ("refinement", 2 * d, config["num_refinement_blocks"], hd[0], 1)]


def _hidden(config, width: int) -> int:
    return int(width * config["ffn_expansion_factor"])


def _block_specs(config, prefix: str, c: int, heads: int):
    h = _hidden(config, c)
    return [(f"{prefix}.norm1.body.weight", (c,)), (f"{prefix}.attn.temperature", (heads, 1, 1)),
            (f"{prefix}.attn.qkv.weight", (3 * c, c, 1, 1)),
            (f"{prefix}.attn.qkv_dwconv.weight", (3 * c, 1, 3, 3)),
            (f"{prefix}.attn.project_out.weight", (c, c, 1, 1)),
            (f"{prefix}.norm2.body.weight", (c,)),
            (f"{prefix}.ffn.project_in.weight", (2 * h, c, 1, 1)),
            (f"{prefix}.ffn.dwconv.weight", (2 * h, 1, 3, 3)),
            (f"{prefix}.ffn.project_out.weight", (c, h, 1, 1))]


def param_specs(config) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the authors' names and module
    order, torch's OIHW layout."""
    d = config["dim"]
    blocks = {name: [s for i in range(n) for s in _block_specs(config, f"{name}.{i}", c, hd)]
              for name, c, n, hd, _ in levels(config)}
    return ([("patch_embed.proj.weight", (d, config["in_channels"], 3, 3))]
            + blocks["encoder_level1"] + [("down1_2.body.0.weight", (d // 2, d, 3, 3))]
            + blocks["encoder_level2"] + [("down2_3.body.0.weight", (d, 2 * d, 3, 3))]
            + blocks["encoder_level3"] + [("down3_4.body.0.weight", (2 * d, 4 * d, 3, 3))]
            + blocks["latent"]
            + [("up4_3.body.0.weight", (16 * d, 8 * d, 3, 3)),
               ("reduce_chan_level3.weight", (4 * d, 8 * d, 1, 1))] + blocks["decoder_level3"]
            + [("up3_2.body.0.weight", (8 * d, 4 * d, 3, 3)),
               ("reduce_chan_level2.weight", (2 * d, 4 * d, 1, 1))] + blocks["decoder_level2"]
            + [("up2_1.body.0.weight", (4 * d, 2 * d, 3, 3))] + blocks["decoder_level1"]
            + blocks["refinement"] + [("output.weight", (config["out_channels"], 2 * d, 3, 3))])


def make_weights(seed: int, config, device) -> Dict[str, torch.Tensor]:
    """The initial weights, made on ``device`` from ``seed``: every conv's
    weight U(-b, b) with b = 1/sqrt(fan_in) (fan_in = shape[1] * kernel
    area, 9 for a depthwise conv), torch's default init, in one draw in
    the order of ``param_specs``; the LayerNorms' weights and the
    temperatures 1, as the authors initialize them."""
    specs = param_specs(config)
    convs = [(name, shape) for name, shape in specs if len(shape) == 4]
    sizes = [math.prod(shape) for _, shape in convs]
    gen = reference.weight_generator(seed, device)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    drawn = {name: part.view(shape) / math.sqrt(math.prod(shape[1:]))
             for (name, shape), part in zip(convs, torch.split(flat, sizes))}
    return {name: drawn[name] if name in drawn else torch.ones(shape, device=device)
            for name, shape in specs}


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision != "fp8":
        return a @ b
    # as reference._conv: the inputs in e4m3 straight through, the output's gradient in e5m2
    a = a + (reference._fake_fp8(a, torch.float8_e4m3fn) - a).detach()
    b = b + (reference._fake_fp8(b, torch.float8_e4m3fn) - b).detach()
    return reference._GradFp8.apply(a @ b)


def _block(p, prefix: str, heads: int, precision: str, x: torch.Tensor) -> torch.Tensor:
    def conv(t, name, **kw):
        return reference._conv(t, p[f"{prefix}.{name}.weight"], None, precision, **kw)

    def norm(t, name):
        w = p[f"{prefix}.{name}.body.weight"]
        return t / torch.sqrt(t.var(dim=1, keepdim=True, unbiased=False) + LN_EPS) \
            * w.reshape(1, -1, 1, 1)

    b, c, h, w = x.shape
    qkv = conv(conv(norm(x, "norm1"), "attn.qkv"), "attn.qkv_dwconv", padding=1, groups=3 * c)
    q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in qkv.chunk(3, dim=1))
    q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
    attn = _matmul(q, k.transpose(-2, -1), precision) * p[f"{prefix}.attn.temperature"]
    out = _matmul(attn.softmax(dim=-1), v, precision).reshape(b, c, h, w)
    x = x + conv(out, "attn.project_out")
    t = conv(norm(x, "norm2"), "ffn.project_in")
    x1, x2 = conv(t, "ffn.dwconv", padding=1, groups=t.shape[1]).chunk(2, dim=1)
    return x + conv(F.gelu(x1) * x2, "ffn.project_out")


def forward(config, p: Dict[str, torch.Tensor], x: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """Restormer on NHWC ``x``; NHWC out."""
    lv = {name: (n, hd) for name, _, n, hd, _ in levels(config)}

    def run(name, t):
        n, heads = lv[name]
        for i in range(n):
            t = checkpoint(_block, p, f"{name}.{i}", heads, precision, t, use_reentrant=False)
        return t

    def conv3(t, name):
        return reference._conv(t, p[name], None, precision, padding=1)

    inp = x.permute(0, 3, 1, 2)
    enc1 = run("encoder_level1", conv3(inp, "patch_embed.proj.weight"))
    enc2 = run("encoder_level2", F.pixel_unshuffle(conv3(enc1, "down1_2.body.0.weight"), 2))
    enc3 = run("encoder_level3", F.pixel_unshuffle(conv3(enc2, "down2_3.body.0.weight"), 2))
    t = run("latent", F.pixel_unshuffle(conv3(enc3, "down3_4.body.0.weight"), 2))
    t = torch.cat([F.pixel_shuffle(conv3(t, "up4_3.body.0.weight"), 2), enc3], 1)
    t = run("decoder_level3", reference._conv(t, p["reduce_chan_level3.weight"], None, precision))
    t = torch.cat([F.pixel_shuffle(conv3(t, "up3_2.body.0.weight"), 2), enc2], 1)
    t = run("decoder_level2", reference._conv(t, p["reduce_chan_level2.weight"], None, precision))
    t = torch.cat([F.pixel_shuffle(conv3(t, "up2_1.body.0.weight"), 2), enc1], 1)
    t = run("refinement", run("decoder_level1", t))
    return (conv3(t, "output.weight") + inp).permute(0, 2, 3, 1)


def program_args(config) -> List[str]:
    """``--base_width`` is every arch's first-level width: Restormer's
    ``dim``; the other published settings are the port's constructor's."""
    return ["--netG", config["arch"], "--base_width", str(config["dim"])]


def forward_flops(config, n: int, h: int, w: int) -> int:
    """The forward's FLOPs (2 a multiply-add): every conv, a depthwise
    conv by its groups, and both products of each attention, q k^T and
    A v (c x c x pixels each, per head)."""
    d, cin, cout = config["dim"], config["in_channels"], config["out_channels"]

    def conv(pixels, c_in, c_out, k=1, groups=1):
        return 2 * n * pixels * c_out * (c_in // groups) * k * k

    def blocks(c, count, heads, pixels):
        hid = _hidden(config, c)
        one = (conv(pixels, c, 3 * c) + conv(pixels, 3 * c, 3 * c, 3, 3 * c)
               + 2 * 2 * n * pixels * c * (c // heads) + conv(pixels, c, c)
               + conv(pixels, c, 2 * hid) + conv(pixels, 2 * hid, 2 * hid, 3, 2 * hid)
               + conv(pixels, hid, c))
        return count * one

    px = [h * w // s ** 2 for s in (1, 2, 4, 8)]
    total = sum(blocks(c, count, heads, h * w // s ** 2)
                for _, c, count, heads, s in levels(config))
    total += conv(px[0], cin, d, 3) + conv(px[0], d, d // 2, 3) + conv(px[1], 2 * d, d, 3)
    total += conv(px[2], 4 * d, 2 * d, 3)
    total += conv(px[3], 8 * d, 16 * d, 3) + conv(px[2], 8 * d, 4 * d)
    total += conv(px[2], 4 * d, 8 * d, 3) + conv(px[1], 4 * d, 2 * d)
    total += conv(px[1], 2 * d, 4 * d, 3)
    return total + conv(px[0], 2 * d, cout, 3)


def step_flops(config, n: int, h: int, w: int) -> int:
    """One train step's FLOPs: 3x the forward's (the input gradient and the
    weight gradient of a conv, and both operands' gradients of a product,
    cost as much as its forward), less ``patch_embed``'s input gradient,
    which is never computed, and no recompute."""
    return 3 * forward_flops(config, n, h, w) - 2 * n * h * w * config["dim"] \
        * config["in_channels"] * 9


def mdta_bytes(config, n: int, h: int, w: int) -> int:
    """The least bytes of one train step's attention work: 22 bytes (bf16)
    for each channel of each block at each of its level's pixels."""
    return MDTA_BYTES_PER_CHANNEL_PIXEL * n * sum(
        count * c * (h * w // s ** 2) for _, c, count, _, s in levels(config))
