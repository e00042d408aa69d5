"""A plain float32 Restormer for the tests: Zamir et al., CVPR 2022
(arXiv:2111.09881), the authors' ``restormer_arch.py`` at the denoising
options' settings (BiasFree LayerNorm, no conv bias), written as one
function of a parameter dict in the authors' ``state_dict`` names, with
NHWC in and out.  It imports no kernel of the port and no JAX.

``param_shapes(...)`` lists the names and shapes; ``forward(p, x, ...)``
runs the network with ``F.normalize``, ``softmax`` and ``@`` for the
transposed attention, as the authors write it.
"""

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

PUBLISHED = dict(dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4, heads=(1, 2, 4, 8),
                 ffn_expansion_factor=2.66)


def _levels(dim, num_blocks, num_refinement_blocks, heads):
    """(name, width, blocks, heads) of each level of transformer blocks, in
    the network's order."""
    return [("encoder_level1", dim, num_blocks[0], heads[0]),
            ("encoder_level2", dim * 2, num_blocks[1], heads[1]),
            ("encoder_level3", dim * 4, num_blocks[2], heads[2]),
            ("latent", dim * 8, num_blocks[3], heads[3]),
            ("decoder_level3", dim * 4, num_blocks[2], heads[2]),
            ("decoder_level2", dim * 2, num_blocks[1], heads[1]),
            ("decoder_level1", dim * 2, num_blocks[0], heads[0]),
            ("refinement", dim * 2, num_refinement_blocks, heads[0])]


def _block_shapes(prefix: str, c: int, heads: int, expansion: float):
    hidden = int(c * expansion)
    return [(f"{prefix}.norm1.body.weight", (c,)),
            (f"{prefix}.attn.temperature", (heads, 1, 1)),
            (f"{prefix}.attn.qkv.weight", (3 * c, c, 1, 1)),
            (f"{prefix}.attn.qkv_dwconv.weight", (3 * c, 1, 3, 3)),
            (f"{prefix}.attn.project_out.weight", (c, c, 1, 1)),
            (f"{prefix}.norm2.body.weight", (c,)),
            (f"{prefix}.ffn.project_in.weight", (2 * hidden, c, 1, 1)),
            (f"{prefix}.ffn.dwconv.weight", (2 * hidden, 1, 3, 3)),
            (f"{prefix}.ffn.project_out.weight", (c, hidden, 1, 1))]


def param_shapes(in_channels: int = 4, out_channels: int = 4, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the authors' module order."""
    levels = {name: (c, n, h) for name, c, n, h in
              _levels(dim, num_blocks, num_refinement_blocks, heads)}

    def level(name):
        c, n, h = levels[name]
        return [s for i in range(n) for s in _block_shapes(f"{name}.{i}", c, h,
                                                             ffn_expansion_factor)]

    return ([("patch_embed.proj.weight", (dim, in_channels, 3, 3))] + level("encoder_level1")
            + [("down1_2.body.0.weight", (dim // 2, dim, 3, 3))] + level("encoder_level2")
            + [("down2_3.body.0.weight", (dim, dim * 2, 3, 3))] + level("encoder_level3")
            + [("down3_4.body.0.weight", (dim * 2, dim * 4, 3, 3))] + level("latent")
            + [("up4_3.body.0.weight", (dim * 16, dim * 8, 3, 3)),
               ("reduce_chan_level3.weight", (dim * 4, dim * 8, 1, 1))]
            + level("decoder_level3")
            + [("up3_2.body.0.weight", (dim * 8, dim * 4, 3, 3)),
               ("reduce_chan_level2.weight", (dim * 2, dim * 4, 1, 1))]
            + level("decoder_level2")
            + [("up2_1.body.0.weight", (dim * 4, dim * 2, 3, 3))] + level("decoder_level1")
            + level("refinement") + [("output.weight", (out_channels, dim * 2, 3, 3))])


def _layer_norm(x, w):
    sigma = x.var(dim=1, keepdim=True, unbiased=False)
    return x / torch.sqrt(sigma + 1e-5) * w.reshape(1, -1, 1, 1)


def _attention(p, prefix, x, heads):
    b, c, h, w = x.shape
    qkv = F.conv2d(x, p[f"{prefix}.qkv.weight"])
    qkv = F.conv2d(qkv, p[f"{prefix}.qkv_dwconv.weight"], padding=1, groups=3 * c)
    q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in qkv.chunk(3, dim=1))
    q = F.normalize(q, dim=-1)
    k = F.normalize(k, dim=-1)
    attn = (q @ k.transpose(-2, -1)) * p[f"{prefix}.temperature"]
    out = attn.softmax(dim=-1) @ v
    return F.conv2d(out.reshape(b, c, h, w), p[f"{prefix}.project_out.weight"])


def _ffn(p, prefix, x):
    t = F.conv2d(x, p[f"{prefix}.project_in.weight"])
    x1, x2 = F.conv2d(t, p[f"{prefix}.dwconv.weight"], padding=1, groups=t.shape[1]).chunk(2, 1)
    return F.conv2d(F.gelu(x1) * x2, p[f"{prefix}.project_out.weight"])


def _blocks(p, name, n, heads, x):
    for i in range(n):
        pre = f"{name}.{i}"
        x = x + _attention(p, f"{pre}.attn", _layer_norm(x, p[f"{pre}.norm1.body.weight"]), heads)
        x = x + _ffn(p, f"{pre}.ffn", _layer_norm(x, p[f"{pre}.norm2.body.weight"]))
    return x


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, dim: int = 48,
            num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
            heads: Sequence[int] = (1, 2, 4, 8)) -> torch.Tensor:
    """Restormer on NHWC ``x`` (H, W multiples of 8); NHWC out."""
    lv = {name: (n, h) for name, _, n, h in _levels(dim, num_blocks, num_refinement_blocks,
                                                     heads)}

    def run(name, t):
        return _blocks(p, name, *lv[name], t)

    def conv3(t, name):
        return F.conv2d(t, p[name], padding=1)

    inp = x.permute(0, 3, 1, 2)
    enc1 = run("encoder_level1", conv3(inp, "patch_embed.proj.weight"))
    enc2 = run("encoder_level2", F.pixel_unshuffle(conv3(enc1, "down1_2.body.0.weight"), 2))
    enc3 = run("encoder_level3", F.pixel_unshuffle(conv3(enc2, "down2_3.body.0.weight"), 2))
    t = run("latent", F.pixel_unshuffle(conv3(enc3, "down3_4.body.0.weight"), 2))
    t = F.pixel_shuffle(conv3(t, "up4_3.body.0.weight"), 2)
    t = run("decoder_level3", F.conv2d(torch.cat([t, enc3], 1), p["reduce_chan_level3.weight"]))
    t = F.pixel_shuffle(conv3(t, "up3_2.body.0.weight"), 2)
    t = run("decoder_level2", F.conv2d(torch.cat([t, enc2], 1), p["reduce_chan_level2.weight"]))
    t = F.pixel_shuffle(conv3(t, "up2_1.body.0.weight"), 2)
    t = run("refinement", run("decoder_level1", torch.cat([t, enc1], 1)))
    return (conv3(t, "output.weight") + inp).permute(0, 2, 3, 1)
