"""Uformer (Wang, Cun, Bao, Zhou, Liu, Li, "Uformer: A General U-Shaped
Transformer for Image Restoration", CVPR 2022, arXiv:2106.03106; the
authors' ``model.py``, class ``Uformer``, built as their ``Uformer_B``:
``token_projection='linear'``, ``token_mlp='leff'``, ``shift_flag`` and
``modulator`` on), the port's ``--netG uformer``.

A U-shaped network of LeWin blocks over (B, H, W, C) token maps, written
in the authors' form.  A block: ``x + proj(W-MSA(LN1(x)))``, then
``x + LeFF(LN2(x))``.  W-MSA rolls the map by ``-shift`` (odd blocks of a
layer whose map is larger than a window at the configuration's
``img_size``), cuts it into ``win_size``² windows, adds the modulator's
weight to every window's tokens (decoder layers), and per head computes
``softmax(q kᵀ d^-1/2 + B + M) v`` with q from ``to_q``, k and v from
``to_kv``, B the relative-position bias gathered from its table by Swin's
index and M Swin's shift mask (-100 between regions); the windows are
merged and rolled back.  LeFF: ``linear1`` (C -> 4C) and GELU, a 3x3
depthwise conv with bias and GELU, ``linear2``.  Around the blocks: a 3x3
``input_proj`` and LeakyReLU 0.01, 4x4 stride-2 ``dowsample`` convs, the
bottleneck ``conv``, 2x2 stride-2 ``upsample`` transposed convs, the
decoder taking ``cat([up, skip])``, a 3x3 ``output_proj`` and ``+ input``.

The configuration keys read here: ``embed_dim``, ``depths``,
``num_heads``, ``win_size``, ``mlp_ratio``, ``img_size``, ``in_channels``
and ``out_channels``.  ``forward`` checkpoints each block
(``torch.utils.checkpoint``), so that the float32 backward at the cell's
batch holds the blocks' inputs and one block's activations at a time: the
same mathematics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from eldbench import reference

LN_EPS = 1e-5
MASK = -100.0
# the bytes of one channel-pixel of a block's attention: q, k, v read and out written forward
# (8), q, k, v, dOut read and dq, dk, dv written backward (14), all bf16
WMSA_BYTES_PER_CHANNEL_PIXEL = 22
ENCODER = ("encoderlayer_0", "encoderlayer_1", "encoderlayer_2", "encoderlayer_3")
DECODER = ("decoderlayer_0", "decoderlayer_1", "decoderlayer_2", "decoderlayer_3")
NAMES = ENCODER + ("conv",) + DECODER
WIDTHS = (1, 2, 4, 8, 16, 16, 8, 4, 2)  # in embed_dim
SCALES = (1, 2, 4, 8, 16, 8, 4, 2, 1)  # pixel pitch
UPSAMPLES = ((16, 8), (16, 4), (8, 2), (4, 1))  # (in, out) in embed_dim


def levels(config) -> List[Tuple[str, int, int, int, int]]:
    """(name, width, blocks, heads, scale) of each layer of LeWin blocks in
    the network's order; ``scale`` is the layer's pixel pitch."""
    d = config["embed_dim"]
    return [(name, w * d, n, hd, s) for name, w, n, hd, s in
            zip(NAMES, WIDTHS, config["depths"], config["num_heads"], SCALES)]


def _block_specs(config, prefix: str, c: int, heads: int, modulator: bool):
    win, hid = config["win_size"], config["mlp_ratio"] * c
    return ([(f"{prefix}.modulator.weight", (win * win, c))] if modulator else []) + [
        (f"{prefix}.norm1.weight", (c,)), (f"{prefix}.norm1.bias", (c,)),
        (f"{prefix}.attn.relative_position_bias_table", ((2 * win - 1) ** 2, heads)),
        (f"{prefix}.attn.qkv.to_q.weight", (c, c)), (f"{prefix}.attn.qkv.to_q.bias", (c,)),
        (f"{prefix}.attn.qkv.to_kv.weight", (2 * c, c)),
        (f"{prefix}.attn.qkv.to_kv.bias", (2 * c,)),
        (f"{prefix}.attn.proj.weight", (c, c)), (f"{prefix}.attn.proj.bias", (c,)),
        (f"{prefix}.norm2.weight", (c,)), (f"{prefix}.norm2.bias", (c,)),
        (f"{prefix}.mlp.linear1.0.weight", (hid, c)), (f"{prefix}.mlp.linear1.0.bias", (hid,)),
        (f"{prefix}.mlp.dwconv.0.weight", (hid, 1, 3, 3)), (f"{prefix}.mlp.dwconv.0.bias", (hid,)),
        (f"{prefix}.mlp.linear2.0.weight", (c, hid)), (f"{prefix}.mlp.linear2.0.bias", (c,))]


def param_specs(config) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the authors' names and module
    order, torch's layouts (Linear (out, in), conv OIHW, transposed conv
    IOHW)."""
    d, cin, cout = config["embed_dim"], config["in_channels"], config["out_channels"]
    specs = [("input_proj.proj.0.weight", (d, cin, 3, 3)), ("input_proj.proj.0.bias", (d,)),
             ("output_proj.proj.0.weight", (cout, 2 * d, 3, 3)),
             ("output_proj.proj.0.bias", (cout,))]
    for i, (name, c, n, heads, _) in enumerate(levels(config)):
        if i > 4:
            a, b = UPSAMPLES[i - 5]
            specs += [(f"upsample_{i - 5}.deconv.0.weight", (a * d, b * d, 2, 2)),
                      (f"upsample_{i - 5}.deconv.0.bias", (b * d,))]
        for j in range(n):
            specs += _block_specs(config, f"{name}.blocks.{j}", c, heads, name in DECODER)
        if i < 4:
            specs += [(f"dowsample_{i}.conv.0.weight", (2 * c, c, 4, 4)),
                      (f"dowsample_{i}.conv.0.bias", (2 * c,))]
    return specs


_LINEARS = ("to_q", "to_kv", "proj", "linear1.0", "linear2.0")


def make_weights(seed: int, config, device) -> Dict[str, torch.Tensor]:
    """The initial weights, made on ``device`` from ``seed`` by the authors'
    init, drawn in the order of ``param_specs``: Linear weights N(0, 0.02²)
    (their ``trunc_normal_(std=.02)``, whose cut at ±2 never bites) and
    Linear biases 0; LayerNorm weights 1 and biases 0; relative-position
    tables N(0, 0.02²); modulators N(0, 1) (``nn.Embedding``'s default);
    conv and transposed-conv weights and biases U(-b, b), b = 1/sqrt(fan_in)
    with fan_in = the weight's shape[1] x its kernel area (torch's
    default)."""
    specs = param_specs(config)
    shapes = dict(specs)
    gen = reference.weight_generator(seed, device)
    out = {}
    for name, shape in specs:
        module, kind = name.rsplit(".", 1)
        if name.endswith("relative_position_bias_table"):
            out[name] = 0.02 * torch.randn(shape, generator=gen, device=device)
        elif name.endswith("modulator.weight"):
            out[name] = torch.randn(shape, generator=gen, device=device)
        elif ".norm" in name:
            out[name] = (torch.ones if kind == "weight" else torch.zeros)(shape, device=device)
        elif module.endswith(_LINEARS):
            out[name] = (0.02 * torch.randn(shape, generator=gen, device=device)
                         if kind == "weight" else torch.zeros(shape, device=device))
        else:  # a conv or transposed conv
            fan_in = math.prod(shapes[f"{module}.weight"][1:])
            u = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
            out[name] = u / math.sqrt(fan_in)
    return out


def _round_in(t: torch.Tensor) -> torch.Tensor:
    # as reference._conv: the input in e4m3, straight through
    return t + (reference._fake_fp8(t, torch.float8_e4m3fn) - t).detach()


def _linear(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision != "fp8":
        return F.linear(t, w, b)
    return reference._GradFp8.apply(F.linear(_round_in(t), _round_in(w), b))


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision != "fp8":
        return a @ b
    # as archs/restormer.py: the inputs in e4m3, the output's gradient in e5m2
    return reference._GradFp8.apply(_round_in(a) @ _round_in(b))


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, win, win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / win / win))
    x = windows.view(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(win: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(win), torch.arange(win)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1)


def shift_mask(h: int, w: int, win: int, shift: int, device) -> torch.Tensor:
    img = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    windows = window_partition(img, win).view(-1, win * win)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASK).masked_fill(mask == 0, 0.0)


def _attention(p, prefix: str, x: torch.Tensor, heads: int, win: int, mask, precision: str):
    b_, n, c = x.shape
    q = _linear(x, p[f"{prefix}.qkv.to_q.weight"], p[f"{prefix}.qkv.to_q.bias"], precision)
    kv = _linear(x, p[f"{prefix}.qkv.to_kv.weight"], p[f"{prefix}.qkv.to_kv.bias"], precision)
    q = q.reshape(b_, n, heads, c // heads).permute(0, 2, 1, 3)
    kv = kv.reshape(b_, n, 2, heads, c // heads).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    q = q * (c // heads) ** -0.5
    attn = _matmul(q, k.transpose(-2, -1), precision)
    index = relative_position_index(win).to(x.device).view(-1)
    bias = p[f"{prefix}.relative_position_bias_table"][index].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = attn.softmax(dim=-1)
    out = _matmul(attn, v, precision).transpose(1, 2).reshape(b_, n, c)
    return _linear(out, p[f"{prefix}.proj.weight"], p[f"{prefix}.proj.bias"], precision)


def _block(p, prefix: str, heads: int, win: int, shift: int, modulator: bool, precision: str,
           x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    shortcut = x
    t = F.layer_norm(x, (c,), p[f"{prefix}.norm1.weight"], p[f"{prefix}.norm1.bias"], LN_EPS)
    if shift:
        t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
    t = window_partition(t, win).view(-1, win * win, c)
    if modulator:
        t = t + p[f"{prefix}.modulator.weight"]
    mask = shift_mask(h, w, win, shift, x.device) if shift else None
    t = _attention(p, f"{prefix}.attn", t, heads, win, mask, precision)
    t = window_reverse(t.view(-1, win, win, c), win, h, w)
    if shift:
        t = torch.roll(t, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + t
    t = F.layer_norm(x, (c,), p[f"{prefix}.norm2.weight"], p[f"{prefix}.norm2.bias"], LN_EPS)
    t = F.gelu(_linear(t, p[f"{prefix}.mlp.linear1.0.weight"], p[f"{prefix}.mlp.linear1.0.bias"],
                       precision))
    t = reference._conv(t.permute(0, 3, 1, 2), p[f"{prefix}.mlp.dwconv.0.weight"],
                        p[f"{prefix}.mlp.dwconv.0.bias"], precision, padding=1, groups=t.shape[-1])
    t = F.gelu(t).permute(0, 2, 3, 1)
    return x + _linear(t, p[f"{prefix}.mlp.linear2.0.weight"], p[f"{prefix}.mlp.linear2.0.bias"],
                       precision)


def forward(config, p: Dict[str, torch.Tensor], x: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """Uformer on NHWC ``x``; NHWC out."""
    win = config["win_size"]

    def run(name, heads, blocks, scale, t):
        # the authors' rule: a layer whose map is no larger than a window does not shift
        shift = win // 2 if config["img_size"] // scale > win else 0
        for j in range(blocks):
            t = checkpoint(_block, p, f"{name}.blocks.{j}", heads, win, shift if j % 2 else 0,
                           name in DECODER, precision, t, use_reentrant=False)
        return t

    def conv(t, name, transpose=False, **kw):
        out = reference._conv(t.permute(0, 3, 1, 2), p[f"{name}.weight"], p[f"{name}.bias"],
                              precision, transpose=transpose, **kw)
        return out.permute(0, 2, 3, 1)

    lv = {name: (heads, n, s) for name, _, n, heads, s in levels(config)}
    inp = x
    y = F.leaky_relu(conv(x, "input_proj.proj.0", padding=1), 0.01)
    skips = []
    for i, name in enumerate(ENCODER):
        y = run(name, *lv[name], y)
        skips.append(y)
        y = conv(y, f"dowsample_{i}.conv.0", stride=2, padding=1)
    y = run("conv", *lv["conv"], y)
    for i, name in enumerate(DECODER):
        up = conv(y, f"upsample_{i}.deconv.0", transpose=True, stride=2)
        y = run(name, *lv[name], torch.cat([up, skips[3 - i]], -1))
    return conv(y, "output_proj.proj.0", padding=1) + inp


def program_args(config) -> List[str]:
    """``--base_width`` is every arch's first-level width: Uformer's
    ``embed_dim``; the other published settings are the port's
    constructor's."""
    return ["--netG", config["arch"], "--base_width", str(config["embed_dim"])]


def forward_flops(config, n: int, h: int, w: int) -> int:
    """The forward's FLOPs (2 a multiply-add): every conv, transposed conv
    (a depthwise conv by its groups) and Linear, and both products of each
    window's attention, q kᵀ and P v (win² x C a token each)."""
    d, cin, cout = config["embed_dim"], config["in_channels"], config["out_channels"]
    tok, ratio = config["win_size"] ** 2, config["mlp_ratio"]

    def conv(pixels, c_in, c_out, k=1, groups=1):  # a Linear is a 1x1 conv
        return 2 * n * pixels * c_out * (c_in // groups) * k * k

    total = conv(h * w, cin, d, 3) + conv(h * w, 2 * d, cout, 3)
    for i, (name, c, blocks, _, s) in enumerate(levels(config)):
        px, hid = h * w // s ** 2, ratio * c
        one = (conv(px, c, 3 * c) + 2 * 2 * n * px * tok * c + conv(px, c, c)
               + conv(px, c, hid) + conv(px, hid, hid, 3, hid) + conv(px, hid, c))
        total += blocks * one
        if i < 4:  # the 4x4 stride-2 conv to the next layer's pixels
            total += conv(px // 4, c, 2 * c, 4)
        if i > 4:  # the 2x2 stride-2 transposed conv into this layer: one tap an output pixel
            a, b = UPSAMPLES[i - 5]
            total += conv(px, a * d, b * d)
    return total


def step_flops(config, n: int, h: int, w: int) -> int:
    """One train step's FLOPs: 3x the forward's (the input gradient and the
    weight gradient of a conv or Linear, and both operands' gradients of a
    product, cost as much as its forward), less ``input_proj``'s input
    gradient, which is never computed, and no recompute."""
    return 3 * forward_flops(config, n, h, w) - 2 * n * h * w * config["embed_dim"] \
        * config["in_channels"] * 9


def wmsa_bytes(config, n: int, h: int, w: int) -> int:
    """The least bytes of one train step's window attention: 22 bytes
    (bf16) for each channel of each block at each of its layer's pixels."""
    return WMSA_BYTES_PER_CHANNEL_PIXEL * n * sum(
        count * c * (h * w // s ** 2) for _, c, count, _, s in levels(config))
