"""The SID U-Net (Chen, Chen, Xu, Koltun, CVPR 2018; the ELD reference's
``models/arch/Unet.py``), the port's ``--netG unet``: 5 levels of two 3x3
convs and LeakyReLU(0.2), 2x2 max pooling, 2x2 stride-2 transposed convs
and skip concatenation, a 1x1 output conv.

The configuration keys read here: ``arch``, ``base_width``,
``in_channels``, ``out_channels``, ``skip_mode`` and ``upsample``.  The
reference computes the published concatenation, of which ``skip_mode``
split is an exact reparameterization, and ``upsample`` convt's
transposed convs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from eldbench import reference

LEVELS = 5


def _widths(config) -> List[int]:
    return [config["base_width"] * 2 ** i for i in range(LEVELS)]


def param_specs(config) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the SID reference's names and
    torch's OIHW (IOHW for the transposed convs) layout."""
    widths = _widths(config)
    specs, prev = [], config["in_channels"]
    for lvl, w in enumerate(widths, start=1):
        specs += [(f"conv{lvl}_1.weight", (w, prev, 3, 3)), (f"conv{lvl}_1.bias", (w,)),
                  (f"conv{lvl}_2.weight", (w, w, 3, 3)), (f"conv{lvl}_2.bias", (w,))]
        prev = w
    for lvl, w in zip(range(6, 10), widths[3::-1]):
        specs += [(f"upv{lvl}.weight", (2 * w, w, 2, 2)), (f"upv{lvl}.bias", (w,)),
                  (f"conv{lvl}_1.weight", (w, 2 * w, 3, 3)), (f"conv{lvl}_1.bias", (w,)),
                  (f"conv{lvl}_2.weight", (w, w, 3, 3)), (f"conv{lvl}_2.bias", (w,))]
    specs += [("conv10_1.weight", (config["out_channels"], widths[0], 1, 1)),
              ("conv10_1.bias", (config["out_channels"],))]
    return specs


def make_weights(seed: int, config, device) -> Dict[str, torch.Tensor]:
    """The initial weights, made on ``device`` from ``seed`` in one draw:
    U(-b, b) with b = 1/sqrt(fan_in), torch's default init of a conv's
    weight and bias (fan_in = shape[1] * kernel area of the weight)."""
    specs = param_specs(config)
    sizes = [math.prod(shape) for _, shape in specs]
    gen = reference.weight_generator(seed, device)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, weight_shape = {}, None
    for (name, shape), part in zip(specs, torch.split(flat, sizes)):
        if name.endswith(".weight"):
            weight_shape = shape
        fan_in = weight_shape[1] * math.prod(weight_shape[2:])
        out[name] = part.view(shape) / math.sqrt(fan_in)
    return out


def forward(config, p: Dict[str, torch.Tensor], x: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """The SID U-Net on NHWC ``x``; NHWC out."""
    def conv(t, name, **kw):
        return reference._conv(t, p[f"{name}.weight"], p[f"{name}.bias"], precision, **kw)

    def pair(t, lvl):
        t = F.leaky_relu(conv(t, f"conv{lvl}_1", padding=1), 0.2)
        return F.leaky_relu(conv(t, f"conv{lvl}_2", padding=1), 0.2)

    t, skips = x.permute(0, 3, 1, 2), []
    for lvl in range(1, 6):
        t = pair(t, lvl)
        if lvl < 5:
            skips.append(t)
            t = F.max_pool2d(t, 2)
    for lvl in range(6, 10):
        t = conv(t, f"upv{lvl}", transpose=True, stride=2)
        t = pair(torch.cat([t, skips[9 - lvl]], dim=1), lvl)
    return conv(t, "conv10_1").permute(0, 2, 3, 1)


def program_args(config) -> List[str]:
    return ["--netG", config["arch"], "--base_width", str(config["base_width"]),
            "--skip_mode", config["skip_mode"], "--upsample", config["upsample"]]


def step_flops(config, n: int, h: int, w: int) -> int:
    """One train step's FLOPs: 3x the forward FLOPs of every conv and
    transposed conv (2 a multiply-add; the input gradient and the weight
    gradient cost as much as the forward), less the first conv's input
    gradient, which is never computed, and no recompute."""
    widths, cin, cout = _widths(config), config["in_channels"], config["out_channels"]
    first = 2 * n * h * w * 9 * cin * widths[0]
    fwd, prev = 0, cin
    for lvl, c in enumerate(widths):
        fwd += 2 * n * h * w * 9 * (prev * c + c * c)
        prev = c
        if lvl < 4:
            h, w = h // 2, w // 2
    for c in widths[3::-1]:
        fwd += 2 * n * h * w * 4 * (2 * c) * c
        h, w = 2 * h, 2 * w
        fwd += 2 * n * h * w * 9 * (2 * c * c + c * c)
    fwd += 2 * n * h * w * widths[0] * cout
    return 3 * fwd - first
