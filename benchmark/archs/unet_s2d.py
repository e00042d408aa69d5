"""The SID U-Net in ``block`` x ``block`` space-to-depth coordinates, as
eld_tpu's ``models/unet_s2d.py`` and the port's ``--netG unet_s2d``: the
U-Net of ``archs/unet.py`` on the (h/b, w/b, b*b*c) input, channel order
(di, dj, c), its output moved back.  Its parameters, initial weights,
flags and FLOPs are the U-Net's at b*b times the channels.

The configuration keys read here: ``unet``'s and ``block``.
"""

from __future__ import annotations

import torch

from eldbench import manifest

unet = manifest.arch("unet")


def inner(config) -> dict:
    """The configuration as the U-Net inside sees it."""
    bb = config["block"] ** 2
    return {**config, "in_channels": config["in_channels"] * bb,
            "out_channels": config["out_channels"] * bb}


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block, c * block * block)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    n, h, w, cbb = x.shape
    c = cbb // (block * block)
    x = x.reshape(n, h, w, block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * block, w * block, c)


def param_specs(config):
    return unet.param_specs(inner(config))


def make_weights(seed: int, config, device):
    return unet.make_weights(seed, inner(config), device)


def forward(config, p, x, precision="f32"):
    b = config["block"]
    return depth_to_space(unet.forward(inner(config), p, space_to_depth(x, b), precision), b)


program_args = unet.program_args


def step_flops(config, n: int, h: int, w: int) -> int:
    b = config["block"]
    return unet.step_flops(inner(config), n, h // b, w // b)
