"""Carry U-Net weights between eld_tpu's Flax params and this port.

The Flax tree is a nested dict of arrays (``enc0/Conv_0/kernel`` ...); the
port's ``UNetSeeInDark.state_dict()`` uses the reference's torch names and
layouts.  The mapping is ``eld_tpu/compat/torch_import.py``'s, repeated
here because importing eld_tpu imports JAX:

  * Conv2d weight (O, I, kh, kw)          <-> Flax Conv kernel (kh, kw, I, O)
  * ConvTranspose2d weight (I, O, kh, kw) <-> Flax ConvTranspose kernel
    (kh, kw, I, O) with the spatial taps flipped (torch's transposed conv
    is the gradient of a conv; lax.conv_transpose is a fractionally
    strided conv; they differ by a mirror of the kernel).
"""

from __future__ import annotations

from typing import Dict

import numpy as onp
import torch

# torch layer name -> (flax module path, kind)
UNET_MAP = {
    "conv1_1": ("enc0/Conv_0", "conv"),
    "conv1_2": ("enc0/Conv_1", "conv"),
    "conv2_1": ("enc1/Conv_0", "conv"),
    "conv2_2": ("enc1/Conv_1", "conv"),
    "conv3_1": ("enc2/Conv_0", "conv"),
    "conv3_2": ("enc2/Conv_1", "conv"),
    "conv4_1": ("enc3/Conv_0", "conv"),
    "conv4_2": ("enc3/Conv_1", "conv"),
    "conv5_1": ("enc4/Conv_0", "conv"),
    "conv5_2": ("enc4/Conv_1", "conv"),
    "upv6": ("ConvTranspose_0", "convT"),
    "conv6_1": ("dec3/Conv_0", "conv"),
    "conv6_2": ("dec3/Conv_1", "conv"),
    "upv7": ("ConvTranspose_1", "convT"),
    "conv7_1": ("dec2/Conv_0", "conv"),
    "conv7_2": ("dec2/Conv_1", "conv"),
    "upv8": ("ConvTranspose_2", "convT"),
    "conv8_1": ("dec1/Conv_0", "conv"),
    "conv8_2": ("dec1/Conv_1", "conv"),
    "upv9": ("ConvTranspose_3", "convT"),
    "conv9_1": ("dec0/Conv_0", "conv"),
    "conv9_2": ("dec0/Conv_1", "conv"),
    "conv10_1": ("Conv_0", "conv"),
}


def flax_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """Flax U-Net params (nested mapping of arrays) -> the port's state_dict
    (float32 CPU tensors)."""
    out = {}
    for tname, (fpath, kind) in UNET_MAP.items():
        node = params
        for p in fpath.split("/"):
            node = node[p]
        k = onp.asarray(node["kernel"], onp.float32)
        if kind == "conv":
            w = k.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        else:
            w = k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # HW(in,out) -> IOHW, flipped
        out[f"{tname}.weight"] = torch.from_numpy(onp.ascontiguousarray(w))
        if "bias" in node:
            out[f"{tname}.bias"] = torch.from_numpy(onp.asarray(node["bias"], onp.float32).copy())
    return out


def state_dict_to_flax(state_dict) -> dict:
    """The port's (or the reference's) state_dict -> nested Flax params of
    numpy float32 arrays."""
    params: dict = {}
    for tname, (fpath, kind) in UNET_MAP.items():
        w = state_dict[f"{tname}.weight"].detach().cpu().float().numpy()
        if kind == "conv":
            kernel = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            kernel = w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        node = params
        parts = fpath.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = node.setdefault(parts[-1], {})
        leaf["kernel"] = onp.ascontiguousarray(kernel)
        bkey = f"{tname}.bias"
        if bkey in state_dict:
            leaf["bias"] = state_dict[bkey].detach().cpu().float().numpy().copy()
    return params
