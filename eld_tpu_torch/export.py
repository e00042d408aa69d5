"""Serving export: self-contained denoiser artifacts (counterpart of
``eld_tpu/export.py``).

The trained network is traced with ``torch.export`` into one program whose
weights travel inside it, so serving needs torch and the artifact, not this
package or a checkpoint:

  * the batch dimension is symbolic (``torch.export.Dim``) unless
    ``symbolic_batch=False`` pins it to 1; H and W are static;
  * ``chop=True`` traces ``ops/chop.forward_chop`` (the reference's 4-tile
    protocol) into the program;
  * ``quantize="int8"`` stores weight-only, symmetric int8 with one f32
    scale per output channel (a ``torch.nn.utils.parametrize``
    parametrization of each conv's weight), dequantized inside the graph
    where each conv reads its weight.  Biases stay f32, and so does the output projection
    ``conv10_1`` (the Flax top-level ``Conv_0`` that eld_tpu keeps).  The
    output-channel axis is dim 0 of a ``Conv2d`` weight but dim 1 of a
    ``ConvTranspose2d`` weight (``upv*``);
  * ``bf16=True`` runs the network in bf16 through explicit casts (input,
    parameters and the dequantized weights), which computes what the
    Engine's bf16-autocast eval forward computes; the output is f32.

Artifact format (``.eldx``): a zip holding ``meta.json`` (arch, geometry,
dtypes, parameter count) and ``model.pt2`` (``torch.export.save``).  A
program traced on one device serves on another: ``load_denoiser`` moves it
with ``torch.export.passes.move_to_device_pass``.  eld_tpu's own artifacts
(a ``model.stablehlo`` entry) are refused.  The program calls the conv
epilogue's operators (``models/epilogue.py``, imported here so that a
load finds them), which run the hand-written kernel on the card.
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from eld_tpu_torch.config import torch_device
from eld_tpu_torch.models import epilogue  # noqa: F401  (registers the operators)
from eld_tpu_torch.ops.chop import forward_chop

# 1 is eld_tpu's StableHLO artifact; 2 this package's torch.export artifact
ARTIFACT_VERSION = 2
_PROGRAM = "model.pt2"
_META = "meta.json"
_JAX_PROGRAM = "model.stablehlo"
KEEP_F32 = ("conv10_1",)


def out_channel_axis(conv: nn.Module) -> int:
    """The output-channel axis of a conv's weight: (O, I, kh, kw) for
    Conv2d, (I, O, kh, kw) for ConvTranspose2d."""
    return 1 if isinstance(conv, nn.ConvTranspose2d) else 0


def quantize_weight(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice along ``axis``: scale =
    max|w| / 127 (1 for an all-zero slice), q = clip(round(w / scale))."""
    dims = tuple(d for d in range(w.ndim) if d != axis)
    amax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


class Int8Weight(nn.Module):
    """A conv weight's parametrization: ``right_inverse`` stores it as int8
    values and f32 scales (the conv's ``parametrizations.weight.original0``
    and ``original1``), ``forward`` dequantizes them to ``dtype`` wherever
    the conv reads ``weight``."""

    def __init__(self, axis: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.axis = axis
        self.dtype = dtype

    def forward(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return (q.to(torch.float32) * scale).to(self.dtype)

    def right_inverse(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return quantize_weight(w, self.axis)


def quantize_model(model: nn.Module, keep_f32=KEEP_F32,
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """Give every Conv2d / ConvTranspose2d of ``model`` int8 weights read
    as ``dtype``, in place, except the modules named in ``keep_f32``."""
    for name, m in list(model.named_modules()):
        if name in keep_f32 or not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            continue
        m.weight.requires_grad_(False)  # int8 cannot require grad
        parametrize.register_parametrization(m, "weight", Int8Weight(out_channel_axis(m), dtype),
                                             unsafe=True)
    return model


class Denoiser(nn.Module):
    """What an artifact computes: f32 (N, H, W, C) in, f32 out."""

    def __init__(self, net: nn.Module, chop: bool, dtype: torch.dtype):
        super().__init__()
        self.net = net
        self.chop = chop
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        out = forward_chop(self.net, x, base=self.net.alignment()) if self.chop else self.net(x)
        return out.to(torch.float32)


def serving_module(model: nn.Module, *, chop: bool = False, quantize: Optional[str] = None,
                   bf16: bool = False) -> Denoiser:
    """A copy of ``model`` set up as an artifact runs it."""
    net = copy.deepcopy(model).eval()
    dtype = torch.bfloat16 if bf16 else torch.float32
    if quantize == "int8":
        quantize_model(net, dtype=dtype)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
    if bf16:
        for m in net.modules():
            if not isinstance(m, parametrize.ParametrizationList):  # int8 values, f32 scales
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(torch.bfloat16)
    return Denoiser(net, chop, dtype)


def export_denoiser(model: nn.Module, height: int, width: int, channels: int = 4, *,
                    chop: bool = False, quantize: Optional[str] = None, bf16: bool = False,
                    symbolic_batch: bool = True):
    """Trace the denoiser on the device its parameters are on; returns the
    ``torch.export.ExportedProgram``."""
    module = serving_module(model, chop=chop, quantize=quantize, bf16=bf16)
    device = next(model.parameters()).device
    # batch 2 in the example: a dimension traced at size 1 is specialized
    example = torch.zeros((2 if symbolic_batch else 1, height, width, channels), device=device)
    dynamic = {"x": {0: torch.export.Dim("batch", min=1)}} if symbolic_batch else None
    with torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes=dynamic)


def save_denoiser(path: str, model: nn.Module, height: int, width: int, channels: int = 4, *,
                  chop: bool = False, quantize: Optional[str] = None, bf16: bool = False,
                  symbolic_batch: bool = True, extra_meta: Optional[dict] = None) -> dict:
    """Export and write a ``.eldx`` artifact; returns its metadata."""
    program = export_denoiser(model, height, width, channels, chop=chop, quantize=quantize,
                              bf16=bf16, symbolic_batch=symbolic_batch)
    blob = io.BytesIO()
    torch.export.save(program, blob)
    meta = {
        "format": "eldx",
        "version": ARTIFACT_VERSION,
        "runtime": "torch.export",
        "torch_version": torch.__version__,
        "device": str(next(model.parameters()).device),
        "height": height,
        "width": width,
        "channels": channels,
        "chop": chop,
        "bf16": bf16,
        "symbolic_batch": symbolic_batch,
        "quantize": quantize,
        "param_count": sum(p.numel() for p in model.parameters()),
        **(extra_meta or {}),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META, json.dumps(meta, indent=1))
        z.writestr(_PROGRAM, blob.getvalue())
    return meta


def _check_meta(path: str, meta: dict) -> dict:
    if meta.get("format") != "eldx":
        raise ValueError(f"{path}: not an eldx artifact (format={meta.get('format')!r})")
    version = meta.get("version")
    if version != ARTIFACT_VERSION:
        raise ValueError(f"{path}: unsupported eldx artifact version {version!r} "
                         f"(this eld_tpu_torch reads version {ARTIFACT_VERSION})")
    return meta


def _open(path: str, z: zipfile.ZipFile) -> dict:
    if _JAX_PROGRAM in z.namelist():
        raise ValueError(
            f"{path} is an eld_tpu (JAX, StableHLO) artifact, which eld_tpu_torch does not "
            "run: export the model's .pt checkpoint with "
            "python -m eld_tpu_torch.tools.export_model")
    return _check_meta(path, json.loads(z.read(_META).decode()))


def read_meta(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return _open(path, z)


def load_denoiser(path: str, device="cuda") -> Tuple[Callable[[torch.Tensor], torch.Tensor], dict]:
    """Load a ``.eldx`` artifact onto ``device``: returns (fn, meta), fn
    mapping an f32 (N, H, W, C) tensor on that device to the denoised
    output, without autograd."""
    device = torch_device(device)
    with zipfile.ZipFile(path) as z:
        meta = _open(path, z)
        program = torch.export.load(io.BytesIO(z.read(_PROGRAM)))
    from torch.export.passes import move_to_device_pass

    module = move_to_device_pass(program, device).module()

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return module(x)

    return fn, meta
