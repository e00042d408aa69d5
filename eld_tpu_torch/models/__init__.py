"""Model zoo + string registry (counterpart of ``eld_tpu.models``).

An unknown name raises the same ``KeyError`` as eld_tpu."""

from typing import Callable, Dict

from eld_tpu_torch.models.restormer import Restormer
from eld_tpu_torch.models.uformer import Uformer
from eld_tpu_torch.models.unet import UNetSeeInDark
from eld_tpu_torch.models.unet_s2d import unet_s2d as _unet_s2d

_ARCHS: Dict[str, Callable] = {}


def register_arch(name: str):
    def deco(fn):
        _ARCHS[name] = fn
        return fn
    return deco


@register_arch("unet")
def unet(in_channels: int = 4, out_channels: int = 4, **kw) -> UNetSeeInDark:
    return UNetSeeInDark(in_channels=in_channels, out_channels=out_channels, **kw)


@register_arch("unet_s2d")
def unet_s2d(in_channels: int = 4, out_channels: int = 4, **kw):
    return _unet_s2d(in_channels, out_channels, **kw)


@register_arch("unet_s2d4")
def unet_s2d4(in_channels: int = 4, out_channels: int = 4, **kw):
    """The block-4 space-to-depth variant."""
    return _unet_s2d(in_channels, out_channels, block=4, **kw)


@register_arch("restormer")
def restormer(in_channels: int = 4, out_channels: int = 4, base_width: int = 48,
              remat: bool = False, skip_mode: str = "split", upsample: str = "convt",
              skip_dtype=None) -> Restormer:
    """Restormer at its published settings, ``base_width`` its first level's
    width (``dim``).  The U-Net's options are refused by name away from the
    defaults every entry point passes."""
    _transformer_options("restormer", skip_mode, upsample, skip_dtype)
    return Restormer(in_channels, out_channels, dim=base_width, remat=remat)


def _transformer_options(name: str, skip_mode, upsample, skip_dtype):
    for option, value, default in (("skip_mode", skip_mode, "split"),
                                   ("upsample", upsample, "convt"),
                                   ("skip_dtype (--skip_bf16)", skip_dtype, None)):
        if value != default:
            raise ValueError(f"{name} has no U-Net {option}: got {value!r}; it takes only "
                             f"the default {default!r}")


@register_arch("uformer")
def uformer(in_channels: int = 4, out_channels: int = 4, base_width: int = 32,
            remat: bool = False, skip_mode: str = "split", upsample: str = "convt",
            skip_dtype=None) -> Uformer:
    """Uformer-B at its published settings, ``base_width`` its ``embed_dim``.
    The U-Net's options are refused by name away from the defaults every
    entry point passes."""
    _transformer_options("uformer", skip_mode, upsample, skip_dtype)
    return Uformer(in_channels, out_channels, embed_dim=base_width, remat=remat)


def build_arch(name: str, in_channels: int, out_channels: int, **kw):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name](in_channels, out_channels, **kw)


def arch_names():
    return sorted(_ARCHS)
