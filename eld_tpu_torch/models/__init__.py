"""Model zoo + string registry (counterpart of ``eld_tpu.models``).

An unknown name raises the same ``KeyError`` as eld_tpu."""

from typing import Callable, Dict

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


def build_arch(name: str, in_channels: int, out_channels: int, **kw):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name](in_channels, out_channels, **kw)


def arch_names():
    return sorted(_ARCHS)
