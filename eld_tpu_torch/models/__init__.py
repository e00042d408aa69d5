"""Model zoo + string registry (counterpart of ``eld_tpu.models``).

Only ``unet`` is ported so far; ``unet_s2d`` / ``unet_s2d4`` are queued in
ROADMAP.md.  An unknown name raises the same ``KeyError`` as eld_tpu."""

from typing import Callable, Dict

from eld_tpu_torch.models.unet import UNetSeeInDark

_ARCHS: Dict[str, Callable] = {}


def register_arch(name: str):
    def deco(fn):
        _ARCHS[name] = fn
        return fn
    return deco


@register_arch("unet")
def unet(in_channels: int = 4, out_channels: int = 4, **kw) -> UNetSeeInDark:
    return UNetSeeInDark(in_channels=in_channels, out_channels=out_channels, **kw)


def build_arch(name: str, in_channels: int, out_channels: int, **kw):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name](in_channels, out_channels, **kw)
