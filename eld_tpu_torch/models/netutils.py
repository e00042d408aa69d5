"""Network utilities (counterpart of ``eld_tpu/models/netutils.py``, after
the reference's ``models/networks.py``): weight-init variants, parameter
counting, receptive-field calculation."""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

from torch import nn

_INITS = {
    "normal": lambda w, gain: nn.init.normal_(w, 0.0, gain),
    "xavier": lambda w, gain: nn.init.xavier_normal_(w),
    "kaiming": lambda w, gain: nn.init.kaiming_normal_(w, a=0, mode="fan_in"),
    "orthogonal": lambda w, gain: nn.init.orthogonal_(w, gain=gain),
}


def weight_init(init_type: str = "normal", gain: float = 0.02) -> Callable[[nn.Module], None]:
    """``fn(module)`` for ``model.apply(fn)``, keyed by the reference's names
    (``networks.py:58-71``): the weights of every convolution and linear
    layer drawn from normal(0, gain) / xavier normal / kaiming normal
    (fan in) / orthogonal(gain), as eld_tpu's initializers draw them, and
    their biases zeroed.  The default training path skips custom init
    (EDSR-style), matching ``ELD_model.py:393``."""
    if init_type not in _INITS:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    draw = _INITS[init_type]

    def init(module: nn.Module):
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            draw(module.weight.data, gain)
            if module.bias is not None:
                nn.init.zeros_(module.bias.data)

    return init


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def print_network(model: nn.Module, name: str = "net") -> int:
    n = param_count(model)
    print(f"[i] {name}: {n:,} parameters")
    return n


def receptive_field(layers: Sequence[Tuple[int, int]]) -> Tuple[int, float, float]:
    """(kernel, stride) per layer -> (rf, effective_stride, effective_pad),
    the recurrence from ``networks.py:112-127``."""
    rf, stride, pad = 1, 1.0, 0.0
    for k, s in layers:
        rf = rf + (k - 1) * stride
        pad = pad + ((k - 1) / 2) * stride
        stride = stride * s
    return rf, stride, pad


def unet_receptive_field() -> int:
    """Receptive field of the SID U-Net encoder path (informational)."""
    layers = []
    for _ in range(5):
        layers += [(3, 1), (3, 1), (2, 2)]
    layers = layers[:-1]  # bottom level has no pool
    return receptive_field(layers)[0]
