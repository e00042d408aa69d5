"""The frozen yardsticks: the analytic FLOP count of a train step equals
``torch.utils.flop_counter``'s count over the benchmark's own plain
reference model, K1's bytes and the card's peaks are the data sheet's."""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from eldbench import reference, yardstick  # noqa: E402


def _counted(arch, n, size, width):
    """FLOPs of one forward and backward of the reference model, the input
    needing no gradient (so the first conv's input gradient is never
    computed)."""
    weights = reference.make_weights(3, arch, width, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in weights.items()}
    x = torch.rand(n, size, size, 4)
    with FlopCounterMode(display=False) as counter:
        reference.model(arch, leaves, x).abs().mean().backward()
    return counter.get_total_flops()


@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_conv_flops_equal_the_flop_counter(arch, size, width):
    assert yardstick.conv_flops(arch, 2, size, size, width) == _counted(arch, 2, size, width)


@pytest.mark.parametrize("arch, tflop", [("unet", 2.31767), ("unet_s2d", 0.58787)])
def test_step_flops_at_the_cells_size(arch, tflop):
    """512^2 at batch 8, the count the port's FlopCounterMode gave at 256^2
    batch 1, scaled (half of the figures at batch 16)."""
    assert round(yardstick.conv_flops(arch, 8, 512, 512, 32) / 1e12, 5) == tflop
    assert yardstick.conv_flops(arch, 16, 512, 512, 32) == 2 * yardstick.conv_flops(
        arch, 8, 512, 512, 32)


def test_k1_bytes_read_once_written_once():
    batch = 8 * 512 * 512 * 4 * 4
    assert yardstick.k1_bytes((8, 512, 512, 4)) == 2 * batch + 8 * 12 * 4
    assert yardstick.k1_bytes((4, 512, 512, 4)) == yardstick.k1_bytes((8, 512, 512, 4)) // 2


def test_h100_peaks():
    assert yardstick.H100_BF16_FLOPS == 989.4e12
    assert yardstick.H100_HBM_BYTES_PER_S == 3350e9


@pytest.mark.parametrize("arch, count", [("unet", 7_760_484), ("unet_s2d", 7_764_336)])
def test_reference_parameters(arch, count):
    assert sum(v.numel() for v in reference.make_weights(1, arch, 32, "cpu").values()) == count
