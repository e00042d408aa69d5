"""The frozen yardsticks: the analytic FLOP count of a train step equals
``torch.utils.flop_counter``'s count over the benchmark's own plain
reference model, K1's bytes and the card's peaks are the data sheet's.
Each cell's program flags, initial weights, FLOPs and parameter count,
which its architecture's module (``archs/``) gives, are pinned: every
reading of the cell rests on them."""

import json
import math
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from eldbench import cell as cell_mod, manifest, yardstick  # noqa: E402

CONFIGS = {"unet": "sid-unet-w32", "unet_s2d": "sid-unet-s2d-w32"}
CELLS = {"unet": "syn-pool.unet.b8", "unet_s2d": "syn-pool.s2d.b8"}


def _config(arch, **kw):
    with open(os.path.join(BENCH, "configs", f"{CONFIGS[arch]}.json")) as f:
        return {**json.load(f), **kw}


def _counted(arch, n, size, width):
    """FLOPs of one forward and backward of the reference model, the input
    needing no gradient (so the first conv's input gradient is never
    computed)."""
    config = _config(arch, base_width=width)
    module = manifest.arch(arch)
    weights = module.make_weights(3, config, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in weights.items()}
    x = torch.rand(n, size, size, 4)
    with FlopCounterMode(display=False) as counter:
        module.forward(config, leaves, x).abs().mean().backward()
    return counter.get_total_flops()


@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_conv_flops_equal_the_flop_counter(arch, size, width):
    flops = manifest.arch(arch).step_flops(_config(arch, base_width=width), 2, size, size)
    assert flops == _counted(arch, 2, size, width)


@pytest.mark.parametrize("arch, tflop", [("unet", 2.31767), ("unet_s2d", 0.58787)])
def test_step_flops_at_the_cells_size(arch, tflop):
    """512^2 at batch 8, the count the port's FlopCounterMode gave at 256^2
    batch 1, scaled (half of the figures at batch 16)."""
    step_flops, config = manifest.arch(arch).step_flops, _config(arch)
    assert round(step_flops(config, 8, 512, 512) / 1e12, 5) == tflop
    assert step_flops(config, 16, 512, 512) == 2 * step_flops(config, 8, 512, 512)


@pytest.mark.parametrize("arch, flops", [("unet", 2_317_671_727_104),
                                         ("unet_s2d", 587_873_648_640)])
def test_step_flops_of_each_cell_are_the_frozen_count(arch, flops):
    """Each cell's step at its traffic's batch and patch: the frozen count
    its ``step.mfu_pct`` reads."""
    cell = manifest.cell(CELLS[arch])
    tr = cell.traffic
    assert cell_mod.arch(cell).step_flops(cell.config, tr["global_batch"], tr["patch"],
                                          tr["patch"]) == flops


def test_k1_bytes_read_once_written_once():
    batch = 8 * 512 * 512 * 4 * 4
    assert yardstick.k1_bytes((8, 512, 512, 4)) == 2 * batch + 8 * 12 * 4
    assert yardstick.k1_bytes((4, 512, 512, 4)) == yardstick.k1_bytes((8, 512, 512, 4)) // 2


def test_h100_peaks():
    assert yardstick.H100_BF16_FLOPS == 989.4e12
    assert yardstick.H100_HBM_BYTES_PER_S == 3350e9


@pytest.mark.parametrize("arch, count", [("unet", 7_760_484), ("unet_s2d", 7_764_336)])
def test_reference_parameters(arch, count):
    module, config = manifest.arch(arch), _config(arch)
    assert sum(v.numel() for v in module.make_weights(1, config, "cpu").values()) == count
    assert sum(torch.Size(s).numel() for _, s in module.param_specs(config)) == count
    assert config["parameters"] == count


def _argv(arch):
    return ["--name", CELLS[arch], "--checkpoints_dir", "SAVE", "--device", "cuda",
            "--netG", arch, "--base_width", "32", "--skip_mode", "split", "--upsample", "convt",
            "--noise", "eld", "--include", "4", "--loss", "l1", "--lr", "0.0001",
            "--beta1", "0.9", "-b", "8", "--mesh_data", "1", "--seed", "2147483653",
            "--no-log", "--no-verbose", "--bf16"]


@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_program_argv_is_the_frozen_list(arch):
    cell = manifest.cell(CELLS[arch])
    assert cell_mod.program_argv(cell, 2**31 + 5, "SAVE", "cuda") == _argv(arch)


# seed 1 on the CPU: the exact sum and sum of squares over every weight (math.fsum), and
# the first and last element of four leaves, as every run of the cells draws them
WEIGHTS = {
    "unet": (-35.650417606414656, 1305.6462455277413, {
        "conv1_1.weight": (-0.052101511508226395, -0.0665159597992897),
        "conv5_2.bias": (0.014725047163665295, 0.0009308605804108083),
        "upv6.weight": (-0.02166757732629776, 0.025747299194335938),
        "conv10_1.bias": (0.09754648059606552, -0.08798348903656006)}),
    "unet_s2d": (-34.37420845920894, 1308.7886248062155, {
        "conv1_1.weight": (-0.026050755754113197, 0.047141075134277344),
        "conv5_2.bias": (0.00032708942308090627, 0.013469517230987549),
        "upv6.weight": (-0.029047243297100067, -0.014738578349351883),
        "conv10_1.bias": (-0.15557228028774261, 0.1611861288547516)}),
}


@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_initial_weights_are_the_frozen_draw(arch):
    cell = manifest.cell(CELLS[arch])
    weights = cell_mod.arch(cell).make_weights(1, cell.config, "cpu")
    total, squares, leaves = WEIGHTS[arch]
    values = [x for v in weights.values() for x in v.double().flatten().tolist()]
    assert math.fsum(values) == total
    assert math.fsum(x * x for x in values) == squares
    for name, (first, last) in leaves.items():
        flat = weights[name].flatten()
        assert (float(flat[0]), float(flat[-1])) == (first, last)
    assert [n for n, _ in cell_mod.arch(cell).param_specs(cell.config)] == list(weights)
