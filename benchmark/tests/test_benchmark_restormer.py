"""Restormer's module of the benchmark (``archs/restormer.py``): its
parameter names and shapes are the program's ``state_dict``, its float32
forward is the program's on the CPU at a small size, its forward FLOPs
are ``torch.utils.flop_counter``'s count, its attention bytes at the
cell's size are pinned, and under "fp8" every conv's and every
attention product's inputs are rounded.  The backward's FLOPs are not
held to the counter, whose count of a grouped conv's backward is too
high; ``step_flops`` is 3x the forward less ``patch_embed``'s input
gradient."""

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from eldbench import manifest, reference  # noqa: E402

restormer = manifest.arch("restormer")
SMALL = dict(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1)
CELL = "syn-pool.restormer.p256b4"


def _config(**kw):
    with open(os.path.join(BENCH, "configs", "restormer-w48.json")) as f:
        return {**json.load(f), **kw}


def _program(config):
    from eld_tpu_torch.models.restormer import Restormer

    return Restormer(config["in_channels"], config["out_channels"], dim=config["dim"],
                     num_blocks=config["num_blocks"],
                     num_refinement_blocks=config["num_refinement_blocks"],
                     heads=config["heads"], ffn_expansion_factor=config["ffn_expansion_factor"])


def test_param_specs_are_the_programs_state_dict():
    from eld_tpu_torch.models import build_arch

    config = _config()
    got = [(n, tuple(t.shape)) for n, t in
           build_arch("restormer", 4, 4, base_width=config["dim"]).state_dict().items()]
    assert restormer.param_specs(config) == got
    assert sum(torch.Size(s).numel() for _, s in got) == config["parameters"] == 26_112_964
    assert restormer.program_args(config) == ["--netG", "restormer", "--base_width", "48"]


def test_the_f32_forward_is_the_programs_on_the_cpu():
    """The program's model loaded with ``make_weights``' draw (LayerNorm
    weights and temperatures moved off 1) against the reference's forward:
    f32, summation order only (rtol 1e-4, an atol of 1e-5 of the largest)."""
    config = _config(**SMALL)
    weights = restormer.make_weights(7, config, "cpu")
    gen = torch.Generator().manual_seed(8)
    for name, t in weights.items():
        if t.dim() != 4:
            weights[name] = 0.5 + torch.rand(t.shape, generator=gen)
    model = _program(config)
    model.load_state_dict(weights)
    x = torch.rand((2, 32, 32, 4), generator=gen)
    with torch.no_grad():
        got, ref = model(x), restormer.forward(config, weights, x)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))


def test_make_weights_follows_torchs_default_init():
    config = _config(**SMALL)
    w = restormer.make_weights(3, config, "cpu")
    assert list(w) == [n for n, _ in restormer.param_specs(config)]
    for name, t in w.items():
        if t.dim() == 4:
            bound = 1.0 / (t.shape[1] * t.shape[2] * t.shape[3]) ** 0.5
            assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.5 * bound, name
        else:
            assert bool((t == 1).all()), name
    assert all(torch.equal(a, b) for a, b in
               zip(w.values(), restormer.make_weights(3, config, "cpu").values()))


def test_forward_flops_are_the_flop_counters():
    for kw, size in ((SMALL, 32), ({}, 16)):
        config = _config(**kw)
        weights = restormer.make_weights(1, config, "cpu")
        x = torch.rand(2, size, size, 4)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            restormer.forward(config, weights, x)
        assert restormer.forward_flops(config, 2, size, size) == counter.get_total_flops()
    config = _config()
    first = 2 * 4 * 256 * 256 * 48 * 4 * 9
    assert restormer.step_flops(config, 4, 256, 256) == \
        3 * restormer.forward_flops(config, 4, 256, 256) - first == 3_718_301_220_864


def test_mdta_bytes_at_the_cells_size():
    """22 bytes a channel-pixel over the 44 blocks: 1,440 channel-pixels for
    each input pixel at dim 48."""
    cell = manifest.cell(CELL)
    tr = cell.traffic
    assert restormer.mdta_bytes(cell.config, tr["global_batch"], tr["patch"], tr["patch"]) \
        == 8_304_721_920 == 22 * 1440 * 4 * 256 * 256


def test_fp8_rounds_every_conv_and_every_attention_product(monkeypatch):
    """Under "fp8" each conv rounds its input and weight, and each of a
    block's two products both inputs (e4m3), and each output's gradient is
    rounded (e5m2); the f32 forward rounds nothing."""
    config = _config(**SMALL)
    weights = {k: v.requires_grad_(True) for k, v in
               restormer.make_weights(2, config, "cpu").items()}
    calls = []
    real = reference._fake_fp8
    monkeypatch.setattr(reference, "_fake_fp8",
                        lambda x, dtype: calls.append(dtype) or real(x, dtype))
    x = torch.rand(1, 16, 16, 4)
    restormer.forward(config, weights, x, "f32")
    assert calls == []
    y = restormer.forward(config, weights, x, "fp8")
    convs = sum(1 for t in weights.values() if t.dim() == 4)
    blocks = sum(n for _, _, n, _, _ in restormer.levels(config))
    assert calls.count(torch.float8_e4m3fn) == 2 * convs + 2 * 2 * blocks
    calls.clear()
    y.sum().backward()
    # the checkpointed blocks run their forward again in the backward
    block_convs = 6 * blocks
    assert calls.count(torch.float8_e5m2) == convs + 2 * blocks
    assert calls.count(torch.float8_e4m3fn) == 2 * block_convs + 2 * 2 * blocks
