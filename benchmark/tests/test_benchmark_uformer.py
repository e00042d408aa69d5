"""Uformer's module of the benchmark (``archs/uformer.py``) and its reader
``metrics/wmsa.roofline_pct.py``: the module's parameter names and shapes
are the program's ``state_dict``, its float32 forward is the program's on
the CPU at a small size, its initial weights follow the authors' init, its
forward FLOPs are ``torch.utils.flop_counter``'s count, its step's FLOPs
and window-attention bytes at the cell's size are pinned, and under "fp8"
every conv, Linear and attention product rounds its inputs; the reader
takes the ``wmsa_*`` kernels' device time a traced step and nothing
else."""

import json
import os
import sys
import types

import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from eldbench import manifest, reference, trace, yardstick  # noqa: E402

uformer = manifest.arch("uformer")
READER = manifest.reader("wmsa.roofline_pct")
CELL = "syn-pool.uformer.p128b32"
# embed_dim 8, heads of 4 channels, windows of 4 at 64^2: every layer, shifts in the encoder and
# in the modulated decoder
SMALL = dict(embed_dim=8, depths=[1, 2, 1, 2, 2, 2, 1, 2, 1],
             num_heads=[2, 4, 8, 16, 32, 32, 16, 8, 4], win_size=4, img_size=64)
# the cell's step: 32 x 128^2 at the published widths
STEP_FLOPS = 4_157_041_803_264
WMSA_BYTES = 5_582_618_624


def _config(**kw):
    with open(os.path.join(BENCH, "configs", "uformer-b-w32.json")) as f:
        return {**json.load(f), **kw}


def _program(config):
    from eld_tpu_torch.models.uformer import Uformer

    return Uformer(config["in_channels"], config["out_channels"], embed_dim=config["embed_dim"],
                   depths=config["depths"], num_heads=config["num_heads"],
                   win_size=config["win_size"])


def test_param_specs_are_the_programs_state_dict():
    from eld_tpu_torch.models import build_arch

    config = _config()
    got = [(n, tuple(t.shape)) for n, t in
           build_arch("uformer", 4, 4, base_width=config["embed_dim"]).state_dict().items()]
    assert uformer.param_specs(config) == got
    assert sum(torch.Size(s).numel() for _, s in got) == config["parameters"] == 50_881_811
    assert uformer.program_args(config) == ["--netG", "uformer", "--base_width", "32"]
    assert sum(n for _, _, n, _, _ in uformer.levels(config)) == config["lewin_blocks"] == 40


def test_the_f32_forward_is_the_programs_on_the_cpu():
    """The program's model loaded with ``make_weights``' draw (the zero
    biases and the unit LayerNorm weights moved) against the reference's
    forward: f32, summation order only (rtol 1e-4, an atol of 1e-5 of the
    largest)."""
    config = _config(**SMALL)
    weights = uformer.make_weights(7, config, "cpu")
    gen = torch.Generator().manual_seed(8)
    for name, t in weights.items():
        if bool((t == 0).all()) or bool((t == 1).all()):
            weights[name] = t + 0.1 * torch.randn(t.shape, generator=gen)
    model = _program(config)
    model.load_state_dict(weights)
    x = torch.rand((2, 64, 64, 4), generator=gen)
    with torch.no_grad():
        got, ref = model(x), uformer.forward(config, weights, x)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))


def test_make_weights_follows_the_authors_init():
    """Linear weights N(0, 0.02^2) and biases 0, LayerNorm weights 1 and
    biases 0, bias tables N(0, 0.02^2), modulators N(0, 1), convs' and
    transposed convs' weights and biases within 1/sqrt(fan_in); the same
    seed draws the same weights."""
    config = _config(**SMALL)
    w = uformer.make_weights(3, config, "cpu")
    assert list(w) == [n for n, _ in uformer.param_specs(config)]

    def pooled(suffixes):
        return torch.cat([t.flatten() for n, t in w.items() if n.endswith(suffixes)])

    linear = pooled(("to_q.weight", "to_kv.weight", "proj.weight", "linear1.0.weight",
                     "linear2.0.weight"))
    assert abs(float(linear.std()) - 0.02) < 0.001 and abs(float(linear.mean())) < 0.001
    tables = pooled("bias_table")
    assert abs(float(tables.std()) - 0.02) < 0.002
    mods = pooled("modulator.weight")
    assert abs(float(mods.std()) - 1.0) < 0.05
    for name, t in w.items():
        if name.endswith(("to_q.bias", "to_kv.bias", "proj.bias", "linear1.0.bias",
                          "linear2.0.bias", "norm1.bias", "norm2.bias")):
            assert bool((t == 0).all()), name
        elif name.endswith(("norm1.weight", "norm2.weight")):
            assert bool((t == 1).all()), name
        elif ".conv." in name or ".deconv." in name or "_proj." in name or "dwconv" in name:
            weight = w[name.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / (weight.shape[1] * weight.shape[2] * weight.shape[3]) ** 0.5
            assert 0.5 * bound < float(t.abs().max()) <= bound, name
    assert all(torch.equal(a, b) for a, b in
               zip(w.values(), uformer.make_weights(3, config, "cpu").values()))


def test_forward_flops_are_the_flop_counters():
    config = _config(**SMALL)
    weights = uformer.make_weights(1, config, "cpu")
    x = torch.rand(2, 64, 64, 4)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        uformer.forward(config, weights, x)
    assert uformer.forward_flops(config, 2, 64, 64) == counter.get_total_flops()


def test_step_flops_and_wmsa_bytes_at_the_cells_size():
    """3x the forward less ``input_proj``'s input gradient: 21.66 G
    multiply-adds an image, 4.157 TFLOP a step of 32; and 22 bytes a
    channel-pixel over the 40 blocks: 7,929,856 channel-pixels an image."""
    cell = manifest.cell(CELL)
    cf, tr = cell.config, cell.traffic
    n, p = tr["global_batch"], tr["patch"]
    assert uformer.forward_flops(cf, 1, p, p) == 2 * 21_657_550_848
    assert uformer.step_flops(cf, n, p, p) == STEP_FLOPS \
        == 3 * uformer.forward_flops(cf, n, p, p) - 2 * n * p * p * 32 * 4 * 9
    assert uformer.wmsa_bytes(cf, n, p, p) == WMSA_BYTES == 22 * 7_929_856 * 32


def test_fp8_rounds_every_conv_linear_and_attention_product(monkeypatch):
    """Under "fp8" each conv and Linear rounds its input and weight, and each
    window's two products both inputs (e4m3), and each output's gradient
    is rounded (e5m2); the f32 forward rounds nothing."""
    config = _config(**SMALL)
    weights = {k: v.requires_grad_(True) for k, v in
               uformer.make_weights(2, config, "cpu").items()}
    calls = []
    real = reference._fake_fp8
    monkeypatch.setattr(reference, "_fake_fp8",
                        lambda x, dtype: calls.append(dtype) or real(x, dtype))
    x = torch.rand(1, 64, 64, 4)
    uformer.forward(config, weights, x, "f32")
    assert calls == []
    y = uformer.forward(config, weights, x, "fp8")
    blocks = sum(n for _, _, n, _, _ in uformer.levels(config))
    convs = 2 + 4 + 4  # the projections, the downsamplings, the upsamplings
    # a block: to_q, to_kv, proj, linear1, the depthwise conv, linear2, two products
    assert calls.count(torch.float8_e4m3fn) == 2 * convs + 2 * 8 * blocks
    calls.clear()
    y.sum().backward()
    # the checkpointed blocks run their forward again in the backward
    assert calls.count(torch.float8_e5m2) == convs + 8 * blocks
    assert calls.count(torch.float8_e4m3fn) == 2 * 8 * blocks


# ---- the reader -------------------------------------------------------------------------

def _kernel(name, a, b):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a}


def _ctx(cell_name, events, steps=2):
    cell = manifest.cell(cell_name)
    tr = cell.traffic
    return types.SimpleNamespace(trace=trace.from_events(events), config=cell.config,
                                 traffic=tr, rows_per_rank=tr["global_batch"] // tr["ranks"],
                                 steps_traced=steps)


def test_the_share_reads_the_wmsa_kernels_a_step():
    """Two traced steps of 5,000 us of ``wmsa_*`` kernels each, beside a
    GEMM, a softmax and the depthwise kernels that it leaves out."""
    events = [_kernel("void (anonymous namespace)::wmsa_fwd<false, true>(...)", 0, 3000),
              _kernel("void (anonymous namespace)::wmsa_bwd<true, true>(...)", 3000, 9500),
              _kernel("(anonymous namespace)::wmsa_sum(float const*, float*, int, int)",
                      9500, 10000),
              _kernel("void (anonymous namespace)::dwconv3_fwd<true>(...)", 10000, 12000),
              _kernel("void at::native::(anonymous namespace)::cunn_SoftMaxForward<...>",
                      12000, 13000),
              _kernel("sm90_xmma_gemm_bf16bf16_bf16f32", 13000, 14000)]
    got = READER.read(_ctx(CELL, events))
    want = 100.0 * WMSA_BYTES / yardstick.H100_HBM_BYTES_PER_S / 5000e-6
    assert abs(got - want) < 1e-9 * want and 33 < want < 34


def test_nothing_is_read_without_the_kernels_or_the_bytes():
    events = [_kernel("cunn_SoftMaxForward", 0, 10)]
    assert READER.read(_ctx(CELL, events)) is None
    wm = [_kernel("void (anonymous namespace)::wmsa_fwd<false, false>(...)", 0, 10)]
    assert READER.read(_ctx("syn-pool.restormer.p256b4", wm)) is None
    for name in ("xwmsa_fwd", "wmsa", "mdta_apply<48>"):
        assert READER.KERNEL.search(name) is None, name
