"""``metrics/dwconv.roofline_pct.py`` on canned traces: the depthwise
convs' channel-pixel count at the Restormer cell's size, against the
model's own ``Conv2d(groups=C)`` modules; the share from the ``dwconv3_*``
kernels' device time a traced step (cuDNN's depthwise kernels and others
left out); and nothing read in a trace without them or in a U-Net cell."""

import os
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from eldbench import manifest, trace, yardstick  # noqa: E402

READER = manifest.reader("dwconv.roofline_pct")
# 3,136,880,640 channel-pixels a step at 10 bytes each
CELL_CHANNEL_PIXELS = 3_136_880_640
CELL_BYTES = 31_368_806_400


def _kernel(name, a, b):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a}


def _ctx(cell_name, events, steps=2):
    cell = manifest.cell(cell_name)
    tr = cell.traffic
    return types.SimpleNamespace(trace=trace.from_events(events), config=cell.config,
                                 traffic=tr, rows_per_rank=tr["global_batch"] // tr["ranks"],
                                 steps_traced=steps)


def test_the_count_at_the_restormer_cells_size():
    cell = manifest.cell("syn-pool.restormer.p256b4")
    levels = manifest.arch("restormer").levels(cell.config)
    got = READER._channel_pixels(levels, cell.config["ffn_expansion_factor"], 4, 256, 256)
    assert got == CELL_CHANNEL_PIXELS == CELL_BYTES // READER.BYTES_PER_CHANNEL_PIXEL
    assert round(got / 1e9, 3) == 3.137 and round(CELL_BYTES / 1e9, 2) == 31.37


def test_the_count_matches_the_models_own_depthwise_modules():
    """Each ``nn.Conv2d`` of as many groups as channels in the port's
    Restormer at the cell's configuration, at its level's pixels of a batch
    of 4 at 256^2: the same sum."""
    torch = pytest.importorskip("torch")
    from eld_tpu_torch.models import build_arch

    model = build_arch("restormer", 4, 4, base_width=48)
    pitch = {name: s for name, _, _, _, s in
             manifest.arch("restormer").levels(manifest.cell("syn-pool.restormer.p256b4").config)}
    total = sum(m.in_channels * 4 * (256 // pitch[name.split(".")[0]]) ** 2
                for name, m in model.named_modules()
                if isinstance(m, torch.nn.Conv2d) and m.groups == m.in_channels > 1)
    assert total == CELL_CHANNEL_PIXELS


def test_the_share_reads_the_dwconv3_kernels_a_step():
    """Two traced steps of 10,000 us of ``dwconv3_*`` kernels each, beside
    cuDNN's depthwise kernels, a LayerNorm kernel and a GEMM that it leaves
    out."""
    events = [_kernel("void (anonymous namespace)::dwconv3_fwd<8>(...)", 0, 7000),
              _kernel("void (anonymous namespace)::dwconv3_bwd<4>(...)", 7000, 19000),
              _kernel("(anonymous namespace)::dwconv3_wsum(float const*, float*, int, int)",
                      19000, 20000),
              _kernel("void conv2d_c1_k1_nhwc_kernel<...>(...)", 20000, 30000),
              _kernel("void dgrad2d_c1_k1_nhwc_specialized_kernel<...>(...)", 30000, 40000),
              _kernel("void wgrad2d_c1_k1_nhwc_kernel<...>(...)", 40000, 50000),
              _kernel("void (anonymous namespace)::bfln_fwd<__nv_bfloat16, 3>(...)", 50000, 51000),
              _kernel("sm90_xmma_wgrad_bf16", 51000, 52000)]
    got = READER.read(_ctx("syn-pool.restormer.p256b4", events))
    want = 100.0 * CELL_BYTES / yardstick.H100_HBM_BYTES_PER_S / 10000e-6
    assert abs(got - want) < 1e-9 * want and 93 < want < 94


def test_the_kernel_pattern_leaves_cudnns_depthwise_kernels_out():
    for name in ("conv2d_c1_k1_nhwc", "dgrad2d_c1_k1_nhwc_specialized", "wgrad2d_c1_k1_nhwc",
                 "void at::native::conv_depthwise2d_forward_kernel<...>", "xdwconv3_fwd"):
        assert READER.KERNEL.search(name) is None, name
    for name in ("dwconv3_fwd", "void (anonymous namespace)::dwconv3_bwd<4>(...)",
                 "void__anonymous_namespace_::dwconv3_wsum"):
        assert READER.KERNEL.search(name) is not None, name


def test_nothing_is_read_without_the_kernels():
    events = [_kernel("wgrad2d_c1_k1_nhwc", 0, 10)]
    assert READER.read(_ctx("syn-pool.restormer.p256b4", events)) is None
    dw = [_kernel("void (anonymous namespace)::dwconv3_fwd<8>(...)", 0, 10)]
    assert READER.read(_ctx("syn-pool.unet.b8", events)) is None
    assert READER.read(_ctx("syn-pool.unet.b8", dw)) is None
