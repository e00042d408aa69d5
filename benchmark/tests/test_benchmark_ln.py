"""``metrics/ln.roofline_pct.py`` on canned traces: the LayerNorm's byte
count at the Restormer cell's size, the share from the ``bfln_*`` kernels'
device time a traced step (other kernels left out), and nothing read in a
trace without them or in a U-Net cell."""

import os
import sys
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from eldbench import manifest, trace, yardstick  # noqa: E402

READER = manifest.reader("ln.roofline_pct")
# 10 bytes a channel-pixel, two norms a block: 754,974,720 channel-pixels a step
CELL_BYTES = 7_549_747_200


def _kernel(name, a, b):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a}


def _ctx(cell_name, events, steps=2):
    cell = manifest.cell(cell_name)
    tr = cell.traffic
    return types.SimpleNamespace(trace=trace.from_events(events), config=cell.config,
                                 traffic=tr, rows_per_rank=tr["global_batch"] // tr["ranks"],
                                 steps_traced=steps)


def test_the_bytes_at_the_restormer_cells_size():
    cell = manifest.cell("syn-pool.restormer.p256b4")
    levels = manifest.arch("restormer").levels(cell.config)
    assert READER._bytes(levels, 4, 256, 256) == CELL_BYTES == 10 * 2 * 1440 * 4 * 256 * 256


def test_the_share_reads_the_bfln_kernels_a_step():
    """Two traced steps of 2,500 us of ``bfln_*`` kernels each, beside an
    MDTA and a cuDNN kernel that it leaves out."""
    events = [_kernel("void (anonymous namespace)::bfln_fwd<__nv_bfloat16, 3>(...)", 0, 1500),
              _kernel("void (anonymous namespace)::bfln_bwd<__nv_bfloat16, 3>(...)", 1500, 4900),
              _kernel("(anonymous namespace)::bfln_wsum(float const*, float*, int, int)",
                      4900, 5000),
              _kernel("void (anonymous namespace)::mdta_gram<48>(...)", 5000, 9000),
              _kernel("sm90_xmma_wgrad_bf16", 9000, 12000)]
    got = READER.read(_ctx("syn-pool.restormer.p256b4", events))
    want = 100.0 * CELL_BYTES / yardstick.H100_HBM_BYTES_PER_S / 2500e-6
    assert abs(got - want) < 1e-9 * want and 90 < want < 91


def test_nothing_is_read_without_the_kernels():
    events = [_kernel("void (anonymous namespace)::mdta_gram<48>(...)", 0, 10)]
    assert READER.read(_ctx("syn-pool.restormer.p256b4", events)) is None
    bfln = [_kernel("void (anonymous namespace)::bfln_fwd<float, 3>(...)", 0, 10)]
    assert READER.read(_ctx("syn-pool.unet.b8", events)) is None
    assert READER.read(_ctx("syn-pool.unet.b8", bfln)) is None
