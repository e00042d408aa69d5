"""ln.roofline_pct: Restormer's BiasFree LayerNorm's least time over its
measured time, per traced step.

The least time is a frozen count of bytes at the HBM peak: 10 bytes (bf16)
for each channel of each norm at each of its level's pixels, the forward
reading x and writing y, the backward reading x and gy and writing gx, two
norms a transformer block, over ``archs/<arch>.py::levels`` of one rank's
batch at the cell's patch.  The measured time is the device time of the
kernels named ``bfln_*`` in the trace (the forward, the backward and the
weight gradient's sum), summed and divided by the traced steps.  Nothing is
returned where the trace holds no such kernel or the architecture has no
levels of transformer blocks."""

import re

from eldbench import manifest, yardstick

KERNEL = re.compile(r"(^|::|\s)bfln_[a-z]+\b")
BYTES_PER_CHANNEL_PIXEL = 10
NORMS_PER_BLOCK = 2


def _bytes(levels, n: int, h: int, w: int) -> int:
    return BYTES_PER_CHANNEL_PIXEL * NORMS_PER_BLOCK * n * sum(
        count * c * (h * w // s ** 2) for _, c, count, _, s in levels)


def read(ctx):
    times = ctx.trace.kernel_us(lambda name: KERNEL.search(name) is not None)
    levels = getattr(manifest.arch(ctx.config["arch"]), "levels", None)
    if not times or levels is None:
        return None
    tr = ctx.traffic
    least_s = _bytes(levels(ctx.config), ctx.rows_per_rank, tr["patch"], tr["patch"]) \
        / yardstick.H100_HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(times) * 1e-6 / ctx.steps_traced)
