"""dwconv.roofline_pct: Restormer's 3x3 depthwise convolutions' least time
over their measured time, per traced step.

The least time is a frozen count of bytes at the HBM peak: 10 bytes (bf16)
for each channel of each depthwise conv at each of its level's pixels, the
forward reading x and writing y, the backward reading x and gy and writing
gx.  Each transformer block runs two: MDTA's over 3 c channels and GDFN's
over 2 int(c · ffn_expansion_factor), c the level's width, over
``archs/<arch>.py::levels`` of one rank's batch at the cell's patch.  The
measured time is the device time of the kernels named ``dwconv3_*`` in the
trace (the forward, the backward and the weight gradient's sum), summed and
divided by the traced steps.  Nothing is returned where the trace holds no
such kernel or the architecture has no levels of transformer blocks."""

import re

from eldbench import manifest, yardstick

KERNEL = re.compile(r"(^|::|\s)dwconv3_[a-z]+\b")
BYTES_PER_CHANNEL_PIXEL = 10


def _channel_pixels(levels, expansion: float, n: int, h: int, w: int) -> int:
    return n * sum(count * (3 * c + 2 * int(c * expansion)) * (h * w // s ** 2)
                   for _, c, count, _, s in levels)


def read(ctx):
    times = ctx.trace.kernel_us(lambda name: KERNEL.search(name) is not None)
    levels = getattr(manifest.arch(ctx.config["arch"]), "levels", None)
    if not times or levels is None:
        return None
    tr = ctx.traffic
    pixels = _channel_pixels(levels(ctx.config), ctx.config["ffn_expansion_factor"],
                             ctx.rows_per_rank, tr["patch"], tr["patch"])
    least_s = BYTES_PER_CHANNEL_PIXEL * pixels / yardstick.H100_HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(times) * 1e-6 / ctx.steps_traced)
