"""wmsa.roofline_pct: Uformer's shifted-window attention's least time over
its measured time, per traced step.

The least time is the frozen ``archs/<arch>.py::wmsa_bytes`` of one rank's
batch at the cell's patch, at the HBM peak (its products take less); the
measured time is the device time of the kernels named ``wmsa_*`` in the
trace (the forward, the backward and the backward's sums), summed and
divided by the traced steps.  Nothing is returned where the trace holds no
such kernel or the architecture has no window-attention bytes."""

import re

from eldbench import manifest, yardstick

KERNEL = re.compile(r"(^|::|\s)wmsa_[a-z_]+\b")


def read(ctx):
    times = ctx.trace.kernel_us(lambda name: KERNEL.search(name) is not None)
    nbytes = getattr(manifest.arch(ctx.config["arch"]), "wmsa_bytes", None)
    if not times or nbytes is None:
        return None
    tr = ctx.traffic
    least_s = nbytes(ctx.config, ctx.rows_per_rank, tr["patch"], tr["patch"]) \
        / yardstick.H100_HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(times) * 1e-6 / ctx.steps_traced)
