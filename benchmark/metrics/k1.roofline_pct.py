"""k1.roofline_pct: K1's least time over its measured time.

The least time is the frozen ``yardstick.k1_bytes`` of one rank's batch
at the HBM peak (its f32 operations take less); the measured time is the
mean device time of the kernels named ``noise_synth`` in the trace.
Nothing is returned where the trace holds no such kernel."""

from eldbench import yardstick


def read(ctx):
    times = ctx.trace.kernel_us(lambda name: "noise_synth" in name)
    if not times:
        return None
    tr = ctx.traffic
    shape = (ctx.rows_per_rank, tr["patch"], tr["patch"], tr["channels"])
    least_s = yardstick.k1_bytes(shape) / yardstick.H100_HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(times) / len(times) * 1e-6)
