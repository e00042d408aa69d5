"""step.mfu_pct: the whole train step's share of the cards' bf16 peak.

The frozen analytic FLOPs of one global step (``yardstick.conv_flops``
at the cell's global batch and patch) over the window's time per step,
which the traced run measures outside the profiler's span, over the
chips' peak."""

from eldbench import yardstick


def read(ctx):
    cf, tr = ctx.config, ctx.traffic
    flops = yardstick.conv_flops(cf["arch"], tr["global_batch"], tr["patch"], tr["patch"],
                                 cf["base_width"], cf["in_channels"], cf["out_channels"])
    return 100.0 * flops / ctx.step_s / (ctx.chips * yardstick.H100_BF16_FLOPS)
