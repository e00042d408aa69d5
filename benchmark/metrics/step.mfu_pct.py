"""step.mfu_pct: the whole train step's share of the cards' bf16 peak.

The frozen analytic FLOPs of one global step (the architecture's
``archs/<arch>.py::step_flops`` at the cell's global batch and patch)
over the window's time per step, which the traced run measures outside
the profiler's span, over the chips' peak."""

from eldbench import manifest, yardstick


def read(ctx):
    cf, tr = ctx.config, ctx.traffic
    flops = manifest.arch(cf["arch"]).step_flops(cf, tr["global_batch"], tr["patch"], tr["patch"])
    return 100.0 * flops / ctx.step_s / (ctx.chips * yardstick.H100_BF16_FLOPS)
