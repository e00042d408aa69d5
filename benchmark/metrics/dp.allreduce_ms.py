"""dp.allreduce_ms: NCCL's device time per optimizer step on rank 0 (the
gradients' all-reduce inside each step's graph, and the losses' mean
once a call), from the traced epoch.  Nothing is returned where the
trace holds no NCCL kernel (one rank)."""


def is_nccl(name: str) -> bool:
    return any(w in name.lower() for w in ("nccl", "allreduce"))


def read(ctx):
    times = ctx.trace.kernel_us(is_nccl)
    if not times:
        return None
    return sum(times) * 1e-3 / ctx.steps_traced
