"""pool.host_ms: the host's own work per pooled call, in ms: the mean over
the traced ``eld.pool.call`` spans of their time outside ``eld.pool.read``
(the seeds, the binding's check, the launch, the report).  Nothing is
returned where the trace holds no such span."""

from eldbench import spans


def read(ctx):
    s = spans.split(ctx.trace)
    if s is None:
        return None
    return s.host_us * 1e-3 / s.calls
