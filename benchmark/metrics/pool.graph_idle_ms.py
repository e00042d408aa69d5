"""pool.graph_idle_ms: the device's idle time per pooled call while the host
is inside an ``eld.pool.read`` span, waiting for the device: gaps inside
the running graph.  Nothing is returned where the trace holds no
``eld.pool.call`` span."""

from eldbench import spans


def read(ctx):
    s = spans.split(ctx.trace)
    if s is None:
        return None
    return s.graph_idle_us * 1e-3 / s.calls
