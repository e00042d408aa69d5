"""pool.host_idle_ms: the device's idle time per pooled call while the host
is inside an ``eld.pool.call`` span but outside its ``eld.pool.read``: the
part of the host's work per call that the device waits out.  Nothing is
returned where the trace holds no call span."""

from eldbench import spans


def read(ctx):
    s = spans.split(ctx.trace)
    if s is None:
        return None
    return s.host_idle_us * 1e-3 / s.calls
