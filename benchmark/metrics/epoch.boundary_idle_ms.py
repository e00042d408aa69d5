"""epoch.boundary_idle_ms: the device's idle time per traced epoch outside
every ``eld.pool.call`` and ``eld.pool.read`` span: the end of one epoch
and the start of the next.  Nothing is returned where the trace holds no
call span or no ``eld.pool.epoch`` span."""

from eldbench import spans


def read(ctx):
    s = spans.split(ctx.trace)
    if s is None or not s.epochs:
        return None
    return s.boundary_idle_us * 1e-3 / s.epochs
