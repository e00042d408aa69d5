"""The window's statistics, from the program's own record of when each
pooled call's loss reached the host (``Engine.history``)."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _epochs(history: Sequence[tuple], step0: int, steps_per_epoch: int):
    """The history's entries (K, host time), split at each epoch's end."""
    out, cur, s_prev = [], [], step0
    for steps, _, t in history:
        cur.append((steps - s_prev, t))
        s_prev = steps
        if (steps - step0) % steps_per_epoch == 0:
            out.append(cur)
            cur = []
    return out + ([cur] if cur else [])


def call_times(history: Sequence[tuple], t_open: float, step0: int,
               steps_per_epoch: int) -> List[Tuple[int, float]]:
    """(steps, seconds) of the window's calls, from ``history`` (entries
    (steps after the call, metrics, host time), the window's only).

    ``Engine.train_pool`` reads a call's loss once the next call is
    queued, and the read waits for that next call: within an epoch of n
    calls, entry i (i < n - 1) marks the end of call i + 1, and the last
    entry, read at once, the end of the last call.  So an epoch's first
    gap spans its first two calls, each later gap one call, and the last
    call runs from entry n - 3 to entry n - 1.  Every second of the window
    and every step is in exactly one span."""
    out, t_prev = [], t_open
    for epoch in _epochs(history, step0, steps_per_epoch):
        ks, ts = [k for k, _ in epoch], [t for _, t in epoch]
        n = len(epoch)
        if n == 1:
            out.append((ks[0], ts[0] - t_prev))
        else:
            ends = ts[:n - 2] + [ts[n - 1]]  # ends[j - 1]: the end of call j, j >= 1
            out.append((ks[0] + ks[1], ends[0] - t_prev))
            out += [(ks[j], ends[j - 1] - ends[j - 2]) for j in range(2, n)]
        t_prev = ts[-1]
    return out


def step_weighted_p95_ms(calls: Sequence[Tuple[int, float]]) -> float:
    """The 95th percentile over all steps, each step given its span's time
    divided by the span's steps."""
    per_step = [1e3 * secs / k for k, secs in calls for _ in range(k)]
    return percentile(per_step, 95)
