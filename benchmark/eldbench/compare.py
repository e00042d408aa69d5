"""The comparison that decides ``correct`` for a training cell.

The program's checked steps (through the window's own pooled calls and
CUDA graphs) against the plain reference's, from the same seed, pool and
initial weights:

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad1_gap``: the first gradient as Adam got it, read from its first
    moment after one step (exp_avg = (1 - beta1) g), by the worst leaf:
    |norm(program leaf) - norm(reference leaf)| over the larger of that
    leaf's reference norm and the median leaf's;
  * ``delta_gap``: the parameters' change after the last checked step,
    by the worst leaf in the same way.  Leaves whose reference first gradient is
    under a thousandth of the median leaf's move by round-off alone under
    Adam and are left out of it;
  * ``grad1_err_median``: the first gradient's error at the median leaf:
    each leaf's norm of the difference of the program's leaf and the
    reference's over the larger of that leaf's reference norm and the
    median leaf's, and the median of these over the leaves.  A gap of
    norms is the projection of the rounding error on the gradient, random
    in sign and size from seed to seed, and does not tell float8 from
    bfloat16 on every seed; the error's own norm does, and its median
    leaf does on every seed, where the worst leaf's swings with one small
    leaf (PERF.md).

Each number has its limit in ``limits/<cell>.json``, set from readings
of sound runs and of the control; ``correct`` is every number finite and
within its limit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

NUMBERS = ("loss_gap", "grad1_gap", "delta_gap", "grad1_err_median")
SILENT_GRAD = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    g, r = _norms(got), _norms(ref)
    keys = [k for k in r if keep is None or k in keep]
    floor = _median([r[k] for k in keys])
    return {k: abs(g[k] - r[k]) / max(r[k], floor, 1e-30) for k in keys}


def leaf_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of the difference over the larger of its reference
    norm and the median leaf's."""
    r = _norms(ref)
    floor = _median(list(r.values()))
    return {k: float(torch.linalg.vector_norm(got[k].double() - ref[k].double()))
            / max(r[k], floor, 1e-30) for k in r}


def err_readings(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> dict:
    """The first gradient's error read four ways: the median leaf's (the
    number compared), the worst leaf's, the worst weight's, and over all
    leaves as one vector."""
    errs = leaf_errors(got, ref)
    diff = torch.cat([(got[k].double() - ref[k].double()).flatten() for k in ref])
    whole = torch.cat([ref[k].double().flatten() for k in ref])
    return {"grad1_err_median": _median(list(errs.values())), "grad1_err": max(errs.values()),
            "grad1_err_weights": max(v for k, v in errs.items() if ref[k].dim() > 1),
            "grad1_err_all": float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(whole))}


def _detail(gaps: Dict[str, float], got, ref) -> dict:
    """The look behind a worst-leaf number: its three worst leaves, the
    median leaf's gap and the gap of the norm over all leaves."""
    total = [float(torch.linalg.vector_norm(torch.cat([t[k].double().flatten() for k in gaps])))
             for t in (got, ref)]
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return {"worst": worst, "median": _median(list(gaps.values())),
            "global": abs(total[0] - total[1]) / total[1], "leaves": gaps}


def readings(losses, grad1, params, ref: dict, weights, detail: bool = False) -> Dict[str, float]:
    """The numbers of one program run (``losses`` of its checked steps,
    its ``grad1`` and ``params`` after the steps) against the
    reference's ``ref`` (``reference.follow``) from ``weights``."""
    ref_losses = ref["losses"]
    if len(losses) != len(ref_losses):
        raise ValueError(f"{len(losses)} program losses against {len(ref_losses)} reference ones")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_norms = _norms(ref["grad1"])
    floor = _median(list(g_norms.values()))
    keep = {k for k, v in g_norms.items() if v >= SILENT_GRAD * floor}
    delta = {k: params[k].double() - weights[k].double() for k in weights}
    ref_delta = {k: ref["params"][k].double() - weights[k].double() for k in weights}
    g1 = leaf_gaps(grad1, ref["grad1"])
    dl = leaf_gaps(delta, ref_delta, keep)
    errs = err_readings(grad1, ref["grad1"])
    out = {"loss_gap": loss_gap, "grad1_gap": max(g1.values()), "delta_gap": max(dl.values()),
           "grad1_err_median": errs["grad1_err_median"]}
    if detail:
        out.update(errs)
        out["losses"] = [[a, b] for a, b in zip(losses, ref_losses)]
        out["grad1"] = _detail(g1, grad1, ref["grad1"])
        out["delta"] = _detail(dl, delta, ref_delta)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]["limit"] for k in NUMBERS)


def lines(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, list]:
    """Each number beside its limit, as the result line carries them."""
    return {k: [numbers[k], limits[k]["limit"]] for k in NUMBERS}
