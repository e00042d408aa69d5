"""The readings a cell's limits are set from (``benchmark/calibrate.py``).

  * ``program``: the program's sound runs, seed by seed: set-up and the
    checked steps as a run makes them, then the comparison (no window).
  * ``control``: the reference computed in float8 put in the program's
    place, against the float32 reference, through every checked step;
    ``control_first``: the same through the first step alone, which is
    all the first gradient's numbers read, on more seeds for as little.
  * ``faults``: the faults a training cell can have, planted in the
    reference put in the program's place: "half_batch", and on several
    ranks "no_exchange" (each rank's own, the worst rank kept).  A step
    that returns its state unchanged reads 1 on ``delta_gap`` and needs
    no run.
  * ``reference_bf16``: the reference under bfloat16 autocast, the
    witness that the program's own readings are bfloat16's.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
from typing import List

import torch

from eldbench import cell as cell_mod
from eldbench import compare, manifest, reference, scenes


def program(cell: manifest.Cell, seeds: List[int], device: str = "cuda",
            extra_argv=()) -> List[dict]:
    out = []
    tr = cell.traffic
    calls = cell_mod.checked_calls(tr["steps_per_call"], cell_mod.epoch_steps(tr))
    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="eldbench-cal-")
        try:
            engine, pool, weights = cell_mod.setup(cell, seed, os.path.join(tmp, "ck"), device,
                                                   extra_argv)
            checked = cell_mod.checked_steps(engine, pool, calls)
            cfg, world, rank = engine.cfg, engine.world, engine.rank
            engine.release_graphs()
            del engine
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            numbers = cell_mod.check(cell, pool["clean"], weights, checked, cfg.seed, cfg.lr,
                                     cfg.beta1, world, detail=True)
            out.append({"seed": seed, "rank": rank, "what": "program", **numbers})
            del pool, weights, checked
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def reference_side(cell: manifest.Cell, seeds: List[int], device: str = "cuda",
                   first_only: bool = False) -> List[dict]:
    """The control's and the faults' readings, reference against reference;
    with ``first_only`` the control's first-gradient numbers alone."""
    tr, cf = cell.traffic, cell.config
    opt, world, model = cf["optimizer"], tr["ranks"], cell_mod.forward(cell)
    n_steps = 1 if first_only else sum(
        cell_mod.checked_calls(tr["steps_per_call"], cell_mod.epoch_steps(tr)))
    out = []
    for seed in seeds:
        pool = scenes.make_pool(seed, tr["pool_patches"], tr["patch"], device)
        weights = cell_mod.arch(cell).make_weights(seed, cf, device)
        bank = reference.camera_bank(cell_mod.camera_file(cell), device)
        steps = [reference.fold_in(cell_mod.program_seed(seed), i) for i in range(n_steps)]

        def follow(**kw):
            return reference.follow(model, weights, pool, bank, tr["global_batch"], steps,
                                    opt["lr"], opt["beta1"], world, **kw)

        ref = follow()
        arms = {"control_fp8": [follow(precision="fp8")]}
        if not first_only:
            arms.update(half_batch=[follow(fault="half_batch")],
                        reference_bf16=[follow(precision="bf16")])
            if world > 1:
                arms["no_exchange"] = [follow(fault="no_exchange", rank=r) for r in range(world)]
        for name, runs in arms.items():
            numbers = [compare.readings(r["losses"], r["grad1"], r["params"], ref, weights,
                                        detail=True) for r in runs]
            worst = max(numbers, key=lambda n: n["grad1_gap"])
            worst.update({k: max(n[k] for n in numbers) for k in compare.NUMBERS})
            if first_only:
                worst = {k: v for k, v in worst.items() if k.startswith(("grad1_gap", "grad1_err"))}
                name = "control_fp8_first"
            out.append({"seed": seed, "what": name, **worst})
        del pool, weights, ref, arms
        gc.collect()
    return out
