"""One run of a pooled-training cell on one rank: set-up, the checked
first steps, the warm-up, the timed window, the traced epochs and the
comparison with the plain reference.

The program is driven through the calls ``eld_tpu_torch/tools/
train_syn.py::main`` makes on its default pooled path: ``config.parse``,
``Engine(cfg)`` (after ``maybe_initialize_multihost`` on a launched
rank), and ``train_syn.train_epochs`` over a device-resident uint16 pool,
one epoch at a time.  The pool is made on the card from the seed in
place of ``pool_to_device`` of a patch store, and the initial weights
are made from the seed and loaded into the Engine's model, so the
reference can start from the same inputs.

Set-up (``setup_s``, from process start to the window's first call):
the Engine, the pool and the weights; the checked calls, each a one-call
epoch (``checked_calls``): a call of one step, whose Adam state gives the
first gradient, then each shape of call the window makes three times,
eagerly, then captured and replayed, then replayed, so the window's own
CUDA graphs make the checked steps; then one whole epoch.  The window
runs whole epochs until ``seconds`` have passed; on several ranks rank 0
decides at each epoch's end and broadcasts the decision.  ``--trace 1``
profiles two more epochs.  Then the Engine and its graphs are freed and
the reference follows every checked step.
"""

from __future__ import annotations

import functools
import gc
import math
import os
import shutil
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional, Sequence

import torch

from eldbench import compare, manifest, reference, scenes, stats, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "eld_tpu")
NO_EVAL = 1 << 30
# epochs the traced run profiles: two, so the span holds an epoch's boundary
TRACED_EPOCHS = 2


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_argv(cell: manifest.Cell, seed: int, save_root: str, device: str) -> List[str]:
    cf, tr = cell.config, cell.traffic
    opt = cf["optimizer"]
    argv = ["--name", cell.name, "--checkpoints_dir", save_root, "--device", device,
            *arch(cell).program_args(cf), "--noise", cf["noise"],
            "--include", str(cf["camera_include"]), "--loss", cf["loss"],
            "--lr", repr(opt["lr"]), "--beta1", repr(opt["beta1"]),
            "-b", str(tr["global_batch"]), "--mesh_data", str(tr["ranks"]),
            "--seed", str(program_seed(seed)), "--no-log", "--no-verbose"]
    if cf["precision"] == "bf16":
        argv.append("--bf16")
    return argv


def arch(cell: manifest.Cell):
    """The module of the cell's architecture (``archs/<arch>.py``)."""
    return manifest.arch(cell.config["arch"])


def forward(cell: manifest.Cell):
    """The cell's model as the reference runs it, ``forward(p, x,
    precision)``: its architecture's ``forward`` with the configuration
    bound."""
    return functools.partial(arch(cell).forward, cell.config)


def program_seed(seed: int) -> int:
    """The Engine's ``--seed``: the run's seed in the 32 bits the program
    also seeds NumPy with."""
    return int(seed) % (1 << 32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _one_epoch(engine, pool, steps: int, k: int):
    from eld_tpu_torch.tools.train_syn import train_epochs

    train_epochs(engine, engine.epoch + 1, NO_EVAL, {}, None, pool, steps, k)


def setup(cell: manifest.Cell, seed: int, save_root: str, device: str = "cuda",
          extra_argv: Sequence[str] = (), phases: Optional[dict] = None):
    """The Engine, its pool and the benchmark's initial weights, loaded;
    ``phases`` gets the time each part ended, from the first."""
    t0, phases = time.time(), {} if phases is None else phases
    from eld_tpu_torch import config as config_mod
    from eld_tpu_torch.parallel.multihost import maybe_initialize_multihost
    from eld_tpu_torch.train.engine import Engine

    cfg = config_mod.parse(program_argv(cell, seed, save_root, device) + list(extra_argv),
                           train=True)
    phases["imports"] = time.time() - t0
    maybe_initialize_multihost(cfg)
    engine = Engine(cfg)
    phases["engine"] = time.time() - t0
    tr = cell.traffic
    pool = {"clean": scenes.make_pool(seed, tr["pool_patches"], tr["patch"], engine.device)}
    weights = arch(cell).make_weights(seed, cell.config, engine.device)
    engine.model.load_state_dict(weights)
    _sync(engine.device)
    phases["pool_weights"] = time.time() - t0
    return engine, pool, weights


def epoch_steps(traffic: dict) -> int:
    return max(1, traffic["pool_patches"] // traffic["global_batch"])


def checked_calls(k: int, steps_per_epoch: int) -> List[int]:
    """The steps of each checked call: one step (Adam's state after it is
    the first gradient), then each shape of call an epoch makes, the
    remainder's and ``k``, three times: eager, captured, replayed."""
    rem = steps_per_epoch % k
    shapes = ([rem] if rem else []) + ([k] if steps_per_epoch >= k else [])
    calls = [] if shapes[0] == 1 else [1]
    for s in shapes:
        calls += [s] * 3
    return calls


def checked_steps(engine, pool, calls: Sequence[int]) -> dict:
    """The checked calls, one call an epoch, and what the comparison reads
    of them: every step's loss, the first gradient and the parameters
    after the last step."""
    grad1 = None
    beta1 = engine.cfg.beta1
    named = dict(engine.model.named_parameters())
    losses = []
    for i, k in enumerate(calls):
        _one_epoch(engine, pool, k, k)
        losses += [float(v) for v in engine._scan_fn(k).losses.detach().float().cpu()]
        if i == 0:
            state = engine.state.optimizer.state
            grad1 = {n: state[p]["exp_avg"].detach() / (1.0 - beta1) for n, p in named.items()}
    params = {n: p.detach().clone() for n, p in named.items()}
    return {"losses": losses, "grad1": grad1, "params": params}


def _window(engine, pool, steps: int, k: int, seconds: float, world: int):
    from eld_tpu_torch.parallel.multihost import broadcast_from_host0

    t_open = time.perf_counter()
    while True:
        _one_epoch(engine, pool, steps, k)
        done = time.perf_counter() - t_open >= seconds
        if world > 1:
            done = bool(broadcast_from_host0(done))
        if done:
            return t_open


def run_rank(cell: manifest.Cell, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", extra_argv: Sequence[str] = ()) -> dict:
    """One rank's run; returns what the result line is made of."""
    tr, cf = cell.traffic, cell.config
    tmp = tempfile.mkdtemp(prefix="eldbench-")
    phases = {"start": time.time() - t_start}
    try:
        engine, pool, weights = setup(cell, seed, os.path.join(tmp, "ck"), device, extra_argv,
                                      phases)
        dev, rank, world = engine.device, engine.rank, engine.world
        _sync(dev)
        phases["setup"] = time.time() - t_start
        k = tr["steps_per_call"]
        steps_per_epoch = epoch_steps(tr)
        checked = checked_steps(engine, pool, checked_calls(k, steps_per_epoch))
        phases["checked"] = time.time() - t_start
        for _ in range(tr["warmup_epochs"]):
            _one_epoch(engine, pool, steps_per_epoch, k)
        _sync(dev)
        phases["warmup"] = time.time() - t_start
        n0, step0 = len(engine.history), engine.iterations
        setup_s = time.time() - t_start
        t_open = _window(engine, pool, steps_per_epoch, k, seconds, world)
        calls = stats.call_times(engine.history[n0:], t_open, step0, steps_per_epoch)
        window_s = engine.history[-1][2] - t_open
        failed = sum(b - a for (a, _, _), (b, m, _) in zip(engine.history[n0 - 1:],
                                                           engine.history[n0:])
                     if not all(math.isfinite(v) for v in m.values()))
        out = {"rank": rank, "world": world, "setup_s": setup_s, "window_s": window_s,
               "calls": calls, "steps": engine.iterations - step0, "failed_steps": failed,
               "steps_per_epoch": steps_per_epoch, "counts": _counts(engine), "phases": phases}
        if traced:
            path = os.path.join(tmp, "trace.json")
            tracing.profile_span(lambda: [_one_epoch(engine, pool, steps_per_epoch, k)
                                          for _ in range(TRACED_EPOCHS)], path, dev)
            trace = tracing.read(path)
            out.update(busy_us=trace.busy_us, traced_us=trace.window_us,
                       per_layer=per_layer(cell, trace, out), breakdown=tracing.breakdown(trace))
        if dev.type == "cuda":
            out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
            out["kind"] = torch.cuda.get_device_name(dev)
        lr, beta1 = engine.cfg.lr, engine.cfg.beta1
        pseed = engine.cfg.seed
        engine.release_graphs()
        del engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["numbers"] = check(cell, pool["clean"], weights, checked, pseed, lr, beta1, world)
        out["forbidden"] = forbidden_modules()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _counts(engine) -> dict:
    from eld_tpu_torch.noise.kernels import synthesize_kernel
    from eld_tpu_torch.train.steps import graph_replays

    return {"k1_launches": synthesize_kernel.launches, "iterations": engine.iterations,
            "graph_replays": sum(graph_replays(fn) for fn in engine._train_scans.values())}


def camera_file(cell: manifest.Cell) -> str:
    return os.path.join(manifest.ROOT, cell.config["calibration_file"])


def check(cell: manifest.Cell, pool: torch.Tensor, weights, checked: dict, program_seed_: int,
          lr: float, beta1: float, world: int, detail: bool = False) -> Dict[str, float]:
    """The reference follows the checked steps; the comparison's numbers."""
    bank = reference.camera_bank(camera_file(cell), pool.device)
    seeds = [reference.fold_in(program_seed_, i) for i in range(len(checked["losses"]))]
    ref = reference.follow(forward(cell), weights, pool, bank, cell.traffic["global_batch"],
                           seeds, lr, beta1, world)
    return compare.readings(checked["losses"], checked["grad1"], checked["params"], ref, weights,
                            detail)


def per_layer(cell: manifest.Cell, trace: tracing.Trace, run: dict) -> Dict[str, float]:
    """The per-layer metrics whose readers find something to read in this
    rank's ``trace`` and ``run``."""
    tr, cf = cell.traffic, cell.config
    ctx = types.SimpleNamespace(
        trace=trace, config=cf, traffic=tr, chips=run["world"],
        rows_per_rank=tr["global_batch"] // tr["ranks"],
        steps_traced=run["steps_per_epoch"] * TRACED_EPOCHS,
        step_s=run["window_s"] / run["steps"])
    out = {}
    for m in cell.per_layer:
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell: manifest.Cell, ranks: List[dict], traced: bool, power_limit: Optional[str]):
    """The result line's object from every rank's run (rank 0 first)."""
    r0 = ranks[0]
    numbers = {k: max(r["numbers"][k] for r in ranks) for k in compare.NUMBERS}
    correct = compare.judge(numbers, cell.limits)
    batch = cell.traffic["global_batch"]
    if traced:
        metrics = r0["per_layer"]
    else:
        calls = r0["calls"]
        values = {"train_patches_per_s": r0["steps"] * batch / r0["window_s"],
                  "train_step_p95_ms": stats.step_weighted_p95_ms(calls),
                  "setup_s": r0["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": r0.get("kind", "none"), "count": len(ranks),
              "memory_peak_bytes": max(r.get("memory_peak_bytes", 0) for r in ranks)}
    if power_limit:
        device["power_limit"] = power_limit
    out = {"correct": correct, "attempted": r0["steps"], "failed": r0["failed_steps"],
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = sum(r["busy_us"] for r in ranks) / len(ranks) * 1e-6
        device["window_s"] = r0["traced_us"] * 1e-6
        out["breakdown"] = r0["breakdown"]
    out["compared"] = compare.lines(numbers, cell.limits)
    return out
