"""The benchmark of the PyTorch/CUDA port: one cell of ``BENCHMARK.json``, once.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It refuses to run without as many CUDA cards as the cell asks for, makes
the cell's inputs and weights from ``--seed``, warms up, trains for
``--seconds`` and prints one JSON object as the last line of standard
output: the end-to-end metrics with ``--trace 0``, the per-layer metrics
with ``--trace 1``.  ``correct`` says whether the program's checked
steps, made by the window's own pooled calls and CUDA graphs, agree with
the plain reference (``eldbench/compare.py``); the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key.  A cell on D cards launches D ranks through
``eld_tpu_torch.parallel.launch.launch`` and prints rank 0's line.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _power_limit():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    from eldbench import cell as cell_mod
    from eldbench import manifest

    cell = manifest.cell(ns.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"[benchmark] {ns.workload} needs {cell.chips} CUDA card(s), found {cards}; "
              "nothing runs on the CPU", file=sys.stderr)
        return 2
    if cell.traffic["ranks"] != cell.chips:
        raise ValueError(f"{ns.workload}: traffic {cell.traffic['name']} runs "
                         f"{cell.traffic['ranks']} ranks on {cell.chips} chips")
    if cell.chips == 1:
        ranks = [cell_mod.run_rank(cell, ns.seed, ns.seconds, bool(ns.trace), T0)]
    else:
        from eld_tpu_torch.parallel.launch import launch

        from eldbench.ranks import rank_main

        args = ["--workload", ns.workload, "--seed", str(ns.seed), "--seconds",
                str(ns.seconds), "--trace", str(ns.trace), "--t0", repr(T0)]
        ranks = launch(rank_main, args, cell.chips, "cuda")
    found = sorted(set(cell_mod.forbidden_modules()).union(*(r["forbidden"] for r in ranks)))
    if found:
        print(f"[benchmark] modules the port must not load were loaded: {found}", file=sys.stderr)
        return 3
    out = cell_mod.result(cell, ranks, bool(ns.trace), _power_limit())
    r0 = ranks[0]
    per_epoch = max(1, len(r0["calls"]) * r0["steps_per_epoch"] // r0["steps"])
    by_position = [sorted(1e3 * s / k for k, s in r0["calls"][i::per_epoch])
                   for i in range(per_epoch)]
    print(json.dumps({"counts": r0["counts"], "calls": len(r0["calls"]), "steps": r0["steps"],
                      "ranks": len(ranks), "phases_s": r0["phases"],
                      "step_ms_by_call_in_epoch": [[v[0], v[len(v) // 2], v[-1]]
                                                   for v in by_position if v]}))
    for name, (value, limit) in out["compared"].items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
