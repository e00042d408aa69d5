"""Readings to set a cell's limits from: the program's sound runs, the
float8 control and the planted faults (``eldbench/calibrate.py``), one
JSON line each on standard output and in ``--out``.

  python3 benchmark/calibrate.py --workload syn-pool.unet.b8 --seeds 1,2,3 \\
      --what program,reference --out chiprun_out/cal.jsonl

``--what control_first`` reads the float8 control's first-gradient
numbers alone, one step a seed.

The program's readings of a cell on D cards come from D launched ranks
(each rank's own line); the reference side runs on one card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,reference")
    p.add_argument("--out", default=None)
    ns = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    from eldbench import calibrate, manifest

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(ns.workload)
    seeds = [int(s) for s in ns.seeds.split(",")]
    what = ns.what.split(",")
    lines = []
    t0 = time.time()
    if "program" in what:
        if cell.chips == 1:
            lines += calibrate.program(cell, seeds)
        else:
            from eld_tpu_torch.parallel.launch import launch

            from eldbench.ranks import calibrate_main

            for rank in launch(calibrate_main, ["--workload", ns.workload, "--seeds", ns.seeds],
                               cell.chips, "cuda"):
                lines += rank
    if "reference" in what:
        lines += calibrate.reference_side(cell, seeds)
    if "control_first" in what:
        lines += calibrate.reference_side(cell, seeds, first_only=True)
    for line in lines:
        line["workload"] = ns.workload
        print(json.dumps(line), flush=True)
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    print(f"[calibrate] {ns.workload}: {len(lines)} readings in {time.time() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
