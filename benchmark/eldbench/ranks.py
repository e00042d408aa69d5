"""The launched ranks of a cell on several cards: ``rank_main`` is the
module-level target ``eld_tpu_torch.parallel.launch.launch`` starts on
each card, with the harness's own flags and the ``--multihost
--mesh_data D`` that ``launch`` appends."""

from __future__ import annotations

import argparse

from eldbench import cell as cell_mod
from eldbench import manifest


def parse(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--t0", type=float, required=True)
    return p.parse_known_args(argv)


def rank_main(argv):
    ns, rest = parse(argv)
    return cell_mod.run_rank(manifest.cell(ns.workload), ns.seed, ns.seconds, bool(ns.trace),
                             ns.t0, extra_argv=rest)


def calibrate_main(argv):
    """A launched rank's program readings for ``benchmark/calibrate.py``."""
    from eldbench import calibrate

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    ns, rest = p.parse_known_args(argv)
    seeds = [int(s) for s in ns.seeds.split(",")]
    return calibrate.program(manifest.cell(ns.workload), seeds, extra_argv=rest)
