"""Drives a cell's run on the CPU with a fault planted in the program
underneath (for ``test_benchmark_faults.py``), in a copy of the
benchmark whose cells are cut to a CPU's size.  K1, which has no CPU
build, is stood in for by its own draws (``kernel_draws``) through the
noise model's core, as the card computes it.

  python benchmark/tests/faultdriver.py --workload <cell> --fault <fault> --seed <n>

Faults: none, unchanged (the optimizer step leaves the parameters as
they were), half_batch (the loss is the mean over the first half of the
rows), no_exchange (the ranks' gradients are not averaged)."""

import argparse
import json
import os
import sys
import time

T0 = time.time()
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def plant(fault: str):
    import torch

    from eld_tpu_torch.noise import kernels
    from eld_tpu_torch.noise.model import noise_core
    from eld_tpu_torch.train import engine, steps

    def k1(seed, clean, params, model="PGrqc", clip=True):
        seed = int(seed.item()) if isinstance(seed, torch.Tensor) else int(seed)
        draws = kernels.kernel_draws(seed & ((1 << 64) - 1), tuple(clean.shape), model)
        out = noise_core(clean, params, model, draws)
        return torch.clamp(out, 0.0, 1.0) if clip else out

    steps.synthesize_kernel = k1
    if fault == "unchanged":
        adam_step = torch.optim.Adam.step

        def step(self, *a, **kw):
            params = [p for g in self.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            out = adam_step(self, *a, **kw)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out

        torch.optim.Adam.step = step
    elif fault == "half_batch":
        init_loss = steps.init_loss

        def half(name):
            fn = init_loss(name)
            return lambda pred, target: fn(pred[: pred.shape[0] // 2],
                                           target[: target.shape[0] // 2])

        steps.init_loss = half
    elif fault == "no_exchange":
        engine._data_parallel = lambda model: model
        steps._GraphCall._mean_grads = lambda self, model: None
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")


def rank_target(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--fault", required=True)
    ns, rest = p.parse_known_args(argv)
    plant(ns.fault)
    from eldbench.ranks import rank_main

    return rank_main(rest)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True)
    p.add_argument("--seed", type=int, required=True)
    ns = p.parse_args()
    from eldbench import cell as cell_mod
    from eldbench import manifest

    cell = manifest.cell(ns.workload)
    if cell.chips == 1:
        plant(ns.fault)
        ranks = [cell_mod.run_rank(cell, ns.seed, 1.0, False, T0, device="cpu")]
    else:
        from eld_tpu_torch.parallel.launch import launch

        args = ["--workload", ns.workload, "--seed", str(ns.seed), "--seconds", "1",
                "--trace", "0", "--t0", repr(T0), "--device", "cpu", "--fault", ns.fault]
        ranks = launch(rank_target, args, cell.chips, "cpu")
    print(json.dumps(cell_mod.result(cell, ranks, False, None)))


if __name__ == "__main__":
    main()
