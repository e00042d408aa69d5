"""The control: the reference computed in float8 in the program's place
comes out not correct, and so do the planted faults.

On the card (marked ``cuda``, skipped without one) each cell's control
and faults run at the cell's own size on three seeds and are judged by
the cell's limits.  On the CPU, at a small size, the float8 control's
median leaf's gradient error is many times bfloat16's, so the rounding does happen."""

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from eldbench import calibrate, cell as cell_mod, compare, manifest, reference, scenes  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEEDS = [2**31 + 301, 2**31 + 302, 2**31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = manifest.cell(name)
    for line in calibrate.reference_side(cell, SEEDS):
        if line["what"] == "reference_bf16":
            continue
        numbers = {k: line[k] for k in compare.NUMBERS}
        assert not compare.judge(numbers, cell.limits), (line["what"], line["seed"], numbers)


def _follow(precision, seed=2**31 + 11):
    cell = manifest.cell("syn-pool.unet.b8")
    pool = scenes.make_pool(seed, 16, 64, "cpu")
    weights = cell_mod.arch(cell).make_weights(seed, cell.config, "cpu")
    bank = reference.camera_bank(cell_mod.camera_file(cell), "cpu")
    seeds = [reference.fold_in(seed, i) for i in range(3)]
    return pool, weights, reference.follow(cell_mod.forward(cell), weights, pool, bank, 4, seeds,
                                           1e-4, 0.9, precision=precision)


def test_float8_control_errs_many_times_bfloat16():
    _, weights, ref = _follow("f32")
    errs = {}
    for precision in ("bf16", "fp8"):
        run = _follow(precision)[2]
        errs[precision] = compare.readings(run["losses"], run["grad1"], run["params"], ref,
                                           weights)["grad1_err_median"]
    assert errs["fp8"] > 4 * errs["bf16"] > 0, errs
