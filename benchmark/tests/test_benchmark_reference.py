"""The plain reference runs its float32 products in float32 (TF32 off,
as the program's float32 path runs them) only while it runs: the
caller's TF32 settings come back after ``follow``, also when the model
raises."""

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from eldbench import cell as cell_mod, manifest, reference, scenes  # noqa: E402

SEED = 2**31 + 29
FLAGS = ("torch.backends.cuda.matmul.allow_tf32", "torch.backends.cudnn.allow_tf32")


def _tf32():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _set_tf32(flags):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _follow(forward):
    cell = manifest.cell("syn-pool.unet.b8")
    pool = scenes.make_pool(SEED, 8, 32, "cpu")
    weights = cell_mod.arch(cell).make_weights(SEED, cell.config, "cpu")
    bank = reference.camera_bank(cell_mod.camera_file(cell), "cpu")
    seeds = [reference.fold_in(SEED, i) for i in range(2)]
    return reference.follow(forward, weights, pool, bank, 2, seeds, 1e-4, 0.9)


@pytest.mark.parametrize("before", [(True, True), (False, True), (True, False)])
def test_follow_turns_tf32_off_while_it_runs_and_gives_the_flags_back(before):
    model, seen = cell_mod.forward(manifest.cell("syn-pool.unet.b8")), []

    def forward(p, x, precision):
        seen.append(_tf32())
        return model(p, x, precision)

    saved = _tf32()
    try:
        _set_tf32(before)
        ref = _follow(forward)
        assert _tf32() == before, FLAGS
    finally:
        _set_tf32(saved)
    assert seen == [(False, False)] * 2
    assert len(ref["losses"]) == 2


def test_follow_gives_the_flags_back_when_the_model_raises():
    def forward(p, x, precision):
        raise RuntimeError("planted")

    saved = _tf32()
    try:
        _set_tf32((True, True))
        with pytest.raises(RuntimeError, match="planted"):
            _follow(forward)
        assert _tf32() == (True, True), FLAGS
    finally:
        _set_tf32(saved)
