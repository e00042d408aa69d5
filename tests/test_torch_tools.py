"""The port's host tools against eld_tpu's: ``utils/matio.loadmat`` gives
equal dicts, ``tools/vis_data`` writes byte-equal PNGs, and
``tools/bench_decode`` emits the same record keys."""

import os

import numpy as onp
import pytest
import scipy.io as spio

from eld_tpu.data.patchstore import PatchStoreWriter
from eld_tpu.tools import bench_decode as jax_bench_decode
from eld_tpu.tools import vis_data as jax_vis_data
from eld_tpu.utils.matio import loadmat as jax_loadmat
from eld_tpu_torch.tools import bench_decode, vis_data
from eld_tpu_torch.utils.matio import loadmat


def _equal(a, b) -> bool:
    """Deep equality of loadmat's output: dicts, lists, arrays, scalars."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, onp.ndarray):
        return isinstance(b, onp.ndarray) and a.dtype == b.dtype and onp.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_loadmat_gives_equal_dicts(tmp_path):
    path = str(tmp_path / "t.mat")
    rng = onp.random.default_rng(3)
    spio.savemat(path, {
        "plain": rng.random((3, 2)),
        "s": {"a": 1.5, "inner": {"b": onp.arange(4), "deep": {"c": "x"}},
              "cell": onp.array([onp.arange(2), "txt", 3.0], dtype=object)},
        "t": {"m": rng.random((2, 2))},
    })
    got, want = loadmat(path), jax_loadmat(path)
    assert isinstance(got["s"], dict) and got["s"]["inner"]["b"] == [0, 1, 2, 3]
    assert _equal({k: v for k, v in got.items() if k != "__header__"},
                  {k: v for k, v in want.items() if k != "__header__"})


@pytest.fixture
def clean_store(tmp_path):
    path = str(tmp_path / "clean.eps")
    rng = onp.random.default_rng(4)
    with PatchStoreWriter(path, (32, 32, 4), dtype=onp.uint16) as w:
        for _ in range(4):
            w.append(rng.integers(0, 65536, (32, 32, 4)).astype(onp.uint16))
    return path


@pytest.mark.parametrize("noise", [None, "g", "eld"])
def test_vis_data_pngs_are_byte_equal(tmp_path, clean_store, noise):
    argv = ["--store", clean_store, "-n", "3", "--seed", "5"]
    if noise:
        argv += ["--noise", noise]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    vis_data.main(argv + ["--outdir", ours])
    jax_vis_data.main(argv + ["--outdir", theirs])
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(ours)) == ["0000.png", "0001.png", "0002.png"]
    for name in names:
        with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def test_bench_decode_emits_the_same_record_keys(tmp_path):
    argv = ["--small", "--reps", "2", "--threads", "2", "--formats", "arw,dng"]
    ours = bench_decode.main(argv + ["--out", str(tmp_path / "rec.jsonl")])
    theirs = jax_bench_decode.main(argv)
    assert [r["format"] for r in ours] == [r["format"] for r in theirs] == ["arw", "dng"]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert a["native"] == b["native"] and a["mosaic_mpix"] == b["mosaic_mpix"]
        assert all(onp.isfinite(a[k]) and a[k] > 0 for k in ("decode_ms", "mb_per_s",
                                                            "mt_frames_per_s"))
    with open(tmp_path / "rec.jsonl") as f:
        assert len(f.readlines()) == 2
