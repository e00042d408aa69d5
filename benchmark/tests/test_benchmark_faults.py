"""A run with the timed path broken underneath comes out not correct:
for each fault a cell can have, the harness's run (its look for a card
skipped) on a copy of the benchmark cut to a CPU's size, in float32 so
that the sound run reads at round-off; the same run without a fault is
correct.  The cells' own limits judge.

The copy also gains a cell of launched ranks on the data axis
(``syn-pool-dp4-b16`` on two ranks, judged by ``syn-pool.unet.b8``'s
limits, the same configuration's), so the harness's path across ranks
and its fault, the exchange left out, are driven too."""

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CASES = [(cell, fault) for cell in ("syn-pool.unet.b8", "syn-pool.s2d.b8")
         for fault in ("none", "unchanged", "half_batch")]
RANKS_CELL = "syn-pool-dp4.unet.b16"
CASES += [(RANKS_CELL, f) for f in ("none", "unchanged", "half_batch", "no_exchange")]


@pytest.fixture(scope="module")
def small_copy(tmp_path_factory):
    """The benchmark with pools of 24 64x64 patches, batches of 4, calls of
    2 steps, 2 ranks in place of 4, and float32."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    man["workloads"].append({"name": RANKS_CELL, "config": "sid-unet-w32",
                             "traffic": "syn-pool-dp4-b16", "chips": 2, "why": "ranks"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    shutil.copy(root / "benchmark/limits/syn-pool.unet.b8.json",
                root / f"benchmark/limits/{RANKS_CELL}.json")
    for f in (root / "benchmark/traffic").iterdir():
        t = json.loads(f.read_text())
        t.update(pool_patches=24, patch=64, global_batch=4, steps_per_call=2,
                 ranks=min(t["ranks"], 2))
        f.write_text(json.dumps(t))
    for f in (root / "benchmark/configs").iterdir():
        c = json.loads(f.read_text())
        c["precision"] = "f32"
        f.write_text(json.dumps(c))
    os.symlink(os.path.join(ROOT, "eld_tpu_torch"), root / "eld_tpu_torch")
    (root / "eld_tpu").mkdir()
    os.symlink(os.path.join(ROOT, "eld_tpu", "data_files"), root / "eld_tpu" / "data_files")
    return root


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_makes_the_run_not_correct(small_copy, cell, fault):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "benchmark/tests/faultdriver.py", "--workload", cell,
                          "--fault", fault, "--seed", str(2**31 + 77)], cwd=small_copy,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is (fault == "none"), res["compared"]
