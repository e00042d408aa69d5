"""The harness on the CPU: the manifest and the files it names, the
contract's names and units, which cells report which metrics, the
readers on a canned profiler trace, the step-weighted tail, adding a cell
by files alone, adding a configuration of a new architecture by files
alone, and the refusal without a card."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from eldbench import manifest, stats, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = manifest.load()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"] and MANIFEST["command"][1] == "benchmark/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    fours = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_and_units_in_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names += [x["name"] for x in MANIFEST[group]]
    names += [w["traffic"] for w in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for g in ("end_to_end", "per_layer") for x in MANIFEST[g])) == \
        len(MANIFEST["end_to_end"]) + len(MANIFEST["per_layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in MANIFEST["workloads"]] + [c["source"] for c in
                                                             MANIFEST["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = manifest.cell(name)
    assert cell.traffic["ranks"] == cell.chips
    assert set(cell.limits) == {"loss_gap", "grad1_gap", "delta_gap", "grad1_err_median"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "train_patches_per_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    conf = {c["name"]: c for c in MANIFEST["configs"]}[
        {w["name"]: w for w in MANIFEST["workloads"]}[name]["config"]]
    assert cell.config["name"] == conf["name"] and cell.config["reduced"] == conf["reduced"]
    assert os.path.exists(os.path.join(ROOT, cell.config["calibration_file"]))


@pytest.mark.parametrize("metric", PER_LAYER)
def test_every_metric_reader_loads_and_its_cells_report_what_it_moves(metric):
    assert callable(manifest.reader(metric).read)
    m = {x["name"]: x for x in MANIFEST["per_layer"]}[metric]
    for name in m["workloads"]:
        assert m["moves"] in {e["name"] for e in manifest.cell(name).end_to_end}


def _canned_trace():
    """Two steps' kernels on one card: K1 twice (0.1 ms each), a conv, an
    NCCL all-reduce, a copy, and an idle gap between them."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1000, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void noise_synth_kernel<true, true>", "ts": 1100,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "cudnn_conv_fprop", "ts": 1200, "dur": 600},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
         "ts": 1800, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "void noise_synth_kernel<true, true>", "ts": 2500,
         "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2600, "dur": 400},
    ]
    return trace.from_events(ev)


def _ctx(t, **kw):
    """A reader's context for four ranks of 4 rows (``syn-pool-dp4-b16``)."""
    import types

    config = json.load(open(os.path.join(BENCH, "configs", "sid-unet-w32.json")))
    traffic = json.load(open(os.path.join(BENCH, "traffic", "syn-pool-dp4-b16.json")))
    base = dict(trace=t, config=config, traffic=traffic, chips=4, rows_per_rank=4,
                steps_traced=2, step_s=0.01)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers_on_a_canned_trace():
    t = _canned_trace()
    # the device's span, 1100 to 3000 us: the host's first 1100 us fall outside it
    assert t.window_us == 1900 and t.busy_us == 1400
    assert t.gaps == [(2000.0, 2500.0)]
    assert manifest.reader("device.idle_pct").read(_ctx(t)) == pytest.approx(100 * 500 / 1900)
    assert manifest.reader("dp.allreduce_ms").read(_ctx(t)) == pytest.approx(0.1)
    least = (2 * 4 * 512 * 512 * 4 * 4 + 4 * 48) / 3350e9
    assert manifest.reader("k1.roofline_pct").read(_ctx(t)) == pytest.approx(
        100 * least / 100e-6)
    flops = manifest.arch("unet").step_flops(_ctx(t).config, 16, 512, 512)
    assert manifest.reader("step.mfu_pct").read(_ctx(t)) == pytest.approx(
        100 * flops / 0.01 / (4 * 989.4e12))
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["cudnn_conv_fprop", pytest.approx(600e-6)]
    assert b["idle_gaps"] == [["host between events", pytest.approx(500e-6)]]


def test_readers_find_nothing_to_read():
    t = trace.from_events([{"ph": "X", "cat": "kernel", "name": "cudnn", "ts": 0, "dur": 5}])
    assert manifest.reader("dp.allreduce_ms").read(_ctx(t)) is None
    assert manifest.reader("k1.roofline_pct").read(_ctx(t)) is None


def _history(call_s, epochs=2, t0=100.0, tail_s=0.0003):
    """``Engine.history`` of ``epochs`` epochs of calls of 10 steps taking
    ``call_s`` each and a last call of one step: a call's loss is read once
    the next call is queued, so entry i marks the end of call i + 1, and the
    epoch's last entry the last call's end, ``tail_s`` after the one before."""
    history, t, steps = [], t0, 0
    for _ in range(epochs):
        ks = [10] * (len(call_s) - 1) + [1]
        ends = []
        for k, s in zip(ks, call_s):
            t += s
            ends.append(t)
        marks = ends[1:-1] + [ends[-1], ends[-1] + tail_s]
        t = marks[-1]
        for k, mark in zip(ks, marks):
            steps += k
            history.append((steps, {"Pixel": 0.1}, mark))
    return history


def test_step_p95_is_weighted_by_steps():
    """Epochs of 16 calls of 10 steps at 170 ms and one call of one step at
    17 ms, each loss read one call late: every step reads 17 ms, the
    remainder call does not decide the tail, a stalled call of 10 steps
    does, and the spans hold every step and every second."""
    call_s = [0.170] * 16 + [0.017]
    history = _history(call_s)
    calls = stats.call_times(history, 100.0, 0, 161)
    assert [k for k, _ in calls] == ([20] + [10] * 14 + [1]) * 2
    assert sum(k for k, _ in calls) == 322
    assert sum(s for _, s in calls) == pytest.approx(history[-1][2] - 100.0)
    assert stats.step_weighted_p95_ms(calls) == pytest.approx(17.0)
    stalled = _history(call_s[:5] + [0.670] + call_s[6:])
    assert stats.step_weighted_p95_ms(stats.call_times(stalled, 100.0, 0, 161)) > 60.0


def test_percentile_interpolates():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([0, 10], 95) == pytest.approx(9.5)


def test_a_new_cell_is_files_and_a_manifest_entry(tmp_path):
    """A copy of the benchmark gains a cell by a traffic file, a limits file
    and an entry; the harness's code is the same."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads(json.dumps(MANIFEST))
    man["workloads"].append({"name": "syn-pool.unet.b16", "config": "sid-unet-w32",
                             "traffic": "syn-pool-b16", "chips": 1, "why": "batch 16"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = json.loads((tmp_path / "benchmark/traffic/syn-pool-b8.json").read_text())
    traffic.update(name="syn-pool-b16", global_batch=16)
    (tmp_path / "benchmark/traffic/syn-pool-b16.json").write_text(json.dumps(traffic))
    shutil.copy(tmp_path / "benchmark/limits/syn-pool.unet.b8.json",
                tmp_path / "benchmark/limits/syn-pool.unet.b16.json")
    code = ("import sys; sys.path.insert(0, 'benchmark'); from eldbench import manifest; "
            "c = manifest.cell('syn-pool.unet.b16'); "
            "print(c.traffic['global_batch'], c.config['arch'], len(c.per_layer))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the per-layer metrics list their cells, so the new cell reports none of them
    # until a manifest entry names it there
    assert out.stdout.split() == ["16", "unet", "0"]
    for name in ("eldbench", "metrics", "archs"):
        for f in os.listdir(os.path.join(BENCH, name)):
            if f.endswith(".py"):
                assert (tmp_path / "benchmark" / name / f).read_text() == \
                    open(os.path.join(BENCH, name, f)).read()


TOY = '''"""A toy architecture: conv 3x3, channel LayerNorm, LeakyReLU, conv 3x3."""

import math

import torch
import torch.nn.functional as F

from eldbench import reference


def param_specs(config):
    c, w, o = config["in_channels"], config["width"], config["out_channels"]
    return [("conv1.weight", (w, c, 3, 3)), ("conv1.bias", (w,)), ("norm.weight", (w,)),
            ("norm.bias", (w,)), ("conv2.weight", (o, w, 3, 3)), ("conv2.bias", (o,))]


def make_weights(seed, config, device):
    gen, out = reference.weight_generator(seed, device), {}
    for name, shape in param_specs(config):
        if name.startswith("norm."):
            out[name] = (torch.ones if name.endswith("weight") else torch.zeros)(
                shape, device=device)
        else:
            if name.endswith(".weight"):
                fan_in = shape[1] * 9
            u = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
            out[name] = u / math.sqrt(fan_in)
    return out


def forward(config, p, x, precision="f32"):
    t = reference._conv(x.permute(0, 3, 1, 2), p["conv1.weight"], p["conv1.bias"], precision,
                        padding=1).permute(0, 2, 3, 1)
    t = F.leaky_relu(F.layer_norm(t, t.shape[-1:], p["norm.weight"], p["norm.bias"]), 0.2)
    return reference._conv(t.permute(0, 3, 1, 2), p["conv2.weight"], p["conv2.bias"], precision,
                           padding=1).permute(0, 2, 3, 1)


def program_args(config):
    return ["--netG", "toy", "--toy_width", str(config["width"])]


def step_flops(config, n, h, w):
    c, k, o = config["in_channels"], config["width"], config["out_channels"]
    return 3 * 2 * n * h * w * 9 * (c * k + k * o) - 2 * n * h * w * 9 * c * k

'''

TOY_RUN = """
import json, math, sys, types
sys.path.insert(0, "benchmark")
from eldbench import cell as cell_mod, manifest, reference, scenes
c = manifest.cell("toy.b8")
toy, tr, cf = cell_mod.arch(c), c.traffic, c.config
weights = toy.make_weights(7, cf, "cpu")
pool = scenes.make_pool(7, tr["pool_patches"], tr["patch"], "cpu")
bank = reference.camera_bank(cell_mod.camera_file(c), "cpu")
ref = reference.follow(cell_mod.forward(c), weights, pool, bank, tr["global_batch"],
                       [reference.fold_in(7, i) for i in range(3)], cf["optimizer"]["lr"],
                       cf["optimizer"]["beta1"])
ctx = types.SimpleNamespace(config=cf, traffic=tr, chips=1, step_s=0.01)
print(json.dumps({
    "argv": cell_mod.program_argv(c, 7, "SAVE", "cpu"), "args": toy.program_args(cf),
    "losses": ref["losses"], "norm_init": weights["norm.weight"].tolist(),
    "moved": [k for k in weights if not bool((ref["params"][k] == weights[k]).all())],
    "flops": toy.step_flops(cf, tr["global_batch"], tr["patch"], tr["patch"]),
    "mfu": manifest.reader("step.mfu_pct").read(ctx)}))
"""


def test_a_new_architecture_is_files_and_manifest_entries(tmp_path):
    """A copy of the benchmark gains a configuration of an architecture it
    has no module for by new files alone (the module, the configuration,
    a traffic mix, limits) and new entries in BENCHMARK.json: the cell
    loads, the program gets the module's flags, the plain reference
    trains it, and the whole step's MFU reader counts its
    FLOPs."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "eld_tpu").mkdir()
    os.symlink(os.path.join(ROOT, "eld_tpu", "data_files"), tmp_path / "eld_tpu" / "data_files")
    before = {p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file()}
    (tmp_path / "benchmark/archs/toy.py").write_text(TOY)
    config = json.loads((tmp_path / "benchmark/configs/sid-unet-w32.json").read_text())
    for key in ("levels", "base_width", "widths", "parameters", "skip_mode", "upsample"):
        del config[key]
    config.update(name="toy", source="a test's own", arch="toy", width=16, precision="f32",
                  reduced=[])
    (tmp_path / "benchmark/configs/toy.json").write_text(json.dumps(config))
    traffic = json.loads((tmp_path / "benchmark/traffic/syn-pool-b8.json").read_text())
    traffic.update(name="toy-b8", pool_patches=8, patch=32, global_batch=8, steps_per_call=2)
    (tmp_path / "benchmark/traffic/toy-b8.json").write_text(json.dumps(traffic))
    shutil.copy(tmp_path / "benchmark/limits/syn-pool.unet.b8.json",
                tmp_path / "benchmark/limits/toy.b8.json")
    man = json.loads(json.dumps(MANIFEST))
    man["configs"].append({"name": "toy", "source": "a test's own",
                           "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    man["workloads"].append({"name": "toy.b8", "config": "toy", "traffic": "toy-b8", "chips": 1,
                             "why": "8 patches of 32x32"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    added = {p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file()} - before
    assert {str(p) for p in added} == {"benchmark/archs/toy.py", "benchmark/configs/toy.json",
                                       "benchmark/traffic/toy-b8.json",
                                       "benchmark/limits/toy.b8.json", "BENCHMARK.json"}
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    i = res["argv"].index("--netG")
    assert res["args"] == ["--netG", "toy", "--toy_width", "16"]
    assert res["argv"][i:i + 4] == res["args"] and res["argv"][i - 2:i] == ["--device", "cpu"]
    assert "--base_width" not in res["argv"] and "--skip_mode" not in res["argv"]
    assert len(res["losses"]) == 3 and all(math.isfinite(v) and v > 0 for v in res["losses"])
    assert res["norm_init"] == [1.0] * 16
    assert set(res["moved"]) == {"conv1.weight", "conv1.bias", "norm.weight", "norm.bias",
                                 "conv2.weight", "conv2.bias"}
    flops = 3 * 2 * 8 * 32 * 32 * 9 * (4 * 16 + 16 * 4) - 2 * 8 * 32 * 32 * 9 * 4 * 16
    assert res["flops"] == flops
    assert res["mfu"] == pytest.approx(100 * flops / 0.01 / 989.4e12)


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "syn-pool.unet.b8", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_run_refuses_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to run: the command exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "syn-pool.unet.b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
