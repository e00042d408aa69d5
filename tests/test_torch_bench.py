"""The port's benchmark tools (eld_tpu_torch.tools.bench_variants and
.roofline) against eld_tpu's.

* ``combos()`` is eld_tpu's combo list, captured from eld_tpu's own
  ``main`` with its children stubbed; the port's ``main`` starts one
  child per combo;
* eld_tpu's TPU-only ``gate`` mode and ``--aot`` / ``--mesh_data`` are
  refused by name, and neither tool falls back to the CPU without
  ``--device cpu``;
* each child mode runs at eld_tpu's smoke size on the CPU and returns
  eld_tpu's record keys, plus ``k1_launches`` and ``steps``;
* ``step_cost``'s FLOPs equal an analytic count of the U-Net's
  convolutions exactly, and lie within 15% of XLA's ``cost_analysis()``
  of eld_tpu's step; its bytes equal a hand count on a conv + add, lie
  within 1x-3x of XLA's "bytes accessed", hold K1's bytes per launch and
  count each kernel operator's inputs and outputs once;
* ``roofline`` returns eld_tpu's record keys.
"""

import collections
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.noise import load_camera_params as jax_bank
from eld_tpu.tools import bench_variants as jax_bench_variants
from eld_tpu.train import create_train_state as jax_create_train_state
from eld_tpu.train import make_train_step as jax_make_train_step
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.kernels import synthesize_kernel
from eld_tpu_torch.tools import bench_variants, roofline
from tests.kernel_helpers import kernel_operator_step

# eld_tpu's record keys per child mode (eld_tpu/tools/bench_variants.py:
# train :71-89 and :320-321, eval :300-302 and :345, peak :256-259 and :329;
# every record but peak's also :346)
JAX_KEYS = {
    "train": {"flops_per_step", "bytes_per_step", "patches_per_sec", "mode", "arch", "remat",
              "f32", "skip_bf16", "skip_mode", "upsample"},
    "eval": {"fullframe_fps", "fps_mad", "chop", "batch", "mode", "arch", "skip_mode",
             "upsample"},
    "peak": {"noise_impl", "batch", "patches_per_sec", "mad", "compile_plus_warmup_s", "mode"},
}
# eld_tpu's roofline record without --aot (eld_tpu/tools/roofline.py:142-156, :172-180)
JAX_ROOFLINE_KEYS = {"arch", "batch", "patch", "noise", "bf16", "remat", "skip_mode", "upsample",
                     "skip_bf16", "flops_per_step", "bytes_per_step",
                     "arith_intensity_flop_per_byte", "ridge_flop_per_byte", "bound",
                     "bw_floor_ms"}
JAX_RUN_KEYS = {"platform", "step_ms", "patches_per_sec", "achieved_tflops", "mfu_pct",
                "achieved_gbs", "hbm_pct"}
SMALL = ["--batch", "2", "--patch", "64", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    """chip_smoke.py, loaded by path: its conv count, ``conv_flops``, is
    what its phase 9 checks on the card."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


conv_flops = _chip_smoke().conv_flops


# ---- the sweep's combos and its children -----------------------------------

def _jax_combos(monkeypatch, capsys, modes):
    """The combos eld_tpu's ``main`` runs for ``--modes modes``, each
    child's subprocess replaced by a stub that records its combo."""
    seen = []

    def run(cmd, **kw):
        seen.append(tuple(cmd[cmd.index("--one") + 1:]))
        return subprocess.CompletedProcess(cmd, 0, stdout='{"mode": "stub"}\n', stderr="")

    monkeypatch.setattr(jax_bench_variants, "subprocess", types.SimpleNamespace(run=run))
    monkeypatch.setitem(sys.modules, "bench", types.SimpleNamespace(probe_device=lambda: "stub"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["bench_variants"] + (["--modes", modes] if modes else []))
    jax_bench_variants.main()
    capsys.readouterr()
    return seen


@pytest.mark.parametrize("modes", [None, "peak", "train,peak", "eval"])
def test_combos_are_eld_tpus(monkeypatch, capsys, modes):
    want = _jax_combos(monkeypatch, capsys, modes)
    got = bench_variants.combos(set(modes.split(",")) if modes else None)
    assert got == want
    assert len(bench_variants.combos()) == 25 and len(bench_variants.combos({"peak"})) == 6


def test_main_runs_one_child_per_combo(monkeypatch, capsys, tmp_path):
    """The port's ``main`` starts ``-m eld_tpu_torch.tools.bench_variants
    --one <combo> --device <d>`` per combo, appends each record to --out,
    and turns a failed child into an error record and goes on."""
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        env = kw["env"]
        assert env["PYTHONPATH"].split(os.pathsep)[0] == bench_variants._PKG_ROOT
        assert float(env[bench_variants._T0_ENV]) > 0
        combo = cmd[cmd.index("--one") + 1:cmd.index("--device")]
        if combo[1] == "jnp":
            return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="boom")
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps({"mode": combo[0]}) + "\n",
                                           stderr="")

    monkeypatch.setattr(bench_variants.subprocess, "run", run)
    out = tmp_path / "rec.jsonl"
    res = bench_variants.main(["--modes", "peak", "--out", str(out), "--device", "cpu"])
    combos = bench_variants.combos({"peak"})
    assert [c[c.index("--one") + 1:] for c in seen] == [[*c, "--device", "cpu"] for c in combos]
    assert all(c[:3] == [sys.executable, "-m", "eld_tpu_torch.tools.bench_variants"]
               for c in seen)
    assert res["platform"] == "cpu" and res["power_limit_w"] is None
    errors = [r for r in res["results"] if "error" in r]
    assert [r["combo"] for r in errors] == ["peak/jnp/32", "peak/jnp/64", "peak/jnp/128"]
    assert all(r["error"] == "CalledProcessError" for r in errors)
    assert [json.loads(line) for line in out.read_text().splitlines()] == res["results"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


def test_a_real_child_failure_does_not_stop_the_sweep(monkeypatch, capsys, tmp_path):
    """Two real children at smoke size, started from outside the checkout:
    an unknown arch fails in its process, the next combo still runs and
    says where its time went."""
    monkeypatch.setenv("ELD_BENCH_VARIANTS_SMOKE", "1")
    monkeypatch.delenv("PYTHONPATH", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_variants, "combos", lambda modes: [
        ("train", "no_such_arch", "concat", "convt"), ("eval", "split", "convt", "nochop", "s2d")])
    res = bench_variants.main(["--device", "cpu"])
    bad, good = res["results"]
    assert bad == {"mode": "train", "combo": "train/no_such_arch/concat/convt",
                   "error": "CalledProcessError"}
    assert good["mode"] == "eval_fullframe" and good["arch"] == "unet_s2d"
    assert good["fullframe_fps"] > 0 and good["chop"] is False
    secs = good["secs"]
    assert set(secs) == {"start", "cuda", "k1_lib", "build", "warmup", "timed", "wall"}
    assert 0 < secs["start"] < secs["wall"]
    assert sum(v for k, v in secs.items() if k != "wall") <= secs["wall"]


@pytest.mark.parametrize("argv, what", [
    (["--modes", "gate"], "gate"), (["--modes", "train,gate"], "gate"), (["--aot"], "--aot"),
    (["--aot", "v5e:2x2", "--device", "cpu"], "--aot")])
def test_bench_variants_refuses_tpu_only_modes_by_name(argv, what):
    with pytest.raises(SystemExit) as e:
        bench_variants.main(argv)
    assert what in str(e.value) and "ROADMAP #16" in str(e.value)
    with pytest.raises(SystemExit) as e:
        bench_variants._child(["gate", "mesh_jnp"], "cpu")
    assert "gate" in str(e.value) and "ROADMAP #16" in str(e.value)


@pytest.mark.parametrize("argv, what", [(["--aot", "v5e:2x2"], "--aot"),
                                        (["--mesh_data", "2"], "--mesh_data")])
def test_roofline_refuses_tpu_only_flags_by_name(capsys, argv, what):
    with pytest.raises(SystemExit) as e:
        roofline.main(argv + ["--no-run", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert what in err and "ROADMAP #16" in err


def test_no_cpu_fallback_without_device_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_variants.main(["--modes", "train"])
    assert e.value.code == 2
    assert json.loads(capsys.readouterr().out) == {"error": "cuda_unavailable"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.main(["--no-run"])


@pytest.fixture
def smoke_sizes(monkeypatch):
    """eld_tpu's ELD_BENCH_VARIANTS_SMOKE sizes in this process."""
    for name, value in {"_SMOKE": True, "PATCH": 64, "BATCH": 2, "EVAL_H": 128,
                        "EVAL_W": 192}.items():
        monkeypatch.setattr(bench_variants, name, value)


@pytest.mark.parametrize("combo", [
    ("train", "unet_s2d", "concat", "convt"), ("train", "unet", "split", "d2s"),
    ("train", "unet_s2d", "concat", "convt", "remat"),
    ("train", "unet_s2d", "concat", "convt", "f32"),
    ("train", "unet_s2d", "concat", "convt", "f32", "skipbf16"),
    ("eval", "concat", "convt", "nochop"), ("eval", "split", "convt", "nochop", "b4"),
    ("eval", "split", "d2s", "s2d"), ("peak", "jnp", "32"), ("peak", "pallas", "64")],
    ids="/".join)
def test_child_records_have_eld_tpus_keys(smoke_sizes, monkeypatch, capsys, combo):
    monkeypatch.delenv(bench_variants._T0_ENV, raising=False)
    rec = bench_variants._child(list(combo), "cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    mode = combo[0]
    extra = {"k1_launches", "steps"} | ({"noise_impl_ref"} if mode == "peak" else set())
    assert set(rec) == (JAX_KEYS[mode] | (extra if mode != "eval" else set())
                        | {"secs", "graph_replays"})
    assert rec["graph_replays"] == 0  # CUDA graphs only on a card
    assert set(rec["secs"]) == {"cuda", "k1_lib", "build", "warmup", "timed"} | (
        {"cost"} if mode == "train" else set())
    assert all(v >= 0 for v in rec["secs"].values())
    if mode == "train":
        flags = combo[4:]
        assert (rec["arch"], rec["skip_mode"], rec["upsample"]) == combo[1:4]
        assert (rec["remat"], rec["f32"], rec["skip_bf16"]) == (
            "remat" in flags, "f32" in flags, "skipbf16" in flags)
        assert rec["patches_per_sec"] > 0 and rec["steps"] == 24
        assert rec["k1_launches"] == 0  # the CPU runs the plain noise
        flops = conv_flops(combo[1], 2, 64, 64, 32)
        if "remat" in flags:  # each level's forward convs run again in the backward
            assert rec["flops_per_step"] > flops
        else:
            assert rec["flops_per_step"] == flops
    elif mode == "eval":
        assert rec["fullframe_fps"] > 0 and rec["chop"] == ("nochop" not in combo)
        assert rec["batch"] == (4 if "b4" in combo else 1)
        assert rec["arch"] == ("unet_s2d" if "s2d" in combo else "unet")
    else:
        assert rec["noise_impl_ref"] == combo[1]
        assert rec["noise_impl"] == {"jnp": "plain", "pallas": "kernel"}[combo[1]]
        assert rec["batch"] == 4 and rec["steps"] == 53 and rec["k1_launches"] == 0
        assert rec["patches_per_sec"] > 0 and rec["mad"] >= 0


# ---- step_cost: FLOPs and bytes ---------------------------------------------

def _cost(arch, width, skip_mode="concat", upsample="convt", bf16=False, noise_impl="auto"):
    ns = types.SimpleNamespace(arch=arch, batch=2, patch=64, noise="eld", bf16=bf16, remat=False,
                               skip_mode=skip_mode, upsample=upsample, skip_bf16=False,
                               base_width=width, noise_impl=noise_impl, device="cpu")
    state, step, data = roofline.build_step(ns)
    return roofline.step_cost(step, state, data)


@pytest.mark.parametrize("upsample", ["convt", "d2s"])
@pytest.mark.parametrize("skip_mode", ["concat", "split"])
@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_step_flops_equal_the_conv_count(arch, width, skip_mode, upsample):
    cost = _cost(arch, width, skip_mode, upsample)
    assert cost["flops_per_step"] == conv_flops(arch, 2, 64, 64, width)
    assert cost["k1_launches"] == 0 and cost["k1_bytes_per_step"] == 0


@pytest.mark.parametrize("bf16, noise_impl", [(True, "auto"), (False, "plain")])
def test_step_flops_do_not_depend_on_precision_or_noise_path(bf16, noise_impl):
    assert _cost("unet_s2d", 8, bf16=bf16, noise_impl=noise_impl)["flops_per_step"] \
        == conv_flops("unet_s2d", 2, 64, 64, 8)


@pytest.fixture(scope="module")
def xla_cost():
    """XLA's cost_analysis() of eld_tpu's step: unet_s2d, concat/convt,
    width 8, (2, 64, 64, 4) f32, noise_impl auto; the state abstract."""
    model = jax_build_arch("unet_s2d", 4, 4, base_width=8, dtype=jnp.float32,
                           skip_mode="concat", upsample="convt")
    state = jax.eval_shape(
        lambda: jax_create_train_state(model, jax.random.PRNGKey(0), (1, 64, 64, 4)))
    step = jax_make_train_step(model, loss="l1", noise_model="eld", bank=jax_bank(),
                               noise_impl="auto")
    clean = jax.ShapeDtypeStruct((2, 64, 64, 4), jnp.float32)
    ca = step.lower(state, {"clean": clean}, jax.random.PRNGKey(0)).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    return float(ca["flops"]), float(ca["bytes accessed"])


@pytest.fixture(scope="module")
def port_cost():
    return _cost("unet_s2d", 8)


def test_step_flops_within_15pct_of_xla(xla_cost, port_cost):
    """XLA also counts the noise model's, the loss's and Adam's elementwise
    FLOPs, which torch's counter leaves out; the convolutions dominate both."""
    assert abs(port_cost["flops_per_step"] / xla_cost[0] - 1) <= 0.15


def test_step_bytes_between_1x_and_3x_of_xla(xla_cost, port_cost):
    """Eager ops are not fused: every intermediate is written and read
    again, where XLA's fusions keep them in registers."""
    assert 1.0 <= port_cost["bytes_per_step"] / xla_cost[1] <= 3.0


def test_byte_counter_equals_a_hand_count():
    x, w, b = torch.rand(1, 3, 8, 8), torch.rand(4, 3, 3, 3), torch.rand(4)
    z = torch.rand(1, 4, 8, 8)
    with roofline.ByteCounter() as counter:
        y = F.conv2d(x, w, b, padding=1)
        y = y + z
        y.permute(0, 2, 3, 1)  # a view moves nothing
    conv = x.nbytes + w.nbytes + b.nbytes + y.nbytes
    add = y.nbytes + z.nbytes + y.nbytes
    assert counter.bytes == conv + add


def test_step_cost_adds_k1_bytes_per_launch(monkeypatch):
    """A step that launches K1 (counted by its wrapper) gets the kernel's
    bytes added: the batch read and written and its parameter rows."""
    monkeypatch.setattr(synthesize_kernel, "launches", 0)
    clean, loss = torch.zeros((2, 64, 64, 4)), torch.zeros(())

    def step(state, batch, seed):
        synthesize_kernel.launches += 1
        return {"Pixel": loss}

    cost = roofline.step_cost(step, None, {"clean": clean})
    assert cost["k1_launches"] == 1 and cost["flops_per_step"] == 0
    assert cost["k1_bytes_per_step"] == cost["bytes_per_step"] == 2 * 2 * 64 * 64 * 4 * 4 \
        + 2 * 12 * 4


def test_step_cost_counts_each_kernel_operator_once():
    """The conv epilogue and the LayerNorm are operators of the dispatcher:
    a step through both, forward and backward, costs their inputs' and
    outputs' bytes, each operator counted once (its twin on the card is
    ``test_torch_cuda.py``'s)."""
    step, want = kernel_operator_step(torch.device("cpu"))
    cost = roofline.step_cost(step, None, {"clean": torch.zeros((2, 8, 8, 4))})
    assert cost["bytes_per_step"] == want and cost["k1_launches"] == 0


# ---- roofline's record --------------------------------------------------------

def test_roofline_record_has_eld_tpus_keys(capsys):
    rec = roofline.main(["--arch", "unet_s2d", "--base_width", "8", "--f32", "--no-run", *SMALL])
    assert json.loads(capsys.readouterr().out) == rec
    assert set(rec) == JAX_ROOFLINE_KEYS | {"noise_impl", "platform", "power_limit_w",
                                            "k1_bytes_per_step", "steps", "graph",
                                            "graph_replays"}
    assert rec["graph"] is False and rec["graph_replays"] == 0
    assert rec["steps"] == 1  # the counted step
    assert rec["bound"] in ("hbm", "compute") and rec["noise_impl"] == "plain"
    assert rec["flops_per_step"] == conv_flops("unet_s2d", 2, 64, 64, 8)
    assert rec["ridge_flop_per_byte"] == round(roofline.H100_F32_TFLOPS / roofline.H100_HBM_GBS
                                               * 1e3, 1)
    assert rec["platform"] == "cpu" and rec["power_limit_w"] is None


def test_roofline_run_adds_eld_tpus_run_keys():
    rec = roofline.main(["--arch", "unet", "--base_width", "8", "--steps", "2",
                         "--noise_impl", "pallas", *SMALL])
    assert JAX_RUN_KEYS <= set(rec) and JAX_ROOFLINE_KEYS <= set(rec)
    assert rec["step_ms"] > 0 and rec["patches_per_sec"] > 0 and rec["bf16"] is True
    assert rec["steps"] == 1 + 3 + 2  # counted, warmup, timed
    assert rec["graph"] is False and rec["graph_replays"] == 0  # the CPU steps eagerly
    assert rec["ridge_flop_per_byte"] == round(roofline.H100_BF16_TFLOPS
                                               / roofline.H100_HBM_GBS * 1e3, 1)


def test_chip_smokes_attention_shapes_are_a_restormer_steps():
    """chip_smoke.py phase 15's shapes are the 44 attentions of a Restormer
    step at dim 48 and batch 4 of 256^2 (4 + 6 + 6 + 8 blocks down, 6 + 6 up,
    4 at level 1 and 4 refinement, whose heads hold 96 channels), and its
    byte bound is the benchmark's ``mdta_bytes`` there, 8,304,721,920; the
    kernel names it reports come from the mangled names ptxas prints."""
    smoke = _chip_smoke()
    model = build_arch("restormer", 4, 4, base_width=48)
    heads_c = collections.Counter((m.num_heads, m.qkv.in_channels // m.num_heads)
                                  for name, m in model.named_modules() if name.endswith(".attn"))
    assert heads_c == {(heads, c): b for *_, heads, c, b in smoke.MDTA_LEVELS}
    assert sum(heads_c.values()) == 44
    assert sum(smoke.MDTA_BYTES * n * h * w * heads * c * b
               for n, h, w, heads, c, b in smoke.MDTA_LEVELS) == 8_304_721_920
    assert smoke._mdta_kernel_name(
        "_ZN39_GLOBAL__N__1d150f53_7_mdta_cu_116edd8510mdta_dq_dkILi96EEEvPK13__nv_bfloat16"
        "PKfS5_S5_S5_PS1_lii") == "mdta_dq_dk<96>"


_PHASE = {"launches": 72, "steps": 2, "step": {"kernel_ms": 1.0}, "registers": {},
          "build_s": 6.0, "max_rel": 1e-3, "max_err": 0.5, "pooled_step_ms": 9.0}
_KERNEL_ENTRIES = {
    "conv_epilogue": lambda smoke: smoke.epilogue_entry(
        {"launches": 36, "steps": 1}, {"epilogue": {"launches": 36, "steps": 1}}, _PHASE),
    "mdta": lambda smoke: smoke.mdta_entry(_PHASE),
    "biasfree_layernorm": lambda smoke: smoke.layernorm_entry(_PHASE),
    "depthwise_conv3x3": lambda smoke: smoke.dwconv_entry(_PHASE),
    "window_attention": lambda smoke: smoke.wmsa_entry(_PHASE),
}


@pytest.mark.parametrize("name", sorted(_KERNEL_ENTRIES))
def test_chip_smokes_kernel_entries_name_their_sources(name):
    """Each kernel's entry of chip_smoke.py's closing JSON line is built from
    its phases' results and names the kernel's source, a file of the repo."""
    entry = _KERNEL_ENTRIES[name](_chip_smoke())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert entry["name"] == name and entry["route"] == "cuda"
    assert entry["source"].startswith("eld_tpu_torch/csrc/")
    assert os.path.isfile(os.path.join(root, entry["source"]))
    assert entry["launches"] == 72 and entry["launches_per_step"] == 36
    json.dumps(entry)


def test_chip_smokes_layernorm_shapes_are_a_restormer_steps():
    """chip_smoke.py phase 16's shapes are the 88 norms of a Restormer step at
    dim 48 and batch 4 of 256^2 (two a block, each at its level's width and
    pixel pitch), and its byte bound is ``metrics/ln.roofline_pct.py``'s
    count there, 7,549,747,200; the kernel names it reports come from the
    mangled names ptxas prints."""
    smoke = _chip_smoke()
    pitch = {"encoder_level1": 1, "decoder_level1": 1, "refinement": 1, "encoder_level2": 2,
             "decoder_level2": 2, "encoder_level3": 4, "decoder_level3": 4, "latent": 8}
    model = build_arch("restormer", 4, 4, base_width=48)
    norms = collections.Counter((256 // pitch[name.split(".")[0]], m.body.weight.numel())
                                for name, m in model.named_modules()
                                if name.endswith((".norm1", ".norm2")))
    assert norms == {(h, c): k for _, h, _, c, k in smoke.LN_LEVELS}
    assert sum(norms.values()) == 88
    assert sum(smoke.LN_BYTES * n * h * w * c * k
               for n, h, w, c, k in smoke.LN_LEVELS) == 7_549_747_200
    assert smoke._ln_kernel_name(
        "_ZN12_GLOBAL__N_18bfln_bwdI13__nv_bfloat16Li3EEEvPKT_S4_PKfPS2_Pflii") \
        == "bfln_bwd<bf16, 3>"
    assert smoke._ln_kernel_name("_ZN12_GLOBAL__N_19bfln_wsumEPKfPfii") == "bfln_wsum"


def test_chip_smokes_depthwise_shapes_are_a_restormer_steps():
    """chip_smoke.py phase 17's shapes are the 88 depthwise convs of a
    Restormer step at dim 48 and batch 4 of 256^2 (two a block, each at its
    level's pixel pitch and its own channels), and its byte bound is
    ``metrics/dwconv.roofline_pct.py``'s count there, 31,368,806,400; the
    kernel names it reports come from the mangled names ptxas prints."""
    smoke = _chip_smoke()
    pitch = {"encoder_level1": 1, "decoder_level1": 1, "refinement": 1, "encoder_level2": 2,
             "decoder_level2": 2, "encoder_level3": 4, "decoder_level3": 4, "latent": 8}
    model = build_arch("restormer", 4, 4, base_width=48)
    convs = collections.Counter((256 // pitch[name.split(".")[0]], m.in_channels)
                                for name, m in model.named_modules()
                                if name.endswith(("qkv_dwconv", "ffn.dwconv")))
    assert convs == {(h, c): k for _, h, _, c, k in smoke.DW_LEVELS}
    assert sum(convs.values()) == 88
    assert sum(smoke.DW_BYTES * n * h * w * c * k
               for n, h, w, c, k in smoke.DW_LEVELS) == 31_368_806_400
    assert smoke._dw_kernel_name(
        "_ZN12_GLOBAL__N_111dwconv3_bwdEPKjS1_PKfPjPfNS_5TilesE") == "dwconv3_bwd"
    assert smoke._dw_kernel_name("_ZN12_GLOBAL__N_112dwconv3_wsumEPKfPfii") == "dwconv3_wsum"


def test_chip_smokes_window_attention_shapes_are_a_uformer_steps():
    """chip_smoke.py phase 18's shapes are the 40 window attentions of a
    Uformer-B step at embed_dim 32 and batch 32 of 128^2 (each at its
    layer's pitch and heads, shifted or not, with the decoder's modulator),
    and its byte bound is the benchmark's ``wmsa_bytes`` there,
    5,582,618,624; the kernel names it reports come from the mangled names
    ptxas prints."""
    from eld_tpu_torch.models.uformer import LeWinTransformerBlock

    smoke = _chip_smoke()
    model = build_arch("uformer", 4, 4, base_width=32)
    pitch = {"encoderlayer_0": 1, "encoderlayer_1": 2, "encoderlayer_2": 4, "encoderlayer_3": 8,
             "conv": 16, "decoderlayer_0": 8, "decoderlayer_1": 4, "decoderlayer_2": 2,
             "decoderlayer_3": 1}
    blocks = collections.Counter(
        (128 // pitch[name.split(".")[0]], m.attn.num_heads, m.modulator is not None, m.shift)
        for name, m in model.named_modules() if isinstance(m, LeWinTransformerBlock))
    want = collections.Counter()
    for n, h, w, heads, modulated, plain, shifted in smoke.WMSA_LEVELS:
        want[(h, heads, modulated, 0)] += plain
        want[(h, heads, modulated, 4)] += shifted
    assert blocks == +want and sum(blocks.values()) == 40
    assert sum(smoke.WMSA_BYTES * n * h * w * 32 * heads * (plain + shifted)
               for n, h, w, heads, _, plain, shifted in smoke.WMSA_LEVELS) == 5_582_618_624
    assert smoke._wmsa_kernel_name(
        "_ZN39_GLOBAL__N__4b94410b_7_wmsa_cu_1ebbe77d8wmsa_bwdILb1ELb0EEEvPK13__nv_bfloat16S3_"
        "PKfS5_S5_PS1_PfS7_NS_3GeoE") == "wmsa_bwd<1, 0>"
    assert smoke._wmsa_kernel_name(
        "_ZN39_GLOBAL__N__4b94410b_7_wmsa_cu_1ebbe77d8wmsa_sumEPKfPfii") == "wmsa_sum"


def test_chip_smokes_leff_shapes_are_a_uformer_steps():
    """Phase 18 checks LeFF's depthwise convs at 4 C channels of each
    attention layer it times: those are the 40 biased depthwise convs of a
    Uformer-B step at embed_dim 32 and batch 32 of 128^2, at their pitch."""
    from eld_tpu_torch.models.uformer import LeFF

    smoke = _chip_smoke()
    model = build_arch("uformer", 4, 4, base_width=32)
    pitch = {"encoderlayer_0": 1, "encoderlayer_1": 2, "encoderlayer_2": 4, "encoderlayer_3": 8,
             "conv": 16, "decoderlayer_0": 8, "decoderlayer_1": 4, "decoderlayer_2": 2,
             "decoderlayer_3": 1}
    convs = collections.Counter(
        (128 // pitch[name.split(".")[0]], m.dwconv[0].in_channels, m.dwconv[0].bias is not None)
        for name, m in model.named_modules() if isinstance(m, LeFF))
    want = collections.Counter()
    for n, h, w, heads, _, plain, shifted in smoke.WMSA_LEVELS:
        want[(h, 4 * 32 * heads, True)] += plain + shifted
    assert convs == want and sum(convs.values()) == 40


_CLEAN_STEP = {"kernels": {"void wmsa_fwd<true, false>(...)": 0.1, "void wmsa_bwd<true, false>(...)":
                           0.2, "void at::native::unrolled_elementwise_kernel<...>": 1.0},
               "ops": {"eld_tpu_torch::window_attention": 40,
                       "eld_tpu_torch::depthwise_conv3x3": 40, "aten::addmm": 160}}


@pytest.mark.parametrize("fault", [
    None, ("kernels", "void at::native::roll_cuda_kernel<float>(...)"),
    ("kernels", "void at::native::softmax_warp_forward<...>"), ("ops", "aten::roll"),
    ("ops", "aten::bmm"), ("ops", "aten::_softmax"), ("drop", "eld_tpu_torch::depthwise_conv3x3"),
    ("drop", "eld_tpu_torch::window_attention"), ("drop", "void wmsa_bwd<true, false>(...)")],
    ids=lambda f: "clean" if f is None else f"{f[0]}-{f[1].split('(')[0].split('<')[0][-24:]}")
def test_chip_smokes_uformer_step_checks(fault):
    """Phase 18's checks of the profiled pooled Uformer step pass a replay
    that runs the ``wmsa_*`` kernels and PyTorch's "unrolled" elementwise
    kernels, with 40 window attentions and 40 depthwise convs eager; a roll
    or softmax kernel, a roll, batched matmul or softmax operator, or a
    missing kernel or operator, fails the smoke."""
    smoke = _chip_smoke()
    step = {k: dict(v) for k, v in _CLEAN_STEP.items()}
    if fault is None:
        out = smoke._uformer_step_checks(step)
        assert out["window_attentions"] == out["depthwise_convs"] == 40 and out["kernels"] == 3
        return
    where, name = fault
    if where == "drop":
        for table in step.values():
            table.pop(name, None)
    else:
        step[where][name] = 1.0
    with pytest.raises(SystemExit):
        smoke._uformer_step_checks(step)
