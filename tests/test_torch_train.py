"""The port's train step, Engine, data pipeline and CLI against eld_tpu.

Float32 on the CPU, from identical weights and batches.  Tolerances: the
loss agrees within rtol 1e-5 (f32 summation order); parameters within
atol 1e-6 on >= 99.9% of entries and within 2 * lr * steps everywhere —
Adam's first steps move each entry by ~lr * sign(grad), so where a
gradient entry is near 0 the two frameworks' rounding can flip its sign.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import eld_tpu.train.engine as jax_engine_mod
from eld_tpu.config import Config as JaxConfig
from eld_tpu.data.datasets import CleanPatchDataset as JaxCleanPatchDataset
from eld_tpu.data.loader import Loader as JaxLoader
from eld_tpu.data.patchstore import PatchStore as JaxPatchStore
from eld_tpu.data.patchstore import PatchStoreWriter as JaxPatchStoreWriter
from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.train.state import TrainState as JaxTrainState
from eld_tpu.train.state import make_optimizer as jax_make_optimizer
from eld_tpu.train.steps import make_train_step as jax_make_train_step
from eld_tpu_torch.compat.jax_params import flax_to_state_dict, state_dict_to_flax
from eld_tpu_torch.config import Config
from eld_tpu_torch.data.datasets import CleanPatchDataset
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.data.patchstore import PatchStore, PatchStoreWriter
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.state import create_train_state, get_learning_rate, set_learning_rate
from eld_tpu_torch.train.steps import fold_in, make_train_step, to_f32

LR = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_unet(width=4, seed=0, **kw):
    torch.manual_seed(seed)
    return build_arch("unet", 4, 4, base_width=width, skip_mode="split", **kw)


def _jax_state(params, lr=LR, wd=0.0):
    tx = jax_make_optimizer(lr, 0.9, wd)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                         epoch=jnp.zeros((), jnp.int32), tx=tx)


def assert_params_close(jax_params, model, steps, lr=LR):
    ref = flax_to_state_dict(jax_params)
    got = model.state_dict()
    close, total = 0, 0
    for k, v in ref.items():
        d = (got[k].detach().cpu() - v).abs()
        assert float(d.max()) <= 2 * lr * steps, k
        close += int((d <= 1e-6).sum())
        total += d.numel()
    assert close / total >= 0.999, close / total


def _paired_batches(n=3, b=2, size=32, seed=0):
    rng = onp.random.default_rng(seed)
    return [{"input": rng.random((b, size, size, 4), dtype=onp.float32),
             "target": rng.random((b, size, size, 4), dtype=onp.float32)} for _ in range(n)]


# ---- the train step -----------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["adam", "adamw"])
def test_paired_steps_match_jax(wd):
    """3 paired L1 steps from identical weights and batches (Adam, and
    optax.adamw against torch.optim.AdamW when wd > 0)."""
    tm = _torch_unet()
    jm = jax_build_arch("unet", 4, 4, base_width=4, skip_mode="split")
    jstate = _jax_state(state_dict_to_flax(tm.state_dict()), wd=wd)
    jstep = jax_make_train_step(jm, loss="l1")
    state = create_train_state(tm, lr=LR, weight_decay=wd)
    assert isinstance(state.optimizer, torch.optim.AdamW if wd else torch.optim.Adam)
    step = make_train_step(tm, loss="l1")
    batches = _paired_batches()
    for i, batch in enumerate(batches):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(i))
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, i)
        onp.testing.assert_allclose(float(m["Pixel"]), float(jm_["Pixel"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    assert_params_close(jstate.params, tm, steps=3)


def test_l2_loss_and_uint_normalization():
    """L2 matches JAX's on one step, and uint16/uint8 batches normalize with
    the same f32 reciprocals as the reference (exactly)."""
    tm = _torch_unet()
    jm = jax_build_arch("unet", 4, 4, base_width=4, skip_mode="split")
    jstate = _jax_state(state_dict_to_flax(tm.state_dict()))
    rng = onp.random.default_rng(1)
    batch = {"input": rng.integers(0, 65535, (2, 32, 32, 4), dtype=onp.uint16),
             "target": rng.integers(0, 255, (2, 32, 32, 4), dtype=onp.uint8)}
    _, jm_ = jax_make_train_step(jm, loss="l2")(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    m = make_train_step(tm, loss="l2")(create_train_state(tm),
                                       {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    onp.testing.assert_allclose(float(m["Pixel"]), float(jm_["Pixel"]), rtol=1e-5)
    u16 = batch["input"]
    onp.testing.assert_array_equal(to_f32(torch.from_numpy(u16)).numpy(),
                                   u16.astype(onp.float32) * onp.float32(1.0 / 65535.0))
    u8 = batch["target"]
    onp.testing.assert_array_equal(to_f32(torch.from_numpy(u8)).numpy(),
                                   u8.astype(onp.float32) * onp.float32(1.0 / 255.0))


def test_set_learning_rate():
    """The LR is a mutable hyperparameter: set/get round-trips, and a step at
    lr 0 leaves every parameter unchanged."""
    tm = _torch_unet()
    state = create_train_state(tm, lr=1e-4)
    assert get_learning_rate(state) == 1e-4
    set_learning_rate(state, 5e-5)
    assert get_learning_rate(state) == 5e-5
    set_learning_rate(state, 0.0)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    make_train_step(tm)(state, {k: torch.from_numpy(v) for k, v in _paired_batches(1)[0].items()},
                        0)
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


def test_synthetic_step_on_cpu_takes_the_plain_noise_path():
    """On CPU tensors "auto" and "kernel" run the plain version: the same step
    seed gives the same loss as noise_impl="plain", and the noise depends
    on the step seed only (fold_in(seed, step) is injective over steps)."""
    bank = load_camera_params(include=4)
    clean = {"clean": torch.from_numpy(
        onp.random.default_rng(2).integers(0, 65535, (2, 32, 32, 4), dtype=onp.uint16))}
    losses = {}
    for impl in ("auto", "kernel", "plain"):
        tm = _torch_unet()
        m = make_train_step(tm, noise_model="eld", bank=bank, noise_impl=impl)(
            create_train_state(tm), clean, fold_in(2018, 0))
        losses[impl] = float(m["Pixel"])
    assert losses["auto"] == losses["kernel"] == losses["plain"]
    assert onp.isfinite(losses["auto"])
    assert len({fold_in(2018, i) for i in range(10_000)}) == 10_000
    with pytest.raises(ValueError):
        make_train_step(_torch_unet(), noise_model="eld", bank=bank, noise_impl="pallas")


# ---- the Engine ---------------------------------------------------------

class _PairedDataset:
    def __init__(self, n=6, size=32, seed=3):
        rng = onp.random.default_rng(seed)
        self.items = [{"input": rng.random((size, size, 4), dtype=onp.float32),
                       "target": rng.random((size, size, 4), dtype=onp.float32)}
                      for _ in range(n)]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def test_engine_train_matches_jax_engine(tmp_path, monkeypatch):
    """Both Engines train one epoch over the same Loader of paired batches
    (cfg.noise = ""), the port's weights carried from the JAX Engine's
    initial params.  The JAX Engine gets those params from the reference's
    default init (torch's) instead of Flax's eager init, which takes ~25 s
    on the CPU; mesh_data=1 because the test harness exposes 8 virtual
    devices and the batch of 2 must divide the data axis."""
    def init_state(model, key, sample_shape, lr=1e-4, beta1=0.9, weight_decay=0.0):
        tm = _torch_unet(width=model.base_width, seed=7)
        return _jax_state(state_dict_to_flax(tm.state_dict()), lr=lr, wd=weight_decay)

    monkeypatch.setattr(jax_engine_mod, "create_train_state", init_state)
    common = dict(noise="", is_train=True, base_width=4, batch_size=2, no_log=True,
                  no_verbose=True, checkpoints_dir=str(tmp_path))
    jeng = jax_engine_mod.Engine(JaxConfig(mesh_data=1, **common))
    eng = Engine(Config(device="cpu", **common))
    eng.model.load_state_dict(flax_to_state_dict(jeng.state.params))

    loader = JaxLoader(_PairedDataset(), batch_size=2, shuffle=True, num_workers=0, seed=5)
    ref = jeng.train(loader)
    got = eng.train(loader)
    assert eng.iterations == jeng.iterations == 3 and eng.epoch == jeng.epoch == 1
    onp.testing.assert_allclose(got["Pixel"], ref["Pixel"], rtol=1e-5)
    assert [h[0] for h in eng.history] == [0, 1, 2]
    assert_params_close(jeng.state.params, eng.model, steps=3)


def test_engine_save_is_the_reference_layout(tmp_path):
    """model_EEE_IIIIIIII.pt / model_<label>.pt holding {netG, opt_g, epoch,
    iterations}; eld_tpu's importer of reference checkpoints reads it."""
    from eld_tpu.compat.torch_import import load_torch_checkpoint

    eng = Engine(Config(device="cpu", base_width=4, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name="run"))
    path = eng.save(wait=True)
    assert os.path.basename(path) == "model_000_00000000.pt"
    ck = torch.load(path, weights_only=False)
    assert set(ck) == {"netG", "opt_g", "epoch", "iterations"}
    params, epoch, iters = load_torch_checkpoint(path)
    assert (epoch, iters) == (0, 0)
    for k, v in flax_to_state_dict(params).items():
        assert torch.equal(v, eng.model.state_dict()[k])
    assert os.path.basename(eng.save(label="latest")) == "model_latest.pt"


# ---- data ---------------------------------------------------------------

def _write(writer_cls, path, records, **kw):
    with writer_cls(path, records.shape[1:], records.dtype, **kw) as w:
        for r in records:
            w.append(r)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_patchstore_reads_across_packages(tmp_path, native):
    """A store written by either package reads identically in the other,
    through the native library and through the NumPy reader."""
    recs = onp.random.default_rng(4).integers(0, 65535, (3, 16, 8, 4), dtype=onp.uint16)
    _write(JaxPatchStoreWriter, str(tmp_path / "a"), recs, use_native=native)
    _write(PatchStoreWriter, str(tmp_path / "b"), recs, use_native=native)
    for path in ("a", "b"):
        ours = PatchStore(str(tmp_path / path), use_native=native)
        ref = JaxPatchStore(str(tmp_path / path), use_native=native)
        assert ours.native == native and len(ours) == len(ref) == 3
        for i in range(3):
            onp.testing.assert_array_equal(ours.record(i), recs[i])
            onp.testing.assert_array_equal(ours[i], ref[i])
        onp.testing.assert_array_equal(ours.batch([2, 0]), ref.batch([2, 0]))


def test_loaders_yield_identical_batches(tmp_path):
    """The same seed gives identical (shuffled, augmented, uint16) batches
    from both packages' CleanPatchDataset + Loader, threads included."""
    recs = onp.random.default_rng(5).integers(0, 65535, (6, 16, 16, 4), dtype=onp.uint16)
    _write(PatchStoreWriter, str(tmp_path / "s"), recs)

    def batches(ds_cls, loader_cls, store_cls):
        ds = ds_cls(store_cls(str(tmp_path / "s")), device_normalize=True,
                    rng=onp.random.default_rng(9))
        loader = loader_cls(ds, batch_size=2, shuffle=True, num_workers=2, seed=9,
                            drop_last=True)
        return [b["clean"] for _ in range(2) for b in loader]  # two epochs

    ours = batches(CleanPatchDataset, Loader, PatchStore)
    ref = batches(JaxCleanPatchDataset, JaxLoader, JaxPatchStore)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert a.dtype == onp.uint16
        onp.testing.assert_array_equal(a, b)


# ---- the CLI and the package --------------------------------------------

def test_train_syn_cli_runs_two_steps_on_cpu(tmp_path):
    from eld_tpu_torch.tools import train_syn

    recs = onp.random.default_rng(6).integers(0, 65535, (4, 32, 32, 4), dtype=onp.uint16)
    _write(PatchStoreWriter, str(tmp_path / "SID_Sony_Raw.eps"), recs)
    argv = ["--traindir", str(tmp_path), "--checkpoints_dir", str(tmp_path / "ck"),
            "--device", "cpu", "--noise", "eld", "--include", "4", "--base_width", "4",
            "-b", "2", "--epochs", "1", "--no-log", "--no-verbose", "--nThreads", "0",
            "--scan", "0"]
    eng = train_syn.main(argv)
    assert eng.iterations == 2
    assert all(onp.isfinite(h[1]["Pixel"]) for h in eng.history)
    assert train_syn.lr_for_epoch(99) == 1e-4 and train_syn.lr_for_epoch(100) == 5e-5
    assert train_syn.lr_for_epoch(180) == 1e-5
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train_syn.main(argv + ["--mesh_data", "2"])
    with pytest.raises(ValueError, match="no cluster environment"):
        train_syn.main(argv + ["--multihost"])
    with pytest.raises(ValueError, match="offline_noise"):
        train_syn.main(argv + ["--noise", ""])


@pytest.mark.parametrize("cli", ["train_syn_per_step", "train_syn_pooled", "train_real"])
def test_profile_traces_and_leaves_the_parameters_unchanged(tmp_path, cli):
    """--profile writes a torch.profiler trace under save_dir/profile (of
    the first min(8, n) steps on the per-step path, of train_pool's first
    call on the pooled one), and the traced run's parameters equal the
    same run's without the flag."""
    import json

    from eld_tpu_torch.data.builder import store_name
    from eld_tpu_torch.tools import train_real, train_syn

    recs = onp.random.default_rng(6).integers(0, 65535, (4, 32, 32, 4), dtype=onp.uint16)
    if cli == "train_real":
        for kind in ("input", "target"):
            _write(PatchStoreWriter, str(tmp_path / store_name(kind)), recs)
        main, extra = train_real.main, []
    else:
        _write(PatchStoreWriter, str(tmp_path / "SID_Sony_Raw.eps"), recs)
        main = train_syn.main
        extra = ["--noise", "eld", "--include", "4", "--scan",
                 "0" if cli == "train_syn_per_step" else "2"]
    params, traces = {}, {}
    for profile in (False, True):
        argv = ["--traindir", str(tmp_path), "--evaldir", str(tmp_path / "none"),
                "--checkpoints_dir", str(tmp_path / f"ck{profile}"), "--device", "cpu",
                "--base_width", "4", "-b", "2", "--epochs", "1", "--no-log", "--no-verbose",
                "--nThreads", "0"] + extra + (["--profile"] if profile else [])
        eng = main(argv)
        assert eng.iterations == 2
        params[profile] = eng.model.state_dict()
        out = os.path.join(eng.cfg.save_dir, "profile")
        traces[profile] = sorted(os.listdir(out)) if os.path.isdir(out) else []
    for k, v in params[False].items():
        assert torch.equal(params[True][k], v), k
    name = "train_pool" if cli == "train_syn_pooled" else "train"
    assert traces == {False: [], True: [f"{name}.pt.trace.json"]}
    with open(os.path.join(eng.cfg.save_dir, "profile", f"{name}.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_package_imports_without_jax_or_nvcc():
    """Every eld_tpu_torch module (the eval stack, the ISP, export and
    serving, the builder, the parallel layer, the demo, the demosaic, the
    video metrics, the host tools, the benchmark tools and the entry points
    included) imports in
    a fresh interpreter without pulling in JAX, and
    importing builds no kernel and loads no native library."""
    code = (
        "import importlib, pkgutil, sys, eld_tpu_torch\n"
        "names = [m.name for m in\n"
        "         pkgutil.walk_packages(eld_tpu_torch.__path__, 'eld_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from eld_tpu_torch.noise.kernels import synthesize_kernel\n"
        "from eld_tpu_torch import _build\n"
        "from eld_tpu_torch.data.rawio import _load_native\n"
        "assert 'jax' not in sys.modules and not _build._LOADED\n"
        "assert _load_native.cache_info().currsize == 0\n"
        "for n in ('models.unet_s2d', 'ops.chop', 'ops.correct', 'ops.metrics',\n"
        "          'core.packing', 'data.pairs', 'data.rawio', 'utils.images',\n"
        "          'train.checkpoints', 'tools.test_sid', 'tools.test_eld',\n"
        "          'core.isp', 'core.emor', 'export', 'noise.host', 'data.builder',\n"
        "          'tools.export_model', 'tools.denoise', 'tools.train_real',\n"
        "          'tools.build_dataset', 'tools.convert_raw', 'parallel.mesh',\n"
        "          'parallel.multihost', 'parallel.spatial', 'tools.demo_synthetic',\n"
        "          'core.demosaic', 'ops.steerable', 'ops.strred', 'utils.matio',\n"
        "          'tools.vis_data', 'tools.bench_decode', 'tools.roofline',\n"
        "          'tools.bench_variants'):\n"
        "    assert 'eld_tpu_torch.' + n in names, n\n"
        "assert synthesize_kernel.launches == 0\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=root)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 61
