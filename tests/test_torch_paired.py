"""The port's paired and sRGB training sources against eld_tpu's: the host
noise model, the dataset builder's stores, the training datasets, the
sRGB eval stage, and the train_real / train_syn --offline_noise / sRGB
CLIs on the CPU.

Tolerances: host code (noise baking, raw stores, raw items, loader
batches) exactly; anything through the ISP within one 8-bit code on at
most 0.1% of values (see test_torch_isp.py; one code is 257 in a uint16
store); whole sRGB evals 0.01 dB PSNR and 1e-4 SSIM; a first paired step's
loss rtol 1e-5 (f32 summation order, as test_torch_train.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import eld_tpu.train.engine as jax_engine_mod
from eld_tpu.config import Config as JaxConfig
from eld_tpu.core.emor import load_crf
from eld_tpu.data import builder as jax_builder
from eld_tpu.data import datasets as jax_datasets
from eld_tpu.data.loader import Loader as JaxLoader
from eld_tpu.data.patchstore import PatchStore as JaxPatchStore
from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.noise.host import HostNoiseModel as JaxHostNoiseModel
from eld_tpu.train.state import TrainState as JaxTrainState
from eld_tpu.train.state import make_optimizer as jax_make_optimizer
from eld_tpu.train.steps import make_train_step as jax_make_train_step
from eld_tpu_torch.compat.jax_params import state_dict_to_flax
from eld_tpu_torch.config import Config
from eld_tpu_torch.data import builder, datasets
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.data.pairs import sid_pairs
from eld_tpu_torch.data.patchstore import PatchStore, PatchStoreWriter
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.host import HostNoiseModel
from eld_tpu_torch.tools import build_dataset, train_real, train_syn
from eld_tpu_torch.train.engine import Engine
from tests.tiff_fixture import make_dng

U16_CODE = 257  # one 8-bit code in a uint16 store: rint(65535 / 255)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_codes_close(got, ref, code=1.0 / 255):
    d = onp.rint((onp.asarray(got, onp.float64) - onp.asarray(ref, onp.float64)) / code)
    assert onp.abs(d).max() <= 1 and (d != 0).mean() <= 1e-3


def _smooth_mosaic(shape, rng):
    yy, xx = onp.meshgrid(onp.linspace(0, 1, shape[0]), onp.linspace(0, 1, shape[1]),
                          indexing="ij")
    img = 0.5 + 0.4 * onp.sin(2 * onp.pi * (rng.uniform(1, 3) * yy + rng.uniform(1, 3) * xx))
    return (2048 + img * 12000).astype(onp.uint16)


def _write_raw(path, mosaic, exposure, wb_neutral=(0.5, 1.0, 0.6)):
    with open(path, "wb") as f:
        f.write(make_dng(mosaic, iso=100, exposure=exposure, wb_neutral=wb_neutral))


def _sid_train_tree(root, shape, n=2):
    """DNG bytes under the first SID train names (``sid_pairs('train')``):
    the first ``n`` long exposures and the shorts of the first ``n``
    pairs, each short the long scene at 1/ratio."""
    rng = onp.random.default_rng(0)
    longs = sorted({p[1] for p in sid_pairs("train")})[:n]
    pairs = sorted(sid_pairs("train"))[:n]
    for sub in ("short", "long"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    scenes = {}
    for fn in sorted(set(longs) | {b for _, b in pairs}):
        scenes[fn] = _smooth_mosaic(shape, rng)
        _write_raw(os.path.join(root, "long", fn), scenes[fn], 10.0)
    for a, b in pairs:
        expo = float(a.split("_")[-1][:-5])  # '00001_00_0.04s.ARW' -> 0.04
        dark = (512 + (scenes[b].astype(onp.float32) - 512) * expo / 10).astype(onp.uint16)
        _write_raw(os.path.join(root, "short", a), dark, expo)
    return root


def _store(path, records, **aux):
    with PatchStoreWriter(str(path), records.shape[1:], records.dtype) as w:
        for i, r in enumerate(records):
            w.append(r, **{k: v[i] for k, v in aux.items()})
    return str(path)


# ---- host noise ---------------------------------------------------------------

@pytest.mark.parametrize("model,channels", [("g", 4), ("PGrqc", 4), ("Pgrqc", 3), ("pG", 9)])
def test_host_noise_model_is_byte_equal_to_jax(model, channels):
    """The same default_rng seed gives the same bytes, parameters drawn
    or given, Bayer (row pairs, color bias) and not."""
    clean = onp.random.default_rng(1).random((16, 24, channels), dtype=onp.float32)
    ours = HostNoiseModel(model=model, include=4, rng=onp.random.default_rng(5))
    ref = JaxHostNoiseModel(model=model, include=4, rng=onp.random.default_rng(5))
    for _ in range(2):
        a, b = ours(clean), ref(clean)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    p = ref._sample_params()
    assert ours._sample_params().keys() == p.keys()
    assert ours(clean, params=p).tobytes() == ref(clean, params=p).tobytes()
    with pytest.raises(ValueError):
        HostNoiseModel(k_mode="typo")._sample_params()


# ---- the builder --------------------------------------------------------------

def _read_store(path):
    with open(os.path.join(path, "data.bin"), "rb") as f:
        data = f.read()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    aux = dict(onp.load(os.path.join(path, "aux.npz")))
    return data, meta, aux


def test_builder_stores_equal_jax(tmp_path):
    """create_sony_dataset{,_paired,_srgb} and create_sony_syn_dataset on
    SID-named DNGs (packed 512x512: one patch each): the raw, paired and
    syn stores byte-equal to eld_tpu's, the sRGB (CRF) store within one
    8-bit code; the CLI writes the same raw store."""
    src = _sid_train_tree(str(tmp_path / "sid"), (1024, 1024))
    dest = {k: str(tmp_path / k) for k in ("ours", "ref", "cli")}
    for mod, d in ((builder, dest["ours"]), (jax_builder, dest["ref"])):
        mod.create_sony_dataset(src, d, num_samples=2)
        mod.create_sony_dataset_paired(src, d, num_samples=2)
        mod.create_sony_syn_dataset(src, d, 4, "PGrqc", num_samples=2, seed=7)
        mod.create_sony_dataset_srgb(src, d, num_samples=2)
    build_dataset.main(["clean", "--sourcedir", src, "--destdir", dest["cli"],
                        "--num_samples", "2"])
    raw_names = ("SID_Sony_Raw.eps", "SID_Sony_input_Raw.eps", "SID_Sony_target_Raw.eps",
                 "SID_Sony_syn_Raw_SonyA7S2.eps")
    for name in raw_names + ("SID_Sony_SRGB_CRF.eps",):
        (a, meta_a, aux_a), (b, meta_b, aux_b) = (_read_store(os.path.join(d, name))
                                                  for d in (dest["ours"], dest["ref"]))
        assert meta_a == meta_b and meta_a["count"] == 2, name
        for k in aux_b:
            onp.testing.assert_array_equal(aux_a[k], aux_b[k])
        if name in raw_names:
            assert a == b, name
        else:
            assert meta_a["shape"] == [512, 512, 3]
            diff = onp.abs(onp.frombuffer(a[4096:], onp.uint16).astype(onp.int32)
                           - onp.frombuffer(b[4096:], onp.uint16))
            assert diff.max() <= U16_CODE and (diff > 0).mean() <= 1e-3
    assert _read_store(os.path.join(dest["cli"], raw_names[0]))[0] == \
        _read_store(os.path.join(dest["ref"], raw_names[0]))[0]
    img = onp.random.default_rng(2).random((70, 50, 3), dtype=onp.float32)
    for patch, stride in ((32, 32), (16, 8), (80, 80)):
        onp.testing.assert_array_equal(builder.extract_patches(img, patch, stride),
                                       jax_builder.extract_patches(img, patch, stride))
    with pytest.raises(FileExistsError):
        builder.create_sony_dataset(src, dest["ours"], num_samples=2)


# ---- datasets -----------------------------------------------------------------

def _items_equal(ours, ref, n, srgb=()):
    for i in range(n):
        a, b = ours[i], ref[i]
        if not isinstance(a, dict):
            a, b = {"x": a}, {"x": b}
        assert set(a) == set(b)
        for k in a:
            if not isinstance(a[k], onp.ndarray):
                assert a[k] == b[k], k
            elif k in srgb:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert_codes_close(a[k], b[k])
            else:
                assert a[k].dtype == b[k].dtype, k
                onp.testing.assert_array_equal(a[k], b[k])


def test_eld_train_syn_and_isp_datasets_equal_jax(tmp_path):
    """ELDTrainDataset (two inputs interleaved, joint augmentation, two
    epochs), SynDataset (host noise, a burst of 2) and ISPDataset (noise,
    CRF, each record's own wb/ccm through physical_index on a store shown
    at a smaller size): the same items for one seed."""
    rng = onp.random.default_rng(3)
    recs = rng.integers(0, 65535, (5, 16, 16, 4), dtype=onp.uint16)
    wb = rng.uniform(1, 2.5, (5, 4)).astype(onp.float32)
    ccm = (onp.eye(3) + rng.normal(0, 0.1, (5, 3, 3))).astype(onp.float32)
    paths = [_store(tmp_path / f"s{j}", (recs + 1000 * j).astype(onp.uint16), wb=wb, ccm=ccm)
             for j in range(3)]
    ours_ds = datasets.ELDTrainDataset(PatchStore(paths[0]), [PatchStore(p) for p in paths[1:]],
                                       rng=onp.random.default_rng(4))
    ref_ds = jax_datasets.ELDTrainDataset(JaxPatchStore(paths[0]),
                                          [JaxPatchStore(p) for p in paths[1:]],
                                          rng=onp.random.default_rng(4))
    assert len(ours_ds) == len(ref_ds) == 10
    for epoch in (0, 1):
        ours_ds.set_epoch(epoch)
        ref_ds.set_epoch(epoch)
        _items_equal(ours_ds, ref_ds, 10)

    ours_syn = datasets.SynDataset(PatchStore(paths[0]), HostNoiseModel(
        "PGrqc", include=4, rng=onp.random.default_rng(6)), num_burst=2)
    ref_syn = jax_datasets.SynDataset(JaxPatchStore(paths[0]), JaxHostNoiseModel(
        "PGrqc", include=4, rng=onp.random.default_rng(6)), num_burst=2)
    _items_equal(ours_syn, ref_syn, 5)

    crf = load_crf()
    ours_isp = datasets.ISPDataset(PatchStore(paths[0], size=3), HostNoiseModel(
        "g", include=4, rng=onp.random.default_rng(8)), crf=crf)
    ref_isp = jax_datasets.ISPDataset(JaxPatchStore(paths[0], size=3), JaxHostNoiseModel(
        "g", include=4, rng=onp.random.default_rng(8)), crf=crf)
    assert PatchStore(paths[0], size=3).physical_index(4) == 1
    _items_equal(ours_isp, ref_isp, 3, srgb=("x",))
    cat = datasets.ConcatDataset([PatchStore(paths[0]), PatchStore(paths[1], size=2)])
    ref_cat = jax_datasets.ConcatDataset([JaxPatchStore(paths[0]), JaxPatchStore(paths[1], size=2)])
    assert len(cat) == len(ref_cat) == 7
    _items_equal(cat, ref_cat, 7)


@pytest.mark.parametrize("stages", [("raw", "raw", False), ("srgb", "srgb", False),
                                    ("srgb", "raw", True)],
                         ids=["raw", "srgb", "srgb_in_gt_wb"])
def test_sid_dataset_stages_equal_jax(tmp_path, stages):
    """SIDDataset with the sRGB stages (CRF, the input's own or, under
    gt_wb, the target's wb: the shorts carry another white balance) and
    32-px crops: the same items for one seed."""
    stage_in, stage_out, gt_wb = stages
    root = str(tmp_path / "sid")
    pairs = [("00001_00_0.1s.ARW", "00001_00_10s.ARW"), ("00002_00_0.04s.ARW", "00002_00_10s.ARW")]
    rng = onp.random.default_rng(9)
    for sub in ("short", "long"):
        os.makedirs(os.path.join(root, sub))
    for a, b in pairs:
        gt = _smooth_mosaic((96, 128), rng)
        _write_raw(os.path.join(root, "long", b), gt, 10.0)
        _write_raw(os.path.join(root, "short", a),
                   (512 + (gt.astype(onp.float32) - 512) / 100).astype(onp.uint16), 0.1,
                   wb_neutral=(0.4, 1.0, 0.7))
    kw = dict(stage_in=stage_in, stage_out=stage_out, gt_wb=gt_wb, crf=load_crf(),
              patch_size=32, repeat=2)
    ours = datasets.SIDDataset(root, pairs, rng=onp.random.default_rng(10), **kw)
    ref = jax_datasets.SIDDataset(root, pairs, rng=onp.random.default_rng(10), **kw)
    srgb = tuple(k for k, s in (("input", stage_in), ("target", stage_out)) if s == "srgb")
    _items_equal(ours, ref, 4, srgb=srgb)
    if srgb:
        assert ours[0]["input"].shape == (32, 32, 3 if stage_in == "srgb" else 4)


# ---- the sRGB eval stage ------------------------------------------------------

def test_engine_srgb_eval_with_crf_matches_jax_engine(tmp_path, monkeypatch):
    """Both Engines load one .pt and score DNG SID pairs with --stage_eval
    srgb --crf (the raw output, target and input rendered with the item's
    wb/ccm): PSNR within 0.01 dB and SSIM within 1e-4, inputs' too.  The
    JAX Engine starts from carried params instead of Flax's eager init."""
    def init_state(model, key, sample_shape, lr=1e-4, beta1=0.9, weight_decay=0.0):
        torch.manual_seed(0)
        sd = build_arch("unet", 4, 4, base_width=model.base_width).state_dict()
        params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(sd))
        tx = jax_make_optimizer(lr, beta1, weight_decay)
        return JaxTrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32), tx=tx)

    monkeypatch.setattr(jax_engine_mod, "create_train_state", init_state)
    common = dict(base_width=4, no_log=True, no_verbose=True, stage_eval="srgb", crf=True)
    src = Engine(Config(device="cpu", name="src", seed=11, checkpoints_dir=str(tmp_path / "ck"),
                        **common))
    path = src.save(label="latest")
    root = str(tmp_path / "sid")
    pairs = [("00001_00_0.1s.ARW", "00001_00_10s.ARW"), ("00002_00_0.04s.ARW", "00002_00_10s.ARW")]
    rng = onp.random.default_rng(12)
    for sub in ("short", "long"):
        os.makedirs(os.path.join(root, sub))
    for a, b in pairs:
        gt = _smooth_mosaic((1040, 1040), rng)
        _write_raw(os.path.join(root, "long", b), gt, 10.0)
        ratio = 100 if "0.1s" in a else 250
        _write_raw(os.path.join(root, "short", a),
                   (512 + (gt.astype(onp.float32) - 512) / ratio).astype(onp.uint16), 10 / ratio)
    ours = Engine(Config(device="cpu", name="e", model_path=path,
                         checkpoints_dir=str(tmp_path / "ck"), **common))
    ref = jax_engine_mod.Engine(JaxConfig(name="e", model_path=path, mesh_data=1,
                                          checkpoints_dir=str(tmp_path / "jck"), async_ckpt=False,
                                          **common))
    got = ours.eval(Loader(datasets.SIDDataset(root, pairs, augment=False, memorize=False),
                           batch_size=1, num_workers=0), "sid", correct=True, crop=True,
                    savedir=str(tmp_path / "png"))
    want = ref.eval(JaxLoader(jax_datasets.SIDDataset(root, pairs, augment=False,
                                                      memorize=False),
                              batch_size=1, num_workers=0), "sid", correct=True, crop=True)
    for k in ("PSNR", "PSNR_in"):
        assert abs(got[k] - want[k]) <= 0.01, (k, got[k], want[k])
    for k in ("SSIM", "SSIM_in"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    from eld_tpu_torch.utils.images import load_png

    pngs = os.listdir(tmp_path / "png" / "00001_00_0.1s")
    assert load_png(str(tmp_path / "png" / "00001_00_0.1s" / "t_label.png")).shape == \
        (512, 512, 3) and len(pngs) == 3


# ---- the training CLIs ---------------------------------------------------------

def _paired_stores(traindir, names, n=8, size=32):
    rng = onp.random.default_rng(13)
    target = rng.integers(0, 65535, (n, size, size, 4), dtype=onp.uint16)
    noisy = onp.clip(target.astype(onp.int64) + rng.integers(-4000, 4000, target.shape),
                     0, 65535).astype(onp.uint16)
    _store(os.path.join(traindir, names[0]), noisy)
    _store(os.path.join(traindir, names[1]), target)


def _jax_first_loss_and_batches(traindir, names, seed):
    """eld_tpu's loader batches over the two stores and its paired step's
    first loss from the weights the port's Engine starts from."""
    ds = jax_datasets.ELDTrainDataset(JaxPatchStore(os.path.join(traindir, names[1])),
                                      [JaxPatchStore(os.path.join(traindir, names[0]))],
                                      rng=onp.random.default_rng(seed))
    loader = JaxLoader(ds, batch_size=2, shuffle=True, num_workers=0, seed=seed, drop_last=True)
    loader.set_epoch(0)
    batches = list(loader)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        init = build_arch("unet", 4, 4, base_width=4, skip_mode="split").state_dict()
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(init))
    tx = jax_make_optimizer(1e-4, 0.9, 0.0)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32), tx=tx)
    step = jax_make_train_step(jax_build_arch("unet", 4, 4, base_width=4, skip_mode="split"),
                               loss="l1")
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batches[0].items()},
                      jax.random.PRNGKey(0))
    return float(metrics["Pixel"]), batches


@pytest.mark.parametrize("cli", ["train_real", "train_syn_offline"])
def test_paired_clis_match_jax_on_cpu(tmp_path, cli, monkeypatch):
    """train_real and train_syn --offline_noise --scan 0, one epoch on the
    CPU: the per-step loader's batches equal eld_tpu's for the seed, and
    the first step's loss equals eld_tpu's paired step within rtol 1e-5."""
    names = {"train_real": ("SID_Sony_input_Raw.eps", "SID_Sony_target_Raw.eps"),
             "train_syn_offline": ("SID_Sony_syn_Raw_SonyA7S2.eps", "SID_Sony_Raw.eps")}[cli]
    traindir = str(tmp_path / "train")
    _paired_stores(traindir, names)
    seen = []
    real_train = Engine.train

    def train(self, loader):
        seen.extend(loader)  # the loader re-iterates the same epoch below
        return real_train(self, loader)

    monkeypatch.setattr(Engine, "train", train)
    argv = ["--traindir", traindir, "--evaldir", str(tmp_path / "none"), "--device", "cpu",
            "--base_width", "4", "-b", "2", "--epochs", "1", "--no-log", "--no-verbose",
            "--nThreads", "0", "--seed", "21", "--checkpoints_dir", str(tmp_path / "ck")]
    if cli == "train_real":
        eng = train_real.main(argv)
    else:
        eng = train_syn.main(argv + ["--offline_noise", "--include", "4", "--scan", "0"])
    want_loss, want_batches = _jax_first_loss_and_batches(traindir, names, 21)
    assert eng.iterations == len(want_batches) == 4 and len(seen) == 4
    for a, b in zip(seen, want_batches):
        for k in ("input", "target"):
            onp.testing.assert_array_equal(a[k], b[k])
    onp.testing.assert_allclose(eng.history[0][1]["Pixel"], want_loss, rtol=1e-5)
    with pytest.raises(ValueError, match="no cluster environment"):
        train_real.main(argv + ["--multihost"])


def test_train_syn_offline_noise_pools_input_and_target(tmp_path, monkeypatch):
    """--scan auto resolves to 10 for --offline_noise, and the pooled
    trainer runs on a pool of {"input", "target"} holding both stores."""
    traindir = str(tmp_path / "train")
    _paired_stores(traindir, ("SID_Sony_syn_Raw_SonyA7S2.eps", "SID_Sony_Raw.eps"), n=24)
    pools = []
    real_pool = Engine.train_pool

    def train_pool(self, pool, steps, steps_per_call=10):
        pools.append(({k: tuple(v.shape) for k, v in pool.items()}, steps, steps_per_call))
        return real_pool(self, pool, steps, steps_per_call)

    monkeypatch.setattr(Engine, "train_pool", train_pool)
    eng = train_syn.main(["--traindir", traindir, "--device", "cpu", "--base_width", "4",
                          "-b", "2", "--epochs", "1", "--no-log", "--no-verbose",
                          "--offline_noise", "--include", "4", "--evaldir",
                          str(tmp_path / "none"), "--checkpoints_dir", str(tmp_path / "ck")])
    assert pools == [({"input": (24, 32, 32, 4), "target": (24, 32, 32, 4)}, 12, 10)]
    assert [h[0] for h in eng.history] == [10, 12] and eng.bank is None
    assert all(onp.isfinite(v) for h in eng.history for v in h[1].values())


def test_train_syn_srgb_stage_on_cpu(tmp_path):
    """--stage_in/--stage_out srgb: 3-channel patches of the CRF store, the
    per-step loader (--scan auto gives 0), noise on the 3 channels, a
    3 -> 3 channel U-Net."""
    traindir = str(tmp_path / "train")
    recs = onp.random.default_rng(14).integers(0, 65535, (4, 32, 32, 3), dtype=onp.uint16)
    _store(os.path.join(traindir, "SID_Sony_SRGB_CRF.eps"), recs)
    eng = train_syn.main(["--traindir", traindir, "--device", "cpu", "--base_width", "4",
                          "-b", "2", "--epochs", "1", "--no-log", "--no-verbose", "--noise",
                          "eld", "--include", "4", "--stage_in", "srgb", "--stage_out", "srgb",
                          "--crf", "--nThreads", "0", "--evaldir", str(tmp_path / "none"),
                          "--checkpoints_dir", str(tmp_path / "ck")])
    assert eng.iterations == 2 and [h[0] for h in eng.history] == [0, 1]
    assert eng.model.conv1_1.in_channels == 3 and eng.model.conv10_1.out_channels == 3
    assert all(onp.isfinite(h[1]["Pixel"]) for h in eng.history)
