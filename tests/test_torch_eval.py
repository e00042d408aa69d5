"""The port's eval stack against eld_tpu: eval forward (edge-pad and chop),
illuminance correction, PSNR/SSIM, raw decoding, the SID/ELD datasets,
read-ahead, checkpoints, Engine.eval/test/load and the test_sid/test_eld
entry points.

Float32 on the CPU.  Tolerances: the eval forward 1e-5 (f32 convolution
summation order through 18 layers at width 4); the correction rtol 1e-5
(one f32 dot product per image, summed in another order); PSNR 1e-3 dB and
SSIM 1e-5 (f32 means over the image, in another order); host code (raw
decoding, datasets) exact; whole evals 0.01 dB / 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import eld_tpu.train.engine as jax_engine_mod
from eld_tpu.config import Config as JaxConfig
from eld_tpu.data import rawio as jax_rawio
from eld_tpu.data.datasets import ELDEvalDataset as JaxELDEvalDataset
from eld_tpu.data.datasets import SIDDataset as JaxSIDDataset
from eld_tpu.data.loader import Loader as JaxLoader
from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.ops.chop import chop_geometry as jax_chop_geometry
from eld_tpu.ops.correct import illuminance_correct_batch as jax_correct
from eld_tpu.ops.metrics import quality_assess as jax_quality_assess
from eld_tpu.tools.test_sid import parse_pairs_file as jax_parse_pairs_file
from eld_tpu.train.state import TrainState as JaxTrainState
from eld_tpu.train.state import make_optimizer as jax_make_optimizer
from eld_tpu.train.steps import make_eval_forward as jax_make_eval_forward
from eld_tpu_torch.compat.jax_params import state_dict_to_flax
from eld_tpu_torch.config import Config
from eld_tpu_torch.data import rawio
from eld_tpu_torch.data.datasets import ELDEvalDataset, SIDDataset
from eld_tpu_torch.data.loader import Loader, readahead
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.ops.chop import chop_geometry
from eld_tpu_torch.ops.correct import illuminance_correct_batch
from eld_tpu_torch.ops.metrics import quality_assess
from eld_tpu_torch.tools import test_eld, test_sid
from eld_tpu_torch.train.checkpoints import find_checkpoint
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.steps import make_eval_forward
from tests.arw_fixture import make_arw
from tests.test_rawio import XTRANS_CFA
from tests.tiff_fixture import make_dng


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch="unet", width=4, seed=0):
    torch.manual_seed(seed)
    return build_arch(arch, 4, 4, base_width=width, skip_mode="split")


# ---- eval forward, chop, correction, metrics ----------------------------

@pytest.mark.parametrize("chop", [False, True], ids=["pad", "chop"])
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_eval_forward_matches_jax(arch, chop):
    """A (2, 72, 88) frame, aligned to neither 16 nor 32: edge-padded to the
    arch's alignment and cropped back, or 4-tile chopped on it."""
    tm = _model(arch)
    jm = jax_build_arch(arch, 4, 4, base_width=4, skip_mode="split")
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(tm.state_dict()))
    x = onp.random.default_rng(1).random((2, 72, 88, 4), dtype=onp.float32)
    ref = onp.asarray(jax_make_eval_forward(jm, chop=chop)(params, jnp.asarray(x)))
    got = make_eval_forward(tm, chop=chop)(torch.from_numpy(x))
    assert got.shape == ref.shape == x.shape and not got.requires_grad
    onp.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_chop_geometry_equals_jax():
    for h, w in [(72, 88), (1424, 2128), (64, 64), (100, 37), (20, 20), (33, 200)]:
        for base in (16, 32, 64):
            try:
                ref = jax_chop_geometry(h, w, base)
            except ValueError as e:
                with pytest.raises(ValueError) as ours:
                    chop_geometry(h, w, base)
                assert str(ours.value) == str(e)
                continue
            assert chop_geometry(h, w, base) == ref


@pytest.mark.parametrize("case", ["per_item", "shared_source", "degenerate"])
def test_illuminance_correction_equals_jax(case):
    """Per-item alpha over the source != 1 mask; a batch-1 source shared;
    alpha = 1 for an all-zero prediction and for a fully saturated source."""
    rng = onp.random.default_rng(2)
    pred = rng.uniform(-0.2, 1.2, (3, 16, 12, 4)).astype(onp.float32)
    source = rng.random((1 if case == "shared_source" else 3, 16, 12, 4), dtype=onp.float32)
    source[..., :3, :] = 1.0  # saturated pixels leave the mask
    if case == "degenerate":
        pred[0] = -1.0
        source[1] = 1.0
    got = illuminance_correct_batch(torch.from_numpy(pred), torch.from_numpy(source)).numpy()
    ref = onp.asarray(jax_correct(jnp.asarray(pred), jnp.asarray(source)))
    onp.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    if case == "degenerate":
        onp.testing.assert_array_equal(got[0], 0.0)
        onp.testing.assert_array_equal(got[1], onp.clip(pred[1], 0, 1))


@pytest.mark.parametrize("shape", [(32, 40, 4), (17, 23, 3)])
def test_psnr_ssim_equal_jax(shape):
    rng = onp.random.default_rng(3)
    target = rng.random(shape, dtype=onp.float32) * 255
    pred = onp.clip(target + rng.normal(0, 20, shape), 0, 255).astype(onp.float32)
    for data_range in (255.0, 1.0):
        p, t = pred / 255 * data_range, target / 255 * data_range
        ours = quality_assess(torch.from_numpy(p), torch.from_numpy(t), data_range)
        ref = jax_quality_assess(p, t, data_range)
        assert abs(ours["PSNR"] - ref["PSNR"]) <= 1e-3
        assert abs(ours["SSIM"] - ref["SSIM"]) <= 1e-5


# ---- host copies: raw decoding, datasets, read-ahead ---------------------

def _raw_file(kind, path, rng):
    if kind == "dng":
        data = make_dng(rng.integers(0, 16383, (24, 32)).astype(onp.uint16), iso=1600,
                        exposure=0.1, black=(100, 200, 300, 400))
    elif kind == "dng_grbg":
        data = make_dng(rng.integers(0, 16383, (24, 32)).astype(onp.uint16), cfa=(1, 0, 2, 1))
    elif kind == "xtrans":
        data = make_dng(rng.integers(1024, 16384, (36, 48)).astype(onp.uint16),
                        black=(1024,) * 4, cfa=XTRANS_CFA)
    elif kind == "arw":
        data = make_arw(rng, width=64, height=8)[0]
    else:
        onp.savez(path, mosaic=rng.integers(0, 16383, (24, 32)).astype(onp.uint16),
                  black_level=onp.float32(512), iso=800.0, exposure=0.5)
        return
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("kind,name", [("dng", "a.dng"), ("dng_grbg", "b.dng"),
                                       ("xtrans", "c.dng"), ("arw", "d.ARW"),
                                       ("rawpack", "e.npz")],
                         ids=["dng", "dng-grbg", "xtrans", "arw", "rawpack"])
def test_rawio_equals_jax(tmp_path, kind, name):
    path = str(tmp_path / name)
    _raw_file(kind, path, onp.random.default_rng(4))
    ours, ref = rawio.imread(path), jax_rawio.imread(path)
    for field in ("mosaic", "black_level", "cfa_pattern", "wb", "ccm"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype
        onp.testing.assert_array_equal(a, b)
    for field in ("white_level", "iso", "exposure", "cfa"):
        assert getattr(ours, field) == getattr(ref, field)
    onp.testing.assert_array_equal(ours.packed(), ref.packed())


def _rawpack(path, mosaic, iso, exposure):
    onp.savez(path, mosaic=mosaic, black_level=onp.float32(512), iso=float(iso),
              exposure=float(exposure), wb=onp.array([2.0, 1.0, 1.5, 1.0], onp.float32))


def _sid_tree(root, pairs, shape, ext=".npz"):
    """Short/long rawpacks (or DNG bytes for ext != .npz) of a smooth
    scene: the long exposure and a 1/ratio-scaled short one."""
    rng = onp.random.default_rng(5)
    os.makedirs(os.path.join(root, "short"), exist_ok=True)
    os.makedirs(os.path.join(root, "long"), exist_ok=True)
    for short, long_, ratio in pairs:
        gt = rng.integers(2048, 16384, shape).astype(onp.uint16)
        dark = (512 + (gt.astype(onp.float32) - 512) / ratio).astype(onp.uint16)
        for sub, fn, mosaic, iso, expo in (("long", long_, gt, 100, 10),
                                          ("short", short, dark, 100, 10 / ratio)):
            path = os.path.join(root, sub, fn)
            if ext == ".npz":
                _rawpack(path, mosaic, iso, expo)
            else:
                with open(path, "wb") as f:
                    f.write(make_dng(mosaic, iso=iso, exposure=expo))
    return root


@pytest.mark.parametrize("augment", [False, True], ids=["full", "crops"])
def test_sid_dataset_items_equal_jax(tmp_path, augment):
    """The same seed gives the same items: decode, pack, ratio, and (with
    augment) the IndexedRNG crops and flips, across two epochs."""
    pairs = [("00001_00_0.1s.npz", "00001_00_10s.npz", 100),
             ("00002_00_0.033s.npz", "00002_00_10s.npz", 300)]
    root = _sid_tree(str(tmp_path), pairs, (96, 128))
    fns = [p[:2] for p in pairs]
    kw = dict(augment=augment, patch_size=32, repeat=2)
    ours = SIDDataset(root, fns, rng=onp.random.default_rng(6), **kw)
    ref = JaxSIDDataset(root, fns, rng=onp.random.default_rng(6), **kw)
    assert len(ours) == len(ref) == 4
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(4):
            a, b = ours[i], ref[i]
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], onp.ndarray):
                    assert a[k].dtype == b[k].dtype
                    onp.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k


def _eld_tree(root, camera, suffix, scenes, shape):
    rng = onp.random.default_rng(7)
    for scene in scenes:
        d = os.path.join(root, camera, f"scene-{scene}")
        os.makedirs(d)
        gt = rng.integers(2048, 16384, shape).astype(onp.uint16)
        dark = (512 + (gt.astype(onp.float32) - 512) / 100).astype(onp.uint16)
        for img_id in (6, 11, 16):
            _rawpack(os.path.join(d, f"IMG_{img_id:04d}{suffix}"), gt, 800, 1.0)
        for img_id in (4, 9, 14, 5, 10, 15):
            _rawpack(os.path.join(d, f"IMG_{img_id:04d}{suffix}"), dark, 800, 0.01)
    return root


def test_eld_eval_dataset_items_equal_jax(tmp_path):
    root = _eld_tree(str(tmp_path), "SonyA7S2", ".npz", (1, 2), (40, 48))
    args = (root, ("SonyA7S2", ".npz"), [1, 2], [4, 9, 14])
    ours, ref = ELDEvalDataset(*args), JaxELDEvalDataset(*args)
    assert len(ours) == len(ref) == 6
    for i in range(6):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) and a["fn"] == b["fn"] and a["rawpath"] == b["rawpath"]
        for k in ("input", "target", "wb", "ccm", "ratio"):
            onp.testing.assert_array_equal(a[k], b[k])


def test_readahead_passes_items_through_exactly():
    """An exception object the iterator yields is an item like any other;
    an exception it raises is raised at its position; size 0 is a no-op."""
    item = ValueError("an item, not an error")
    got = list(readahead(iter([1, item, None, 2]), 2))
    assert got == [1, item, None, 2] and got[1] is item

    def failing():
        yield 1
        raise KeyError("boom")

    it = readahead(failing(), 2)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    plain = iter([1])
    assert readahead(plain, 0) is plain


# ---- checkpoints and the Engine ------------------------------------------

def _cfg(tmp_path, name, **kw):
    base = dict(device="cpu", base_width=4, no_verbose=True, no_log=True,
                checkpoints_dir=str(tmp_path / "ck"), name=name)
    base.update(kw)
    return Config(**base)


def test_checkpoint_discovery_and_orbax_refusal(tmp_path):
    eng = Engine(_cfg(tmp_path, "c"))
    save_dir = eng.cfg.save_dir
    assert find_checkpoint(save_dir) is None
    assert find_checkpoint(str(tmp_path / "absent")) is None
    eng.save(label="latest")
    assert find_checkpoint(save_dir).endswith("model_latest.pt")
    for epoch, step in ((3, 30), (5, 50)):
        eng.state.epoch, eng.state.step = epoch, step
        eng.save()
    assert find_checkpoint(save_dir).endswith("model_005_00000050.pt")
    assert find_checkpoint(save_dir, 3).endswith("model_003_00000030.pt")
    assert find_checkpoint(save_dir, 4) is None
    assert not [f for f in os.listdir(save_dir) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="flax_to_state_dict"):
        eng.load(str(tmp_path / "model_latest.ckpt"))
    with pytest.raises(FileNotFoundError):
        Engine(_cfg(tmp_path, "empty", resume=True))


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


def test_resume_restores_params_optimizer_epoch_and_iterations(tmp_path):
    """--resume (newest checkpoint) and --model_path restore everything a
    run needs: a resumed run's next epoch equals the uninterrupted run's."""
    loader = Loader(_PairedDataset(), batch_size=2, shuffle=True, num_workers=0, seed=5)
    kw = dict(is_train=True, noise="", batch_size=2, no_log=False)
    eng = Engine(_cfg(tmp_path, "r", **kw))
    eng.train(loader)
    resumed = Engine(_cfg(tmp_path, "r", resume=True, **kw))
    by_path = Engine(_cfg(tmp_path, "other", model_path=os.path.join(eng.cfg.save_dir,
                                                                     "model_latest.pt"), **kw))
    for other in (resumed, by_path):
        assert (other.epoch, other.iterations) == (1, 3)
        for k, v in eng.model.state_dict().items():
            assert torch.equal(v, other.model.state_dict()[k]), k
        ref_opt = eng.state.optimizer.state_dict()["state"]
        got_opt = other.state.optimizer.state_dict()["state"]
        assert ref_opt.keys() == got_opt.keys()
        for i in ref_opt:
            assert all(torch.equal(ref_opt[i][k], got_opt[i][k]) for k in ref_opt[i])
    eng.train(loader)
    resumed.train(loader)
    assert resumed.iterations == eng.iterations == 6
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


def test_best_checkpoint_direction_and_persistence(tmp_path):
    """Quality metrics are maximized and losses minimized; a new best saves
    model_best_<key>_<name>.pt and then best_val.json, which a resumed run
    reads back."""
    eng = Engine(_cfg(tmp_path, "b"))
    loader = Loader(_PairedDataset(n=2), batch_size=1, num_workers=0)
    meters = eng.eval(loader, "d", loss_key="PSNR", crop=False)
    assert set(meters.keys()) == {"PSNR", "SSIM", "PSNR_in", "SSIM_in"}
    assert os.path.exists(os.path.join(eng.cfg.save_dir, "model_best_PSNR_d.pt"))
    assert eng.best_val == {"d/PSNR": meters["PSNR"]}
    assert eng.eval_history == [(0, "d", meters.as_dict())]
    assert not eng._is_new_best("d", "PSNR", meters["PSNR"] - 1)
    assert eng._is_new_best("d", "PSNR", meters["PSNR"] + 1)
    eng._record_best("d", "Pixel", 0.5)
    assert not eng._is_new_best("d", "Pixel", 0.6) and eng._is_new_best("d", "Pixel", 0.4)
    eng.save(label="latest")  # discovery reads numbered and latest saves, not best ones
    resumed = Engine(_cfg(tmp_path, "b", resume=True))
    assert resumed.best_val == eng.best_val


def test_engine_eval_matches_jax_engine_on_one_checkpoint(tmp_path, monkeypatch):
    """Both Engines load the same .pt (the port's save) and score the same
    DNG SID pairs with the released protocol (center 512 crop, correction):
    PSNR within 0.01 dB and SSIM within 1e-4, inputs' metrics too.  The JAX
    Engine starts from any params (they are replaced by the checkpoint)
    instead of Flax's ~25 s eager init."""
    def init_state(model, key, sample_shape, lr=1e-4, beta1=0.9, weight_decay=0.0):
        params = jax.tree_util.tree_map(jnp.asarray,
                                        state_dict_to_flax(_model(width=model.base_width)
                                                           .state_dict()))
        tx = jax_make_optimizer(lr, beta1, weight_decay)
        return JaxTrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
                             tx=tx)

    monkeypatch.setattr(jax_engine_mod, "create_train_state", init_state)
    path = Engine(_cfg(tmp_path, "src", seed=11)).save(label="latest")
    pairs = [("00001_00_0.1s.ARW", "00001_00_10s.ARW", 100),
             ("00002_00_0.033s.ARW", "00002_00_10s.ARW", 300)]
    root = _sid_tree(str(tmp_path / "sid"), pairs, (1040, 1040), ext=".ARW")
    fns = [p[:2] for p in pairs]
    ours = Engine(_cfg(tmp_path, "e", model_path=path))
    ref = jax_engine_mod.Engine(JaxConfig(name="e", checkpoints_dir=str(tmp_path / "jck"),
                                          model_path=path, base_width=4, mesh_data=1,
                                          no_log=True, no_verbose=True, async_ckpt=False))
    got = ours.eval(Loader(SIDDataset(root, fns, augment=False, memorize=False), batch_size=1,
                           num_workers=0), "sid", correct=True, crop=True)
    want = ref.eval(JaxLoader(JaxSIDDataset(root, fns, augment=False, memorize=False),
                              batch_size=1, num_workers=0), "sid", correct=True, crop=True)
    for k in ("PSNR", "PSNR_in"):
        assert abs(got[k] - want[k]) <= 0.01, k
    for k in ("SSIM", "SSIM_in"):
        assert abs(got[k] - want[k]) <= 1e-4, k


def test_unported_eval_options_raise_and_test_writes_previews(tmp_path):
    """Multi-device options raise naming their queue item; Engine.test
    previews a raw output as packed RGBG, or in sRGB through the ISP when
    the item carries a white balance."""
    for kw in ({"mesh_spatial": 2}, {"multihost": True}):
        with pytest.raises(NotImplementedError, match="queue 1 #13"):
            Engine(_cfg(tmp_path, "u", **kw))
    eng = Engine(_cfg(tmp_path, "t"))
    items = [{"input": onp.random.default_rng(9).random((32, 32, 4), dtype=onp.float32),
              "fn": "a.npz"}]
    eng.test(items, savedir=str(tmp_path / "png"))
    assert os.listdir(tmp_path / "png" / "a") == ["t.png"]
    eng.test([dict(items[0], fn="b.npz", wb=onp.array([2.0, 1.0, 1.5, 1.0]), ccm=onp.eye(3))],
             savedir=str(tmp_path / "png"))
    from eld_tpu_torch.utils.images import load_png

    assert load_png(str(tmp_path / "png" / "b" / "t.png")).shape == (32, 32, 3)


# ---- the entry points ----------------------------------------------------

def test_test_sid_cli_on_cpu(tmp_path):
    """--pairs over rawpacks, --model_path and --savedir: one bucket per
    ratio, finite metrics, the reference's PNG names; the pair-file parser
    equals eld_tpu's, errors included."""
    pairs = [("00001_00_0.1s.npz", "00001_00_10s.npz", 100),
             ("00001_00_0.033s.npz", "00001_00_10s.npz", 300)]
    root = _sid_tree(str(tmp_path / "sid"), pairs, (1030, 1040))
    pairs_file = tmp_path / "pairs.txt"
    pairs_file.write_text("# short long ratio\n\n" + "".join(f"{a} {b} {r}\n"
                                                             for a, b, r in pairs))
    assert test_sid.parse_pairs_file(str(pairs_file)) == jax_parse_pairs_file(str(pairs_file))
    path = Engine(_cfg(tmp_path, "src")).save(label="latest")
    results = test_sid.main(["--datadir", root, "--pairs", str(pairs_file),
                             "--savedir", str(tmp_path / "png"), "--model_path", path,
                             "--device", "cpu", "--base_width", "4", "--no-verbose",
                             "--no-log", "--checkpoints_dir", str(tmp_path / "ck")])
    assert sorted(results) == [100, 300]
    assert all(onp.isfinite(v) for r in results.values() for v in r.values())
    names = sorted(os.listdir(tmp_path / "png" / "00001_00_0.1s"))
    assert names[0].startswith("eld_model_") and names[1].startswith("m_input_")
    assert names[2] == "t_label.png"
    bad = tmp_path / "bad.txt"
    bad.write_text("a b\n")
    with pytest.raises(SystemExit, match="bad.txt:1"):
        test_sid.parse_pairs_file(str(bad))


def test_test_eld_cli_full_frame_chop_on_cpu(tmp_path):
    """One camera, one scene, both levels, full frames through the 4-tile
    chop (crop=False), resuming the run's latest checkpoint."""
    root = _eld_tree(str(tmp_path / "eld"), "SonyA7S2", ".npz", (1,), (160, 200))
    Engine(_cfg(tmp_path, "run")).save(label="latest")
    results = test_eld.main(["--datadir", root, "--include", "4", "--suffix", ".npz",
                             "--scenes", "1", "--chop", "--name", "run",
                             "--checkpoints_dir", str(tmp_path / "ck"), "--device", "cpu",
                             "--base_width", "4", "--no-verbose", "--no-log"])
    assert sorted(results) == [("SonyA7S2", "x100"), ("SonyA7S2", "x200")]
    assert all(onp.isfinite(v) for r in results.values() for v in r.values())
