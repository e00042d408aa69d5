"""The port's pooled trainer (make_train_scan, Engine.train_pool, the
--scan auto default of train_syn) against eld_tpu and against the port's
own per-step train step.

Exact where the arithmetic is the same: the augmentation given the masks
JAX draws, and K pooled steps against K per-step calls on the batches the
pool gave (the same torch operations in the same order, on one thread).
"""

import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.train.steps import _augment_batch as jax_augment_batch
from eld_tpu_torch.config import Config
from eld_tpu_torch.data.loader import pool_to_device
from eld_tpu_torch.data.pairs import eval_pairs_by_ratio
from eld_tpu_torch.data.patchstore import PatchStore, PatchStoreWriter
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.tools import train_syn
from eld_tpu_torch.train.checkpoints import wait_for_saves
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.state import create_train_state
from eld_tpu_torch.train.steps import (
    augment_batch,
    augment_masks,
    fold_in,
    make_train_scan,
    make_train_step,
    pick_batch,
)
from tests.tiff_fixture import make_dng


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unet(seed=0, width=4):
    torch.manual_seed(seed)
    return build_arch("unet", 4, 4, base_width=width, skip_mode="split")


def _u16(shape, seed):
    return onp.random.default_rng(seed).integers(0, 65535, shape, dtype=onp.uint16)


def _store(path, records):
    with PatchStoreWriter(path, records.shape[1:], records.dtype) as w:
        for r in records:
            w.append(r)
    return PatchStore(path)


# ---- augmentation and picks ----------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 8, 4), (8, 8, 6, 4)], ids=["square", "nonsquare"])
def test_augment_batch_equals_jax_given_its_masks(shape):
    """Fed the three masks eld_tpu's _augment_batch draws from its key, the
    port's augment_batch gives exactly its output for two joint arrays; the
    transpose applies to square patches only."""
    rng = onp.random.default_rng(0)
    x, y = rng.random(shape, dtype=onp.float32), rng.random(shape, dtype=onp.float32)
    key = jax.random.PRNGKey(3)
    ref = jax_augment_batch(key, jnp.asarray(x), jnp.asarray(y))
    masks = [torch.from_numpy(onp.array(jax.random.bernoulli(k, shape=(shape[0], 1, 1, 1)))
                              .reshape(-1)) for k in jax.random.split(key, 3)]
    assert all(0 < int(m.sum()) < shape[0] for m in masks)  # both outcomes occur
    got = augment_batch([torch.from_numpy(x), torch.from_numpy(y)], *masks)
    for a, b in zip(got, ref):
        assert a.is_contiguous()
        onp.testing.assert_array_equal(a.numpy(), onp.asarray(b))


def test_paired_picks_stay_aligned():
    """Paired pools share one set of pick indices and one set of masks: from
    two copies of one pool the input and target batches are equal; each row
    is an augmented pool record; picks differ across step seeds; masks are
    fair coins."""
    recs = _u16((6, 8, 8, 4), 1)
    pool = {"input": torch.from_numpy(recs), "target": torch.from_numpy(recs.copy())}
    candidates = []
    for r in recs.astype(onp.float32) * onp.float32(1.0 / 65535.0):
        for a in (r, r[::-1]):
            for b in (a, a[:, ::-1]):
                candidates += [b, b.transpose(1, 0, 2)]
    picked = []
    for seed in range(4):
        b = pick_batch(pool, 5, fold_in(7, seed))
        assert b["input"].dtype == torch.float32 and b["input"].shape == (5, 8, 8, 4)
        assert torch.equal(b["input"], b["target"])
        for row in b["input"].numpy():
            assert any(onp.array_equal(row, c) for c in candidates)
        picked.append(b["input"])
    assert not torch.equal(picked[0], picked[1])
    m = torch.stack(augment_masks(torch.Generator().manual_seed(0), 4000)).float().mean(1)
    assert bool(((m - 0.5).abs() < 0.03).all())


@pytest.mark.parametrize("paired", [False, True], ids=["synthetic", "paired"])
def test_scan_steps_equal_train_steps_on_the_batches_it_picked(paired):
    """make_train_scan's K steps are exactly K calls of make_train_step on
    the batches pick_batch gives for the same step seeds: same losses, same
    parameters, same step count."""
    bank = load_camera_params(include=4)
    if paired:
        pool = {"input": torch.from_numpy(_u16((5, 16, 16, 4), 2)),
                "target": torch.from_numpy(_u16((5, 16, 16, 4), 3))}
        kw = {}
    else:
        pool = {"clean": torch.from_numpy(_u16((5, 16, 16, 4), 2))}
        kw = dict(noise_model="eld", bank=bank)
    seeds = [fold_in(2018, i) for i in range(3)]
    scan_model, step_model = _unet(), _unet()
    scan_state, step_state = create_train_state(scan_model), create_train_state(step_model)
    m = make_train_scan(scan_model, batch=2, steps_per_call=3, **kw)(scan_state, pool, seeds)
    step = make_train_step(step_model, **kw)
    losses = [float(step(step_state, pick_batch(pool, 2, s), s)["Pixel"]) for s in seeds]
    assert float(m["PixelLast"]) == losses[-1]
    onp.testing.assert_allclose(float(m["Pixel"]), onp.mean(losses), rtol=1e-6)
    assert scan_state.step == step_state.step == 3
    for (name, a), b in zip(scan_model.state_dict().items(), step_model.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError):
        make_train_scan(scan_model, batch=2, steps_per_call=3, **kw)(scan_state, pool, seeds[:2])


# ---- the Engine and the CLI ------------------------------------------------

def _engine(tmp_path, **kw):
    base = dict(device="cpu", noise="eld", include=4, base_width=4, batch_size=2,
                is_train=True, save_epoch_freq=1, checkpoints_dir=str(tmp_path), name="p",
                no_verbose=True)
    base.update(kw)
    return Engine(Config(**base))


def test_train_pool_launch_split_counters_and_saves(tmp_path):
    """7 steps at K = 3 run as calls of 3, 3 and 1 (one scan function per
    (K, batch), reused across epochs); counters advance, metrics are read
    per call, and the epoch saves the numbered and the latest checkpoint.
    Step seeds do not depend on K: one call of 7 from the same start gives
    the same parameters."""
    pool = {"clean": pool_to_device(_store(str(tmp_path / "s"), _u16((6, 16, 16, 4), 4)),
                                    "cpu")}
    eng = _engine(tmp_path)
    eng.train_pool(pool, steps=7, steps_per_call=3)
    assert (eng.epoch, eng.iterations) == (1, 7)
    assert [h[0] for h in eng.history] == [3, 6, 7]
    assert all(set(h[1]) == {"Pixel", "PixelLast"} for h in eng.history)
    assert sorted(eng._train_scans) == [(1, 2), (3, 2)]
    wait_for_saves()
    assert {"model_001_00000007.pt", "model_latest.pt"} <= set(os.listdir(eng.cfg.save_dir))
    fns = dict(eng._train_scans)
    eng.train_pool(pool, steps=7, steps_per_call=3)
    assert (eng.epoch, eng.iterations) == (2, 14) and eng._train_scans == fns

    one = _engine(tmp_path, name="q", no_log=True)
    one.train_pool(pool, steps=7, steps_per_call=7)
    ref = _engine(tmp_path, name="r", no_log=True)
    ref.train_pool(pool, steps=7, steps_per_call=3)
    for (name, a), b in zip(one.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_pool_to_device_keeps_the_stored_records(tmp_path):
    recs = _u16((5, 8, 4, 4), 5)
    store = _store(str(tmp_path / "s"), recs)
    pool = pool_to_device(store, "cpu")
    assert pool.dtype == torch.uint16 and pool.shape == (5, 8, 4, 4)
    onp.testing.assert_array_equal(pool.numpy(), recs)


def test_scan_auto_budget():
    """--scan -1 resolves to 10 when the uint16 pool fits half the device's
    memory: the SID clean set (1288 x 512^2 x 4 x 2 B = 2.70 GB) on an
    80 GB card; the per-step loader when it does not; sRGB stages and an
    explicit K are kept apart."""
    sid_pool = 1288 * 512 * 512 * 4 * 2
    assert sid_pool == 2_701_131_776
    h100 = 80 * 2**30
    assert train_syn.pool_budget_bytes(h100) == 40 * 2**30
    assert train_syn.resolve_scan(-1, sid_pool, train_syn.pool_budget_bytes(h100), False) == 10
    assert train_syn.resolve_scan(-1, sid_pool, train_syn.pool_budget_bytes(4 * 2**30),
                                  False) == 0
    assert train_syn.resolve_scan(-1, 1, train_syn.pool_budget_bytes(h100), True) == 0
    assert train_syn.resolve_scan(0, 1, h100, False) == 0
    assert train_syn.resolve_scan(5, 10 * h100, h100, False) == 5
    assert train_syn.device_memory_bytes("cpu") > 0


def _sid_eval_tree(root, pairs, size=1024):
    """The files of ``pairs`` ({ratio: [(short, long)]}) as DNG bytes under
    their .ARW names (the native decoder reads the TIFF container whatever
    the extension); the smallest mosaic whose packed frame takes the 512
    crop."""
    rng = onp.random.default_rng(8)
    gt = rng.integers(2048, 16384, (size, size)).astype(onp.uint16)
    dark = (512 + (gt.astype(onp.float32) - 512) / 100).astype(onp.uint16)
    long_bytes = make_dng(gt, iso=100, exposure=10)
    short_bytes = make_dng(dark, iso=100, exposure=0.1)
    os.makedirs(os.path.join(root, "short"))
    os.makedirs(os.path.join(root, "long"))
    for ratio_pairs in pairs.values():
        for short, long_ in ratio_pairs:
            with open(os.path.join(root, "long", long_), "wb") as f:
                f.write(long_bytes)
            with open(os.path.join(root, "short", short), "wb") as f:
                f.write(short_bytes)
    return root


def test_train_syn_defaults_to_the_pooled_trainer_with_periodic_eval(tmp_path, capsys,
                                                                     monkeypatch):
    """With no --scan, train_syn pools the store (K = 10) and runs the SID
    indoor-15 ratio-100 and ratio-300 eval every --eval_every epochs (cut
    to the first pair of each ratio here, for time); with the eval files
    missing it says so and trains on."""
    pairs = {r: p[:1] for r, p in eval_pairs_by_ratio().items()}
    monkeypatch.setattr(train_syn, "eval_pairs_by_ratio", lambda: pairs)
    _store(str(tmp_path / "SID_Sony_Raw.eps"), _u16((8, 32, 32, 4), 6))
    evaldir = _sid_eval_tree(str(tmp_path / "sid"), pairs)
    argv = ["--traindir", str(tmp_path), "--checkpoints_dir", str(tmp_path / "ck"),
            "--device", "cpu", "--noise", "eld", "--include", "4", "--base_width", "4",
            "-b", "2", "--no-log", "--no-verbose", "--nThreads", "0"]
    eng = train_syn.main(argv + ["--evaldir", evaldir, "--epochs", "2", "--eval_every", "2"])
    assert eng.iterations == 8 and [h[0] for h in eng.history] == [4, 8]
    # K resolved to 10; an epoch of 4 steps is one remainder call of 4
    assert sorted(eng._train_scans) == [(4, 2)]
    assert "scan x10" in capsys.readouterr().out
    assert [(e, name) for e, name, _ in eng.eval_history] == [(2, "sid_eval_100"),
                                                               (2, "sid_eval_300")]
    for _, _, res in eng.eval_history:
        assert set(res) == {"PSNR", "SSIM", "PSNR_in", "SSIM_in"}
        assert all(onp.isfinite(v) for v in res.values())
    eng = train_syn.main(argv + ["--evaldir", str(tmp_path / "nowhere"), "--epochs", "1",
                                 "--eval_every", "1"])
    assert eng.eval_history == [] and eng.iterations == 4
    assert "[i] eval datasets unavailable" in capsys.readouterr().err
