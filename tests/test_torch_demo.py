"""The port's synthetic demo (eld_tpu_torch.tools.demo_synthetic), its
``apply_noise`` and the pooled trainer's ``augment`` switch, against
eld_tpu's.

* ``make_scenes`` is byte-equal to eld_tpu's for the same seed, and the
  card's ``make_scenes_device`` has its distribution;
* ``calibrated_params`` agrees within 1e-6 relative;
* ``apply_noise``'s core equals eld_tpu's ``apply_noise`` given JAX's own
  draws (exact up to f32 rounding, atol 1e-5), and its moments agree with
  JAX's for ``poisson="fast"`` and ``"exact"``;
* ``make_train_scan(augment=False)`` is K train steps on the same picks;
* a tiny CPU run emits eld_tpu's JSON keys, and its held-out noisy PSNRs
  lie within 0.3 dB of eld_tpu's (the same scenes, other noise bits);
* the argument guards refuse where eld_tpu's do.
"""

import types

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.noise import load_camera_params as jax_bank
from eld_tpu.noise.model import apply_noise as jax_apply_noise
from eld_tpu.noise.model import expand_model
from eld_tpu.tools import demo_synthetic as jax_demo
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.model import apply_noise, noise_core
from eld_tpu_torch.noise.params import NoiseParams, load_camera_params
from eld_tpu_torch.tools import demo_synthetic as demo
from eld_tpu_torch.train.state import create_train_state
from eld_tpu_torch.train.steps import fold_in, make_train_scan, make_train_step, pick_batch
from tests.test_torch_noise import FIELDS, to_torch_params

TINY = ["--size", "64", "--n_train", "8", "--batch", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- scenes and parameters -------------------------------------------------

def test_make_scenes_is_byte_equal_to_jax():
    got = demo.make_scenes(onp.random.default_rng(3), 3, 48)
    want = jax_demo.make_scenes(onp.random.default_rng(3), 3, 48)
    assert got.dtype == want.dtype == onp.float32
    assert got.tobytes() == want.tobytes()


def test_make_scenes_device_has_the_scene_distribution():
    """The generator path draws the same family: per-channel means within
    0.03 and spreads within 15% of the NumPy path's over 64 scenes (the
    per-scene means vary with a standard deviation of ~0.1), in range, and
    the chunks cover every scene whatever ``chunk`` divides."""
    gen = torch.Generator().manual_seed(0)
    dev = demo.make_scenes_device(gen, 64, 32, chunk=24).numpy()
    ref = demo.make_scenes(onp.random.default_rng(0), 64, 32)
    assert dev.shape == ref.shape and dev.dtype == onp.float32
    assert dev.min() >= 0.02 and dev.max() <= 0.98
    onp.testing.assert_allclose(dev.mean(axis=(0, 1, 2)), ref.mean(axis=(0, 1, 2)), atol=0.03)
    onp.testing.assert_allclose(dev.std(axis=(0, 1, 2)), ref.std(axis=(0, 1, 2)), rtol=0.15)
    assert len({dev[i].tobytes() for i in range(64)}) == 64


@pytest.mark.parametrize("ratio", [100, 300])
def test_calibrated_params_match_jax(ratio):
    want = jax_demo.calibrated_params(jax_bank(include=4), ratio)
    got = demo.calibrated_params(load_camera_params(include=4), ratio)
    for f in FIELDS:
        onp.testing.assert_allclose(onp.asarray(getattr(got, f)), onp.asarray(getattr(want, f)),
                                    rtol=1e-6, err_msg=f)


# ---- apply_noise -------------------------------------------------------------

def _one_image_params():
    p = jax_demo.calibrated_params(jax_bank(include=4), 200)
    return p, to_torch_params(p)


def _apply_noise_draws(key, img_shape, model):
    """The draws eld_tpu's apply_noise makes from ``key`` for one image, in
    noise_core's layout (a batch of one): the (shot, read, tl, row, quant)
    split of model.py:66, fast_poisson's (u, n) split of the shot key."""
    k_shot, k_read, k_tl, k_row, k_quant = jax.random.split(key, 5)
    k_u, k_n = jax.random.split(k_shot)
    draws = {
        "poisson_u": jax.random.uniform(k_u, img_shape, minval=1e-12, maxval=1.0),
        "shot_n": jax.random.normal(k_n if "P" in expand_model(model) else k_shot, img_shape),
        "read_n": jax.random.normal(k_read, img_shape),
        "tukey_u": jax.random.uniform(k_tl, img_shape, minval=1e-7, maxval=1.0 - 1e-7),
        "row_n": jax.random.normal(k_row, (img_shape[0], 1, 2))[:, 0, :],
        "quant_u": jax.random.uniform(k_quant, img_shape, minval=-0.5, maxval=0.5),
    }
    return {k: torch.from_numpy(onp.array(v)[None]) for k, v in draws.items()}


@pytest.mark.parametrize("model", ["eld", "PGrqc", "PGrq"])
def test_apply_noise_core_equals_jax_on_jax_draws(model):
    """The noise chain apply_noise runs (noise_core on one image) fed the
    draws eld_tpu's apply_noise makes from its key equals eld_tpu's output,
    unclipped, within atol 1e-5 (f32 rounding of the same operations; a
    Poisson count flip would break it)."""
    clean = onp.random.default_rng(1).random((32, 24, 4), dtype=onp.float32)
    jp, tp = _one_image_params()
    key = jax.random.PRNGKey(11)
    want = onp.asarray(jax_apply_noise(key, jnp.asarray(clean), jp, model))
    one = NoiseParams(**{f: getattr(tp, f).reshape(1, -1) for f in FIELDS})
    got = noise_core(torch.from_numpy(clean)[None], one, model,
                     _apply_noise_draws(key, clean.shape, model))[0].numpy()
    onp.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("poisson", ["fast", "exact"])
@pytest.mark.parametrize("model", ["PGrq", "eld"])
def test_apply_noise_moments_match_jax(model, poisson):
    """The noise apply_noise adds against eld_tpu's on one 128x128x4 image
    (65k elements): means within 6 standard errors plus the row term, and
    standard deviations within 5%."""
    clean = 0.1 + 0.3 * onp.random.default_rng(2).random((128, 128, 4), dtype=onp.float32)
    jp, tp = _one_image_params()
    want = onp.asarray(jax_apply_noise(jax.random.PRNGKey(3), jnp.asarray(clean), jp, model,
                                       poisson=poisson)) - clean
    got = (apply_noise(torch.Generator().manual_seed(3), torch.from_numpy(clean), tp, model,
                       poisson=poisson).numpy() - clean)
    row = 6 * float(jp.R_scale * jp.ratio / jp.saturation_level) / onp.sqrt(2 * 128)
    se = 6 * want.std() / onp.sqrt(want.size) + row
    assert abs(got.mean() - want.mean()) < se
    assert abs(got.std() / want.std() - 1.0) < 0.05


def test_apply_noise_is_unclipped():
    _, tp = _one_image_params()
    ones = torch.ones(64, 64, 4)
    out = apply_noise(torch.Generator().manual_seed(0), ones, tp, "eld")
    assert out.shape == ones.shape and float(out.max()) > 1.0


# ---- make_train_scan(augment=False) ---------------------------------------------

def test_train_scan_without_augment_is_k_steps_on_the_same_picks():
    """K steps of make_train_scan(augment=False) equal K make_train_step
    steps fed pick_batch(..., augment=False) under the same seeds: the
    same losses and parameters (the same operations in the same order)."""
    bank = load_camera_params(include=4)
    pool = {"clean": torch.from_numpy(demo.make_scenes(onp.random.default_rng(4), 6, 32))}
    seeds = [fold_in(9, i) for i in range(3)]

    def model():
        torch.manual_seed(0)
        return build_arch("unet", 4, 4, base_width=4)

    scan_state = create_train_state(model())
    out = make_train_scan(scan_state.model, noise_model="eld", bank=bank, batch=2,
                          steps_per_call=3, augment=False)(scan_state, pool, seeds)
    step_state = create_train_state(model())
    step = make_train_step(step_state.model, noise_model="eld", bank=bank)
    losses = [float(step(step_state, pick_batch(pool, 2, s, augment=False), s)["Pixel"])
              for s in seeds]
    assert float(out["Pixel"]) == pytest.approx(onp.mean(losses), rel=1e-6)
    assert float(out["PixelLast"]) == losses[-1]
    for a, b in zip(scan_state.model.parameters(), step_state.model.parameters()):
        assert torch.equal(a, b)
    # the picks are the augmenting path's (fold_in(seed, 2)), without its flips
    idx = torch.randint(0, 6, (2,), generator=torch.Generator().manual_seed(fold_in(seeds[0], 2)))
    assert torch.equal(pick_batch(pool, 2, seeds[0], augment=False)["clean"], pool["clean"][idx])


# ---- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_record():
    """eld_tpu's record at the tiny size with --ratio_sweep and no steps, its
    U-Net replaced by the identity (the keys and the held-out noise do not
    depend on the network)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_demo, "build_arch", lambda *a, **k: types.SimpleNamespace(
        apply=lambda variables, x: x))
    mp.setattr(jax_demo, "create_train_state",
               lambda *a, **k: types.SimpleNamespace(params={}))
    try:
        yield jax_demo.main(["--size", "64", "--n_train", "8", "--batch", "2", "--steps", "0",
                             "--ratio_sweep"])
    finally:
        mp.undo()


@pytest.mark.parametrize("extra", [[], ["--scan", "2"], ["--sample", "perm", "--ratio_sweep"]],
                         ids=["pick", "scan", "perm_sweep"])
def test_tiny_run_emits_jax_keys(jax_record, extra):
    rec = demo.main(TINY + ["--steps", "4"] + extra)
    want = set(jax_record)
    if "--ratio_sweep" not in extra:
        want = {k for k in want if not k.startswith(("x100", "x200", "x300"))}
    assert set(rec) == want | {"graph_replays"}
    assert rec["graph_replays"] == {"train": 0, "eval": 0}  # CUDA graphs only on a card
    assert rec["steps"] == 4 and rec["scan"] == (2 if "--scan" in extra else 0)
    assert onp.isfinite(rec["final_loss"]) and rec["train_patches_per_sec"] > 0
    # the same held-out scenes under other noise bits
    for k in want:
        if k.endswith("noisy_psnr"):
            assert abs(rec[k] - jax_record[k]) < 0.3, k


@pytest.mark.parametrize("argv", [
    ["--scan", "4", "--lr_decay", "--steps", "10"],
    ["--scan", "2", "--sample", "perm"],
    ["--sample", "perm", "--batch", "3", "--n_train", "8"],
], ids=["lr_decay_unaligned", "perm_with_scan", "perm_batch"])
def test_guards_refuse_where_jax_does(argv):
    with pytest.raises(SystemExit) as ours:
        demo.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jax_demo.main(argv)
    assert str(ours.value) == str(theirs.value) and str(ours.value)


def test_lr_decay_steps_at_the_boundaries(monkeypatch):
    """--lr_decay sets x0.5 at 50% and x0.1 at 90% of the steps, the same on
    the per-step and the aligned --scan path."""
    seen = []
    real = demo.set_learning_rate
    monkeypatch.setattr(demo, "set_learning_rate",
                        lambda state, lr: seen.append(lr) or real(state, lr))
    base = TINY + ["--size", "32", "--steps", "10", "--lr_decay", "--lr", "1e-3"]
    demo.main(base)
    demo.main(base + ["--scan", "1"])
    assert seen == pytest.approx([5e-4, 1e-4, 5e-4, 1e-4])
