"""The port's ISP and EMoR (eld_tpu_torch.core) against eld_tpu.core, and
the noise model at three channels (the sRGB training stage's K1 input).

Tolerances: values before an 8-bit quantization within 1e-6 (f32 rounding
of the same operations; XLA may fuse a multiply and an add); 8-bit outputs
equal except at most 0.1% of values, which may differ by exactly 1/255 (a
value within an ulp of a code boundary truncates to either side); the EMoR
host code exactly; the noise chain at C = 3 fed JAX's own draws exactly
(1e-6 under the Tukey-lambda component).
"""

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.core import emor as jax_emor
from eld_tpu.core import isp as jax_isp
from eld_tpu.noise import load_camera_params as jax_bank
from eld_tpu.noise import sample_params_batch as jax_sample
from eld_tpu.noise.model import apply_noise as jax_apply_noise
from eld_tpu_torch.core import emor, isp
from eld_tpu_torch.noise.model import noise_core
from tests.test_torch_noise import jax_draws, to_torch_params


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, shape=(2, 40, 48)):
    rng = onp.random.default_rng(seed)
    raw = rng.random(shape + (4,), dtype=onp.float32)
    wb = rng.uniform(1.0, 2.5, (shape[0], 4)).astype(onp.float32)
    wb[:, 1] = 1.0
    ccm = (onp.eye(3) + rng.normal(0, 0.2, (shape[0], 3, 3))).astype(onp.float32)
    return raw, wb, ccm


def assert_8bit_close(got, ref):
    """Equal codes except <= 0.1% of values, which differ by exactly one."""
    codes = onp.rint(onp.asarray(got, onp.float64) * 255) - onp.rint(onp.asarray(ref) * 255)
    assert onp.abs(codes).max() <= 1
    assert (codes != 0).mean() <= 1e-3
    onp.testing.assert_allclose(got * 255, onp.rint(got * 255), atol=1e-3)  # on the code grid


# ---- the stages before quantization --------------------------------------

@pytest.mark.parametrize("stage", ["gains", "binning", "ccm", "crf_interp"])
def test_isp_stages_equal_jax_before_quantization(stage):
    raw, wb, ccm = _inputs()
    rgb = onp.clip(raw[..., :3] * 1.2 - 0.1, 0, 1)
    if stage == "gains":
        ref = jax_isp.apply_gains(jnp.asarray(raw), jnp.asarray(wb))
        got = isp.apply_gains(torch.from_numpy(raw), torch.from_numpy(wb))
    elif stage == "binning":
        ref = jax_isp.binning(jnp.asarray(raw))
        got = isp.binning(torch.from_numpy(raw))
    elif stage == "ccm":
        ref = jax_isp.apply_ccms(jnp.asarray(rgb), jnp.asarray(ccm))
        got = isp.apply_ccms(torch.from_numpy(rgb), torch.from_numpy(ccm))
    else:
        # inside the grid, on its knots, and outside it on both sides
        E, fs = emor.load_crf()
        x = onp.concatenate([rgb.ravel(), E[0, :64], [-0.5, 1.5, E[0, -1]]]).astype(onp.float32)
        ref = onp.stack([jnp.interp(jnp.asarray(x), jnp.asarray(E[c]), jnp.asarray(fs[c]))
                         for c in range(3)])
        got = torch.stack([isp.interp(torch.from_numpy(x), torch.from_numpy(E[c]),
                                      torch.from_numpy(fs[c])) for c in range(3)])
        onp.testing.assert_array_equal(got.numpy()[:, -3:-1], fs[:, [0, -1]])
    assert got.shape == ref.shape
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), rtol=0, atol=1e-6)


def test_quantization_truncates():
    """Both 8-bit points truncate toward zero (torch's .int()), never round."""
    x = torch.tensor([0.0, 0.999 / 255, 1.999 / 255, 254.99 / 255, 1.0, 1.5, -0.2])
    onp.testing.assert_array_equal(isp.quantize_8bit(x).numpy() * 255,
                                   [0, 0, 1, 254, 255, 255, 0])
    onp.testing.assert_array_equal(isp.quantize_8bit(x).numpy(),
                                   onp.asarray(jax_isp.quantize_8bit(jnp.asarray(x.numpy()))))


# ---- whole pipelines (8-bit outputs) -------------------------------------

@pytest.mark.parametrize("render", ["gamma", "crf"])
def test_process_equals_jax(render):
    raw, wb, ccm = _inputs(1, (3, 64, 96))
    crf = emor.load_crf() if render == "crf" else None
    ref = jax_isp.process(jnp.asarray(raw), jnp.asarray(wb), jnp.asarray(ccm),
                          crf=None if crf is None else tuple(map(jnp.asarray, crf)))
    got = isp.process(torch.from_numpy(raw), torch.from_numpy(wb), torch.from_numpy(ccm),
                      crf=crf)
    assert got.shape == (3, 64, 96, 3)
    assert_8bit_close(got.numpy(), onp.asarray(ref))


@pytest.mark.parametrize("render", ["gamma", "crf"])
def test_raw2rgb_equals_jax(render):
    """One image, a raw (un-normalized) wb and a 4x4 ccm as raw files give
    them: wb / wb[1], the ccm's top-left 3x3."""
    raw, _, _ = _inputs(2, (1, 32, 40))
    wb = onp.array([2100.0, 1024.0, 1500.0, 1024.0], onp.float32)
    ccm = onp.eye(4, dtype=onp.float32)
    ccm[:3, :3] += onp.random.default_rng(3).normal(0, 0.2, (3, 3)).astype(onp.float32)
    crf = emor.load_crf() if render == "crf" else None
    ref = jax_isp.raw2rgb(jnp.asarray(raw[0]), wb, ccm, crf=crf)
    got = isp.raw2rgb(torch.from_numpy(raw[0]), wb, ccm, crf=crf)
    assert_8bit_close(got.numpy(), onp.asarray(ref))


# ---- EMoR ----------------------------------------------------------------

def test_emor_equals_jax(tmp_path):
    for a, b in zip(emor.read_emor(), jax_emor.read_emor()):
        assert a.dtype == b.dtype
        onp.testing.assert_array_equal(a, b)
    for a, b in zip(emor.load_crf(), jax_emor.load_crf()):
        onp.testing.assert_array_equal(a, b)
    rng = onp.random.default_rng(4)
    x = onp.sort(rng.random(300)).astype(onp.float32)
    y = onp.clip(x ** 0.45 + rng.normal(0, 0.01, 300), 0, 1).astype(onp.float32)
    for a, b in zip(emor.fit_emor_coeffs(x, y, 5), jax_emor.fit_emor_coeffs(x, y, 5)):
        onp.testing.assert_array_equal(a, b)
    E, fs = emor.load_crf()
    fs = fs.copy()
    fs[1, 500:510] = fs[1, 499]  # a flat stretch and a dip: made monotone
    fs[2, 700] = 0.0
    for (b1, e1), (b2, e2) in zip(emor.invert_crf(E, fs), jax_emor.invert_crf(E, fs)):
        onp.testing.assert_array_equal(b1, b2)
        onp.testing.assert_array_equal(e1, e2)
    dorf = tmp_path / "dorf.txt"
    dorf.write_text("".join(f"curve{i}\ngraph\nI =\n0 0.5 1\nB =\n0 {0.6 + i / 10} 1\n"
                            for i in range(2)))
    ours, ref = emor.read_dorf(str(dorf)), jax_emor.read_dorf(str(dorf))
    assert ours[0] == ref[0] == ["curve0", "curve1"]
    for a, b in zip(ours[1] + ours[2], ref[1] + ref[2]):
        onp.testing.assert_array_equal(a, b)


# ---- the noise model at C = 3 ---------------------------------------------

@pytest.fixture(scope="module")
def sony_params():
    return jax_sample(jax.random.PRNGKey(5), jax_bank(include=4), 2)


@pytest.mark.parametrize("model", ["eld", "Pgrqc", "r", "c"])
def test_noise_core_c3_equals_jax_on_jax_draws(sony_params, model):
    """noise_core at C = 3 (sRGB patches) fed JAX's own draws equals
    eld_tpu's apply_noise: one row draw per packed row (the even one) on
    every channel, and no color bias.  Exactly, except under 'G' (in
    "eld"), whose Tukey-lambda powf XLA rounds an ulp apart on ~1% of
    elements: within 1e-6 there."""
    jp = sony_params
    clean = onp.random.default_rng(6).random((2, 24, 32, 3), dtype=onp.float32)
    key = jax.random.PRNGKey(8)
    keys = jax.random.split(key, 2)
    ref = onp.stack([
        onp.asarray(jax_apply_noise(keys[i], jnp.asarray(clean[i]),
                                    jax.tree_util.tree_map(lambda x: x[i], jp), model))
        for i in range(2)])
    draws = jax_draws(key, clean.shape, model)
    got = noise_core(torch.from_numpy(clean), to_torch_params(jp), model, draws).numpy()
    onp.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 if model == "eld" else 0)
    if model == "r":
        e = got - clean
        rows = draws["row_n"].numpy()[..., 0] * onp.asarray(jp.R_scale)[:, None]
        want = rows * onp.asarray(jp.ratio / jp.saturation_level)[:, None]
        onp.testing.assert_allclose(e, onp.broadcast_to(want[:, :, None, None], e.shape),
                                    atol=1e-6)
    if model == "c":
        onp.testing.assert_allclose(got, clean, atol=1e-6)
