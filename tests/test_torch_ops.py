"""The port's demosaic, CFA unpackers, video metrics, steerable band,
ST-RRED and the small model/noise utilities, against eld_tpu's, on inputs
made from a seed with NumPy.

Tolerances: the demosaics, renders and unpackers within 1e-5 absolute
(f32 stencil sums in another order); ``raw2gray``, ``compare_ncc``,
``local_error`` and the video PSNR/SSIM within 1e-5 relative; the
steerable band within 1e-4 absolute (two FFT libraries); STRRED within
1e-3 relative on eld_tpu's own test clip (a GSM fit over 20 blocks per
frame pair).  STRREDSN, a difference of two field means, cancels to a
small number and is held within 2e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.core import demosaic as jax_demosaic
from eld_tpu.core import packing as jax_packing
from eld_tpu.models import losses as jax_losses
from eld_tpu.models import netutils as jax_netutils
from eld_tpu.noise import params as jax_params
from eld_tpu.ops import metrics as jax_metrics
from eld_tpu.ops import steerable as jax_steerable
from eld_tpu.ops import strred as jax_strred
from eld_tpu_torch.core import demosaic, packing
from eld_tpu_torch.core.emor import load_crf
from eld_tpu_torch.models import build_arch, losses, netutils
from eld_tpu_torch.noise import params
from eld_tpu_torch.ops import metrics, steerable, strred

OFFSETS = [((0, 0), (0, 1), (1, 1), (1, 0)), ((1, 1), (1, 0), (0, 0), (0, 1)),
           ((0, 1), (0, 0), (1, 0), (1, 1))]
WB = [2.1, 1.0, 1.6, 1.0]
CCM = [[1.6, -0.4, -0.2], [-0.2, 1.5, -0.3], [0.0, -0.5, 1.5]]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(seed=0, shape=(40, 56, 4), scale=1.0):
    return (onp.random.default_rng(seed).random(shape, dtype=onp.float32) * scale)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


# ---- CFA unpacking and demosaic ------------------------------------------------

@pytest.mark.parametrize("offsets", OFFSETS, ids=["rggb", "bggr", "grbg"])
def test_unpack_bayer_matches_jax(offsets):
    x = _packed(1)
    want = onp.asarray(jax_packing.unpack_bayer(jnp.asarray(x), xp=jnp, offsets=offsets))
    assert onp.array_equal(packing.unpack_bayer(torch.from_numpy(x), offsets=offsets).numpy(), want)
    assert onp.array_equal(packing.unpack_bayer(x, offsets=offsets), want)
    assert onp.array_equal(packing.pack_bayer(want, offsets=offsets), x)


def test_unpack_xtrans_matches_jax():
    x = _packed(2, (12, 18, 9))
    want = onp.asarray(jax_packing.unpack_xtrans(jnp.asarray(x), xp=jnp))
    assert onp.array_equal(packing.unpack_xtrans(torch.from_numpy(x)).numpy(), want)
    assert onp.array_equal(packing.unpack_xtrans(x), want)
    assert onp.array_equal(packing.pack_xtrans(want), x)


@pytest.mark.parametrize("offsets", OFFSETS, ids=["rggb", "bggr", "grbg"])
@pytest.mark.parametrize("fn", ["demosaic_bilinear", "demosaic_mhc"])
def test_demosaic_matches_jax(fn, offsets):
    x = _packed(3)
    want = onp.asarray(getattr(jax_demosaic, fn)(jnp.asarray(x), offsets=offsets))
    got = getattr(demosaic, fn)(torch.from_numpy(x), offsets=offsets).numpy()
    assert got.shape == want.shape == (80, 112, 3)
    onp.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("how", ["mhc", "bilinear"])
@pytest.mark.parametrize("crf", [False, True], ids=["gamma", "crf"])
@pytest.mark.parametrize("half_size", [True, False], ids=["half", "full"])
def test_render_preview_matches_jax(half_size, crf, how):
    x = _packed(4, scale=0.3)
    curve = load_crf() if crf else None
    want = onp.asarray(jax_demosaic.render_preview(
        jnp.asarray(x), WB, CCM, half_size=half_size, demosaic=how,
        crf=None if curve is None else tuple(jnp.asarray(c) for c in curve)))
    got = demosaic.render_preview(torch.from_numpy(x), WB, CCM, half_size=half_size,
                                  demosaic=how, crf=curve).numpy()
    onp.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- metrics ------------------------------------------------------------------

def _clip_pair(seed=5, shape=(3, 40, 48, 4)):
    rng = onp.random.default_rng(seed)
    x = rng.random(shape, dtype=onp.float32)
    y = onp.clip(x + rng.normal(0, 0.05, shape), 0, 1).astype(onp.float32)
    return x, y


def test_raw2gray_ncc_local_error_match_jax():
    x, y = _clip_pair()
    t = torch.from_numpy
    onp.testing.assert_allclose(metrics.raw2gray(t(x)).numpy(),
                                onp.asarray(jax_metrics.raw2gray(x)), rtol=1e-5)
    assert _rel(metrics.compare_ncc(t(x), t(y)), jax_metrics.compare_ncc(x, y)) < 1e-5
    for size, shift in ((8, 8), (8, 4), (5, 3)):
        assert _rel(metrics.local_error(t(x[0]), t(y[0]), size, shift),
                    jax_metrics.local_error(x[0], y[0], size, shift)) < 1e-5
    # a rescaled estimate has no local error
    assert float(metrics.local_error(t(x[0]), 2 * t(x[0]), 8, 8)) < 1e-10


@pytest.mark.parametrize("channels", [4, 3])
def test_quality_assess_video_matches_jax(channels):
    x, y = _clip_pair(6, (3, 48, 64, channels))
    want = jax_metrics.quality_assess_video(x * 255, y * 255)
    got = metrics.quality_assess_video(torch.from_numpy(x) * 255, torch.from_numpy(y) * 255)
    assert set(got) == set(want) == {"PSNR", "SSIM", "STRRED", "STRREDSN"}
    assert _rel(got["PSNR"], want["PSNR"]) < 1e-5 and _rel(got["SSIM"], want["SSIM"]) < 1e-5
    one = metrics.quality_assess_video(torch.from_numpy(x[:1]), torch.from_numpy(y[:1]), 1.0)
    assert one["STRRED"] == 0.0 and one["STRREDSN"] == 0.0
    with pytest.raises(ValueError, match="channel"):
        metrics.quality_assess_video(torch.zeros(2, 32, 32, 2), torch.zeros(2, 32, 32, 2))


@pytest.mark.parametrize("level,orientation,nbands", [(1, 0, 6), (2, 3, 6), (4, 0, 6),
                                                      (3, 1, 4)])
def test_steerable_band_matches_jax(level, orientation, nbands):
    f = onp.random.default_rng(7).random((70, 90), dtype=onp.float32)
    want = onp.asarray(jax_steerable.steerable_band(jnp.asarray(f), level, orientation, nbands))
    got = steerable.steerable_band(torch.from_numpy(f), level, orientation, nbands).numpy()
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="too small"):
        steerable.steerable_band(torch.zeros(16, 16), level=4)


@pytest.mark.parametrize("amp", [0.02, 0.08, 0.3])
def test_strred_matches_jax(amp):
    """eld_tpu's own test clip (tests/test_metrics.py::test_strred_properties):
    4 smoothed 96x128 frames and their noisy copies."""
    rng = onp.random.default_rng(2018)
    base = rng.random((4, 96, 128), dtype=onp.float32)
    base = 0.5 * (base + onp.roll(base, 1, axis=1))
    noisy = onp.clip(base + rng.normal(0, amp, base.shape).astype(onp.float32), 0, 1)
    per_j, s_j, sn_j = jax_strred.strred(base, noisy)
    per, s, sn = strred.strred(torch.from_numpy(base), torch.from_numpy(noisy))
    assert per.shape == (3, 2)
    assert _rel(s, s_j) < 1e-3
    assert _rel(sn, sn_j) < 2e-2
    onp.testing.assert_allclose(per.numpy(), onp.asarray(per_j), rtol=1e-3)
    _, s0, sn0 = strred.strred(torch.from_numpy(base), torch.from_numpy(base))
    assert s0 == 0.0 and sn0 == 0.0


def test_strred_isotropic_band_matches_jax():
    """Frames under 32 px take the isotropic band; equal to eld_tpu's."""
    f = onp.random.default_rng(8).random((30, 30), dtype=onp.float32) * 255
    onp.testing.assert_allclose(strred.isotropic_subband(torch.from_numpy(f)).numpy(),
                                onp.asarray(jax_strred.isotropic_subband(jnp.asarray(f))),
                                rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="at least 2 frames"):
        strred.strred(torch.zeros(1, 32, 32), torch.zeros(1, 32, 32))


# ---- losses, netutils, camera selection -------------------------------------------

def test_multiple_loss_matches_jax():
    x, y = _clip_pair(9, (2, 16, 16, 4))
    for weight in (None, [0.3, 0.7]):
        want = jax_losses.MultipleLoss([jax_losses.l1_loss, jax_losses.l2_loss], weight)(
            jnp.asarray(x), jnp.asarray(y))
        got = losses.MultipleLoss([losses.l1_loss, losses.l2_loss], weight)(
            torch.from_numpy(x), torch.from_numpy(y))
        assert _rel(got, want) < 1e-6


def test_receptive_field_and_print_network_match_jax(capsys):
    layers = [(3, 1), (3, 2), (5, 1), (2, 2)]
    assert netutils.receptive_field(layers) == jax_netutils.receptive_field(layers)
    assert netutils.unet_receptive_field() == jax_netutils.unet_receptive_field()
    model = build_arch("unet", 4, 4, base_width=4)
    n = netutils.print_network(model, "unet")
    assert n == netutils.param_count(model) and f"{n:,} parameters" in capsys.readouterr().out


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_weight_init_draws_what_jax_draws(init_type):
    """Weights of a (64, 32, 3, 3) convolution drawn by the port's init and
    by eld_tpu's initializer for the same kernel (HWIO): standard
    deviations within 5%; biases zeroed; an unknown name refused."""
    conv = torch.nn.Conv2d(32, 64, 3)
    torch.manual_seed(0)
    torch.nn.Sequential(conv).apply(netutils.weight_init(init_type, gain=0.02))
    want = jax_netutils.weight_init(init_type, gain=0.02)(jax.random.PRNGKey(0), (3, 3, 32, 64))
    assert abs(float(conv.weight.detach().std()) / float(jnp.std(want)) - 1.0) < 0.05
    assert float(conv.bias.abs().max()) == 0.0
    with pytest.raises(NotImplementedError):
        netutils.weight_init("uniform")


@pytest.mark.parametrize("kw", [{}, {"include": 4}, {"exclude": 0},
                                {"cameras": ("NikonD850", "SonyA7S2"), "include": 1}])
def test_selected_cameras_match_jax(kw):
    assert params.selected_cameras(**kw) == jax_params.selected_cameras(**kw)
