"""The port's noise model (eld_tpu_torch.noise) against eld_tpu.noise.

* Deterministic cores agree exactly given the same draws: the Poisson
  inverse-CDF count, and the whole noise chain fed the very draws JAX
  makes from one key (rebuilt from eld_tpu's key-split layout).
* Random parts agree in distribution: torch's generators and JAX's
  threefry give different bits by design.
* The CUDA kernel's module imports without nvcc and sends CPU tensors to
  its plain version, and its recomputed draws keep the kernel's stream
  layout; the kernel itself is checked on the card
  (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import scipy.stats as sps
import torch

from eld_tpu.noise import load_camera_params as jax_bank
from eld_tpu.noise import sample_params_batch as jax_sample
from eld_tpu.noise import synthesize as jax_synthesize
from eld_tpu.noise.fast_poisson import poisson_small_from_uniform as jax_poisson_small
from eld_tpu.noise.model import apply_noise as jax_apply_noise
from eld_tpu.noise.model import expand_model
from eld_tpu_torch.noise import kernels
from eld_tpu_torch.noise.fast_poisson import fast_poisson, poisson_small_from_uniform
from eld_tpu_torch.noise.model import noise_core, synthesize, tukey_lambda
from eld_tpu_torch.noise.params import (
    NoiseParams,
    load_camera_params,
    sample_params_batch,
)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: with XLA's CPU thread
    pool in the same process, torch's multi-threaded elementwise kernels
    have returned wrong elements on this suite's CPU runs (reproduced on
    the Poisson loop, not seen with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("K", "g_scale", "G_scale", "G_shape", "R_scale", "color_bias",
          "saturation_level", "ratio")


def to_torch_params(jp) -> NoiseParams:
    return NoiseParams(**{f: torch.from_numpy(onp.array(getattr(jp, f), onp.float32))
                          for f in FIELDS})


def jax_draws(key, shape, model):
    """The draws eld_tpu.noise.model.synthesize makes from ``key``, in
    noise_core's layout: synthesize splits one key per image
    (model.py:120); apply_noise splits (shot, read, tl, row, quant)
    (model.py:66); fast_poisson splits (u, n) from the shot key
    (fast_poisson.py:85-93)."""
    n, h = shape[0], shape[1]
    img_shape = shape[1:]
    model = expand_model(model)
    per = {k: [] for k in ("poisson_u", "shot_n", "read_n", "tukey_u", "row_n", "quant_u")}
    for k in jax.random.split(key, n):
        k_shot, k_read, k_tl, k_row, k_quant = jax.random.split(k, 5)
        k_u, k_n = jax.random.split(k_shot)
        per["poisson_u"].append(jax.random.uniform(k_u, img_shape, minval=1e-12, maxval=1.0))
        if "P" in model:
            per["shot_n"].append(jax.random.normal(k_n, img_shape))
        else:
            per["shot_n"].append(jax.random.normal(k_shot, img_shape))
        per["read_n"].append(jax.random.normal(k_read, img_shape))
        per["tukey_u"].append(jax.random.uniform(k_tl, img_shape, minval=1e-7, maxval=1.0 - 1e-7))
        per["row_n"].append(jax.random.normal(k_row, (h, 1, 2))[:, 0, :])
        per["quant_u"].append(jax.random.uniform(k_quant, img_shape, minval=-0.5, maxval=0.5))
    return {k: torch.from_numpy(onp.stack([onp.asarray(x) for x in v])) for k, v in per.items()}


@pytest.fixture(scope="module")
def sony():
    return jax_bank(include=4), load_camera_params(include=4)


@pytest.fixture(scope="module")
def batch(sony):
    """(2, 32, 32, 4) clean batch from numpy and JAX-sampled parameters."""
    clean = onp.random.default_rng(0).random((2, 32, 32, 4), dtype=onp.float32)
    jp = jax_sample(jax.random.PRNGKey(5), sony[0], 2)
    return clean, jp


# ---- exact, given the same draws ----------------------------------------

def test_poisson_small_matches_jax_on_same_uniforms():
    """Same (lam, u): counts equal on >= 99.9% of elements and never differ
    by more than 1 — only f32 rounding of exp / the running sum can move a
    count across a CDF step."""
    rng = onp.random.default_rng(1)
    lam = rng.uniform(0.0, 12.0, 200_000).astype(onp.float32)
    lam[:4] = [0.0, 1e-6, 11.999, 12.0]
    u = rng.uniform(1e-12, 1.0, lam.shape).astype(onp.float32)
    ref = onp.asarray(jax_poisson_small(jnp.asarray(lam), jnp.asarray(u)))
    got = poisson_small_from_uniform(torch.from_numpy(lam), torch.from_numpy(u)).numpy()
    diff = onp.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("model", ["g", "pg", "Pg", "eld", "r"])
def test_noise_core_equals_jax_apply_noise_on_jax_draws(batch, model):
    """noise_core fed JAX's own draws equals eld_tpu's apply_noise per image,
    unclipped, within atol 1e-5 (f32 rounding of the same operations on
    values in [0, ~2]; a Poisson count flip would break it)."""
    clean, jp = batch
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, clean.shape[0])
    ref = onp.stack([
        onp.asarray(jax_apply_noise(keys[i], jnp.asarray(clean[i]),
                                    jax.tree_util.tree_map(lambda x: x[i], jp), model))
        for i in range(clean.shape[0])])
    got = noise_core(torch.from_numpy(clean), to_torch_params(jp), model,
                     jax_draws(key, clean.shape, model)).numpy()
    onp.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("channels", [4, 9])
def test_row_noise_channel_mapping(sony, channels):
    """'r' on a constant image: one draw per packed row, (R, G1) channels
    0-1 take the even-row draw and (B, G2) 2-3 the odd one; a 9-channel
    (X-Trans) layout takes the even draw everywhere.  Equal to JAX
    within atol 1e-5, and the structure holds exactly."""
    clean = onp.full((2, 32, 32, channels), 0.5, onp.float32)
    jp = jax_sample(jax.random.PRNGKey(3), sony[0], 2)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 2)
    ref = onp.stack([
        onp.asarray(jax_apply_noise(keys[i], jnp.asarray(clean[i]),
                                    jax.tree_util.tree_map(lambda x: x[i], jp), "r"))
        for i in range(2)])
    draws = jax_draws(key, clean.shape, "r")
    got = noise_core(torch.from_numpy(clean), to_torch_params(jp), "r", draws).numpy()
    onp.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    e = got - 0.5
    assert (e == e[:, :, :1, :]).all()
    scale = onp.asarray(jp.R_scale * jp.ratio / jp.saturation_level)[:, None]
    rows = draws["row_n"].numpy()
    if channels == 4:
        assert (e[..., 0] == e[..., 1]).all() and (e[..., 2] == e[..., 3]).all()
        onp.testing.assert_allclose(e[:, :, 0, 0], rows[..., 0] * scale, atol=1e-5)
        onp.testing.assert_allclose(e[:, :, 0, 2], rows[..., 1] * scale, atol=1e-5)
    else:
        assert (e == e[..., :1]).all()
        onp.testing.assert_allclose(e[:, :, 0, 0], rows[..., 0] * scale, atol=1e-5)


@pytest.mark.parametrize("channels", [4, 9])
def test_color_bias_only_for_bayer(sony, channels):
    """'c' adds color_bias[channel] (in DN, rescaled) for 4 channels and
    nothing for 9; exact to f32 rounding (atol 1e-6)."""
    clean = onp.full((2, 8, 8, channels), 0.25, onp.float32)
    p = to_torch_params(jax_sample(jax.random.PRNGKey(4), sony[0], 2))
    out = noise_core(torch.from_numpy(clean), p, "c", {}).numpy()
    if channels == 4:
        want = 0.25 + (p.color_bias * (p.ratio / p.saturation_level)[:, None]).numpy()
        onp.testing.assert_allclose(out, onp.broadcast_to(want[:, None, None, :], out.shape),
                                    atol=1e-6)
    else:
        onp.testing.assert_allclose(out, clean, atol=1e-6)


def test_exact_poisson_path_is_integral():
    """poisson="exact" (torch.poisson) gives z/K integral and the right mean."""
    n = 2
    ones = torch.ones(n)
    p = NoiseParams(K=ones * 2, g_scale=ones, G_scale=ones, G_shape=ones * 0.1, R_scale=ones,
                    color_bias=torch.zeros(n, 4), saturation_level=ones * 100,
                    ratio=ones * 10)
    clean = torch.full((n, 64, 64, 4), 0.5)
    out = synthesize(torch.Generator().manual_seed(0), clean, p, "P", clip=False,
                     poisson="exact")
    counts = out.numpy() * 100 / 10 / 2  # out * sat / ratio / K
    onp.testing.assert_allclose(counts, onp.round(counts), atol=1e-4)
    assert abs(counts.mean() / 2.5 - 1) < 0.02  # lam = 0.5*100/10/2, 32k draws


# ---- in distribution ----------------------------------------------------

@pytest.mark.parametrize("model", ["g", "pg", "Pg", "eld"])
def test_synthesize_moments_match_jax(sony, model):
    """Per-image noise mean and std of the port's synthesize (torch
    Generator) against eld_tpu's synthesize (threefry), with the bounds of
    tests/test_pallas_noise.py: mean within 6 standard errors (+ the row
    term for row noise), std ratio within 15%."""
    clean = onp.random.default_rng(0).random((2, 64, 32, 4), dtype=onp.float32)
    jp = jax_sample(jax.random.PRNGKey(5), sony[0], 2)
    ref = onp.asarray(jax_synthesize(jax.random.PRNGKey(7), jnp.asarray(clean), jp, model=model))
    got = synthesize(torch.Generator().manual_seed(7), torch.from_numpy(clean),
                     to_torch_params(jp), model).numpy()
    e_p, e_r = got - clean, ref - clean
    for i in range(clean.shape[0]):
        se = max(e_r[i].std() / onp.sqrt(e_r[i].size) * 6, 1e-4)
        if "r" in model or model == "eld":
            se += 6 * float(jp.R_scale[i] * jp.ratio[i] / jp.saturation_level[i]) \
                / onp.sqrt(2 * clean.shape[1])
        assert abs(e_p[i].mean() - e_r[i].mean()) < se, (model, i)
        assert abs(e_p[i].std() / max(e_r[i].std(), 1e-6) - 1.0) < 0.15, (model, i)


def test_fast_poisson_distribution():
    """The hybrid sampler, with the bounds of tests/test_noise.py: PMF within
    2.5e-3 below the switch point, mean/var within 0.5%/2% above it."""
    gen = torch.Generator().manual_seed(0)
    for lam in (0.05, 0.5, 2.0, 8.0):
        s = fast_poisson(gen, torch.full((300_000,), lam)).numpy()
        vals, counts = onp.unique(s, return_counts=True)
        assert onp.abs(counts / len(s) - sps.poisson(lam).pmf(vals)).max() < 2.5e-3, lam
        assert abs(s.var() / lam - 1.0) < 0.02, lam
    for lam in (30.0, 500.0):
        s = fast_poisson(gen, torch.full((200_000,), lam)).double().numpy()
        assert abs(s.mean() / lam - 1.0) < 5e-3
        assert abs(s.var() / lam - 1.0) < 2e-2


def test_tukey_lambda_matches_scipy():
    """KS against scipy's tukeylambda (p > 1e-3, as tests/test_noise.py)."""
    gen = torch.Generator().manual_seed(5)
    for lam in (-0.14, 0.0, 0.09, 0.13):
        s = tukey_lambda(gen, (200_000,), lam).double().numpy()
        assert sps.kstest(s, sps.tukeylambda(lam).cdf).pvalue > 1e-3, lam


@pytest.mark.parametrize("kw", [{}, {"include": 4}, {"exclude": 0}],
                         ids=["all", "include4", "exclude0"])
def test_bank_equals_jax(kw):
    """The bank is built from the same files with the same padding guard:
    every array equal to eld_tpu's exactly."""
    ref, got = jax_bank(**kw), load_camera_params(**kw)
    for f in ("kmin", "kmax", "g_slope", "g_bias", "g_sigma", "G_slope", "G_bias", "G_sigma",
              "R_slope", "R_bias", "R_sigma", "g_shape", "color_bias", "n_iso"):
        onp.testing.assert_array_equal(getattr(got, f).numpy(), onp.asarray(getattr(ref, f)))
    assert got.num_cameras == ref.num_cameras


def test_sampled_params_match_jax_in_distribution(sony):
    """4096 draws each.  Bounds: K within [0.1, 30] and ratio within
    [100, 300] exactly; mean log K within 0.05 of the uniform's centre and
    of JAX's; mean ratio within 3 of 200 (5 sd of the mean is 2.9); the
    regression of log g on log K recovers the calibrated slope/bias within
    0.05 and the residual sd within 0.02 (tests/test_noise.py)."""
    jb, tb = sony
    p = sample_params_batch(torch.Generator().manual_seed(0), tb, 4096)
    ref = jax_sample(jax.random.PRNGKey(0), jb, 4096)
    K, ratio = p.K.double().numpy(), p.ratio.double().numpy()
    assert K.min() >= 0.1 - 1e-5 and K.max() <= 30 + 1e-3
    assert ratio.min() >= 100 and ratio.max() <= 300
    logk = onp.log(K)
    lo, hi = onp.log(0.1), onp.log(30)
    assert abs(logk.mean() - (lo + hi) / 2) < 0.05
    assert abs(logk.mean() - onp.log(onp.asarray(ref.K)).mean()) < 0.05
    assert abs(ratio.mean() - 200) < 3
    logg = onp.log(p.g_scale.double().numpy())
    slope, bias = onp.polyfit(logk, logg, 1)
    assert abs(slope - float(tb.g_slope[0])) < 0.05
    assert abs(bias - float(tb.g_bias[0])) < 0.05
    assert abs((logg - (slope * logk + bias)).std() - float(tb.g_sigma[0])) < 0.02
    assert float(p.saturation_level[0]) == 16383 - 800


def test_calibrated_k_mode_and_iso_index(sony):
    """k_mode="calibrated" keeps K in [Kmin, Kmax]; the ISO index stays below
    the camera's real count, so padded rows are never drawn: on a 16-ISO
    camera the most-drawn Tukey shape is < 1.8x the median count (it would
    be ~3x if the two padding rows, copies of row 15, were drawable)."""
    tb = sony[1]
    p = sample_params_batch(torch.Generator().manual_seed(1), tb, 1024, k_mode="calibrated")
    assert float(p.K.min()) >= float(tb.kmin[0]) - 1e-5
    assert float(p.K.max()) <= float(tb.kmax[0]) + 1e-4
    full = load_camera_params()
    cam16 = int(torch.argmin(full.n_iso))
    bank1 = load_camera_params(include=cam16)
    assert int(bank1.n_iso[0]) == 16
    shapes = sample_params_batch(torch.Generator().manual_seed(0), bank1, 4000).G_shape.numpy()
    real = bank1.g_shape[0][:16].numpy()
    assert set(onp.unique(shapes).tolist()) <= set(real.tolist())
    counts = onp.array([(shapes == v).sum() for v in onp.unique(real)])
    assert counts.max() < onp.median(counts) * 1.8


# ---- the kernel module --------------------------------------------------

def test_philox_matches_random123_known_answers():
    """The PyTorch Philox4x32-10 that recomputes the kernel's draws gives
    Random123's published known-answer vectors (the kernel's own generator
    is checked against the third on the card by chip_smoke.py)."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        assert tuple(int(x) for x in kernels.philox4x32_10(ctr, key)) == want


def test_kernel_draws_structure():
    """The kernel's draws: uniforms in their clamped ranges, row draws one
    (even, odd) pair per packed row, and independent streams per seed."""
    shape = (2, 8, 4, 4)
    d = kernels.kernel_draws(5, shape, "PGrqc")
    assert d["row_n"].shape == (2, 8, 2)
    assert float(d["poisson_u"].min()) >= 1e-12 and float(d["poisson_u"].max()) < 1
    assert 1e-7 <= float(d["tukey_u"].min()) and float(d["tukey_u"].max()) <= 0.9999999
    assert -0.5 <= float(d["quant_u"].min()) and float(d["quant_u"].max()) < 0.5
    d2 = kernels.kernel_draws(6, shape, "PGrqc")
    assert not torch.equal(d["poisson_u"], d2["poisson_u"])
    g = kernels.kernel_draws(5, shape, "Pg")
    assert not torch.equal(g["read_n"], g["shot_n"])  # 'g' under 'P' takes stream 1


def test_kernel_wrapper_sends_cpu_tensors_to_the_plain_version():
    """A CPU tensor runs the plain version, bit-identical to synthesize on a
    generator seeded the same, and no launch is counted.  (That the module
    imports with no nvcc present is test_torch_train's package test.)"""
    bank = load_camera_params(include=4)
    gen = torch.Generator().manual_seed(3)
    clean = torch.rand((2, 16, 16, 4), generator=gen)
    p = sample_params_batch(gen, bank, 2)
    before = kernels.synthesize_kernel.launches
    got = kernels.synthesize_kernel(12345, clean, p, "eld")
    want = synthesize(torch.Generator().manual_seed(12345), clean, p, "eld")
    assert torch.equal(got, want)
    assert kernels.synthesize_kernel.launches == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(sony):
    p = sample_params_batch(torch.Generator().manual_seed(0), sony[1], 2)
    with pytest.raises(TypeError):
        kernels.synthesize_kernel(0, torch.zeros((2, 8, 8, 4), dtype=torch.float64), p)
    with pytest.raises(ValueError):
        kernels.synthesize_kernel(0, torch.zeros((2, 8, 8, 0)), p)
    for c in (1, 3, 5):  # any C >= 1, as the TPU kernel
        assert kernels.synthesize_kernel(0, torch.zeros((2, 8, 8, c)), p).shape == (2, 8, 8, c)
    with pytest.raises(ValueError):
        kernels.synthesize_kernel(0, torch.zeros((2, 8, 8, 4)).transpose(1, 2), p)
    with pytest.raises(ValueError):
        kernels.synthesize_kernel(0, torch.zeros((3, 8, 8, 4)), p)
    with pytest.raises(ValueError):
        kernels.model_flags("PGx")
    assert kernels.model_flags("eld") == kernels.model_flags("PGrqc") == 1 | 8 | 16 | 32 | 64


def _philox_by_hand(ctr, key):
    """Philox4x32-10 on Python ints (Random123's round and key schedule)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & 0xFFFFFFFF,
                          (p0 >> 32) ^ c3 ^ k1, p0 & 0xFFFFFFFF)
        k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c0, c1, c2, c3


@pytest.mark.parametrize("shape", [(3, 37, 53, 9), (2, 5, 7, 4)])
def test_kernel_draws_keep_the_stream_layout(shape):
    """The stream contract the CUDA kernel keeps, pinned element by element:
    key (seed lo, seed hi); the element at (n, h, w, ch) draws stream 0 (and
    stream 1 for 'g' under 'P') at counter flat_index = ((n*H + h)*W + w)*C
    + ch; row (n, h) draws stream 2 at counter n*H + h, its (even, odd) pair
    the cosine and sine legs of the first two uniforms.  Uniforms are equal
    exactly; the normals within 1e-6 (torch's f32 log/cos/sin against float64)."""
    seed = 0x0123_4567_89AB_CDEF
    key = (seed & 0xFFFFFFFF, seed >> 32)
    n_, h_, w_, c_ = shape
    d = kernels.kernel_draws(seed, shape, "PGgrq")
    u01 = lambda x: onp.float32(x >> 8) * onp.float32(2.0 ** -24)  # noqa: E731

    def legs(x, y):  # in float64, the angle rounded to f32 as the kernel rounds it
        r = math.sqrt(-2.0 * math.log(max(u01(x), onp.float32(1e-7))))
        th = float(onp.float32(6.283185307179586) * u01(y))
        return r * math.cos(th), r * math.sin(th)

    rng = onp.random.default_rng(0)
    picks = [tuple(int(rng.integers(0, m)) for m in shape) for _ in range(24)]
    picks += [(0, 0, 0, 0), (n_ - 1, h_ - 1, w_ - 1, c_ - 1)]
    for n, h, w, ch in picks:
        flat = ((n * h_ + h) * w_ + w) * c_ + ch
        a = _philox_by_hand((flat & 0xFFFFFFFF, flat >> 32, 0, 0), key)
        b = _philox_by_hand((flat & 0xFFFFFFFF, flat >> 32, 1, 0), key)
        at = (n, h, w, ch)
        assert float(d["poisson_u"][at]) == max(u01(a[0]), 1e-12)
        assert float(d["tukey_u"][at]) == min(max(u01(a[2]), onp.float32(1e-7)),
                                              onp.float32(0.9999999))
        assert float(d["quant_u"][at]) == u01(a[3]) - onp.float32(0.5)
        assert abs(float(d["shot_n"][at]) - legs(a[0], a[1])[0]) < 1e-6
        assert abs(float(d["read_n"][at]) - legs(b[0], b[1])[0]) < 1e-6
    for n in range(n_):
        for h in range(h_):
            r = _philox_by_hand((n * h_ + h, 0, 2, 0), key)
            even, odd = legs(r[0], r[1])
            assert abs(float(d["row_n"][n, h, 0]) - even) < 1e-6
            assert abs(float(d["row_n"][n, h, 1]) - odd) < 1e-6
