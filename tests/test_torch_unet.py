"""The port's U-Nets (eld_tpu_torch.models: unet, unet_s2d, unet_s2d4)
against eld_tpu's Flax models.

Weights are carried across by eld_tpu_torch.compat.jax_params; both run
in float32 on the CPU (TF32 is off, though it has no effect there).
Tolerances: forward atol 2e-5 and input gradient rtol 1e-4 / atol 1e-5
cover f32 summation-order differences between XLA's and torch's
convolutions through 18 layers at these widths (the bf16-skip variant's
gradient is explained where it is checked).
"""

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.compat.torch_import import convert_unet_state_dict, export_torch_state_dict
from eld_tpu.models import arch_names as jax_arch_names
from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.models.unet import depth_to_space as jax_depth_to_space
from eld_tpu.models.unet import space_to_depth as jax_space_to_depth
from eld_tpu_torch.compat.jax_params import flax_to_state_dict, state_dict_to_flax
from eld_tpu_torch.models import arch_names, build_arch
from eld_tpu_torch.models.netutils import param_count
from eld_tpu_torch.models.unet import UNetSeeInDark, depth_to_space, space_to_depth
from eld_tpu_torch.models.unet_s2d import UNetS2D
from tests.test_torch_import import make_torch_state_dict, torch_forward


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)


VARIANTS = [("concat", "convt", None), ("concat", "d2s", None), ("split", "convt", None),
            ("split", "d2s", None), ("split", "convt", "bf16")]


def _pair(skip_mode, upsample, skip, width=8, arch="unet"):
    """The port's model with torch's (the reference's) default init, and the
    Flax model with the same weights carried across."""
    torch.manual_seed(0)
    tm = build_arch(arch, 4, 4, base_width=width, skip_mode=skip_mode, upsample=upsample,
                    skip_dtype=torch.bfloat16 if skip else None)
    jm = jax_build_arch(arch, 4, 4, base_width=width, skip_mode=skip_mode, upsample=upsample,
                        skip_dtype=jnp.bfloat16 if skip else None)
    return jm, state_dict_to_flax(tm.state_dict()), tm


def _forward_and_input_gradient(jm, params, tm, size, skip=None, fwd_atol=2e-5):
    rng = onp.random.default_rng(0)
    x = rng.random((2, size, size, 4), dtype=onp.float32)
    w = rng.standard_normal((2, size, size, 4)).astype(onp.float32)

    @jax.jit
    def forward_and_vjp(p, x_, w_):
        y, pull = jax.vjp(lambda a: jm.apply({"params": p}, a), x_)
        return y, pull(w_)[0]

    y_ref, g_ref = (onp.asarray(a) for a in forward_and_vjp(params, x, w))

    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y * torch.from_numpy(w)).sum().backward()
    onp.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=0, atol=fwd_atol)
    # with bf16 skips both frameworks round the skip path's cotangent to
    # bf16 (the VJP of the cast), so an f32-ulp difference upstream can flip
    # one bf16 rounding (2^-8 relative) in that path: atol 5e-5 there
    onp.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=1e-4,
                                atol=5e-5 if skip else 1e-5)


@pytest.mark.parametrize("skip_mode,upsample,skip", VARIANTS,
                         ids=["-".join(str(x) for x in v) for v in VARIANTS])
def test_forward_and_input_gradient_match_flax(skip_mode, upsample, skip):
    _forward_and_input_gradient(*_pair(skip_mode, upsample, skip), size=32, skip=skip)


@pytest.mark.parametrize("arch,size", [("unet_s2d", 64), ("unet_s2d4", 64)])
def test_s2d_forward_and_input_gradient_match_flax(arch, size):
    """unet_s2d / unet_s2d4 at width 4: the Flax checkpoint carries across
    through compat/jax_params unchanged (same inner parameter names), and
    forward and input gradient agree as for unet."""
    jm, params, tm = _pair("split", "convt", None, width=4, arch=arch)
    assert isinstance(tm, UNetS2D) and tm.conv1_1.in_channels == 4 * tm.block ** 2
    _forward_and_input_gradient(jm, params, tm, size=size, fwd_atol=1e-5)


def test_space_to_depth_keeps_the_jax_channel_order():
    """(di, dj, c) channel order, exactly eld_tpu's in both directions
    (pixel_unshuffle's (c, di, dj) order would differ)."""
    x = onp.random.default_rng(2).random((2, 8, 12, 4), dtype=onp.float32)
    for block in (2, 4):
        ours = space_to_depth(torch.from_numpy(x), block)
        onp.testing.assert_array_equal(ours.numpy(),
                                       onp.asarray(jax_space_to_depth(jnp.asarray(x), block)))
        back = depth_to_space(ours, block)
        onp.testing.assert_array_equal(back.numpy(), x)
        onp.testing.assert_array_equal(
            back.numpy(), onp.asarray(jax_depth_to_space(jnp.asarray(ours.numpy()), block)))
    assert not torch.equal(space_to_depth(torch.from_numpy(x), 2),
                           torch.nn.functional.pixel_unshuffle(
                               torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1))


def test_remat_is_exact():
    """remat re-runs each level under torch.utils.checkpoint: the output and
    every parameter gradient are bit-identical."""
    torch.manual_seed(0)
    a = UNetSeeInDark(base_width=4, skip_mode="split")
    b = UNetSeeInDark(base_width=4, skip_mode="split", remat=True)
    b.load_state_dict(a.state_dict())
    x = torch.rand((2, 32, 32, 4), generator=torch.Generator().manual_seed(1))
    for m in (a, b):
        m.train()
        m(x).square().sum().backward()
    for (n1, p1), (_, p2) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p1.grad, p2.grad), n1


def test_full_width_param_count_and_reference_names():
    """7,760,484 parameters at base width 32, under the reference's names and
    layouts: its state_dict loads, and the port equals an independent
    functional forward of the published topology (same torch operations,
    atol 1e-6)."""
    model = UNetSeeInDark(4, 4)
    assert param_count(model) == 7_760_484
    sd = make_torch_state_dict(onp.random.default_rng(0))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    model.load_state_dict(sd)
    x = onp.random.default_rng(1).random((1, 32, 32, 4), dtype=onp.float32)
    with torch.no_grad():
        ref = torch_forward(sd, torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        got = model(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, ref.transpose(0, 2, 3, 1), rtol=0, atol=1e-6)


def test_converter_equals_eld_tpu_conversions():
    """state_dict_to_flax gives exactly eld_tpu's convert_unet_state_dict,
    flax_to_state_dict exactly its export_torch_state_dict, and the two
    invert each other exactly."""
    sd = make_torch_state_dict(onp.random.default_rng(3))
    params = state_dict_to_flax(sd)
    ref_params = convert_unet_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    ref_flat = dict(jax.tree_util.tree_leaves_with_path(ref_params))
    assert len(flat) == len(ref_flat) == 46
    for path, leaf in flat:
        onp.testing.assert_array_equal(leaf, ref_flat[path])
    ours = flax_to_state_dict(params)
    ref = export_torch_state_dict(params)
    assert set(ours) == set(ref) == set(sd)
    for k in ref:
        onp.testing.assert_array_equal(ours[k].numpy(), ref[k])
        onp.testing.assert_array_equal(ours[k].numpy(), sd[k].numpy())


def test_registry_and_alignment():
    assert isinstance(build_arch("unet", 4, 4, base_width=4), UNetSeeInDark)
    assert arch_names() == jax_arch_names() == ["unet", "unet_s2d", "unet_s2d4"]
    assert build_arch("unet_s2d", 4, 4, base_width=4).alignment() == 32
    # eld_tpu's block-4 model also reports 32; its decoder needs 64
    assert build_arch("unet_s2d4", 4, 4, base_width=4).alignment() == 64
    with pytest.raises(KeyError) as ours:
        build_arch("unet_nope", 4, 4)
    with pytest.raises(KeyError) as ref:
        jax_build_arch("unet_nope", 4, 4)
    assert "unknown arch 'unet_nope'" in str(ours.value) and "unknown arch" in str(ref.value)
    assert UNetSeeInDark.alignment() == 16
    with pytest.raises(ValueError):
        UNetSeeInDark(skip_mode="sum")
    with pytest.raises(ValueError):
        UNetSeeInDark(upsample="nearest")
