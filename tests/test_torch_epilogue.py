"""The U-Net's convolution epilogue (``models/epilogue.py``) on the CPU:
``bias_lrelu``'s plain version against the composition it replaces, the
port's U-Nets against a reference written here from the same weights, the
wrapper's and the backward launch's refusals, the launch count a replayed
pooled call adds (through ``test_torch_fake_card.py``'s stand-in card), and
a serving artifact that calls the epilogue's operator.  The kernels
themselves are held to the plain version on the card by
``tests/test_torch_cuda.py``.

Tolerances: in float32 the plain version runs the composition's own
operations, so y and the input gradients are equal and the bias gradient
differs by the f32 sum's order at most (rtol 1e-6).  In bf16 the sum and
the activation run in f32 and round once, as the kernel does.  The U-Nets
against the reference: rtol 1e-4 and an atol of 1e-5 of the largest value,
the f32 summation-order differences of 18 convolutions (and of `split`'s
and `d2s`'s exact re-parameterizations) at these widths.
"""

import numpy as onp
import pytest
import torch
import torch.nn.functional as F

from eld_tpu_torch.models import build_arch, epilogue
from eld_tpu_torch.models.epilogue import bias_lrelu
from eld_tpu_torch.models.unet import space_to_depth
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.state import create_train_state
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensor(shape, seed, dtype=torch.float32, channels_last=True):
    t = torch.from_numpy(onp.random.default_rng(seed).standard_normal(shape).astype(onp.float32))
    t = t.to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if channels_last and t.ndim == 4 else t


# ---- the plain version against the composition it replaces -------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("split", [False, True], ids=["z", "z+z2"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("c", [32, 64, 12])
def test_plain_version_equals_the_composition(c, channels_last, split, dtype):
    """y, gz, gz2 and gbias against lrelu(z [+ z2] + b) under autograd,
    the composition evaluated in f32 on the same values; y and the input
    gradients rounded once to the working dtype."""
    shape = (2, c, 6, 5)
    z = _tensor(shape, 1, dtype, channels_last).requires_grad_(True)
    z2 = _tensor(shape, 2, dtype, channels_last).requires_grad_(True) if split else None
    b = _tensor((c,), 3).requires_grad_(True)
    gy = _tensor(shape, 4, dtype, channels_last)
    y = bias_lrelu(z, b, z2)
    y.backward(gy)

    zr = z.detach().float().requires_grad_(True)
    z2r = z2.detach().float().requires_grad_(True) if split else None
    br = b.detach().clone().requires_grad_(True)
    yr = F.leaky_relu((zr if z2r is None else zr + z2r) + br.reshape(1, -1, 1, 1), 0.2)
    yr.backward(gy.float())

    assert y.dtype == dtype and torch.equal(y, yr.to(dtype))
    assert z.grad.dtype == dtype and torch.equal(z.grad, zr.grad.to(dtype))
    if split:
        assert torch.equal(z2.grad, z2r.grad.to(dtype))
    assert b.grad.dtype == torch.float32
    torch.testing.assert_close(b.grad, br.grad, rtol=1e-6, atol=1e-6)


def test_the_backward_keeps_only_y():
    """The one tensor saved for the backward is the output, which the next
    convolution keeps anyway; under no_grad nothing is saved."""
    z, z2 = (_tensor((2, 8, 4, 4), s).requires_grad_(True) for s in (1, 2))
    b = _tensor((8,), 3).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = bias_lrelu(z, b, z2)
    assert len(saved) == 1 and saved[0] is y
    saved.clear()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y0 = bias_lrelu(z, b, z2)
    assert saved == [] and y0.grad_fn is None and torch.equal(y0, y)


@pytest.mark.parametrize("case", ["bias_shape", "bias_dtype", "z2_shape", "z2_dtype", "z_ndim"])
def test_wrapper_refusals(case):
    z, b = _tensor((2, 8, 4, 4), 1), _tensor((8,), 2)
    z2 = None
    if case == "bias_shape":
        b = _tensor((7,), 2)
    elif case == "bias_dtype":
        b = b.double()
    elif case == "z2_shape":
        z2 = _tensor((2, 8, 4, 2), 3)
    elif case == "z2_dtype":
        z2 = _tensor((2, 8, 4, 4), 3, torch.bfloat16)
    else:
        z = z[0]
    with pytest.raises((ValueError, TypeError)):
        bias_lrelu(z, b, z2)


@pytest.mark.parametrize("case", ["dtype", "shape"])
def test_the_backward_launch_refuses_a_gradient_unlike_y(case):
    """The kernel reads gy in y's dtype and shape; the direct entry checks
    both before anything is launched."""
    y = _tensor((2, 8, 4, 4), 1, torch.bfloat16)
    gy = _tensor((2, 8, 4, 4), 2) if case == "dtype" else _tensor((2, 8, 4, 2), 2, torch.bfloat16)
    with pytest.raises(ValueError, match="gy must match y"):
        epilogue.launch_backward(None, gy, y)


# ---- the U-Nets against a reference written from the same weights -------------------

def _reference(model, x):
    """The SID U-Net as the reference writes it: F.conv2d with its bias,
    LeakyReLU(0.2), concatenated skips, transposed convolutions; the
    space-to-depth variant around it.  NHWC in and out."""
    p = dict(model.named_parameters())

    def conv(t, name):
        return F.leaky_relu(F.conv2d(t, p[f"{name}.weight"], p[f"{name}.bias"], padding=1), 0.2)

    block = getattr(model, "block", 1)
    t = space_to_depth(x, block) if block > 1 else x
    t = t.permute(0, 3, 1, 2)
    skips = []
    for lvl in range(1, 6):
        t = conv(conv(t, f"conv{lvl}_1"), f"conv{lvl}_2")
        if lvl < 5:
            skips.append(t)
            t = F.max_pool2d(t, 2)
    for lvl in range(6, 10):
        t = F.conv_transpose2d(t, p[f"upv{lvl}.weight"], p[f"upv{lvl}.bias"], stride=2)
        t = torch.cat([t, skips[9 - lvl]], dim=1)
        t = conv(conv(t, f"conv{lvl}_1"), f"conv{lvl}_2")
    out = F.conv2d(t, p["conv10_1.weight"], p["conv10_1.bias"]).permute(0, 2, 3, 1)
    if block == 1:
        return out
    n, h, w, cbb = out.shape
    c = cbb // (block * block)
    out = out.reshape(n, h, w, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h * block, w * block, c)


_VARIANTS = [("unet", s, u, r) for s in ("split", "concat") for u in ("convt", "d2s")
             for r in (False, True)] + [("unet_s2d", "split", "convt", False)]


@pytest.mark.parametrize("arch,skip_mode,upsample,remat", _VARIANTS,
                         ids=["-".join(str(v) for v in x) for x in _VARIANTS])
def test_unet_equals_the_reference_forward_and_parameter_gradients(arch, skip_mode, upsample,
                                                                   remat):
    torch.manual_seed(0)
    model = build_arch(arch, 4, 4, base_width=4, skip_mode=skip_mode, upsample=upsample,
                       remat=remat).train()
    size = 64 if arch == "unet_s2d" else 32
    x = _tensor((2, size, size, 4), 5, channels_last=False)
    w = _tensor((2, size, size, 4), 6, channels_last=False)
    grads = []
    for fn in (model, lambda t: _reference(model, t)):
        model.zero_grad()
        y = fn(x)
        (y * w).sum().backward()
        grads.append((y.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (y, g), (y_ref, g_ref) = grads
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5 * float(y_ref.abs().max()))
    assert g.keys() == g_ref.keys()
    for name, ref in g_ref.items():
        torch.testing.assert_close(g[name], ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()),
                                   msg=name)


# ---- a replayed pooled call counts the epilogue's launches -------------------------

@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_a_replayed_pooled_call_counts_36_epilogue_launches_a_step(monkeypatch, arch):
    """18 convolutions with an epilogue, each one launch forward and one
    backward: 36 a step.  The eager call counts its own, the capture counts
    none and records what the graph holds, and each replay adds it."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    monkeypatch.setattr(bias_lrelu, "launches", 0)
    torch.manual_seed(0)
    state = create_train_state(build_arch(arch, 4, 4, base_width=4, skip_mode="split"),
                               lr=1e-4)
    k = 2
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=k)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (6, 64, 64, 4), dtype=onp.uint16))}
    counts = []
    for call in range(4):  # eager, capture (replayed at once), two replays
        before = bias_lrelu.launches
        fn(state, pool, [steps.fold_in(3, k * call + j) for j in range(k)])
        counts.append(bias_lrelu.launches - before)
    (graph,) = fn.graphs.values()
    assert graph.launches[bias_lrelu] == 36 * k
    assert counts == [36 * k] * 4 and steps.graph_replays(fn) == 3


# ---- a served artifact calls the operator ----------------------------------------

def test_an_exported_artifact_calls_the_epilogue_operator(monkeypatch, tmp_path):
    """``torch.export`` records each epilogue as one call of the operator,
    not as the plain version's ops, so the artifact runs the kernel on a
    card; loaded and run, it makes the 18 calls a forward holds."""
    from eld_tpu_torch import export

    torch.manual_seed(0)
    model = build_arch("unet", 4, 4, base_width=4, skip_mode="split").eval()
    program = export.export_denoiser(model, 32, 32)
    calls = [n for n in program.graph.nodes
             if n.target is torch.ops.eld_tpu_torch.bias_lrelu.default]
    assert len(calls) == 18
    path = str(tmp_path / "a.eldx")
    export.save_denoiser(path, model, 32, 32)
    fn, _ = export.load_denoiser(path, "cpu")
    install_fake_card(monkeypatch.setattr)
    monkeypatch.setattr(bias_lrelu, "launches", 0)
    x = _tensor((2, 32, 32, 4), 7, channels_last=False)
    got = fn(x)
    assert bias_lrelu.launches == 18
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=0, atol=1e-6)
