"""Restormer's 3x3 depthwise convolutions (``models/dwconv.py``) on the
CPU: the plain version against autograd through ``F.conv2d(groups=C)`` at
the benchmark cell's eight channel counts; the operator in bf16 and under
autocast; the refusals, of a convolution that is not this function on any
device and of a card tensor the kernels do not take; what the forward
keeps for the backward; both operators recorded by ``torch.export`` and a
traced backward; and the launches a served artifact and a replayed pooled
call count (through ``test_torch_fake_card.py``'s stand-in card).  The
model against the benchmark's plain Restormer is
``tests/test_torch_restormer.py``'s; the kernels themselves are held to the
f32 composition on the card by ``tests/test_torch_cuda.py``.

Tolerances of the backward against autograd, f32: the same products,
summed in another order (autograd's wgrad and dgrad are convolutions of
their own), so rtol 1e-5 with an atol of 1e-6 of the largest value.
"""

import types

import numpy as onp
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.fx.experimental.proxy_tensor import make_fx

from eld_tpu_torch import export
from eld_tpu_torch.models import dwconv
from eld_tpu_torch.models.dwconv import depthwise_conv3x3
from eld_tpu_torch.models.restormer import TransformerBlock
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.state import create_train_state
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card
from tests.test_torch_restormer import SMALL_BLOCKS, _small

# the benchmark cell's channel counts at dim 48: MDTA's 3 dim and GDFN's 2 int(2.66 dim) at
# each level's width (48, 96, 192, 384)
CHANNELS = [144, 254, 288, 510, 576, 1020, 1152, 2042]
FRAMES = [(6, 8), (5, 7)]  # (H, W): even, and odd both ways


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv(c, seed=0, **kw):
    """The model's depthwise conv over ``c`` channels, its weight seeded."""
    torch.manual_seed(seed)
    args = dict(kernel_size=3, padding=1, groups=c, bias=False)
    return nn.Conv2d(c, c, **{**args, **kw})


def _inputs(c, hw, seed, dtype=torch.float32):
    """x and gy (2, c, H, W) channels-last."""
    rng = onp.random.default_rng(seed)
    x, gy = (torch.from_numpy(rng.standard_normal((2, c, *hw)).astype(onp.float32)).to(dtype)
             .contiguous(memory_format=torch.channels_last) for _ in range(2))
    return x, gy


@pytest.mark.parametrize("hw", FRAMES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("c", CHANNELS)
def test_the_plain_version_equals_autograd_through_conv2d(c, hw):
    """``plain_forward`` is ``F.conv2d(groups=C)`` itself, bit for bit;
    ``plain_backward`` (the kernels' algebra: the flipped stencil of gy for
    gx, sum_q x(q) gy(q - d) for gw) equals autograd through it, f32."""
    conv = _conv(c, c)
    x, gy = _inputs(c, hw, c + hw[0])
    xa = x.detach().clone().requires_grad_(True)
    y_ref = F.conv2d(xa, conv.weight, padding=1, groups=c)
    y_ref.backward(gy)
    y = dwconv.plain_forward(x, conv.weight)
    gx, gw, _ = dwconv.plain_backward(gy, x, conv.weight)
    assert torch.equal(y, y_ref.detach())
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert gx.is_contiguous(memory_format=torch.channels_last)
    assert gx.dtype == torch.float32 and gw.dtype == torch.float32 and gw.shape == (c, 1, 3, 3)
    for got, ref in ((gx, xa.grad), (gw, conv.weight.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * float(ref.abs().max()))


def test_the_operator_and_its_gradients_equal_autograd_through_the_module():
    """``depthwise_conv3x3(x, conv)`` through autograd on the CPU: y is the
    module's own output bit for bit, and x's and the weight's gradients are
    autograd's through the module within the tolerances above."""
    conv = _conv(254, 1)
    x, gy = _inputs(254, (5, 7), 2)
    runs = []
    for fn in (depthwise_conv3x3, lambda t, m: m(t)):
        conv.zero_grad()
        xa = x.detach().clone().requires_grad_(True)
        y = fn(xa, conv)
        y.backward(gy)
        runs.append((y.detach(), xa.grad, conv.weight.grad.clone()))
    (y, gx, gw), (y_ref, gx_ref, gw_ref) = runs
    assert torch.equal(y, y_ref)
    for got, ref in ((gx, gx_ref), (gw, gw_ref)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * float(ref.abs().max()))


def test_bf16_rounds_the_weight_as_autocast_did_for_cudnn():
    """bf16 x: the weight rounded to bf16 and ``F.conv2d`` in bf16, as bf16
    autocast ran the module; the same under autocast, which leaves the
    operator's inputs as they come."""
    conv = _conv(144, 3)
    x, _ = _inputs(144, (6, 8), 4, torch.bfloat16)
    want = F.conv2d(x, conv.weight.to(torch.bfloat16), padding=1, groups=144)
    got = depthwise_conv3x3(x, conv)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert torch.equal(depthwise_conv3x3(x, conv), want)


@pytest.mark.parametrize("case", ["kernel 5x5", "padding 0", "stride 2", "dilation 2",
                                  "groups 1", "a bias", "x not 4-D", "weight elsewhere"])
def test_a_convolution_that_is_not_this_function_is_refused(case):
    """On any device, a conv other than the 3x3 depthwise one of padding 1 and
    stride 1 over x's channels, or one whose bias (which the kernels take)
    lies on another device than x, is refused by name."""
    kw, x = {}, _inputs(8, (6, 8), 5)[0]
    if case == "kernel 5x5":
        kw = dict(kernel_size=5, padding=2)
    elif case == "padding 0":
        kw = dict(padding=0)
    elif case == "stride 2":
        kw = dict(stride=2)
    elif case == "dilation 2":
        kw = dict(dilation=2, padding=2)
    elif case == "groups 1":
        kw = dict(groups=1)
    elif case == "a bias":
        kw = dict(bias=True)
    conv = _conv(8, **kw)
    if case == "x not 4-D":
        x = x[0]
    elif case == "weight elsewhere":
        conv = conv.to("meta")
    elif case == "a bias":
        conv.bias = nn.Parameter(conv.bias.detach().to("meta"))
    with pytest.raises(ValueError):
        depthwise_conv3x3(x, conv)


@pytest.mark.parametrize("case", ["odd channels", "float32", "float16"])
def test_a_card_tensor_the_kernels_do_not_take_is_refused(case):
    """On a card the kernels run bf16 x of any even channel count, or the
    call is refused by name; a CPU tensor of any of these runs the plain
    version."""
    dtype, c = {"odd channels": (torch.bfloat16, 255), "float32": (torch.float32, 254),
                "float16": (torch.float16, 254)}[case]

    def x(device, dtype=dtype, c=c):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(4, c, 8, 8))

    assert dwconv.on_card(x("cpu")) is False
    with pytest.raises(ValueError, match=f"got {dtype} with {c} channels"):
        dwconv.on_card(x("cuda"))
    for width in CHANNELS + [2, 8]:
        assert dwconv.on_card(x("cuda", torch.bfloat16, width)) is True


def test_the_forward_keeps_only_x_and_the_weight():
    """What the backward keeps: x (the caller holds it anyway) and the
    weight, no copy of either; nothing under no_grad."""
    conv = _conv(16, 6)
    x = _inputs(16, (6, 8), 7, torch.bfloat16)[0].requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        depthwise_conv3x3(x, conv)
    assert [(tuple(t.shape), t.dtype) for t in saved] == [(tuple(x.shape), torch.bfloat16),
                                                          ((16, 1, 3, 3), torch.float32)]
    saved.clear()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        depthwise_conv3x3(x, conv)
    assert saved == []


def test_torch_export_records_both_convolutions_of_a_block():
    """``torch.export`` of one transformer block records its two depthwise
    convs (MDTA's and GDFN's) as calls of the operator; the only
    convolutions left to aten are the four 1x1 ones."""
    torch.manual_seed(0)
    block = TransformerBlock(8, 1, 2.66).eval()
    x = torch.rand((1, 8, 16, 16)).contiguous(memory_format=torch.channels_last)
    program = torch.export.export(block, (x,))
    nodes = list(program.graph.nodes)
    calls = [n for n in nodes if n.target is torch.ops.eld_tpu_torch.depthwise_conv3x3.default]
    assert [tuple(n.args[1].meta["val"].shape) for n in calls] == [(24, 1, 3, 3), (42, 1, 3, 3)]
    convs = [n for n in nodes if n.target is torch.ops.aten.conv2d.default]
    assert [tuple(n.args[1].meta["val"].shape[2:]) for n in convs] == [(1, 1)] * 4
    with torch.no_grad():
        torch.testing.assert_close(program.module()(x), block(x), rtol=0, atol=0)


def test_a_traced_backward_records_the_backward_operator():
    """The gradient is the registered backward, one operator call that
    returns gx and gw, as a trace of the joint computation shows."""
    conv = _conv(6, 8)
    x = _inputs(6, (5, 7), 9)[0].requires_grad_(True)

    def grads(x, w):
        y = dwconv._forward(x, w, None)
        return torch.autograd.grad(y.sum(), (x, w))

    graph = make_fx(grads)(x, conv.weight)
    targets = [n.target for n in graph.graph.nodes]
    assert targets.count(torch.ops.eld_tpu_torch.depthwise_conv3x3.default) == 1
    assert targets.count(torch.ops.eld_tpu_torch.depthwise_conv3x3_backward.default) == 1
    gx, gw = graph(x, conv.weight)
    ref = dwconv.plain_backward(torch.ones_like(x), x.detach(), conv.weight.detach())
    assert torch.equal(gx, ref[0]) and torch.equal(gw, ref[1])


def test_an_exported_restormer_calls_the_convolution_operator(tmp_path, monkeypatch):
    """A served artifact of the small Restormer runs its 16 depthwise convs
    as the operator's calls, each counted as a launch on the stand-in
    card."""
    model = _small().eval()
    path = str(tmp_path / "r.eldx")
    export.save_denoiser(path, model, 32, 32)
    fn, _ = export.load_denoiser(path, "cpu")
    install_fake_card(monkeypatch.setattr)
    monkeypatch.setattr(depthwise_conv3x3, "launches", 0)
    x = torch.rand((2, 32, 32, 4), generator=torch.Generator().manual_seed(4))
    got = fn(x)
    assert depthwise_conv3x3.launches == 2 * SMALL_BLOCKS
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=0, atol=1e-5)


def test_a_replayed_pooled_call_counts_four_convolution_launches_a_block_and_step(monkeypatch):
    """Each transformer block's two depthwise convs are one launch forward
    and one backward each: 32 a step for the small Restormer's 8 blocks
    (the benchmark's 44 blocks: 176).  The eager call counts its own, the
    capture counts none and records what the graph holds, and each replay
    adds it."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    monkeypatch.setattr(depthwise_conv3x3, "launches", 0)
    state = create_train_state(_small(), lr=1e-4)
    k = 2
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=k)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (6, 32, 32, 4), dtype=onp.uint16))}
    counts = []
    for call in range(4):  # eager, capture (replayed at once), two replays
        before = depthwise_conv3x3.launches
        fn(state, pool, [steps.fold_in(3, k * call + j) for j in range(k)])
        counts.append(depthwise_conv3x3.launches - before)
    (graph,) = fn.graphs.values()
    assert graph.launches[depthwise_conv3x3] == 4 * SMALL_BLOCKS * k
    assert counts == [4 * SMALL_BLOCKS * k] * 4 and steps.graph_replays(fn) == 3
