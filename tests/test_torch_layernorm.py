"""Restormer's BiasFree LayerNorm (``models/layernorm.py``) on the CPU: the
operator against the composition the model ran before, bit for bit; its
registered backward (the kernels' algebra) against autograd of the
composition in float64; the wrapper's refusals, on the CPU and for a card
tensor the kernels do not take; what the forward keeps for the backward;
``torch.export`` recording the operator; and the launches a replayed
pooled call counts (through ``test_torch_fake_card.py``'s stand-in card).
The kernels themselves are held to the composition on the card by
``tests/test_torch_cuda.py``.

Tolerances of the backward against float64: the same f32 inputs, f32 sums
in other orders, and the f32 mean's rounding at the offset (an ulp of 100
against spreads of 0.5 to 2, ~1e-5 of x - m): rtol 1e-4 and an atol of
1e-5 of the largest value (as the Restormer tests); in bf16 the port
rounds its f32 gradient once, so one bf16 ulp of the largest value more.
The variance taken as E[x²] - E[x]² in f32 misses by ~1e-3 relative at
this offset, and x centred in the output by orders of magnitude.
"""

import types

import numpy as onp
import pytest
import torch

from eld_tpu_torch import export
from eld_tpu_torch.models import layernorm
from eld_tpu_torch.models.layernorm import biasfree_layernorm
from eld_tpu_torch.models.restormer import TransformerBlock
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.state import create_train_state
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card
from tests.test_torch_restormer import SMALL_BLOCKS, _small

WIDTHS = [48, 96, 192, 384]  # Restormer's level widths at dim 48
OFFSET = 100.0  # a common offset of every channel, against spreads of 0.5 to 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed, dtype=torch.float32, offset=0.0):
    """x (2, c, 5, 7) channels-last with a common offset and a spread that
    differs by pixel, a weight drawn away from 1, and gy."""
    rng = onp.random.default_rng(seed)
    x = rng.standard_normal((2, c, 5, 7)) * rng.uniform(0.5, 2.0, (2, 1, 5, 7)) + offset
    w = 0.5 + rng.random(c)
    gy = rng.standard_normal((2, c, 5, 7))
    x, gy = (torch.from_numpy(t.astype(onp.float32)).to(dtype)
             .contiguous(memory_format=torch.channels_last) for t in (x, gy))
    return x, torch.from_numpy(w.astype(onp.float32)), gy


def _composition(x, w):
    """``LayerNorm.forward`` as the model ran it before the operator."""
    x = x.float()
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return x / torch.sqrt(var + 1e-5) * w.reshape(1, -1, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_the_operator_on_the_cpu_equals_the_composition_bit_for_bit(c, dtype):
    """The CPU runs the composition itself: f32 x gives its f32 output, bf16
    x its output rounded once to bf16, as autocast's cast for the next conv
    rounded it; under autocast the same."""
    x, w, _ = _inputs(c, c, dtype, OFFSET)
    want = _composition(x, w).to(dtype)
    got = biasfree_layernorm(x, w)
    assert got.dtype == dtype and torch.equal(got, want)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert torch.equal(biasfree_layernorm(x, w), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_the_backward_equals_autograd_of_the_composition_in_f64(c, dtype):
    """gx and gw of the registered backward (``plain_backward``) against
    autograd through the composition in float64, on the same values: x with
    a common offset of 100 (the variance must be centred), a weight drawn
    away from 1."""
    x, w, gy = _inputs(c, c + 1, dtype, OFFSET)
    xa, wa = x.detach().clone().requires_grad_(True), w.clone().requires_grad_(True)
    biasfree_layernorm(xa, wa).backward(gy)
    xr = x.detach().double().requires_grad_(True)
    wr = w.double().requires_grad_(True)
    var = xr.var(dim=1, keepdim=True, unbiased=False)
    (xr / torch.sqrt(var + 1e-5) * wr.reshape(1, -1, 1, 1)).backward(gy.double())
    assert xa.grad.dtype == dtype and wa.grad.dtype == torch.float32
    ulp = 0.0 if dtype == torch.float32 else 2 ** -8
    for got, ref in ((xa.grad, xr.grad), (wa.grad, wr.grad)):
        top = float(ref.abs().max())
        torch.testing.assert_close(got.double(), ref, rtol=1e-4 + ulp,
                                   atol=(1e-5 + ulp) * top)


@pytest.mark.parametrize("case", ["weight shape", "x not 4-D", "weight on another device"])
def test_the_refusals(case):
    x, w, _ = _inputs(8, 1)
    if case == "weight shape":
        w = torch.ones(9)
    elif case == "x not 4-D":
        x = x[0]
    else:
        w = w.to("meta")
    with pytest.raises(ValueError):
        biasfree_layernorm(x, w)


@pytest.mark.parametrize("case", ["44 channels", "uint8", "float16", "520 f32 channels"])
def test_a_card_tensor_the_kernels_do_not_take_is_refused(case):
    """On a card the kernels run, or the call is refused by name: C not a
    multiple of 8, a pixel past 2 KiB (1024 bf16 or 512 f32 channels), or a
    dtype other than f32 and bf16; a CPU tensor of any of these runs the
    composition."""
    dtype, c = {"44 channels": (torch.bfloat16, 44), "uint8": (torch.uint8, 48),
                "float16": (torch.float16, 48), "520 f32 channels": (torch.float32, 520)}[case]

    def x(device, dtype=dtype, c=c):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(4, c, 8, 8))

    assert layernorm.on_card(x("cpu")) is False
    with pytest.raises(ValueError, match=f"got {dtype} with {c} channels"):
        layernorm.on_card(x("cuda"))
    for width in WIDTHS + [8, 512]:
        for fit in (torch.bfloat16, torch.float32):
            assert layernorm.on_card(x("cuda", fit, width)) is True
    assert layernorm.on_card(x("cuda", torch.bfloat16, 1024)) is True


def test_the_forward_keeps_only_x_and_the_weight():
    """What the backward keeps: x (the caller holds it anyway) and the
    weight, no f32 copy of either; nothing under no_grad."""
    x, w, _ = _inputs(16, 2, torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        biasfree_layernorm(x, w)
    assert [(tuple(t.shape), t.dtype) for t in saved] == [(tuple(x.shape), torch.bfloat16),
                                                          ((16,), torch.float32)]
    saved.clear()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        biasfree_layernorm(x, w)
    assert saved == []


def test_torch_export_of_a_block_records_the_operator():
    """``torch.export`` of one transformer block records each of its two
    norms as one call of the operator, not the composition's ops."""
    torch.manual_seed(0)
    block = TransformerBlock(8, 1, 2.66).eval()
    x = torch.rand((1, 8, 16, 16)).contiguous(memory_format=torch.channels_last)
    program = torch.export.export(block, (x,))
    calls = [n for n in program.graph.nodes
             if n.target is torch.ops.eld_tpu_torch.biasfree_layernorm.default]
    assert len(calls) == 2
    with torch.no_grad():
        torch.testing.assert_close(program.module()(x), block(x), rtol=0, atol=0)


def test_an_exported_restormer_calls_the_norm_operator(tmp_path, monkeypatch):
    """A served artifact of the small Restormer runs its 16 norms as the
    operator's calls, each counted as a launch on the stand-in card."""
    model = _small().eval()
    path = str(tmp_path / "r.eldx")
    export.save_denoiser(path, model, 32, 32)
    fn, _ = export.load_denoiser(path, "cpu")
    install_fake_card(monkeypatch.setattr)
    monkeypatch.setattr(biasfree_layernorm, "launches", 0)
    x = torch.rand((2, 32, 32, 4), generator=torch.Generator().manual_seed(4))
    got = fn(x)
    assert biasfree_layernorm.launches == 2 * SMALL_BLOCKS
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=0, atol=1e-5)


def test_a_replayed_pooled_call_counts_four_norm_launches_a_block_and_step(monkeypatch):
    """Each transformer block's two norms are one launch forward and one
    backward each: 32 a step for the small Restormer's 8 blocks.  The eager
    call counts its own, the capture counts none and records what the graph
    holds, and each replay adds it."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    monkeypatch.setattr(biasfree_layernorm, "launches", 0)
    state = create_train_state(_small(), lr=1e-4)
    k = 2
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=k)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (6, 32, 32, 4), dtype=onp.uint16))}
    counts = []
    for call in range(4):  # eager, capture (replayed at once), two replays
        before = biasfree_layernorm.launches
        fn(state, pool, [steps.fold_in(3, k * call + j) for j in range(k)])
        counts.append(biasfree_layernorm.launches - before)
    (graph,) = fn.graphs.values()
    assert graph.launches[biasfree_layernorm] == 4 * SMALL_BLOCKS * k
    assert counts == [4 * SMALL_BLOCKS * k] * 4 and steps.graph_replays(fn) == 3
