"""Restormer (``models/restormer.py``) and its transposed attention
(``models/mdta.py``) on the CPU: the port against the benchmark's plain
Restormer, ``benchmark/archs/restormer.py`` (f32, the authors' formulas,
read by path and not edited), forward and in every parameter's gradient, the published widths' names, shapes and count, the eval
forward's alignment padding, two pooled train steps, the registry's
refusals, the serving CLIs, the attention's plain backward against
autograd of its composition, and the attention's launches in a replayed
pooled call (through ``test_torch_fake_card.py``'s stand-in card).  The
kernels themselves are held to the composition on the card by
``tests/test_torch_cuda.py``.

Tolerances, f32 throughout: the port runs the reference's operations but
for the attention's backward, which is the kernels' algebra (q̂·dq̂ from
the c x c matrices) rather than autograd's, and the LayerNorm's f32
cast; both differ from the reference by summation order and a few
roundings at most, so rtol 1e-4 with an atol of 1e-5 of the largest value
(as the U-Nets' tests), which a wrong term in any gradient exceeds by
orders of magnitude.
"""

import os
import sys
import types

import numpy as onp
import pytest
import torch

from eld_tpu_torch import export
from eld_tpu_torch.models import build_arch, mdta as attention
from eld_tpu_torch.models.mdta import mdta
from eld_tpu_torch.models.restormer import Restormer
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.tools import denoise, export_model
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.state import create_train_state
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card
from tests.tiff_fixture import make_dng

# the benchmark's modules import ``eldbench``; appended, so nothing of the repository's is shadowed
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "benchmark"))
from eldbench import manifest  # noqa: E402

reference = manifest.arch("restormer")

SMALL = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8))
SMALL_BLOCKS = 8  # 4 encoder levels, 2 decoder levels, decoder level 1, refinement
PUBLISHED = dict(dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4, heads=(1, 2, 4, 8))


def _config(in_channels=4, out_channels=4, **widths):
    """The benchmark module's configuration keys for ``Restormer(in_channels,
    out_channels, **widths)`` at the published expansion factor 2.66."""
    return dict(widths, in_channels=in_channels, out_channels=out_channels,
                ffn_expansion_factor=2.66)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _array(shape, seed):
    return torch.from_numpy(onp.random.default_rng(seed).standard_normal(shape)
                            .astype(onp.float32))


def _small(seed=0, remat=False):
    """A small Restormer with seeded weights: torch's default init for the
    convs, and the LayerNorm weights and temperatures drawn away from 1 so
    that their gradients are tested on something."""
    torch.manual_seed(seed)
    model = Restormer(4, 4, remat=remat, **SMALL)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("body.weight", "temperature")):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
    return model


def _close(got, ref, name=""):
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()),
                               msg=name)


# ---- the model against the reference -----------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_restormer_equals_the_reference_forward_and_parameter_gradients(remat):
    model = _small(remat=remat).train()
    x = _array((2, 32, 32, 4), 5)
    w = _array((2, 32, 32, 4), 6)
    runs = []
    for fn in (model, lambda t: reference.forward(_config(**SMALL), dict(model.named_parameters()),
                                                  t, "f32")):
        model.zero_grad()
        y = fn(x)
        (y * w).sum().backward()
        runs.append((y.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (y, g), (y_ref, g_ref) = runs
    _close(y, y_ref)
    assert g.keys() == g_ref.keys()
    assert sum(n.endswith("temperature") for n in g) == SMALL_BLOCKS
    for name, ref in g_ref.items():
        _close(g[name], ref, name)


def test_published_widths_names_shapes_and_count():
    """dim 48, blocks [4, 6, 6, 8], 4 refinement blocks, heads [1, 2, 4, 8],
    expansion 2.66 at 4 -> 4 channels: the authors' names in their order,
    26,112,964 parameters (26,111,668 at the published 3 -> 3)."""
    model = build_arch("restormer", 4, 4, base_width=48)
    specs = reference.param_specs(_config(**PUBLISHED))
    assert [(n, tuple(t.shape)) for n, t in model.state_dict().items()] == specs
    assert sum(p.numel() for p in model.parameters()) == 26_112_964
    assert sum(onp.prod(s) for _, s in reference.param_specs(_config(3, 3, **PUBLISHED))) \
        == 26_111_668
    assert len([n for n, _ in specs if n.endswith("temperature")]) == 44
    assert model.alignment() == 8


def test_eval_forward_pads_to_the_8px_alignment():
    """A 36x44 frame runs as the edge-padded 40x48 crop, cropped back."""
    model = _small().eval()
    x = torch.rand((1, 36, 44, 4), generator=torch.Generator().manual_seed(2))
    fwd = steps.make_eval_forward(model)
    with torch.no_grad():
        padded = steps.edge_pad(x, 40, 48)
        torch.testing.assert_close(fwd(x), model(padded)[:, :36, :44], rtol=0, atol=0)


def test_make_train_scan_trains_a_small_restormer():
    """Two pooled calls of two steps on one patch: finite losses, and the
    second call's below the first's."""
    state = create_train_state(_small(), lr=1e-3)
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=2)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (1, 32, 32, 4), dtype=onp.uint16))}
    means = []
    for call in range(2):
        metrics = fn(state, pool, [steps.fold_in(3, 2 * call + j) for j in range(2)])
        assert bool(torch.isfinite(fn.losses).all())
        means.append(float(metrics["Pixel"]))
    assert state.step == 4 and means[1] < means[0]


@pytest.mark.parametrize("option", [{"skip_mode": "concat"}, {"upsample": "d2s"},
                                    {"skip_dtype": torch.bfloat16}],
                         ids=["skip_mode", "upsample", "skip_dtype"])
def test_the_registry_refuses_the_unets_options_by_name(option):
    name = next(iter(option))
    with pytest.raises(ValueError, match=f"restormer has no U-Net {name}"):
        build_arch("restormer", 4, 4, base_width=8, **option)
    build_arch("restormer", 4, 4, base_width=8, skip_mode="split", upsample="convt")


# ---- the attention: plain backward, what it keeps, the launches ---------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,c", [(1, 8), (2, 16), (4, 48)])
def test_the_attentions_backward_equals_autograd_of_its_composition(heads, c, dtype):
    """``plain_backward`` (the kernels' algebra) against autograd through
    ``F.normalize``, the Gram, the softmax and A v in f32, on the same
    values; one q channel and one k channel all zero, where the norm's
    clamp passes no gradient to the norm and the channel's gradient is
    dq̂ / eps (1e7-1e12 here), compared relatively.  Elsewhere, f32 sums in
    other orders: rtol 1e-4 and an atol of 1e-5 of the largest value; in
    bf16 both read the same rounded input and the port rounds its f32
    gradient once: one bf16 ulp (2^-8 relative, 2^-7 of the largest)."""
    n, h, w = 2, 6, 5
    zero = [0, heads * c + 1]  # q's channel 0, k's channel 1
    qkv = _array((n, h, w, 3 * heads * c), heads + c).to(dtype)
    qkv[..., zero] = 0
    temp = (0.5 + torch.rand((heads, 1, 1), generator=torch.Generator().manual_seed(c)))
    dout = _array((n, h, w, heads * c), 9).to(dtype)
    x = qkv.detach().clone().requires_grad_(True)
    t = temp.clone().requires_grad_(True)
    mdta(x, t, heads).backward(dout)

    xr = qkv.detach().float().requires_grad_(True)
    tr = temp.clone().requires_grad_(True)
    q, k, v = (part.reshape(n, h * w, heads, c).permute(0, 2, 3, 1)
               for part in xr.chunk(3, dim=-1))
    q, k = torch.nn.functional.normalize(q, dim=-1), torch.nn.functional.normalize(k, dim=-1)
    out = ((q @ k.transpose(-2, -1)) * tr).softmax(-1) @ v
    out.permute(0, 3, 1, 2).reshape(n, h, w, heads * c).backward(dout.float())
    assert x.grad.dtype == dtype and t.grad.dtype == torch.float32
    rest = [i for i in range(3 * heads * c) if i not in zero]
    got, ref = x.grad.float(), xr.grad
    assert float(ref[..., zero].abs().min()) > 1e6
    if dtype == torch.float32:
        _close(got[..., rest], ref[..., rest])
        torch.testing.assert_close(got[..., zero], ref[..., zero], rtol=1e-4, atol=0)
    else:
        bound = float(ref[..., rest].abs().max()) * 2 ** -7
        assert float((got[..., rest] - ref[..., rest]).abs().max()) <= bound
        torch.testing.assert_close(got[..., zero], ref[..., zero], rtol=2 ** -8, atol=0)
    _close(t.grad, tr.grad)


def test_the_attention_keeps_qkv_and_three_small_matrices():
    """What the backward keeps: qkv (already in memory) and, a head, A,
    q̂ k̂ᵀ (c x c) and the norms (2 x c); the temperature; nothing under
    no_grad."""
    heads, c = 2, 8
    qkv = _array((2, 4, 4, 3 * heads * c), 1).requires_grad_(True)
    temp = torch.ones((heads, 1, 1), requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        mdta(qkv, temp, heads)
    shapes = sorted(tuple(t.shape) for t in saved)
    assert shapes == sorted([tuple(qkv.shape), (heads, 1, 1), (2, heads, c, c),
                             (2, heads, c, c), (2, heads, 2, c)])
    saved.clear()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        mdta(qkv, temp, heads)
    assert saved == []


@pytest.mark.parametrize("case", ["heads", "temperature", "ndim"])
def test_the_attentions_refusals(case):
    qkv, temp, heads = _array((2, 4, 4, 48), 1), torch.ones((2, 1, 1)), 2
    if case == "heads":
        heads = 5
    elif case == "temperature":
        temp = torch.ones((3, 1, 1))
    else:
        qkv = qkv[0]
    with pytest.raises(ValueError):
        mdta(qkv, temp, heads)


def test_the_kernels_apply_to_bf16_head_sizes_48_and_96_on_a_card():
    """The dispatch: the card's kernels for bf16 qkv of head size 48 or 96,
    the composition elsewhere (a CPU tensor, f32, another head size); and
    the chunk plan at the cell's level 1 and at a ragged latent."""
    def qkv(device="cuda", dtype=torch.bfloat16, channels=3 * 96):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(4, 8, 8, channels))

    assert attention.kernel_applies(qkv(), 1) and attention.kernel_applies(qkv(), 2)
    assert not attention.kernel_applies(qkv(device="cpu"), 1)
    assert not attention.kernel_applies(qkv(dtype=torch.float32), 1)
    assert not attention.kernel_applies(qkv(), 3)  # 32 channels a head
    assert not attention.kernel_applies(qkv(channels=3 * 64), 1)
    chunks, chunk_len, tile_blocks = attention.plan(4, 1, 256 * 256, 132)
    assert (chunks, chunk_len, tile_blocks) == (64, 32 * 32, 66)
    assert chunks * chunk_len >= 256 * 256 > (chunks - 1) * chunk_len
    assert attention.plan(4, 8, 30, 132) == (1, 32, 1)


@pytest.mark.parametrize("case", ["f32", "32 channels a head", "64 channels a head"])
def test_a_card_tensor_the_kernels_do_not_take_is_refused(case):
    """On a card the kernels run, or the call is refused by name: an f32
    ``qkv`` (Restormer without ``--bf16``) or a head size other than 48 and
    96 (another ``--base_width``) raises, where a CPU tensor of any dtype
    and head size runs the composition."""
    dtype, heads, channels = {"f32": (torch.float32, 1, 3 * 48),
                              "32 channels a head": (torch.bfloat16, 3, 3 * 96),
                              "64 channels a head": (torch.bfloat16, 1, 3 * 64)}[case]

    def qkv(device):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(4, 8, 8, channels))

    assert attention.on_card(qkv("cpu"), heads) is False
    with pytest.raises(ValueError, match=f"{dtype} with {channels // 3 // heads} channels"):
        attention.on_card(qkv("cuda"), heads)
    fit = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.bfloat16,
                                shape=(4, 8, 8, 3 * 96))
    assert attention.on_card(fit, 1) is True and attention.on_card(fit, 2) is True


def test_a_replayed_pooled_call_counts_two_attention_launches_a_block_and_step(monkeypatch):
    """Each transformer block's attention is one launch forward and one
    backward: 16 a step for the small Restormer's 8 blocks.  The eager call
    counts its own, the capture counts none and records what the graph
    holds, and each replay adds it."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    monkeypatch.setattr(mdta, "launches", 0)
    state = create_train_state(_small(), lr=1e-4)
    k = 2
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=k)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (6, 32, 32, 4), dtype=onp.uint16))}
    counts = []
    for call in range(4):  # eager, capture (replayed at once), two replays
        before = mdta.launches
        fn(state, pool, [steps.fold_in(3, k * call + j) for j in range(k)])
        counts.append(mdta.launches - before)
    (graph,) = fn.graphs.values()
    assert graph.launches[mdta] == 2 * SMALL_BLOCKS * k
    assert counts == [2 * SMALL_BLOCKS * k] * 4 and steps.graph_replays(fn) == 3


# ---- serving -------------------------------------------------------------------------

def _pt(tmp_path, model):
    path = str(tmp_path / "model_latest.pt")
    torch.save({"netG": model.state_dict(), "epoch": 3, "iterations": 30}, path)
    return path


def test_export_model_takes_restormer_and_the_artifact_calls_the_attention(tmp_path,
                                                                           monkeypatch):
    """``export_model --netG restormer`` from a .pt: the artifact records
    the attention as its operator (one call a block) and equals the eager
    forward."""
    torch.manual_seed(0)
    model = build_arch("restormer", 4, 4, base_width=8).eval()
    out = str(tmp_path / "r.eldx")
    meta = export_model.main(["--model_path", _pt(tmp_path, model), "--netG", "restormer",
                              "--base_width", "8", "--height", "32", "--width", "40",
                              "--device", "cpu", "--out", out])
    assert meta["arch"] == "restormer"
    fn, _ = export.load_denoiser(out, "cpu")
    x = torch.rand((2, 32, 40, 4), generator=torch.Generator().manual_seed(4))
    install_fake_card(monkeypatch.setattr)
    monkeypatch.setattr(mdta, "launches", 0)
    got = fn(x)
    assert mdta.launches == 44
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=0, atol=1e-5)


def test_denoise_takes_restormer(tmp_path):
    """``denoise --netG restormer`` over a DNG whose packed frame (36x40) is
    not 8-aligned in width: one PNG and the packed output, finite."""
    torch.manual_seed(0)
    model = build_arch("restormer", 4, 4, base_width=8).eval()
    raw = tmp_path / "a.dng"
    mosaic = (512 + onp.random.default_rng(0).random((72, 80)) * 40).astype(onp.uint16)
    raw.write_bytes(make_dng(mosaic, iso=1600, exposure=0.04))
    (rec,) = denoise.main(["--input", str(raw), "--ratio", "100", "--model_path",
                           _pt(tmp_path, model), "--netG", "restormer", "--base_width", "8",
                           "--device", "cpu", "--save_raw", "--out", str(tmp_path / "o")])
    packed = onp.load(rec["raw_output"])["packed"]
    assert packed.shape[:2] == (36, 40) and onp.isfinite(packed).all()
