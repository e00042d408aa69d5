"""Uformer (``models/uformer.py``) and its shifted-window attention
(``models/wmsa.py``) on the CPU: the port against the benchmark's plain
Uformer, ``benchmark/archs/uformer.py`` (f32, the authors' own form: roll,
partition, the modulator added, scores, bias, mask, softmax, reverse;
read by path and not edited), forward and in every parameter's gradient
with every parameter drawn (biases, bias tables and modulators included);
a shifted and an unshifted block, with and without the modulator; the
attention's shift-and-partition addressing and modulator table against the
authors' form; its plain backward against autograd of its composition; the
published widths' names, shapes and count at 4 -> 4 and 3 -> 3; the eval's
alignment padding; two pooled train steps; the registry's refusals; the
spatial forward refused; the attention's launches in a replayed pooled
call (through ``test_torch_fake_card.py``'s stand-in card) and in an
exported artifact; ``export_model`` and ``denoise`` taking ``--netG
uformer``.  The kernels themselves are held to the composition on the card
by ``tests/test_torch_cuda.py``.

Tolerances, f32 throughout: the port runs the reference's operations but
for the attention's backward, which is the kernels' algebra (rowsum(P ∘ dP)
in place of dO · O, the modulator as the table m Wᵀ added to q, k and v,
to_q and to_kv as one GEMM), so the two differ by summation order and a
few roundings: rtol 1e-4 with an atol of 1e-5 of the largest value (as the
Restormer tests), which a wrong term in any gradient exceeds by orders of
magnitude.
"""

import os
import sys
import types

import numpy as onp
import pytest
import torch
import torch.nn.functional as F

from eld_tpu_torch import export
from eld_tpu_torch.config import Config
from eld_tpu_torch.models import build_arch, wmsa
from eld_tpu_torch.models.uformer import LeWinTransformerBlock, Uformer
from eld_tpu_torch.models.wmsa import window_attention
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.tools import denoise, export_model
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.state import create_train_state
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card
from tests.tiff_fixture import make_dng

# the benchmark's modules import ``eldbench``; appended, so nothing of the repository's is shadowed
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "benchmark"))
from eldbench import manifest  # noqa: E402

reference = manifest.arch("uformer")

# embed_dim 16 with heads of 8 channels, windows of 4 at 64^2 (the bottleneck's map one window),
# layers of depth 2 where a block shifts, in the encoder and in the modulated decoder
SMALL = dict(embed_dim=16, depths=(1, 2, 1, 2, 2, 2, 1, 2, 1),
             num_heads=(2, 4, 8, 16, 32, 32, 16, 8, 4), win_size=4)
SMALL_BLOCKS = 14
PUBLISHED = dict(embed_dim=32, depths=(1, 2, 8, 8, 2, 8, 8, 2, 1),
                 num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8)


def _config(in_channels=4, out_channels=4, img_size=64, **widths):
    """The benchmark module's configuration keys for ``Uformer(in_channels,
    out_channels, **widths)`` at MLP ratio 4, its training crop
    ``img_size``."""
    return dict(widths, in_channels=in_channels, out_channels=out_channels, mlp_ratio=4,
                img_size=img_size, arch="uformer")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _array(shape, seed, scale=1.0):
    return torch.from_numpy(scale * onp.random.default_rng(seed).standard_normal(shape)
                            .astype(onp.float32))


def _draw(model, seed):
    """Every parameter drawn: weights and biases about 0.1, LayerNorm weights
    about 1, bias tables and modulators about 0.5."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.5 if name.endswith(("bias_table", "modulator.weight")) else 0.1
            p.copy_(scale * torch.randn(p.shape, generator=gen)
                    + (1.0 if ".norm" in name and name.endswith("weight") else 0.0))
    return model


def _small(seed=0, remat=False):
    return _draw(Uformer(4, 4, remat=remat, **SMALL), seed)


def _close(got, ref, name=""):
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()),
                               msg=name)


def _grads(fn, params, x, w):
    for p in params.values():
        p.grad = None
    y = fn(x)
    (y * w).sum().backward()
    return y.detach(), {n: p.grad.clone() for n, p in params.items()}


# ---- the model against the reference -----------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_uformer_equals_the_reference_forward_and_parameter_gradients(remat):
    model = _small(remat=remat).train()
    params = dict(model.named_parameters())
    x, w = _array((2, 64, 64, 4), 5), _array((2, 64, 64, 4), 6)
    y, g = _grads(model, params, x, w)
    y_ref, g_ref = _grads(lambda t: reference.forward(_config(**SMALL), params, t, "f32"),
                          params, x, w)
    _close(y, y_ref)
    assert g.keys() == g_ref.keys()
    assert sum(n.endswith("modulator.weight") for n in g) == 6
    for name, ref in g_ref.items():
        _close(g[name], ref, name)


@pytest.mark.parametrize("modulator", [False, True], ids=["encoder", "decoder"])
@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_a_block_equals_the_authors_form(shift, modulator):
    """One LeWin block (16 channels, 2 heads, windows of 4 over 8 x 12
    tokens) against the reference's block: the shift, the mask, the
    modulator, LeFF's biased depthwise conv."""
    block = _draw(LeWinTransformerBlock(16, 2, 4, shift, modulator), 3)
    params = {f"b.{n}": p for n, p in block.named_parameters()}
    x, w = _array((2, 8, 12, 16), 7), _array((2, 8, 12, 16), 8)
    y, g = _grads(block, params, x, w)
    y_ref, g_ref = _grads(lambda t: reference._block(params, "b", 2, 4, shift, modulator, "f32",
                                                     t), params, x, w)
    _close(y, y_ref)
    for name, ref in g_ref.items():
        _close(g[name], ref, name)


@pytest.mark.parametrize("modulator", [False, True], ids=["plain", "modulated"])
@pytest.mark.parametrize("shift", [0, 2], ids=["w", "sw"])
def test_the_attentions_addressing_and_table_equal_roll_partition_and_add(shift, modulator):
    """``window_attention`` over the qkv projection of the unshifted map,
    with the table m W_qkvᵀ, is the authors' form: roll the normed map,
    partition it, add m to every window, project, attend with the bias and
    the mask, reverse, roll back."""
    c, heads, win = 16, 2, 4
    x = _array((2, 8, 12, c), 1)
    wq, bq = _array((c, c), 2, 0.3), _array((c,), 3, 0.1)
    wkv, bkv = _array((2 * c, c), 4, 0.3), _array((2 * c,), 5, 0.1)
    table = _array(((2 * win - 1) ** 2, heads), 6, 0.5)
    m = _array((win * win, c), 7, 0.5) if modulator else None
    p = {"a.qkv.to_q.weight": wq, "a.qkv.to_q.bias": bq, "a.qkv.to_kv.weight": wkv,
         "a.qkv.to_kv.bias": bkv, "a.relative_position_bias_table": table,
         "a.proj.weight": torch.eye(c), "a.proj.bias": torch.zeros(c)}
    t = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    t = reference.window_partition(t, win).view(-1, win * win, c)
    if modulator:
        t = t + m
    mask = reference.shift_mask(8, 12, win, shift, "cpu") if shift else None
    ref = reference.window_reverse(reference._attention(p, "a", t, heads, win, mask, "f32")
                                   .view(-1, win, win, c), win, 8, 12)
    ref = torch.roll(ref, (shift, shift), (1, 2)) if shift else ref
    idx = reference.relative_position_index(win).view(-1)
    bias = table[idx].view(win * win, win * win, heads).permute(2, 0, 1)
    w_qkv = torch.cat([wq, wkv])
    got = window_attention(F.linear(x, w_qkv, torch.cat([bq, bkv])), bias,
                           None if m is None else m @ w_qkv.t(), heads, shift)
    _close(got, ref)


@pytest.mark.parametrize("modulator", [False, True], ids=["plain", "modulated"])
@pytest.mark.parametrize("shift", [0, 2], ids=["w", "sw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_attentions_backward_equals_autograd_of_its_composition(dtype, shift, modulator):
    """``plain_backward`` (the kernels' algebra) against autograd through the
    roll, the partition, the table, the scores, the bias, the mask, the
    softmax and P v in f64 on the same values.  f32: rtol 1e-4 and an atol
    of 1e-5 of the largest value; bf16: both read the same rounded input and
    the port rounds its f32 gradient once, one bf16 ulp (2^-7 of the
    largest); the bias's and the table's gradients stay f32."""
    n, h, w, heads, d, win = 2, 8, 12, 2, 8, 4
    c = heads * d
    qkv = _array((n, h, w, 3 * c), heads + shift).to(dtype)
    bias = _array((heads, win * win, win * win), 9, 0.5)
    table = _array((win * win, 3 * c), 10, 0.5) if modulator else None
    dout = _array((n, h, w, c), 11).to(dtype)
    x, b = qkv.detach().clone().requires_grad_(True), bias.clone().requires_grad_(True)
    t = None if table is None else table.clone().requires_grad_(True)
    window_attention(x, b, t, heads, shift).backward(dout)

    xr = qkv.detach().double().requires_grad_(True)
    br = bias.double().requires_grad_(True)
    tr = None if table is None else table.double().requires_grad_(True)
    xs = torch.roll(xr, (-shift, -shift), (1, 2)) if shift else xr
    win_x = wmsa.partition(xs, win) + (0 if tr is None else tr)
    q, k, v = win_x.reshape(-1, win * win, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = q @ k.transpose(-2, -1) * d ** -0.5 + br
    if shift:
        mask = wmsa.shift_mask(h, w, win, shift).double()
        s = (s.reshape(n, -1, heads, win * win, win * win) + mask[None, :, None]).reshape(s.shape)
    o = wmsa.reverse((s.softmax(-1) @ v).permute(0, 2, 1, 3).reshape(-1, win * win, c), n, h, w)
    o = torch.roll(o, (shift, shift), (1, 2)) if shift else o
    o.backward(dout.double())
    assert x.grad.dtype == dtype and b.grad.dtype == torch.float32
    if dtype == torch.float32:
        _close(x.grad, xr.grad.float())
    else:
        bound = float(xr.grad.abs().max()) * 2 ** -7
        assert float((x.grad.double() - xr.grad).abs().max()) <= bound
    _close(b.grad, br.grad.float())
    if modulator:
        _close(t.grad, tr.grad.float())


def test_the_attention_keeps_qkv_the_bias_the_table_and_the_lse():
    """What the backward keeps: qkv (already in memory), the bias, the
    table, and a log-sum-exp a window, head and query; nothing under
    no_grad."""
    heads, c, win = 2, 16, 4
    qkv = _array((2, 8, 8, 3 * c), 1).requires_grad_(True)
    bias = _array((heads, 16, 16), 2).requires_grad_(True)
    table = _array((16, 3 * c), 3).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        window_attention(qkv, bias, table, heads, 2)
    assert sorted(tuple(t.shape) for t in saved) == sorted(
        [tuple(qkv.shape), (heads, 16, 16), (16, 3 * c), (2 * 4, heads, win * win)])
    saved.clear()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        window_attention(qkv, bias, table, heads, 2)
    assert saved == []


@pytest.mark.parametrize("case", ["heads", "bias", "window", "shift", "table", "ndim"])
def test_the_attentions_refusals(case):
    qkv, bias, table, heads, shift = _array((2, 8, 8, 48), 1), torch.zeros((2, 16, 16)), None, 2, 0
    if case == "heads":
        heads = 5
    elif case == "bias":
        bias = torch.zeros((3, 16, 16))
    elif case == "window":
        bias = torch.zeros((2, 9, 9))  # windows of 3 do not divide 8
    elif case == "shift":
        shift = 4
    elif case == "table":
        table = torch.zeros((16, 47))
    else:
        qkv = qkv[0]
    with pytest.raises(ValueError):
        window_attention(qkv, bias, table, heads, shift)


@pytest.mark.parametrize("case", ["f32", "16 channels a head", "windows of 4", "shift 2",
                                  "frame"])
def test_a_card_tensor_the_kernels_do_not_take_is_refused(case):
    """On a card the kernels run bf16 qkv of head size 32 in windows of 8,
    shifted by 0 or 4, on frames of multiples of 8, or the call is refused
    by name; a CPU tensor of any of these runs the composition."""
    dtype, heads, c3, tok, shift, hw = {
        "f32": (torch.float32, 2, 192, 64, 0, 16), "16 channels a head": (torch.bfloat16, 4, 192,
                                                                          64, 0, 16),
        "windows of 4": (torch.bfloat16, 2, 192, 16, 0, 16),
        "shift 2": (torch.bfloat16, 2, 192, 64, 2, 16),
        "frame": (torch.bfloat16, 2, 192, 64, 0, 12)}[case]

    def qkv(device, dtype=dtype, c3=c3, hw=hw):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(2, hw, hw, c3))

    bias = types.SimpleNamespace(shape=(heads, tok, tok))
    assert wmsa.on_card(qkv("cpu"), bias, heads, shift) is False
    what = {"f32": "torch.float32", "frame": "12 x 12"}.get(case, case)
    with pytest.raises(ValueError, match=what):
        wmsa.on_card(qkv("cuda"), bias, heads, shift)
    fit = types.SimpleNamespace(shape=(2, 64, 64))
    assert wmsa.on_card(qkv("cuda", torch.bfloat16, 192, 16), fit, 2, 4) is True


def test_published_widths_names_shapes_and_count():
    """embed_dim 32, depths [1, 2, 8, 8, 2, 8, 8, 2, 1], heads [1, 2, 4, 8, 16,
    16, 8, 4, 2] at 4 -> 4 channels: the authors' names in their order,
    50,881,811 parameters (50,880,946 at the published 3 -> 3, the paper's
    50.88 M), 40 bias tables, 19 modulators (the decoder's), 18 shifted
    blocks, and a 128-pixel alignment."""
    model = build_arch("uformer", 4, 4, base_width=32)
    specs = reference.param_specs(_config(img_size=128, **PUBLISHED))
    assert [(n, tuple(t.shape)) for n, t in model.state_dict().items()] == specs
    assert sum(p.numel() for p in model.parameters()) == 50_881_811
    assert sum(onp.prod(s) for _, s in reference.param_specs(_config(3, 3, 128, **PUBLISHED))) \
        == 50_880_946
    assert len([n for n, _ in specs if n.endswith("bias_table")]) == 40
    assert len([n for n, _ in specs if n.endswith("modulator.weight")]) == 19
    blocks = [b for m in model.modules() if isinstance(m, LeWinTransformerBlock) for b in [m]]
    assert len(blocks) == 40 and sum(b.shift == 4 for b in blocks) == 18
    assert all(b.shift == 0 for b in model.conv.blocks)
    assert model.alignment() == 128


def test_eval_forward_pads_to_the_alignment():
    """A 60x70 frame runs as the edge-padded 64x128 crop (the small model's
    64 px alignment), cropped back."""
    model = _small().eval()
    assert model.alignment() == 64
    x = torch.rand((1, 60, 70, 4), generator=torch.Generator().manual_seed(2))
    fwd = steps.make_eval_forward(model)
    with torch.no_grad():
        padded = steps.edge_pad(x, 64, 128)
        torch.testing.assert_close(fwd(x), model(padded)[:, :60, :70], rtol=0, atol=0)


def test_make_train_scan_trains_a_small_uformer():
    """Two pooled calls of two steps on one patch: finite losses, and the
    second call's below the first's."""
    state = create_train_state(_small(), lr=1e-3)
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=2)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (1, 64, 64, 4), dtype=onp.uint16))}
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
    with pytest.raises(ValueError, match=f"uformer has no U-Net {name}"):
        build_arch("uformer", 4, 4, base_width=8, **option)
    build_arch("uformer", 4, 4, base_width=8, skip_mode="split", upsample="convt")


@pytest.mark.parametrize("arch", ["uformer", "restormer"])
def test_the_spatial_forward_is_refused_for_the_transformers(arch, tmp_path, monkeypatch):
    """``--mesh_spatial 2`` shards a frame into slabs with a halo, which a
    window's attention (Uformer) or an attention over every pixel
    (Restormer) crosses: the Engine refuses it by name before it runs."""
    from eld_tpu_torch.train import engine as engine_mod

    monkeypatch.setattr(engine_mod, "spatial_devices", lambda dev, s, cards: [dev] * s)
    cfg = Config(device="cpu", netG=arch, base_width=8, mesh_spatial=2, is_train=False,
                 no_log=True, no_verbose=True, checkpoints_dir=str(tmp_path), name=arch)
    monkeypatch.setattr(engine_mod.MeshSpec, "resolve",
                        lambda self, world, cards: types.SimpleNamespace(data=1, spatial=2))
    with pytest.raises(ValueError, match=f"{arch}.*--mesh_spatial 2"):
        Engine(cfg)


# ---- the launches ----------------------------------------------------------------------

def test_a_replayed_pooled_call_counts_two_attention_launches_a_block_and_step(monkeypatch):
    """Each LeWin block's attention is one launch forward and one backward: 28
    a step for the small Uformer's 14 blocks.  The eager call counts its
    own, the capture counts none and records what the graph holds, and each
    replay adds it."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    monkeypatch.setattr(window_attention, "launches", 0)
    state = create_train_state(_small(), lr=1e-4)
    k = 2
    fn = steps.make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                               batch=2, steps_per_call=k)
    pool = {"clean": torch.from_numpy(onp.random.default_rng(1).integers(
        0, 65535, (4, 64, 64, 4), dtype=onp.uint16))}
    counts = []
    for call in range(4):  # eager, capture (replayed at once), two replays
        before = window_attention.launches
        fn(state, pool, [steps.fold_in(3, k * call + j) for j in range(k)])
        counts.append(window_attention.launches - before)
    (graph,) = fn.graphs.values()
    assert graph.launches[window_attention] == 2 * SMALL_BLOCKS * k
    assert counts == [2 * SMALL_BLOCKS * k] * 4 and steps.graph_replays(fn) == 3


def test_an_exported_uformer_records_and_calls_the_window_attention(tmp_path, monkeypatch):
    """``torch.export`` of the small Uformer records the window attention as
    its operator, once a block, and the served artifact calls it (counted
    on the stand-in card) and equals the eager forward."""
    model = _small().eval()
    x = torch.rand((2, 64, 64, 4), generator=torch.Generator().manual_seed(4))
    ep = torch.export.export(model, (x,))
    targets = [n.target for n in ep.graph.nodes]
    assert targets.count(torch.ops.eld_tpu_torch.window_attention.default) == SMALL_BLOCKS
    assert targets.count(torch.ops.eld_tpu_torch.depthwise_conv3x3.default) == SMALL_BLOCKS
    with torch.no_grad():
        want = model(x)
    install_fake_card(monkeypatch.setattr)
    monkeypatch.setattr(window_attention, "launches", 0)
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(x), want, rtol=0, atol=1e-5)
    assert window_attention.launches == SMALL_BLOCKS


# ---- serving -------------------------------------------------------------------------

def _pt(tmp_path, model):
    path = str(tmp_path / "model_latest.pt")
    torch.save({"netG": model.state_dict(), "epoch": 3, "iterations": 30}, path)
    return path


def test_export_model_takes_uformer(tmp_path):
    """``export_model --netG uformer`` from a .pt at embed_dim 8 (the
    published depths, heads and windows, 8 channels a head): the artifact
    equals the eager forward on a 128^2 frame."""
    torch.manual_seed(0)
    model = build_arch("uformer", 4, 4, base_width=8).eval()
    out = str(tmp_path / "u.eldx")
    meta = export_model.main(["--model_path", _pt(tmp_path, model), "--netG", "uformer",
                              "--base_width", "8", "--height", "128", "--width", "128",
                              "--device", "cpu", "--out", out])
    assert meta["arch"] == "uformer"
    fn, _ = export.load_denoiser(out, "cpu")
    x = torch.rand((1, 128, 128, 4), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        torch.testing.assert_close(fn(x), model(x), rtol=0, atol=1e-5)


def test_denoise_takes_uformer(tmp_path):
    """``denoise --netG uformer`` over a DNG whose packed frame (36x40) is
    padded to the 128-pixel alignment: one PNG and the packed output,
    finite."""
    torch.manual_seed(0)
    model = build_arch("uformer", 4, 4, base_width=8).eval()
    raw = tmp_path / "a.dng"
    mosaic = (512 + onp.random.default_rng(0).random((72, 80)) * 40).astype(onp.uint16)
    raw.write_bytes(make_dng(mosaic, iso=1600, exposure=0.04))
    (rec,) = denoise.main(["--input", str(raw), "--ratio", "100", "--model_path",
                           _pt(tmp_path, model), "--netG", "uformer", "--base_width", "8",
                           "--device", "cpu", "--save_raw", "--out", str(tmp_path / "o")])
    packed = onp.load(rec["raw_output"])["packed"]
    assert packed.shape[:2] == (36, 40) and onp.isfinite(packed).all()
