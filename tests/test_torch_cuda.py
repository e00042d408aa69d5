"""The port's noise kernel (and its device-seed entry), the conv epilogue's
kernels, Restormer's attention (MDTA), LayerNorm and depthwise convolution
kernels (the latter with Uformer's bias too), Uformer's shifted-window
attention kernels, pooled trainer
and per-step train step (and their CUDA graphs against the eager
paths, one process and data-parallel in a world-1 NCCL group), eval
forward (and its CUDA graph), ISP, serving
artifacts, spatial forward, data-parallel picks, asynchronous saves, the
synthetic demo, apply_noise, the demosaic and the benchmark tools on the
card (marked ``cuda``; skipped where there is none).

This file imports neither JAX nor eld_tpu, so it runs on a machine that
has the card and torch but not the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import copy
import socket

import numpy as onp
import pytest
import torch
import torch.distributed as dist

from eld_tpu_torch import export
from eld_tpu_torch.config import Config
from eld_tpu_torch.core import emor, isp
from eld_tpu_torch.data.loader import pool_to_device
from eld_tpu_torch.data.patchstore import PatchStore, PatchStoreWriter
from eld_tpu_torch.models import build_arch, dwconv, epilogue, layernorm, wmsa
from eld_tpu_torch.models import mdta as attention
from eld_tpu_torch.models.dwconv import depthwise_conv3x3
from eld_tpu_torch.models.epilogue import bias_lrelu
from eld_tpu_torch.models.layernorm import biasfree_layernorm
from eld_tpu_torch.models.mdta import mdta
from eld_tpu_torch.models.wmsa import window_attention
from eld_tpu_torch.noise.kernels import kernel_draws, seed_tensor, synthesize_kernel
from eld_tpu_torch.noise.model import noise_core
from eld_tpu_torch.noise.params import load_camera_params, sample_params_batch
from eld_tpu_torch.parallel.mesh import rank_rows
from eld_tpu_torch.parallel.multihost import initialize_multihost
from eld_tpu_torch.parallel.spatial import make_spatial_forward
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.state import create_train_state, set_learning_rate
from eld_tpu_torch.train.steps import (
    fold_in,
    graph_replays,
    make_eval_forward,
    make_train_scan,
    make_train_step,
    pick_batch,
)
from tests.kernel_helpers import kernel_operator_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the noise kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(device, shape, seed=0):
    bank = load_camera_params(include=4, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    clean = torch.rand(shape, generator=gen, device=device)
    return clean, sample_params_batch(gen, bank, shape[0])


MODELS = ["g", "p", "pg", "Pg", "G", "r", "q", "c", "eld", "Pgrqc"]
# the test shape; ragged (odd H and W); one pixel per row; 9 channels;
# rows wider than a block (several pixels per thread); 3 channels (the
# sRGB stage); one ragged channel
SHAPES = [(2, 64, 48, 4), (3, 37, 53, 4), (2, 5, 1, 4), (2, 33, 31, 9), (1, 3, 1100, 4),
          (2, 64, 48, 3), (3, 37, 53, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("model", MODELS)
def test_kernel_equals_core_on_its_draws(cuda_device, model, shape):
    """The kernel equals noise_core fed the kernel's own draws: the same
    IEEE f32 operations in the same order (atol 1e-5; 0 expected)."""
    clean, p = _batch(cuda_device, shape)
    out = synthesize_kernel(99, clean, p, model, clip=False)
    ref = noise_core(clean, p, model, kernel_draws(99, clean.shape, model, cuda_device))
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_misaligned_batch_gives_the_same_output(cuda_device):
    """A C = 4 batch that does not start on 16 bytes takes the kernel's
    scalar path: bit-identical to the aligned (float4) path."""
    clean, p = _batch(cuda_device, (2, 37, 53, 4))
    buf = torch.empty(clean.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(clean.shape)
    shifted.copy_(clean)
    assert shifted.data_ptr() % 16 != 0
    for model in ("eld", "Pg"):
        a = synthesize_kernel(5, clean, p, model)
        b = synthesize_kernel(5, shifted, p, model)
        assert torch.equal(a, b), model


@pytest.mark.cuda
def test_kernel_counts_launches_and_distinct_seeds(cuda_device):
    clean, p = _batch(cuda_device, (2, 32, 32, 9))
    before = synthesize_kernel.launches
    a = synthesize_kernel(1, clean, p, "eld", clip=False)
    b = synthesize_kernel(2, clean, p, "eld", clip=False)
    assert synthesize_kernel.launches == before + 2
    assert float((a == b).float().mean()) < 1e-3
    assert bool(torch.isfinite(a).all())


@pytest.mark.cuda
def test_kernel_row_structure_and_clip_on_a_ragged_shape(cuda_device):
    """Model 'r' on a constant ragged batch: the noise is constant along
    each packed row, channels (0, 1) share the even draw and (2, 3) the odd
    one; with the full model, clip=True stays in [0, 1] while clip=False
    keeps the noise floor below 0."""
    shape = (3, 37, 53, 4)
    _, p = _batch(cuda_device, shape)
    half = torch.full(shape, 0.5, device=cuda_device)
    e = synthesize_kernel(3, half, p, "r", clip=False) - half
    assert bool((e == e[:, :, :1, :]).all())
    assert bool((e[..., 0] == e[..., 1]).all() and (e[..., 2] == e[..., 3]).all())
    assert float((e[..., 0] == e[..., 2]).float().mean()) < 0.05
    dark = torch.zeros(shape, device=cuda_device)
    clipped = synthesize_kernel(5, dark, p, "eld", clip=True)
    raw = synthesize_kernel(5, dark, p, "eld", clip=False)
    assert float(clipped.min()) >= 0 and float(clipped.max()) <= 1
    assert float(raw.min()) < 0


@pytest.mark.cuda
def test_pooled_trainer_launches_the_noise_kernel_once_per_step(cuda_device, tmp_path):
    recs = onp.random.default_rng(7).integers(0, 65535, (6, 32, 32, 4), dtype=onp.uint16)
    with PatchStoreWriter(str(tmp_path / "s"), recs.shape[1:], recs.dtype) as w:
        for r in recs:
            w.append(r)
    pool = {"clean": pool_to_device(PatchStore(str(tmp_path / "s")), cuda_device)}
    eng = Engine(Config(device="cuda", noise="eld", include=4, base_width=4, batch_size=2,
                        is_train=True, checkpoints_dir=str(tmp_path), name="p",
                        no_verbose=True, no_log=True))
    before = synthesize_kernel.launches
    eng.train_pool(pool, steps=5, steps_per_call=3)
    assert synthesize_kernel.launches - before == eng.iterations == 5
    assert all(onp.isfinite(h[1]["Pixel"]) for h in eng.history)


@pytest.mark.cuda
@pytest.mark.parametrize("chop", [False, True], ids=["pad", "chop"])
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_eval_forward_on_the_card_matches_the_cpu(cuda_device, arch, chop):
    """The same weights on the card (f32, TF32 off) and on the CPU, on a
    frame aligned to neither 16 nor 32: within 1e-4 (cuDNN's summation
    order)."""
    torch.manual_seed(0)
    model = build_arch(arch, 4, 4, base_width=8, skip_mode="split")
    x = torch.from_numpy(onp.random.default_rng(1).random((1, 72, 88, 4), dtype=onp.float32))
    cpu = make_eval_forward(model, chop=chop)(x)
    card = make_eval_forward(copy.deepcopy(model).to(cuda_device), chop=chop)(x.to(cuda_device))
    assert float((card.cpu() - cpu).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("render", ["gamma", "crf"])
def test_isp_on_the_card_matches_the_cpu(cuda_device, render):
    """process on the card against the CPU: 8-bit codes equal except at most
    0.1%, which differ by one (pow/interp an ulp apart)."""
    rng = onp.random.default_rng(2)
    raw = torch.from_numpy(rng.random((2, 64, 96, 4), dtype=onp.float32))
    wb = torch.from_numpy(rng.uniform(1, 2.5, (2, 4)).astype(onp.float32))
    ccm = torch.from_numpy((onp.eye(3) + rng.normal(0, 0.2, (2, 3, 3))).astype(onp.float32))
    crf = emor.load_crf() if render == "crf" else None
    cpu = isp.process(raw, wb, ccm, crf=crf)
    card = isp.process(raw.to(cuda_device), wb.to(cuda_device), ccm.to(cuda_device), crf=crf)
    codes = torch.round((card.cpu().double() - cpu.double()) * 255)
    assert float(codes.abs().max()) <= 1 and float((codes != 0).double().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_artifact_exported_on_the_cpu_serves_on_the_card(cuda_device, tmp_path, quantize):
    """An artifact traced on the CPU, loaded on the card: equal to the CPU
    load within 1e-4 (cuDNN's summation order), batches of 1 and 3."""
    torch.manual_seed(0)
    model = build_arch("unet", 4, 4, base_width=8, skip_mode="split").eval()
    path = str(tmp_path / "a.eldx")
    meta = export.save_denoiser(path, model, 64, 96, quantize=quantize)
    assert meta["device"] == "cpu"
    on_cpu, _ = export.load_denoiser(path, "cpu")
    on_card, _ = export.load_denoiser(path, cuda_device)
    for n in (1, 3):
        x = torch.from_numpy(onp.random.default_rng(n).random((n, 64, 96, 4), dtype=onp.float32))
        got = on_card(x.to(cuda_device))
        assert got.device.type == "cuda"
        assert float((got.cpu() - on_cpu(x)).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4])
def test_spatial_forward_on_the_card(cuda_device, s):
    """The halo-sharded forward over S replicas on the one card: within the
    chop protocol's bound (mean 1e-3) of the eager forward, and equal to
    the same sharding on the CPU within 1e-4 (cuDNN's summation order)."""
    torch.manual_seed(0)
    model = build_arch("unet", 4, 4, base_width=8, skip_mode="split").eval()
    x = torch.from_numpy(onp.random.default_rng(3).random((1, 232, 344, 4), dtype=onp.float32))
    cpu = make_spatial_forward(model, ["cpu"] * s, base=model.alignment())(x)
    card_model = copy.deepcopy(model).to(cuda_device)
    card = make_spatial_forward(card_model, [cuda_device] * s, base=model.alignment())(
        x.to(cuda_device))
    eager = make_eval_forward(card_model)(x.to(cuda_device))
    assert card.shape == x.shape and card.device.type == "cuda"
    assert float((card - eager).abs().mean()) < 1e-3
    assert float((card.cpu() - cpu).abs().max()) < 1e-4


@pytest.mark.cuda
def test_rank_rows_of_a_pooled_batch_on_the_card(cuda_device):
    recs = onp.random.default_rng(8).integers(0, 65535, (6, 16, 16, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    full = pick_batch(pool, 4, 123)["clean"]
    for r in range(2):
        assert torch.equal(pick_batch(pool, 4, 123, rank_rows(r, 2, 4))["clean"],
                           full[2 * r:2 * r + 2])


@pytest.mark.cuda
def test_async_save_on_the_card_writes_the_state_of_the_call(cuda_device, tmp_path):
    """The background write holds the parameters and Adam state of the
    save() call, though two more steps updated them in place on the card
    before it landed."""
    recs = onp.random.default_rng(7).integers(0, 65535, (6, 32, 32, 4), dtype=onp.uint16)
    with PatchStoreWriter(str(tmp_path / "s"), recs.shape[1:], recs.dtype) as w:
        for r in recs:
            w.append(r)
    pool = {"clean": pool_to_device(PatchStore(str(tmp_path / "s")), cuda_device)}
    eng = Engine(Config(device="cuda", noise="eld", include=4, base_width=8, batch_size=2,
                        is_train=True, checkpoints_dir=str(tmp_path), name="a",
                        no_verbose=True, no_log=True))
    eng.train_pool(pool, steps=2, steps_per_call=2)
    want = {k: v.detach().cpu().clone() for k, v in eng.model.state_dict().items()}
    want_opt = {i: {k: t.detach().cpu().clone() for k, t in st.items()}
                for i, st in eng.state.optimizer.state_dict()["state"].items()}
    path = eng.save(label="async")
    eng.train_pool(pool, steps=2, steps_per_call=2)
    ckpt.wait_for_saves()
    got = torch.load(path, weights_only=True)
    assert all(torch.equal(got["netG"][k], v) for k, v in want.items())
    assert all(torch.equal(got["opt_g"]["state"][i][k], t)
               for i, st in want_opt.items() for k, t in st.items())
    assert got["iterations"] == 2
    assert not all(torch.equal(v, eng.model.state_dict()[k].cpu()) for k, v in want.items())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--scan", "2"]], ids=["per_step", "scan"])
def test_demo_synthetic_launches_the_kernel_once_per_step(cuda_device, extra):
    from eld_tpu_torch.tools import demo_synthetic

    before = synthesize_kernel.launches
    rec = demo_synthetic.main(["--size", "64", "--n_train", "8", "--batch", "2", "--steps", "4"]
                              + extra)
    assert synthesize_kernel.launches - before == 4
    assert onp.isfinite(rec["final_loss"]) and onp.isfinite(rec["mid_gain_db"])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["PGrq", "eld"])
def test_apply_noise_on_the_card_equals_the_cpu_on_the_same_draws(cuda_device, model):
    """apply_noise on the card against noise_core on the CPU fed the very
    draws the card's generator made: equal within 1e-5 on >= 99.9% of the
    elements, and never more than one Poisson count apart (exp rounds
    differently on the two devices)."""
    from eld_tpu_torch.noise.model import apply_noise, sample_draws
    from eld_tpu_torch.tools.demo_synthetic import calibrated_params

    p = calibrated_params(load_camera_params(include=4, device=cuda_device), 200)
    y = torch.rand((64, 48, 4), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    got = apply_noise(torch.Generator(device=cuda_device).manual_seed(5), y, p, model)
    one = type(p)(**{k: v.reshape(1, -1) for k, v in vars(p).items()})
    draws = sample_draws(torch.Generator(device=cuda_device).manual_seed(5), y[None], one, model)
    want = noise_core(y[None].cpu(), type(p)(**{k: v.cpu() for k, v in vars(one).items()}),
                      model, {k: v.cpu() for k, v in draws.items()})[0]
    diff = (got.cpu() - want).abs()
    count = float(p.K * p.ratio / p.saturation_level)
    assert float((diff <= 1e-5).float().mean()) >= 0.999
    assert float(diff.max()) <= count + 1e-5


@pytest.mark.cuda
def test_demosaic_mhc_on_the_card_equals_the_cpu(cuda_device):
    from eld_tpu_torch.core.demosaic import demosaic_mhc, render_preview

    x = torch.rand((96, 128, 4), generator=torch.Generator().manual_seed(2))
    assert float((demosaic_mhc(x.to(cuda_device)).cpu() - demosaic_mhc(x)).abs().max()) <= 1e-5
    wb, ccm = [2.0, 1.0, 1.5, 1.0], torch.eye(3)
    card = render_preview(x.to(cuda_device) * 0.3, wb, ccm, half_size=False)
    assert float((card.cpu() - render_preview(x * 0.3, wb, ccm, half_size=False)).abs().max()) \
        <= 1.0 / 255 + 1e-6


@pytest.mark.cuda
def test_bench_variants_train_child_launches_the_kernel_once_per_step(cuda_device, monkeypatch,
                                                                      capsys):
    """A train child at eld_tpu's smoke size on the card: K1 once per step
    (1 counted, 3 warmup, 2 x 10 timed)."""
    from eld_tpu_torch.tools import bench_variants

    for name, value in {"_SMOKE": True, "PATCH": 64, "BATCH": 2}.items():
        monkeypatch.setattr(bench_variants, name, value)
    rec = bench_variants._child(["train", "unet_s2d", "split", "convt"], "cuda")
    assert rec["k1_launches"] == rec["steps"] == 24
    assert rec["patches_per_sec"] > 0


@pytest.mark.cuda
def test_roofline_on_the_card_counts_the_cpus_flops(cuda_device):
    """The card's step counts the FLOPs the CPU's does, K1's bytes are
    added by hand, and the MFU lies in (0, 100]."""
    from eld_tpu_torch.tools import roofline

    argv = ["--arch", "unet", "--batch", "2", "--patch", "64"]
    card = roofline.main(argv + ["--steps", "3", "--device", "cuda"])
    cpu = roofline.main(argv + ["--no-run", "--device", "cpu"])
    assert card["flops_per_step"] == cpu["flops_per_step"]
    assert 0 < card["mfu_pct"] <= 100
    assert card["noise_impl"] == "kernel" and cpu["noise_impl"] == "plain"
    assert card["k1_bytes_per_step"] == 2 * 2 * 64 * 64 * 4 * 4 + 2 * 12 * 4


@pytest.mark.cuda
def test_step_cost_counts_each_kernel_operator_once_on_the_card(cuda_device):
    """On the card the operators launch the kernels, and ``step_cost`` counts
    each one's inputs and outputs once, as on the CPU."""
    from eld_tpu_torch.tools import roofline

    step, want = kernel_operator_step(cuda_device)
    before = bias_lrelu.launches, biasfree_layernorm.launches
    cost = roofline.step_cost(step, None, {"clean": torch.zeros((2, 8, 8, 4))})
    assert (bias_lrelu.launches - before[0], biasfree_layernorm.launches - before[1]) == (2, 2)
    assert cost["bytes_per_step"] == want and cost["k1_launches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_device_seed_equals_host_seed(cuda_device, shape):
    """K1's device-seed entry (the seed a one-element int64 tensor on the
    card) gives the host-seed entry's output bit for bit, for seeds below
    and above 2^63, on the float4 and the scalar path."""
    clean, p = _batch(cuda_device, shape)
    for seed in (99, 0x1234_5678_9ABC_DEF0, (1 << 63) + 5):
        for model in ("eld", "Pg", "r"):
            a = synthesize_kernel(seed, clean, p, model)
            b = synthesize_kernel(seed_tensor(seed, cuda_device), clean, p, model)
            assert torch.equal(a, b), (seed, model)


@pytest.mark.cuda
def test_a_graph_of_a_device_seed_launch_draws_each_new_seed(cuda_device):
    """A captured device-seed launch reads its seed when it runs: each
    replay after a new seed is written to the buffer equals the host-seed
    launch of that seed."""
    clean, p = _batch(cuda_device, (2, 64, 48, 4))
    buf = seed_tensor(0, cuda_device)
    synthesize_kernel(buf, clean, p, "eld")  # the library is built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = synthesize_kernel(buf, clean, p, "eld")
    for seed in (5, 6, (1 << 63) + 1):
        buf.copy_(seed_tensor(seed, cuda_device))
        graph.replay()
        assert torch.equal(out, synthesize_kernel(seed, clean, p, "eld"))


# (K, the rate set before the call): K = 3 eager, captured and replayed,
# replayed at rate 0; K = 2 eager back at 1e-4, then captured and replayed
_GRAPH_CALLS = ((3, None), (3, None), (3, 0.0), (2, 1e-4), (2, None))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_captured_pooled_calls_equal_the_eager_loop(cuda_device, tmp_path, arch):
    """The Engine's pooled trainer on the card replays one CUDA graph per
    (K, batch) from its second call; against make_train_scan(capture=False)
    from the same weights, pool and seeds, every call's K losses and the
    parameters are equal bit for bit (cuDNN held to deterministic
    algorithms), and so are state.step and K1's launches; a rate set
    between calls holds in the replay (at rate 0 it moves nothing)."""
    _captured_pooled_calls_equal_the_eager_loop(cuda_device, tmp_path, arch, 8)


@pytest.mark.cuda
def test_captured_pooled_restormer_calls_equal_the_eager_loop(cuda_device, tmp_path):
    """The same for Restormer at its published widths (dim 48, so the MDTA
    kernels run, inside the graph): bit for bit, the kernels having no
    float atomics."""
    _captured_pooled_calls_equal_the_eager_loop(cuda_device, tmp_path, "restormer", 48)


@pytest.mark.cuda
def test_captured_pooled_uformer_calls_equal_the_eager_loop(cuda_device, tmp_path):
    """The same for Uformer-B at its published widths (embed_dim 32, so the
    window-attention kernels run inside the graph) on 128^2 patches, its
    alignment: bit for bit, no kernel of its step having float atomics."""
    _captured_pooled_calls_equal_the_eager_loop(cuda_device, tmp_path, "uformer", 32, 128)


def _captured_pooled_calls_equal_the_eager_loop(cuda_device, tmp_path, arch, width, patch=64):
    recs = onp.random.default_rng(3).integers(0, 65535, (6, patch, patch, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for arm in ("eager", "graph"):
            eng = Engine(Config(device="cuda", netG=arch, noise="eld", include=4,
                                base_width=width, batch_size=2, bf16=True, is_train=True,
                                no_log=True, no_verbose=True, checkpoints_dir=str(tmp_path),
                                name=arm))
            eager = {k: make_train_scan(eng.model, noise_model="eld", bank=eng.bank, batch=2,
                                        steps_per_call=k, autocast_dtype=torch.bfloat16,
                                        capture=False) for k in (3, 2)}
            before = synthesize_kernel.launches
            losses = []
            for k, lr in _GRAPH_CALLS:
                if lr is not None:
                    set_learning_rate(eng.state, lr)
                fn = eng._scan_fn(k) if arm == "graph" else eager[k]
                params = [p.detach().clone() for p in eng.model.parameters()]
                fn(eng.state, pool, [fold_in(1, eng.iterations + j) for j in range(k)])
                losses.append(fn.losses.cpu())
                still = all(torch.equal(a, b) for a, b in zip(params, eng.model.parameters()))
                assert still == (lr == 0.0), (arm, k, lr)
            replays = sum(c.replays for k in (3, 2) for c in eng._scan_fn(k).graphs.values())
            runs[arm] = (losses, {k: v.cpu() for k, v in eng.model.state_dict().items()},
                         eng.iterations, synthesize_kernel.launches - before, replays)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (le, pe, se, ne, _), (lg, pg, sg, ng, rg) = runs["eager"], runs["graph"]
    assert rg == 3
    assert se == sg == ne == ng == sum(k for k, _ in _GRAPH_CALLS)
    for a, b in zip(le, lg):
        assert torch.equal(a, b)
    for name, v in pe.items():
        assert torch.equal(v, pg[name]), name


@pytest.mark.cuda
def test_traced_pooled_epoch_names_its_calls_on_the_devices_clock(cuda_device, tmp_path):
    """A warm pooled epoch (calls of 2, 2 and 2 steps, each a replay) under
    torch.profiler: the epoch, each call, its replay and its read are
    spans in the trace, and the kernels of each replay's graph launch
    start after its ``eld.graph.replay`` span starts: the host's spans and
    the device's operations share one clock."""
    import json

    from torch.profiler import ProfilerActivity, profile

    recs = onp.random.default_rng(4).integers(0, 65535, (6, 64, 64, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    eng = Engine(Config(device="cuda", noise="eld", include=4, base_width=8, batch_size=2,
                        bf16=True, is_train=True, no_log=True, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name="spans"))
    eng.train_pool(pool, steps=6, steps_per_call=2)  # eager, capture, replay
    torch.cuda.synchronize(cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.train_pool(pool, steps=6, steps_per_call=2)
        torch.cuda.synchronize(cuda_device)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    count = {n: sum(e["name"] == n for e in spans) for n in
             ("eld.pool.epoch", "eld.pool.call", "eld.graph.replay", "eld.pool.read",
              "eld.graph.eager", "eld.graph.capture")}
    assert count == {"eld.pool.epoch": 1, "eld.pool.call": 3, "eld.graph.replay": 3,
                     "eld.pool.read": 3, "eld.graph.eager": 0, "eld.graph.capture": 0}
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels.setdefault(e["args"]["correlation"], []).append(e["ts"])
    launches = [e for e in events
                if e.get("cat") == "cuda_runtime" and e["name"] == "cudaGraphLaunch"]
    for replay in (e for e in spans if e["name"] == "eld.graph.replay"):
        (launch,) = [e for e in launches
                     if replay["ts"] <= e["ts"] <= replay["ts"] + replay["dur"]]
        first = min(kernels[launch["args"]["correlation"]])
        assert first >= launch["ts"] >= replay["ts"]


# the per-step calls: the rate set just before each step (None: unchanged);
# step 0 runs eagerly, step 1 captures, the rest replay, one at rate 0
_STEP_RATES = (None, None, None, 0.0, 1e-4, None)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,noise,impl,remat", [
    ("unet", "eld", "auto", False), ("unet_s2d", "eld", "auto", False),
    ("unet", None, "auto", False), ("unet_s2d", None, "auto", False),
    ("unet_s2d", "eld", "plain", False), ("unet", "eld", "auto", True)],
    ids=["unet-K1", "unet_s2d-K1", "unet-paired", "unet_s2d-paired", "unet_s2d-plain",
         "unet-K1-remat"])
def test_captured_train_steps_equal_the_eager_step(cuda_device, arch, noise, impl, remat):
    """make_train_step on the card replays one CUDA graph per batch shape
    from its second step; against make_train_step(capture=False) from the
    same weights, batches and seeds, every loss and the parameters are
    equal bit for bit (cuDNN held to deterministic algorithms), across a
    rate change (at rate 0 a replay moves nothing), and so are
    state.step and K1's launches (one a synthetic step, counted by the
    runner); --remat captures too."""
    rng = onp.random.default_rng(5)
    keys = ("clean",) if noise else ("input", "target")
    batches = [{k: torch.from_numpy(rng.integers(0, 65535, (2, 64, 64, 4), dtype=onp.uint16))
                .to(cuda_device) for k in keys} for _ in range(len(_STEP_RATES))]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for capture in (False, True):
            torch.manual_seed(0)
            model = build_arch(arch, 4, 4, base_width=8, skip_mode="split", remat=remat)
            model = model.to(cuda_device).to(memory_format=torch.channels_last)
            state = create_train_state(model)
            step = make_train_step(model, noise_model=noise,
                                   bank=load_camera_params(include=4, device=cuda_device),
                                   noise_impl=impl, autocast_dtype=torch.bfloat16,
                                   capture=capture)
            before = synthesize_kernel.launches
            losses = []
            for i, (batch, lr) in enumerate(zip(batches, _STEP_RATES)):
                if lr is not None:
                    set_learning_rate(state, lr)
                params = [p.detach().clone() for p in model.parameters()]
                losses.append(float(step(state, batch, fold_in(7, i))["Pixel"]))
                still = all(torch.equal(a, b) for a, b in zip(params, model.parameters()))
                assert still == (lr == 0.0), (capture, i, lr)
            runs[capture] = (losses, [p.detach().cpu() for p in model.parameters()],
                             state.step, synthesize_kernel.launches - before,
                             graph_replays(step))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (le, pe, se, ne, re_), (lg, pg, sg, ng, rg) = runs[False], runs[True]
    n = len(_STEP_RATES)
    assert (re_, rg) == (0, n - 1) and se == sg == n
    assert ne == ng == (n if noise and impl == "auto" else 0)
    assert le == lg
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch,chop,shape", [
    ("unet_s2d", False, (1, 72, 88, 4)), ("unet", False, (2, 64, 64, 4)),
    ("unet", True, (1, 72, 88, 4))], ids=["pad", "aligned", "chop"])
def test_captured_eval_forward_equals_the_eager_forward(cuda_device, arch, chop, shape, dtype):
    """make_eval_forward on the card replays one CUDA graph per (shape,
    dtype) from its second call, bit for bit the eager forward's output
    under cudnn.deterministic; an output is a copy, which later calls
    leave as it was."""
    torch.manual_seed(0)
    model = build_arch(arch, 4, 4, base_width=8, skip_mode="split").to(cuda_device)
    model = model.to(memory_format=torch.channels_last)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xs = [torch.rand(shape, generator=gen, device=cuda_device) for _ in range(4)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fwd = make_eval_forward(model, chop=chop, autocast_dtype=dtype)
        eager = make_eval_forward(model, chop=chop, autocast_dtype=dtype, capture=False)
        outs = [fwd(x) for x in xs]
        kept = [o.clone() for o in outs]
        want = [eager(x) for x in xs]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert graph_replays(fwd) == 3 and eager.graphs == {}
    for o, k, w in zip(outs, kept, want):
        assert o.shape == shape and torch.equal(o, w) and torch.equal(o, k)


@pytest.fixture
def nccl_world_one(cuda_device):
    """A world-1 NCCL group over a free local port, destroyed after the
    test."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("pooled", [False, True], ids=["per_step", "pooled"])
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_data_parallel_graph_equals_eager_ddp_in_a_nccl_group(cuda_device, nccl_world_one,
                                                              tmp_path, arch, pooled):
    """In a world-1 NCCL group the --multihost Engine's own trainer (per
    step, or pooled K = 2) replays one CUDA graph with the gradient
    all-reduce inside from its second call; against the same trainer
    built with capture=False (eager, through the DDP wrapper) from the
    same weights and data, every loss and the parameters are equal bit
    for bit under cudnn.deterministic, across a call at rate 0, and so
    are state.step and K1's launches."""
    rng = onp.random.default_rng(9)
    data = torch.from_numpy(rng.integers(0, 65535, (6, 64, 64, 4), dtype=onp.uint16))
    pool = {"clean": data.to(cuda_device)}
    k = 2 if pooled else 1
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for capture in (True, False):
            eng = Engine(Config(device="cuda", netG=arch, noise="eld", include=4, base_width=8,
                                batch_size=2, bf16=True, is_train=True, multihost=True,
                                no_log=True, no_verbose=True, checkpoints_dir=str(tmp_path),
                                name=f"dp_{capture}"))
            assert eng._forward is not None and (eng.rank, eng.world) == (0, 1)
            kw = dict(noise_model="eld", bank=eng.bank, autocast_dtype=torch.bfloat16,
                      forward=eng._forward, shard=(0, 1), capture=False)
            if pooled:
                fn = eng._scan_fn(k) if capture else make_train_scan(
                    eng.model, batch=2, steps_per_call=k, **kw)
            else:
                fn = eng._train_step if capture else make_train_step(eng.model, **kw)
            before = synthesize_kernel.launches
            losses = []
            for i, lr in enumerate(_STEP_RATES):
                if lr is not None:
                    set_learning_rate(eng.state, lr)
                params = [p.detach().clone() for p in eng.model.parameters()]
                if pooled:
                    fn(eng.state, pool, [fold_in(3, k * i + j) for j in range(k)])
                    losses.append(fn.losses.cpu())
                else:
                    m = fn(eng.state, {"clean": pool["clean"][i % 5:i % 5 + 2]}, fold_in(3, i))
                    losses.append(m["Pixel"].cpu())
                still = all(torch.equal(a, b) for a, b in zip(params, eng.model.parameters()))
                assert still == (lr == 0.0), (capture, i, lr)
            runs[capture] = (losses, [p.detach().cpu() for p in eng.model.parameters()],
                             eng.iterations, synthesize_kernel.launches - before,
                             graph_replays(fn))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lg, pg, sg, ng, rg), (le, pe, se, ne, re_) = runs[True], runs[False]
    n = len(_STEP_RATES)
    assert (rg, re_) == (n - 1, 0) and sg == se == ng == ne == n * k
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))


# ---- the conv epilogue's kernels (models/epilogue.py) ---------------------------

# unet's 18 epilogues at batch 8 (each level's output, with z2 in the first
# conv of levels 6-9); the scalar path (C = 12), one chunk a row (C = 4 f32,
# 8 bf16), chunks in several groups (C = 2304)
EPILOGUE_SHAPES = [(8, 32, 512, 512), (8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64),
                   (8, 512, 32, 32), (3, 12, 7, 9), (2, 4, 16, 16), (2, 8, 5, 3), (2, 2304, 3, 5)]


def _epilogue_inputs(device, shape, dtype, split):
    gen = torch.Generator(device=device).manual_seed(sum(shape))

    def draw(s):
        t = torch.randn(s, generator=gen, device=device).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if len(s) == 4 else t

    return draw(shape), (draw(shape) if split else None), draw(shape[1:2]).float(), draw(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("split", [False, True], ids=["z", "z+z2"])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_epilogue_kernels_equal_the_plain_version(cuda_device, shape, split, dtype):
    """The forward and backward kernels against the plain version on the
    same inputs (the backward's on the kernel's y).  y and gz within one
    ulp of the working dtype (rtol eps, atol 0): both compute in f32 and
    round once, 0 expected.  gbias within 1e-5 of the channel's sum of |gz|:
    the two sum 2M values a channel in different orders, and a blocked f32
    sum's rounding stays far below that."""
    z, z2, b, gy = _epilogue_inputs(cuda_device, shape, dtype, split)
    lib = epilogue.LIBRARY.load()
    y = epilogue.launch_forward(lib, z, b, z2)
    gz, gbias = epilogue.launch_backward(lib, gy, y)
    y_ref = epilogue.plain_forward(z, b, z2)
    gz_ref, gbias_ref = epilogue.plain_backward(gy, y)
    torch.cuda.synchronize(cuda_device)
    eps = torch.finfo(dtype).eps
    assert y.is_contiguous(memory_format=torch.channels_last) and y.dtype == dtype
    torch.testing.assert_close(y, y_ref, rtol=eps, atol=0)
    torch.testing.assert_close(gz, gz_ref, rtol=eps, atol=0)
    bound = 1e-5 * gz_ref.float().abs().sum((0, 2, 3))
    assert gbias.dtype == torch.float32
    assert bool(((gbias - gbias_ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_epilogue_backward_is_bit_identical_run_to_run(cuda_device, dtype):
    """No float atomics: two backward runs on the same input give the same
    bits, gz and the bias sum alike."""
    for shape in [(8, 32, 512, 512), (8, 512, 32, 32), (3, 12, 7, 9)]:
        y, _, _, gy = _epilogue_inputs(cuda_device, shape, dtype, False)
        lib = epilogue.LIBRARY.load()
        first = epilogue.launch_backward(lib, gy, y)
        second = epilogue.launch_backward(lib, gy, y)
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]), shape


@pytest.mark.cuda
def test_conv_epilogue_refusals_on_the_card(cuda_device):
    """The kernel takes dense NHWC bf16 or f32, and nothing else."""
    z, _, b, _ = _epilogue_inputs(cuda_device, (2, 8, 4, 4), torch.float32, False)
    with pytest.raises(ValueError, match="channels_last"):
        bias_lrelu(z.contiguous(), b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bias_lrelu(z.half(), b)
    with pytest.raises(ValueError, match="z2"):
        bias_lrelu(z, b, z.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_pooled_calls_launch_the_epilogue_36_times_a_step(cuda_device, tmp_path, arch):
    """The benchmark's configurations (width 32, bf16, split, convt, batch
    8) in the Engine's pooled trainer at K = 10: the eager call, the
    capture's replay and a replay each count 360 launches of the conv
    epilogue, 18 forward and 18 backward a step."""
    recs = onp.random.default_rng(5).integers(0, 65535, (16, 64, 64, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    eng = Engine(Config(device="cuda", netG=arch, noise="eld", include=4, base_width=32,
                        batch_size=8, bf16=True, is_train=True, no_log=True, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name=arch))
    fn = eng._scan_fn(10)
    counts = []
    for call in range(3):
        before = bias_lrelu.launches
        fn(eng.state, pool, [fold_in(1, 10 * call + j) for j in range(10)])
        counts.append(bias_lrelu.launches - before)
    torch.cuda.synchronize(cuda_device)
    assert counts == [360] * 3 and graph_replays(fn) == 2
    assert onp.isfinite(fn.losses.cpu().numpy()).all()


# ---- Restormer's attention (MDTA) ----------------------------------------------------

# (n, h, w, heads, c): head sizes 48 and 96, 8^2 to 256^2 pixels, batch 1 to 4, ragged
# frames (37 x 29, 5 x 6) and many heads (8, the latent's)
MDTA_SHAPES = [(1, 8, 8, 1, 48), (2, 37, 29, 2, 48), (3, 5, 6, 8, 48), (4, 32, 32, 8, 48),
               (4, 128, 128, 2, 48), (4, 256, 256, 1, 48), (2, 16, 16, 1, 96),
               (4, 64, 64, 1, 96), (4, 256, 256, 1, 96)]


# the largest relative errors (norm of the difference over the composition's norm) the
# kernels may show.  Read on the card (PERF.md): out, dq, dk, dv 2.32e-3 to 2.44e-3
# at every shape, the bf16 rounding of the outputs themselves (the composition under bf16
# autocast reads the same for out and dv, and 3.9e-3 to 4.2e-3 for dq and dk); the
# temperature's gradient up to 1.7e-5 (autocast's up to 1.6e-2).  A term left out of the
# algebra reads 1e-1 or more.
MDTA_REL = {"out": 4e-3, "dq": 4e-3, "dk": 4e-3, "dv": 4e-3, "dt": 1e-4}


def _mdta_inputs(device, n, h, w, heads, c):
    gen = torch.Generator(device=device).manual_seed(n * h * w + c)
    qkv = torch.randn((n, h, w, 3 * heads * c), generator=gen, device=device).to(torch.bfloat16)
    temp = 0.5 + torch.rand((heads, 1, 1), generator=gen, device=device)
    dout = torch.randn((n, h, w, heads * c), generator=gen, device=device).to(torch.bfloat16)
    return qkv, temp, dout


def _rel(got, ref):
    return float((got.float() - ref.float()).norm() / ref.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MDTA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mdta_kernels_equal_the_composition(cuda_device, shape):
    """The forward and backward runs against the composition in f32 on the
    same bf16 inputs (``plain_forward``, ``plain_backward``, which the CPU
    tests hold to autograd): A, q̂ k̂ᵀ and the norms to f32's rounding over
    up to 65,536-pixel sums (atol 1e-4, rtol 1e-4); out, dq, dk, dv and
    the temperature's gradient within MDTA_REL of the composition's norm,
    where the kernels round A and M to bf16 for the tensor cores as
    autocast rounds them, and round each output once."""
    n, h, w, heads, c = shape
    dim = heads * c
    qkv, temp, dout = _mdta_inputs(cuda_device, n, h, w, heads, c)
    lib = attention.LIBRARY.load()
    out, a, g, norms = attention.launch_forward(lib, qkv, temp, heads)
    dqkv, dtemp = attention.launch_backward(lib, dout, qkv, temp, heads, a, g, norms)
    ref = attention.plain_forward(qkv.float(), temp, heads)
    dref, dtref = attention.plain_backward(dout.float(), qkv.float(), temp, heads, *ref[1:])
    torch.cuda.synchronize(cuda_device)
    assert out.dtype == dqkv.dtype == torch.bfloat16 and dtemp.shape == temp.shape
    for got, want in zip((a, g, norms), ref[1:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _rel(out, ref[0]) <= MDTA_REL["out"]
    for name, sl in (("dq", slice(0, dim)), ("dk", slice(dim, 2 * dim)),
                     ("dv", slice(2 * dim, 3 * dim))):
        assert _rel(dqkv[..., sl], dref[..., sl]) <= MDTA_REL[name], name
    assert _rel(dtemp, dtref) <= MDTA_REL["dt"]


@pytest.mark.cuda
def test_mdta_runs_are_bit_identical_run_to_run(cuda_device):
    """No float atomics: two runs each way on the same inputs give the same
    bits, every output."""
    for shape in [(4, 256, 256, 1, 96), (4, 32, 32, 8, 48), (2, 37, 29, 2, 48)]:
        qkv, temp, dout = _mdta_inputs(cuda_device, *shape)
        lib = attention.LIBRARY.load()
        runs = []
        for _ in range(2):
            fwd = attention.launch_forward(lib, qkv, temp, shape[3])
            runs.append(fwd + attention.launch_backward(lib, dout, qkv, temp, shape[3],
                                                        *fwd[1:]))
        assert all(torch.equal(x, y) for x, y in zip(*runs)), shape


@pytest.mark.cuda
def test_mdta_on_the_card_dispatches_by_head_size_and_dtype(cuda_device):
    """bf16 at head sizes 48 and 96 runs the kernels (counted); f32 and other
    head sizes are refused on the card by name (nothing runs, nothing is
    counted), forward and backward."""
    before = mdta.launches
    qkv, temp, dout = _mdta_inputs(cuda_device, 2, 8, 8, 2, 48)
    mdta(qkv, temp, 2)
    assert mdta.launches == before + 1
    for x, heads, what in ((qkv.float(), 2, "torch.float32"), (qkv, 3, "32 channels a head")):
        t = torch.ones((heads, 1, 1), device=cuda_device)
        with pytest.raises(ValueError, match=what):
            mdta(x, t, heads)
        small = attention.plain_forward(x, t, heads)
        with pytest.raises(ValueError, match=what):
            attention._backward(dout[..., :x.shape[-1] // 3].to(x.dtype), x, t, heads,
                                *small[1:])
        assert mdta.launches == before + 1


@pytest.mark.cuda
def test_pooled_restormer_calls_launch_mdta_88_times_a_step(cuda_device, tmp_path):
    """The benchmark's configuration (dim 48, bf16, batch 4) in the Engine's
    pooled trainer at K = 10: the eager call, the capture's replay and a
    replay each count 880 launches of the attention, 44 forward and 44
    backward a step."""
    recs = onp.random.default_rng(5).integers(0, 65535, (8, 64, 64, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    eng = Engine(Config(device="cuda", netG="restormer", noise="eld", include=4, base_width=48,
                        batch_size=4, bf16=True, is_train=True, no_log=True, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name="restormer"))
    fn = eng._scan_fn(10)
    counts = []
    for call in range(3):
        before = mdta.launches
        fn(eng.state, pool, [fold_in(1, 10 * call + j) for j in range(10)])
        counts.append(mdta.launches - before)
    torch.cuda.synchronize(cuda_device)
    assert counts == [880] * 3 and graph_replays(fn) == 2
    assert onp.isfinite(fn.losses.cpu().numpy()).all()


# ---- Restormer's BiasFree LayerNorm ---------------------------------------------------

# (n, h, w, c): the benchmark cell's five norm shapes (dim 48, batch 4 of 256^2), a ragged
# frame with an odd pixel count, and the narrowest and widest channels the kernels take
LN_SHAPES = [(4, 256, 256, 48), (4, 256, 256, 96), (4, 128, 128, 96), (4, 64, 64, 192),
             (4, 32, 32, 384), (3, 37, 29, 96), (1, 5, 7, 8), (2, 9, 11, 512)]


def _ln_inputs(device, shape, dtype):
    n, h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(n * h * w + c)

    def draw(*s):
        return torch.randn(s, generator=gen, device=device)

    x = (draw(n, h, w, c) * (0.5 + draw(n, h, w, 1).abs()) + draw(n, h, w, 1)).to(dtype)
    gy = draw(n, h, w, c).to(dtype)
    wgt = 0.5 + torch.rand(c, generator=gen, device=device)
    return x.permute(0, 3, 1, 2), wgt, gy.permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_layernorm_kernels_equal_the_composition(cuda_device, shape, dtype):
    """The forward and backward runs against the f32 composition on the same
    inputs (``plain_forward`` and ``plain_backward`` in f32, which the CPU
    tests hold to the model's old formula and to autograd in f64).  In bf16
    y and gx round once: within one bf16 eps relative, and gx within one eps
    of its largest value where its two terms cancel; in f32 the same at
    1e-5 and 1e-4, f32 sums in other orders.  gw within 1e-5 of the
    channel's sum of |gy x r| over up to 262,144 pixels."""
    x, wgt, gy = _ln_inputs(cuda_device, shape, dtype)
    lib = layernorm.LIBRARY.load()
    y = layernorm.launch_forward(lib, x, wgt)
    gx, gw = layernorm.launch_backward(lib, gy, x, wgt)
    y_ref = layernorm.plain_forward(x.float(), wgt)
    gx_ref, gw_ref = layernorm.plain_backward(gy.float(), x.float(), wgt)
    torch.cuda.synchronize(cuda_device)
    assert y.dtype == gx.dtype == dtype and gw.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    tol = torch.finfo(torch.bfloat16).eps if dtype == torch.bfloat16 else None
    y_tol, gx_tol = (tol, tol) if tol else (1e-5, 1e-4)
    torch.testing.assert_close(y.float(), y_ref, rtol=y_tol,
                               atol=1e-6 * float(y_ref.abs().max()))
    torch.testing.assert_close(gx.float(), gx_ref, rtol=gx_tol,
                               atol=(tol or 1e-5) * float(gx_ref.abs().max()))
    xf = x.float()
    r = 1 / torch.sqrt(xf.var(dim=1, keepdim=True, unbiased=False) + layernorm.EPS)
    bound = 1e-5 * (gy.float() * xf * r).abs().sum((0, 2, 3))
    assert bool(((gw - gw_ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_layernorm_runs_are_bit_identical_run_to_run(cuda_device, dtype):
    """No float atomics: two runs each way on the same inputs give the same
    bits, y, gx and gw alike."""
    for shape in [(4, 256, 256, 48), (4, 32, 32, 384), (3, 37, 29, 96)]:
        x, wgt, gy = _ln_inputs(cuda_device, shape, dtype)
        lib = layernorm.LIBRARY.load()
        runs = [(layernorm.launch_forward(lib, x, wgt),)
                + layernorm.launch_backward(lib, gy, x, wgt) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs)), shape


@pytest.mark.cuda
def test_layernorm_on_the_card_refuses_what_the_kernels_do_not_take(cuda_device):
    """bf16 at 48 channels runs the kernels (one launch counted each way); 44
    channels or a uint8 x is refused by name, forward and backward, and
    nothing is launched or counted."""
    before = biasfree_layernorm.launches
    x, wgt, gy = _ln_inputs(cuda_device, (2, 8, 8, 48), torch.bfloat16)
    x.requires_grad_(True)
    biasfree_layernorm(x, wgt).backward(gy)
    assert biasfree_layernorm.launches == before + 2
    for bad, what in ((x.detach()[:, :44], "44 channels"),
                      (x.detach().to(torch.uint8), "torch.uint8 with 48 channels")):
        w = wgt[:bad.shape[1]]
        with pytest.raises(ValueError, match=what):
            biasfree_layernorm(bad, w)
        with pytest.raises(ValueError, match=what):
            layernorm._backward(gy[:, :bad.shape[1]].to(x.dtype), bad, w)
    assert biasfree_layernorm.launches == before + 2


@pytest.mark.cuda
def test_pooled_restormer_calls_launch_the_layernorm_176_times_a_step(cuda_device, tmp_path):
    """The benchmark's configuration (dim 48, bf16, batch 4) in the Engine's
    pooled trainer at K = 10: the eager call, the capture's replay and a
    replay each count 1,760 launches of the LayerNorm, 88 forward and 88
    backward a step."""
    recs = onp.random.default_rng(5).integers(0, 65535, (8, 64, 64, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    eng = Engine(Config(device="cuda", netG="restormer", noise="eld", include=4, base_width=48,
                        batch_size=4, bf16=True, is_train=True, no_log=True, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name="restormer"))
    fn = eng._scan_fn(10)
    counts = []
    for call in range(3):
        before = biasfree_layernorm.launches
        fn(eng.state, pool, [fold_in(1, 10 * call + j) for j in range(10)])
        counts.append(biasfree_layernorm.launches - before)
    torch.cuda.synchronize(cuda_device)
    assert counts == [1760] * 3 and graph_replays(fn) == 2
    assert onp.isfinite(fn.losses.cpu().numpy()).all()


# ---- Restormer's 3x3 depthwise convolutions -----------------------------------------

# (n, h, w, c): every depthwise conv of the benchmark cell (dim 48, batch 4 of 256^2), MDTA's
# 3 dim and GDFN's 2 int(2.66 dim) channels at each level, then a ragged frame and the
# narrowest channels the kernels take
DW_SHAPES = [(4, 256, 256, 144), (4, 256, 256, 254), (4, 128, 128, 288), (4, 128, 128, 510),
             (4, 64, 64, 576), (4, 64, 64, 1020), (4, 32, 32, 1152), (4, 32, 32, 2042),
             (4, 256, 256, 288), (4, 256, 256, 510), (3, 37, 29, 254), (1, 5, 7, 2)]


def _dw_inputs(device, shape, seed=0):
    """x and gy bf16 channels-last, and a conv whose weight is drawn in
    [-1, 1)."""
    n, h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(n * h * w + c + seed)
    x = torch.randn((n, h, w, c), generator=gen, device=device).to(torch.bfloat16)
    gy = torch.randn((n, h, w, c), generator=gen, device=device).to(torch.bfloat16)
    conv = torch.nn.Conv2d(c, c, 3, padding=1, groups=c, bias=False).to(device)
    with torch.no_grad():
        conv.weight.copy_(2 * torch.rand(conv.weight.shape, generator=gen, device=device) - 1)
    return x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2), conv


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dwconv_kernels_equal_the_composition(cuda_device, shape):
    """The forward and backward runs against the f32 composition on the same
    inputs and the weight rounded to bf16 (``plain_forward`` and
    ``plain_backward`` in f32, which the CPU tests hold to autograd through
    ``F.conv2d``).  y and gx are f32 sums of 9 products rounded once to bf16:
    within one bf16 eps relative, and 1e-5 of the largest value where the
    products cancel; gw within 1e-5 of the tap's sum of |x gy| over up to
    262,144 pixels."""
    x, gy, conv = _dw_inputs(cuda_device, shape)
    wr = conv.weight.detach().to(torch.bfloat16).float()
    lib = dwconv.LIBRARY.load()
    y = dwconv.launch_forward(lib, x, conv.weight)
    gx, gw, _ = dwconv.launch_backward(lib, gy, x, conv.weight)
    y_ref = dwconv.plain_forward(x.float(), wr)
    gx_ref, gw_ref, _ = dwconv.plain_backward(gy.float(), x.float(), wr)
    bound = 1e-5 * dwconv.plain_backward(gy.float().abs(), x.float().abs(), wr)[1]
    torch.cuda.synchronize(cuda_device)
    assert y.dtype == gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert gx.is_contiguous(memory_format=torch.channels_last)
    eps = torch.finfo(torch.bfloat16).eps
    for got, ref in ((y, y_ref), (gx, gx_ref)):
        torch.testing.assert_close(got.float(), ref, rtol=eps, atol=1e-5 * float(ref.abs().max()))
    assert gw.shape == conv.weight.shape and bool(((gw - gw_ref).abs() <= bound).all())


@pytest.mark.cuda
def test_dwconv_runs_are_bit_identical_run_to_run(cuda_device):
    """No float atomics: two runs each way on the same inputs give the same
    bits, y, gx and gw alike."""
    for shape in [(4, 256, 256, 254), (4, 32, 32, 2042), (3, 37, 29, 254)]:
        x, gy, conv = _dw_inputs(cuda_device, shape, 1)
        lib = dwconv.LIBRARY.load()
        runs = [(dwconv.launch_forward(lib, x, conv.weight),)
                + dwconv.launch_backward(lib, gy, x, conv.weight) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs)), shape


@pytest.mark.cuda
def test_dwconv_on_the_card_refuses_what_the_kernels_do_not_take(cuda_device):
    """bf16 at 254 channels runs the kernels (one launch counted each way); 255
    channels, an f32 x, a stride of 2 or a dilation of 2 is refused by name,
    and nothing is launched or counted."""
    before = depthwise_conv3x3.launches
    x, gy, conv = _dw_inputs(cuda_device, (2, 8, 8, 254))
    x.requires_grad_(True)
    depthwise_conv3x3(x, conv).backward(gy)
    assert depthwise_conv3x3.launches == before + 2
    odd = torch.nn.Conv2d(255, 255, 3, padding=1, groups=255, bias=False).to(cuda_device)
    wide = _dw_inputs(cuda_device, (2, 8, 8, 256))[0]
    cases = [(wide[:, :255], odd, "torch.bfloat16 with 255 channels"),
             (x.detach().float(), conv, "torch.float32 with 254 channels")]
    for bad, c, what in cases:
        with pytest.raises(ValueError, match=what):
            depthwise_conv3x3(bad, c)
        with pytest.raises(ValueError, match=what):
            dwconv._backward(gy[:, :bad.shape[1]].to(bad.dtype), bad, c.weight, False)
    for kw, what in ((dict(stride=2), "stride"), (dict(dilation=2), "dilation")):
        c = torch.nn.Conv2d(254, 254, 3, padding=1, groups=254, **kw).to(cuda_device)
        with pytest.raises(ValueError, match=what):
            depthwise_conv3x3(x.detach(), c)
    assert depthwise_conv3x3.launches == before + 2


@pytest.mark.cuda
def test_pooled_restormer_calls_launch_the_dwconv_176_times_a_step(cuda_device, tmp_path):
    """The benchmark's configuration (dim 48, bf16, batch 4) in the Engine's
    pooled trainer at K = 10: the eager call, the capture's replay and a
    replay each count 1,760 launches of the depthwise convs, 88 forward and
    88 backward a step."""
    recs = onp.random.default_rng(5).integers(0, 65535, (8, 64, 64, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    eng = Engine(Config(device="cuda", netG="restormer", noise="eld", include=4, base_width=48,
                        batch_size=4, bf16=True, is_train=True, no_log=True, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name="restormer"))
    fn = eng._scan_fn(10)
    counts = []
    for call in range(3):
        before = depthwise_conv3x3.launches
        fn(eng.state, pool, [fold_in(1, 10 * call + j) for j in range(10)])
        counts.append(depthwise_conv3x3.launches - before)
    torch.cuda.synchronize(cuda_device)
    assert counts == [1760] * 3 and graph_replays(fn) == 2
    assert onp.isfinite(fn.losses.cpu().numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 256, 254), (4, 32, 32, 2042), (3, 37, 29, 254),
                                   (32, 128, 128, 128), (32, 16, 16, 2048), (1, 5, 7, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dwconv_kernels_with_a_bias_equal_the_composition(cuda_device, shape):
    """Uformer's LeFF conv has a bias: y against ``F.conv2d`` with the bias
    (the weight and the bias rounded to bf16, as autocast rounds them), gx
    and gw as without it, gb against the sum of gy in f64, within 1e-5 of
    the sum of |gy| (f32 sums in a fixed order over up to 524,288 pixels; a
    bf16 sum would miss by 1e-3 of it); the kernels without a bias give the
    bits of the kernels with a zero bias, forward and backward, on
    Restormer's shapes and Uformer's (the bias changes nothing else)."""
    x, gy, conv = _dw_inputs(cuda_device, shape, 2)
    c = shape[-1]
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    bias = 2 * torch.rand((c,), generator=gen, device=cuda_device) - 1
    wr = conv.weight.detach().to(torch.bfloat16).float()
    lib = dwconv.LIBRARY.load()
    y = dwconv.launch_forward(lib, x, conv.weight, bias)
    gx, gw, gb = dwconv.launch_backward(lib, gy, x, conv.weight, True)
    y_ref = dwconv.plain_forward(x.float(), wr, bias.to(torch.bfloat16).float())
    gx_ref, gw_ref, _ = dwconv.plain_backward(gy.float(), x.float(), wr)
    bound = 1e-5 * dwconv.plain_backward(gy.float().abs(), x.float().abs(), wr)[1]
    eps = torch.finfo(torch.bfloat16).eps
    torch.testing.assert_close(y.float(), y_ref, rtol=eps, atol=1e-5 * float(y_ref.abs().max()))
    torch.testing.assert_close(gx.float(), gx_ref, rtol=eps,
                               atol=1e-5 * float(gx_ref.abs().max()))
    assert bool(((gw - gw_ref).abs() <= bound).all())
    gb64 = gy.double().sum((0, 2, 3))
    assert gb.shape == (c,) and bool(((gb - gb64).abs() <= 1e-5 * gy.double().abs().sum((0, 2, 3)))
                                     .all())
    assert torch.equal(dwconv.launch_forward(lib, x, conv.weight),
                       dwconv.launch_forward(lib, x, conv.weight, torch.zeros_like(bias)))
    plain, biased = (dwconv.launch_backward(lib, gy, x, conv.weight, wb)[:2]
                     for wb in (False, True))
    assert all(torch.equal(a, b) for a, b in zip(plain, biased))


# ---- Uformer's shifted-window attention ------------------------------------------------

# (n, h, w, heads): every layer's attention of the cell syn-pool.uformer.p128b32 (batch 32 of
# 128^2 at embed_dim 32, 32 channels a head): the encoder's and the bottleneck's, then the
# decoder's
WMSA_SHAPES = [(32, 128, 128, 1), (32, 64, 64, 2), (32, 32, 32, 4), (32, 16, 16, 8),
               (32, 8, 8, 16), (32, 16, 16, 16), (32, 32, 32, 8), (32, 64, 64, 4),
               (32, 128, 128, 2)]

# the largest relative errors (norm of the difference over the composition's norm) the kernels
# may show.  Without a table: out, dq, dk, dv round P and dS to bf16 for the tensor cores as
# autocast rounds them, and each output once, read 2.34e-3 to 2.39e-3 on the card (PERF.md);
# the bias's gradient is an f32 sum of f32 dS (read 3.7e-7), the log-sum-exp f32's own (5.8e-8).
# With the modulator's table the kernels round q + T, k + T and v + T to bf16 once more (the
# composition adds T in f32), which moves every score and product by another 2^-9: read up to
# 5.0e-3 (dq), 3.9e-3 (the bias's gradient), 4.7e-4 (the log-sum-exp).  A float8 product, a
# bf16 sum over the 64 keys, or a term left out, reads 1e-2 or more.
WMSA_REL = {"out": 5e-3, "dq": 5e-3, "dk": 5e-3, "dv": 5e-3, "dbias": 1e-5, "lse": 1e-6}
WMSA_REL_MODULATED = {"out": 8e-3, "dq": 8e-3, "dk": 8e-3, "dv": 8e-3, "dbias": 8e-3,
                      "dtable": 8e-3, "lse": 1e-3}


def _wmsa_inputs(device, n, h, w, heads, modulated, seed=0):
    gen = torch.Generator(device=device).manual_seed(n * h * w + heads + seed)
    c = 32 * heads
    qkv = torch.randn((n, h, w, 3 * c), generator=gen, device=device).to(torch.bfloat16)
    bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device=device)
    table = (torch.randn((64, 3 * c), generator=gen, device=device) if modulated else None)
    dout = torch.randn((n, h, w, c), generator=gen, device=device).to(torch.bfloat16)
    return qkv, bias, table, dout


@pytest.mark.cuda
@pytest.mark.parametrize("modulated", [False, True], ids=["plain", "modulated"])
@pytest.mark.parametrize("shift", [0, 4], ids=["w", "sw"])
@pytest.mark.parametrize("shape", WMSA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wmsa_kernels_equal_the_composition(cuda_device, shape, shift, modulated):
    """The forward and backward runs against the composition in f32 on the
    same bf16 inputs (``plain_forward``, ``plain_backward``, which the CPU
    tests hold to autograd and to the authors' roll and partition): the
    log-sum-exp to f32's rounding, out, dq, dk, dv, the bias's and the
    table's gradients within WMSA_REL of the composition's norm."""
    n, h, w, heads = shape
    c = 32 * heads
    qkv, bias, table, dout = _wmsa_inputs(cuda_device, n, h, w, heads, modulated)
    lib = wmsa.LIBRARY.load()
    out, lse = wmsa.launch_forward(lib, qkv, bias, table, heads, shift)
    dqkv, dbias, dtable = wmsa.launch_backward(lib, dout, qkv, bias, table, lse, heads, shift)
    ref, lse_ref = wmsa.plain_forward(qkv.float(), bias, table, heads, shift)
    dref, dbias_ref, dtable_ref = wmsa.plain_backward(dout.float(), qkv.float(), bias, table,
                                                      lse_ref, heads, shift)
    torch.cuda.synchronize(cuda_device)
    assert out.dtype == dqkv.dtype == torch.bfloat16 and dbias.shape == bias.shape
    rel = {"lse": _rel(lse, lse_ref), "out": _rel(out, ref), "dbias": _rel(dbias, dbias_ref)}
    for name, sl in (("dq", slice(0, c)), ("dk", slice(c, 2 * c)), ("dv", slice(2 * c, 3 * c))):
        rel[name] = _rel(dqkv[..., sl], dref[..., sl])
    if modulated:
        rel["dtable"] = _rel(dtable, dtable_ref)
    else:
        assert dtable.numel() == 0
    limits = WMSA_REL_MODULATED if modulated else WMSA_REL
    print(shape, shift, modulated, rel)
    assert all(v <= limits[k] for k, v in rel.items()), rel


@pytest.mark.cuda
def test_wmsa_runs_are_bit_identical_run_to_run(cuda_device):
    """No float atomics: two runs each way on the same inputs give the same
    bits, every output."""
    for shape, shift, modulated in [((32, 128, 128, 1), 0, False), ((32, 64, 64, 4), 4, True),
                                    ((32, 8, 8, 16), 0, False), ((32, 16, 16, 16), 4, True)]:
        qkv, bias, table, dout = _wmsa_inputs(cuda_device, *shape, modulated, 1)
        lib = wmsa.LIBRARY.load()
        runs = []
        for _ in range(2):
            fwd = wmsa.launch_forward(lib, qkv, bias, table, shape[3], shift)
            runs.append(fwd + wmsa.launch_backward(lib, dout, qkv, bias, table, fwd[1], shape[3],
                                                   shift))
        assert all(torch.equal(x, y) for x, y in zip(*runs)), shape


@pytest.mark.cuda
def test_wmsa_on_the_card_refuses_what_the_kernels_do_not_take(cuda_device):
    """bf16 at head size 32, window 8, shift 0 or 4 runs the kernels (one
    launch counted each way); f32, another head size, another window or
    shift, or a frame that is no multiple of 8 is refused by name, forward
    and backward, and nothing is counted."""
    before = window_attention.launches
    qkv, bias, table, dout = _wmsa_inputs(cuda_device, 2, 16, 16, 2, True)
    x = qkv.clone().requires_grad_(True)
    window_attention(x, bias, table, 2, 4).backward(dout)
    assert window_attention.launches == before + 2
    cases = [(qkv.float(), bias, 2, 0, "torch.float32"),
             (qkv, bias.repeat(2, 1, 1), 4, 0, "16 channels a head"),
             (qkv, bias[:, :16, :16].contiguous(), 2, 0, "windows of 4"),
             (qkv, bias, 2, 2, "shift 2"),
             (qkv[:, :12, :12], bias, 2, 0, "12 x 12")]
    for t, b, heads, shift, what in cases:
        with pytest.raises(ValueError, match=what if what != "12 x 12" else "dividing 12 x 12"):
            window_attention(t, b, None, heads, shift)
        with pytest.raises(ValueError, match=what):
            wmsa._backward(dout[:, :t.shape[1], :t.shape[2], :t.shape[-1] // 3].to(t.dtype), t, b,
                           None, torch.zeros((1,), device=cuda_device), heads, shift)
    assert window_attention.launches == before + 2


@pytest.mark.cuda
def test_pooled_uformer_calls_launch_the_window_attention_80_times_a_step(cuda_device, tmp_path):
    """The benchmark's configuration (embed_dim 32, bf16) in the Engine's
    pooled trainer at K = 10, batch 2 of 128^2: the eager call, the
    capture's replay and a replay each count 800 launches of the window
    attention, 40 forward and 40 backward a step, and 800 of the depthwise
    convs."""
    recs = onp.random.default_rng(5).integers(0, 65535, (4, 128, 128, 4), dtype=onp.uint16)
    pool = {"clean": torch.from_numpy(recs).to(cuda_device)}
    eng = Engine(Config(device="cuda", netG="uformer", noise="eld", include=4, base_width=32,
                        batch_size=2, bf16=True, is_train=True, no_log=True, no_verbose=True,
                        checkpoints_dir=str(tmp_path), name="uformer"))
    fn = eng._scan_fn(10)
    counts = []
    for call in range(3):
        before = (window_attention.launches, depthwise_conv3x3.launches)
        fn(eng.state, pool, [fold_in(1, 10 * call + j) for j in range(10)])
        counts.append((window_attention.launches - before[0],
                       depthwise_conv3x3.launches - before[1]))
    torch.cuda.synchronize(cuda_device)
    assert counts == [(800, 800)] * 3 and graph_replays(fn) == 2
    assert onp.isfinite(fn.losses.cpu().numpy()).all()
