"""The port's noise kernel, pooled trainer, eval forward, ISP, serving
artifacts, spatial forward, data-parallel picks, asynchronous saves, the
synthetic demo, apply_noise, the demosaic and the benchmark tools on the
card (marked ``cuda``; skipped where there is none).

This file imports neither JAX nor eld_tpu, so it runs on a machine that
has the card and torch but not the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import copy

import numpy as onp
import pytest
import torch

from eld_tpu_torch import export
from eld_tpu_torch.config import Config
from eld_tpu_torch.core import emor, isp
from eld_tpu_torch.data.loader import pool_to_device
from eld_tpu_torch.data.patchstore import PatchStore, PatchStoreWriter
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.kernels import kernel_draws, synthesize_kernel
from eld_tpu_torch.noise.model import noise_core
from eld_tpu_torch.noise.params import load_camera_params, sample_params_batch
from eld_tpu_torch.parallel.mesh import rank_rows
from eld_tpu_torch.parallel.spatial import make_spatial_forward
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.steps import make_eval_forward, pick_batch


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
