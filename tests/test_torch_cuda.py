"""The port's pooled trainer and eval forward on the card (marked ``cuda``;
skipped where there is none).

This file imports neither JAX nor eld_tpu, so it runs on a machine that
has the card and torch but not the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import copy

import numpy as onp
import pytest
import torch

from eld_tpu_torch.config import Config
from eld_tpu_torch.data.loader import pool_to_device
from eld_tpu_torch.data.patchstore import PatchStore, PatchStoreWriter
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.kernels import synthesize_kernel
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.steps import make_eval_forward


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the noise kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
