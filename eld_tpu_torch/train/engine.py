"""Engine — epoch-level training orchestration (counterpart of
``eld_tpu/train/engine.py``: ``__init__``, ``set_learning_rate``, ``train``
and ``save``).

The Engine owns the U-Net, the optimizer and the train step on one
explicit device.  It sets the float32 matmul/convolution precision
explicitly (no TF32: an f32 run computes in f32, and ``--bf16`` is the
fast path, autocast over f32 parameters).  Evaluation, test and
checkpoint loading are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from eld_tpu_torch.config import Config
from eld_tpu_torch.data.loader import prefetch_to_device
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.models.netutils import param_count
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train.state import create_train_state, get_learning_rate, set_learning_rate
from eld_tpu_torch.train.steps import fold_in, make_train_step
from eld_tpu_torch.utils.logging import (
    AverageMeters,
    ThroughputMeter,
    get_summary_writer,
    progress,
    write_loss,
)


class Engine:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {cfg.device}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.writer = None
        self.throughput = ThroughputMeter()
        # (iteration, {metric: value}, host time the values were read)
        self.history = []

        # torch's default init is the reference's; seeded without touching
        # the process-wide generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_arch(
                cfg.netG, cfg.in_channels, cfg.out_channels,
                base_width=cfg.base_width, remat=cfg.remat, skip_mode=cfg.skip_mode,
                upsample=cfg.upsample,
                skip_dtype=torch.bfloat16 if cfg.skip_bf16 else None,
            )
        model = model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.state = create_train_state(model, lr=cfg.lr, beta1=cfg.beta1, weight_decay=cfg.wd)

        self.bank = None
        self._train_step = None
        if cfg.is_train:
            synthetic = cfg.noise not in (None, "", "none")
            if synthetic:
                self.bank = load_camera_params(include=cfg.include, exclude=cfg.exclude,
                                               device=self.device)
            self._train_step = make_train_step(
                model, loss=cfg.loss, noise_model=cfg.noise if synthetic else None,
                bank=self.bank, k_mode=cfg.k_mode,
                autocast_dtype=torch.bfloat16 if cfg.bf16 else None,
            )

        os.makedirs(cfg.save_dir, exist_ok=True)
        if not cfg.no_log:
            self.writer = get_summary_writer(os.path.join(cfg.save_dir, "logs"))
        if not cfg.no_verbose:
            print(f"[i] arch {cfg.netG}: {param_count(model):,} params on {self.device}")

    # ---- counters ----
    @property
    def epoch(self) -> int:
        return self.state.epoch

    @property
    def iterations(self) -> int:
        return self.state.step

    def set_learning_rate(self, lr: float):
        print(f"[i] set learning rate to {lr}")
        set_learning_rate(self.state, lr)

    # ---- training ----
    def train(self, loader):
        """One epoch over ``loader`` yielding dict batches of NumPy arrays."""
        cfg = self.cfg
        print(f"\nEpoch: {self.epoch} (lr {get_learning_rate(self.state):.2e})")
        meters = AverageMeters()
        t0 = time.time()
        n = len(loader)
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.epoch)

        # reading the loss every step would wait for the device each step;
        # metrics are read one step late so the host runs a step ahead
        host_step = self.iterations
        pending = None  # (index, metrics, step, batch size) still in flight

        def drain(i, metrics, step_idx, bs):
            self.throughput.tick(bs)
            values = {k: float(v) for k, v in metrics.items()}
            self.history.append((step_idx, values, time.perf_counter()))
            meters.update(values)
            progress(i, n, f"{meters} | {self.throughput.items_per_sec:.1f} patches/s",
                     every=10)
            if self.writer is not None:
                write_loss(self.writer, "train", meters, step_idx)

        for i, batch in enumerate(prefetch_to_device(loader, self.device)):
            # seed = f(seed, iteration): a resumed run sees the same noise
            metrics = self._train_step(self.state, batch, fold_in(cfg.seed, host_step))
            bs = next(iter(batch.values())).shape[0]
            if pending is not None:
                drain(*pending)
            pending = (i, metrics, host_step, bs)
            host_step += 1
        if pending is not None:
            drain(*pending)

        self.state.epoch += 1
        if not cfg.no_log:
            if self.epoch % cfg.save_epoch_freq == 0:
                print(f"saving the model at epoch {self.epoch}, iters {self.iterations}")
                self.save()
            self.save(label="latest")
            print(f"Time Taken: {int(time.time() - t0)} sec")
        return meters

    # ---- checkpoints ----
    def save(self, label: Optional[str] = None) -> str:
        """Write the reference's .pt layout {netG, opt_g, epoch, iterations}
        as model_EEE_IIIIIIII.pt, or model_<label>.pt."""
        name = (f"model_{label}.pt" if label
                else f"model_{self.epoch:03d}_{self.iterations:08d}.pt")
        path = os.path.join(self.cfg.save_dir, name)
        torch.save({"netG": self.model.state_dict(),
                    "opt_g": self.state.optimizer.state_dict(),
                    "epoch": self.epoch,
                    "iterations": self.iterations}, path)
        return path
