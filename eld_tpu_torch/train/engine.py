"""Engine — epoch-level orchestration: train, eval, test, checkpoints
(counterpart of ``eld_tpu/train/engine.py``).

The Engine owns the U-Net, the optimizer, the train steps and the eval
forward on one explicit device.  It sets the float32 matmul/convolution
precision explicitly (no TF32: an f32 run computes in f32, and ``--bf16``
is the fast path, autocast over f32 parameters).

Eval protocol (the reference's ``models/ELD_model.py:203-307``): optional
512-px center crop, forward (optionally 4-tile chopped), per-item
illuminance correction, optional raw -> sRGB (``--stage_eval srgb``, gamma
or the calibrated CRF under ``--crf``), x255 clip, PSNR/SSIM per item.
Multi-device runs need the parallel layer (ROADMAP.md queue 1 #13) and
are refused.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as onp
import torch

from eld_tpu_torch.config import Config, torch_device
from eld_tpu_torch.core import emor, isp
from eld_tpu_torch.core.packing import crop_center
from eld_tpu_torch.data.loader import prefetch_to_device, readahead
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.models.netutils import param_count
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.ops.correct import illuminance_correct_batch
from eld_tpu_torch.ops.metrics import quality_assess
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train.state import create_train_state, get_learning_rate, set_learning_rate
from eld_tpu_torch.train.steps import fold_in, make_eval_forward, make_train_scan, make_train_step
from eld_tpu_torch.utils.images import save_png
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
        if cfg.multihost or cfg.mesh_spatial > 1:
            raise NotImplementedError("not ported yet: --multihost / --mesh_spatial > 1 "
                                      "(parallel: ROADMAP.md queue 1 #13)")
        self.device = torch_device(cfg.device)
        self.writer = None
        self.throughput = ThroughputMeter()
        # (iteration, {metric: value}, host time the values were read)
        self.history = []
        # (epoch, dataset name, {metric: mean}) of every eval
        self.eval_history = []
        # per-(dataset, metric) best values for best-checkpoint tracking;
        # persisted to best_val.json so a resumed run keeps the true best
        self.best_val: dict = {}
        self._train_scans = {}

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
        self.crf = None
        if cfg.crf:
            self.crf = tuple(torch.from_numpy(a).to(self.device) for a in emor.load_crf())

        autocast = torch.bfloat16 if cfg.bf16 else None
        self.bank = None
        self._train_step = None
        if cfg.is_train:
            synthetic = cfg.noise not in (None, "", "none")
            if synthetic:
                self.bank = load_camera_params(include=cfg.include, exclude=cfg.exclude,
                                               device=self.device)
            self._train_step = make_train_step(
                model, loss=cfg.loss, noise_model=cfg.noise if synthetic else None,
                bank=self.bank, k_mode=cfg.k_mode, autocast_dtype=autocast,
            )
        self._fwd = make_eval_forward(model, chop=cfg.chop, autocast_dtype=autocast)

        os.makedirs(cfg.save_dir, exist_ok=True)
        if not cfg.no_log:
            self.writer = get_summary_writer(os.path.join(cfg.save_dir, "logs"))
        if cfg.resume or cfg.model_path:
            self.load(cfg.model_path, cfg.resume_epoch)
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
        self._end_epoch(t0)
        return meters

    def _scan_fn(self, k: int):
        """The K-steps-per-call trainer, built once per (K, batch size)."""
        cfg = self.cfg
        key = (k, cfg.batch_size)
        if key not in self._train_scans:
            synthetic = cfg.noise not in (None, "", "none")
            self._train_scans[key] = make_train_scan(
                self.model, loss=cfg.loss, noise_model=cfg.noise if synthetic else None,
                bank=self.bank, k_mode=cfg.k_mode, batch=cfg.batch_size, steps_per_call=k,
                autocast_dtype=torch.bfloat16 if cfg.bf16 else None)
        return self._train_scans[key]

    def train_pool(self, pool: dict, steps: int, steps_per_call: int = 10):
        """One training "epoch" of ``steps`` optimizer steps over a
        device-resident pool ({"clean"} or {"input", "target"}, from
        ``data.loader.pool_to_device``): full ``steps_per_call``-step
        calls plus one remainder call, each step picking, augmenting and
        noising its batch on the device.

        Step i is seeded with fold_in(seed, i), as in ``train``, so a
        resumed run reproduces the picks and the noise whatever K is.
        Metrics are read one call late, so the host queues call i+1 while
        the device runs call i."""
        cfg = self.cfg
        print(f"\nEpoch: {self.epoch} (lr {get_learning_rate(self.state):.2e}, "
              f"scan x{steps_per_call})")
        meters = AverageMeters()
        t0 = time.time()
        host_step = self.iterations
        n_full, rem = divmod(max(steps, 1), steps_per_call)
        launches = [steps_per_call] * n_full + ([rem] if rem else [])
        pending = None  # (index, metrics, step count after the call, K)

        def drain(i, metrics, step_idx, k):
            self.throughput.tick(cfg.batch_size * k)
            values = {name: float(v) for name, v in metrics.items()}
            self.history.append((step_idx, values, time.perf_counter()))
            meters.update(values)
            progress(i, len(launches),
                     f"{meters} | {self.throughput.items_per_sec:.1f} patches/s", every=1)
            if self.writer is not None:
                write_loss(self.writer, "train", meters, step_idx)

        for i, k in enumerate(launches):
            seeds = [fold_in(cfg.seed, host_step + j) for j in range(k)]
            metrics = self._scan_fn(k)(self.state, pool, seeds)
            host_step += k
            if pending is not None:
                drain(*pending)
            pending = (i, metrics, host_step, k)
        if pending is not None:
            drain(*pending)
        self._end_epoch(t0)
        return meters

    def _end_epoch(self, t0: float):
        cfg = self.cfg
        self.state.epoch += 1
        if not cfg.no_log:
            if self.epoch % cfg.save_epoch_freq == 0:
                print(f"saving the model at epoch {self.epoch}, iters {self.iterations}")
                self.save()
            self.save(label="latest")
            print(f"Time Taken: {int(time.time() - t0)} sec")

    # ---- evaluation ----
    def _to_device(self, x) -> torch.Tensor:
        return torch.from_numpy(onp.ascontiguousarray(x, onp.float32)).to(self.device)

    def _to_srgb(self, x4: torch.Tensor, wb, ccm) -> torch.Tensor:
        """(N, H, W, 4) raw -> (N, H, W, 3) sRGB with per-item or shared
        wb/ccm; each wb is normalized by its green."""
        n = x4.shape[0]
        wb = torch.atleast_2d(torch.as_tensor(onp.asarray(wb, onp.float32), device=x4.device))
        wb = wb / wb[:, 1:2]
        ccm = torch.as_tensor(onp.asarray(ccm, onp.float32), device=x4.device).reshape(-1, 3, 3)
        return isp.process(x4, wb.expand(n, -1), ccm.expand(n, -1, -1), crf=self.crf)

    def eval_one(self, item: dict, correct: bool = True, crop: bool = True,
                 savedir: Optional[str] = None) -> dict:
        """Score one {input, target, ...} item: {PSNR, SSIM} averaged over
        the batch, every batch item corrected and scored on its own, plus
        the input-vs-target PSNR_in / SSIM_in.  With ``--stage_eval srgb``
        a raw output, target and input are scored after the ISP, with the
        item's wb/ccm."""
        inp, tgt = item["input"], item["target"]
        if inp.ndim == 3:
            inp, tgt = inp[None], tgt[None]
        if crop:
            inp = crop_center(inp, 512, 512)
            tgt = crop_center(tgt, 512, 512)
        inp, tgt = self._to_device(inp), self._to_device(tgt)

        out = self._fwd(inp)
        if correct:
            out = illuminance_correct_batch(out, tgt)
        if self.cfg.stage_out == "raw" and self.cfg.stage_eval == "srgb":
            wb, ccm = item["wb"], item["ccm"]
            out = self._to_srgb(out.float(), wb, ccm)
            tgt, inp = self._to_srgb(tgt, wb, ccm), self._to_srgb(inp, wb, ccm)

        def to_im(t):
            return (t.float() * 255.0).clamp(0.0, 255.0)

        out_im, tgt_im, inp_im = to_im(out), to_im(tgt), to_im(inp)
        per = [quality_assess(out_im[i], tgt_im[i], data_range=255)
               for i in range(out_im.shape[0])]
        per_in = [quality_assess(inp_im[i], tgt_im[i], data_range=255)
                  for i in range(out_im.shape[0])]
        res = {k: float(onp.mean([p[k] for p in per])) for k in per[0]}
        res.update({f"{k}_in": float(onp.mean([p[k] for p in per_in])) for k in per_in[0]})
        if savedir is not None:
            self._dump_pngs(savedir, item, out_im[0].cpu().numpy(), tgt_im[0].cpu().numpy(),
                            inp_im[0].cpu().numpy(), res)
        return res

    def _dump_pngs(self, savedir, item, out_im, tgt_im, inp_im, res):
        """The reference's names (ELD_model.py:300): output and input carry
        their PSNR."""
        name = os.path.splitext(os.path.basename(str(item.get("fn", "item"))))[0]
        d = os.path.join(savedir, name)
        os.makedirs(d, exist_ok=True)
        save_png(os.path.join(d, f"{self.cfg.run_name}_{res['PSNR']:.2f}.png"), out_im)
        save_png(os.path.join(d, f"m_input_{res['PSNR_in']:.2f}.png"), inp_im)
        save_png(os.path.join(d, "t_label.png"), tgt_im)

    def eval(self, loader, dataset_name: str, savedir=None, loss_key=None,
             correct: bool = True, crop: bool = True):
        """Mean metrics over ``loader``'s items.  Item i+1's raw decode runs
        on a thread while item i is scored.
        With ``loss_key`` a new best value of that metric saves
        model_best_<key>_<name>.pt and then records the value."""
        meters = AverageMeters()
        n = len(loader)
        for i, item in readahead(enumerate(loader)):
            meters.update(self.eval_one(item, correct=correct, crop=crop, savedir=savedir))
            progress(i, n, str(meters))
        if self.writer is not None:
            write_loss(self.writer, os.path.join("eval", dataset_name), meters, self.epoch)
        self.eval_history.append((self.epoch, dataset_name, meters.as_dict()))
        if loss_key is not None and self._is_new_best(dataset_name, loss_key,
                                                      meters[loss_key]):
            # save first: a best value recorded before a failed save would
            # keep this quality level from ever being saved after a resume
            self.save(label=f"best_{loss_key}_{dataset_name}")
            self._record_best(dataset_name, loss_key, meters[loss_key])
        return meters

    # quality metrics are maximized, anything else (losses) minimized
    _MAXIMIZE_PREFIXES = ("PSNR", "SSIM", "NCC")

    def _is_new_best(self, dataset_name: str, key: str, value: float) -> bool:
        maximize = key.startswith(self._MAXIMIZE_PREFIXES)
        best = self.best_val.get(f"{dataset_name}/{key}")
        return best is None or (value > best if maximize else value < best)

    def _record_best(self, dataset_name: str, key: str, value: float):
        self.best_val[f"{dataset_name}/{key}"] = float(value)
        with open(self._best_val_path, "w") as f:
            json.dump(self.best_val, f, indent=1)

    @property
    def _best_val_path(self) -> str:
        return os.path.join(self.cfg.save_dir, "best_val.json")

    def _load_best_val(self):
        try:
            with open(self._best_val_path) as f:
                self.best_val = json.load(f)
        except (FileNotFoundError, ValueError):
            pass

    def test(self, loader, savedir=None):
        """Inference only (no targets): denoise and save previews.  A raw
        output of an item with a white balance is previewed in sRGB."""
        for i, item in readahead(enumerate(loader)):
            inp = item["input"]
            if inp.ndim == 3:
                inp = inp[None]
            out = self._fwd(self._to_device(inp))
            if savedir is not None:
                if "wb" in item and self.cfg.stage_out == "raw":
                    out = self._to_srgb(out.float(), item["wb"], item["ccm"])
                name = os.path.splitext(os.path.basename(str(item.get("fn", f"item{i}"))))[0]
                os.makedirs(os.path.join(savedir, name), exist_ok=True)
                save_png(os.path.join(savedir, name, f"{self.cfg.run_name}.png"),
                         (out[0].float() * 255).clamp(0, 255).cpu().numpy())
            progress(i, len(loader))

    # ---- checkpoints ----
    def save(self, label: Optional[str] = None) -> str:
        """Write the reference's .pt layout {netG, opt_g, epoch, iterations}
        as model_EEE_IIIIIIII.pt, or model_<label>.pt (synchronously)."""
        return ckpt.save_checkpoint(self.cfg.save_dir, self.state, label)

    def load(self, model_path: Optional[str] = None, resume_epoch: Optional[int] = None) -> str:
        """Restore params, optimizer state, epoch and iterations from
        ``model_path``, or from the save dir's checkpoint of
        ``resume_epoch`` (default: the newest)."""
        path = model_path or ckpt.find_checkpoint(self.cfg.save_dir, resume_epoch)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint found in {self.cfg.save_dir} (epoch={resume_epoch})")
        ckpt.load_checkpoint(path, self.state)
        self._load_best_val()
        print(f"Resume from epoch {self.epoch}, iteration {self.iterations}")
        return path
