"""Engine — epoch-level orchestration: train, eval, test, checkpoints
(counterpart of ``eld_tpu/train/engine.py``).

The Engine owns the U-Net, the optimizer, the train steps and the eval
forward on one explicit device.  It sets the float32 matmul/convolution
precision explicitly (no TF32: an f32 run computes in f32, and ``--bf16``
is the fast path, autocast over f32 parameters).

Eval protocol (the reference's ``models/ELD_model.py:203-307``): optional
512-px center crop, forward (optionally 4-tile chopped, or halo-sharded
over ``--mesh_spatial`` cards), per-item illuminance correction, optional
raw -> sRGB (``--stage_eval srgb``, gamma or the calibrated CRF under
``--crf``), x255 clip, PSNR/SSIM per item.

``--profile`` records a torch.profiler trace (CPU and, on a card, CUDA
activity) of epoch 0's first ``min(8, n)`` steps on the per-step path and
of ``train_pool``'s first warm replays on the pooled one (``_trace_calls``),
to ``save_dir/profile/<train|train_pool>.pt.trace.json``.  While a
profiler records, the pooled path names its host work in spans
(``utils/logging.py::span``).

Under ``--multihost`` (one torch.distributed rank per card, launched by
torchrun) the Engine trains data-parallel, stride-shards eval and test
items over the ranks and merges the eval's metric sums in rank order, and
rank 0 alone writes checkpoints, TensorBoard, progress, traces and
``best_val.json``; every rank enters ``save()``.  On the card over NCCL
the per-step and pooled trainers are CUDA graphs that hold the gradient
all-reduce; over gloo (or with ``capture=False``) they run eagerly
through a DistributedDataParallel wrapper of the model.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Optional

import numpy as onp
import torch
from torch.nn.parallel import DistributedDataParallel

from eld_tpu_torch.config import Config, torch_device
from eld_tpu_torch.core import emor, isp
from eld_tpu_torch.core.packing import crop_center
from eld_tpu_torch.data.loader import prefetch_to_device, readahead
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.models.netutils import param_count
from eld_tpu_torch.noise import kernels as noise_kernels
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.ops.correct import illuminance_correct_batch
from eld_tpu_torch.ops.metrics import quality_assess
from eld_tpu_torch.parallel.mesh import MeshSpec, spatial_devices
from eld_tpu_torch.parallel.multihost import allgather_objects, barrier, host_shard
from eld_tpu_torch.parallel.spatial import make_spatial_forward
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train.state import create_train_state, get_learning_rate, set_learning_rate
from eld_tpu_torch.train.steps import (
    SPATIAL,
    fold_in,
    make_eval_forward,
    make_train_scan,
    make_train_step,
    say_eager,
)
from eld_tpu_torch.utils.images import save_png
from eld_tpu_torch.utils.logging import (
    AverageMeters,
    ThroughputMeter,
    get_summary_writer,
    progress,
    span,
    write_loss,
)


def _data_parallel(model: torch.nn.Module) -> DistributedDataParallel:
    """A DistributedDataParallel wrapper of ``model``, built on a side
    stream on a card.  DDP keeps each parameter's gradient accumulator,
    and an accumulator runs on the stream it was made on: one made on the
    default stream would make that stream wait on a CUDA graph's capture
    of the backward, which CUDA refuses."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        return DistributedDataParallel(model)
    main, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        ddp = DistributedDataParallel(model)
    main.wait_stream(side)
    return ddp


class Engine:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.rank, self.world = host_shard()
        self.host0 = self.rank == 0
        self.device = torch_device(cfg.device)
        self.mesh = self._resolve_mesh(cfg)
        self.writer = None
        self.throughput = ThroughputMeter()
        # (iteration, {metric: value}, host time the values were read)
        self.history = []
        # (epoch, dataset name, {metric: mean}) of every eval
        self.eval_history = []
        # per-(dataset, metric) best values for best-checkpoint tracking;
        # persisted to best_val.json so a resumed run keeps the true best
        self.best_val: dict = {}
        # make_train_scan's trainers by (K, batch).  On a card the per-step
        # trainer, each pooled trainer and the eval forward hold CUDA
        # graphs, which drop themselves when called on another pool or
        # optimizer state, and which a load (release_graphs) drops at once
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
        if self._spatial_devices and not getattr(model, "SPATIAL_HALO", True):
            raise ValueError(
                f"{cfg.netG} cannot run under --mesh_spatial {cfg.mesh_spatial}: the spatial "
                "forward shards a frame into slabs with a halo of a few pixels, and its "
                "attention reaches across any such halo (a window's, or every pixel's), so the "
                "slabs would not compute its forward; use --mesh_spatial 1")
        synthetic = cfg.noise not in (None, "", "none")
        if self.device.type == "cuda":
            # nvcc builds the kernels this run launches, each on a thread of
            # its own, while the card and the trainers are set up; the first
            # launch waits for its build
            libraries = getattr(model, "KERNEL_LIBRARIES", ())
            if cfg.is_train and synthetic:
                libraries += (noise_kernels.LIBRARY,)
            for library in libraries:
                library.start()
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
        # under --multihost a DistributedDataParallel wrapper: built, it
        # broadcasts rank 0's parameters; the eager trainers call it, and it
        # averages the gradients over the ranks (a CUDA graph calls
        # self.model and all-reduces them itself); saves and loads go
        # through self.model, so the .pt keeps the reference's names
        self._forward = None
        if cfg.is_train:
            if cfg.multihost:
                self._forward = _data_parallel(model)
            if synthetic:
                self.bank = load_camera_params(include=cfg.include, exclude=cfg.exclude,
                                               device=self.device)
            self._train_step = make_train_step(
                model, loss=cfg.loss, noise_model=cfg.noise if synthetic else None,
                bank=self.bank, k_mode=cfg.k_mode, autocast_dtype=autocast,
                forward=self._forward, shard=(self.rank, self.world),
            )
        self._replicas = []
        if self.mesh.spatial > 1:
            say_eager("eval forward", SPATIAL)
            self._fwd = self._spatial_forward(autocast)
        else:
            self._fwd = make_eval_forward(model, chop=cfg.chop, autocast_dtype=autocast)

        os.makedirs(cfg.save_dir, exist_ok=True)
        if not cfg.no_log and self.host0:
            self.writer = get_summary_writer(os.path.join(cfg.save_dir, "logs"))
        if cfg.resume or cfg.model_path:
            self.load(cfg.model_path, cfg.resume_epoch)
        if not cfg.no_verbose:
            print(f"[i] arch {cfg.netG}: {param_count(model):,} params on {self.device}, "
                  f"mesh data={self.mesh.data} spatial={self.mesh.spatial}")

    def _resolve_mesh(self, cfg: Config) -> MeshSpec:
        """The run's mesh, after eld_tpu's refusals (engine.py:62-87,
        :130-139): a multi-process run needs --multihost and a process
        group, spatial sharding needs one process and no --chop, and the
        global batch must split over the data axis."""
        launched = max(self.world, int(os.environ.get("WORLD_SIZE", "1")))
        if launched > 1 and not cfg.multihost:
            raise RuntimeError(
                f"{launched} processes are present but cfg.multihost is not set; every rank "
                "would load duplicate batches. Pass --multihost.")
        if cfg.multihost and not torch.distributed.is_initialized():
            raise RuntimeError(
                "--multihost needs the torch.distributed process group: give the entry point "
                "--mesh_data N (it launches its ranks) or launch under torchrun, and call "
                "parallel.multihost.maybe_initialize_multihost(cfg) first")
        if cfg.mesh_spatial > 1 and self.world > 1:
            raise NotImplementedError(
                "spatially-sharded eval is not supported across processes (eval items are "
                "process-local); use --mesh_spatial 1 under --multihost")
        if cfg.mesh_spatial > 1 and cfg.chop:
            raise ValueError(
                "--chop and --mesh_spatial>1 are mutually exclusive: spatial halo sharding "
                "replaces the 4-tile chop for full-frame eval. Drop --chop (sharded eval "
                "matches the chop protocol's windowing) or use --mesh_spatial 1.")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        mesh = MeshSpec(cfg.mesh_data, cfg.mesh_spatial).resolve(self.world, cards)
        # the cards of the spatial forward, refused before the model moves
        self._spatial_devices = (spatial_devices(self.device, mesh.spatial, cards)
                                 if mesh.spatial > 1 else [])
        if cfg.is_train and cfg.batch_size % mesh.data:
            raise ValueError(
                f"batch_size={cfg.batch_size} must be divisible by the mesh data axis "
                f"({mesh.data} ranks); set --batchSize or --mesh_data")
        return mesh

    def _spatial_forward(self, autocast):
        """The full-frame forward halo-sharded over the S cards that start at
        the Engine's own, cuda:k..k+S-1, one replica of the U-Net per card
        (the model itself on its own card); the output comes back on the
        input's card.  The replicas are refreshed from the model before
        every eval or test pass (``_sync_replicas``)."""
        devices = self._spatial_devices
        by_index = {d.index: self.model if i == 0 else copy.deepcopy(self.model).to(d)
                    for i, d in enumerate(devices)}
        self._replicas = [by_index[d.index] for d in devices[1:]]

        def apply(t):
            with torch.autocast("cuda", dtype=autocast, enabled=autocast is not None):
                return by_index[t.device.index](t)

        return make_spatial_forward(apply, devices, base=self.model.alignment())

    def _sync_replicas(self):
        """Copy the model's weights into the spatial replicas, so they never
        serve weights older than a training step or a load."""
        for replica in self._replicas:
            replica.load_state_dict(self.model.state_dict())

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
        """One epoch over ``loader`` yielding dict batches of NumPy arrays.
        On a card each batch shape runs as one CUDA graph from its second
        step (``steps.make_train_step``); metrics are read one step late."""
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
            self.throughput.tick(bs * self.world)  # global patches
            values = {k: float(v) for k, v in metrics.items()}
            self.history.append((step_idx, values, time.perf_counter()))
            meters.update(values)
            if self.host0:
                progress(i, n, f"{meters} | {self.throughput.items_per_sec:.1f} patches/s",
                         every=10)
            if self.writer is not None:
                write_loss(self.writer, "train", meters, step_idx)

        # --profile: the first min(8, n) steps of epoch 0, as eld_tpu traces
        prof = self._start_trace()
        for i, batch in enumerate(prefetch_to_device(loader, self.device)):
            if prof is not None and i == min(8, n):
                self._stop_trace(prof, "train")
                prof = None
            # seed = f(seed, iteration): a resumed run sees the same noise
            metrics = self._train_step(self.state, batch, fold_in(cfg.seed, host_step))
            bs = next(iter(batch.values())).shape[0]
            if pending is not None:
                drain(*pending)
            pending = (i, metrics, host_step, bs)
            host_step += 1
        if prof is not None:
            self._stop_trace(prof, "train")
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
                autocast_dtype=torch.bfloat16 if cfg.bf16 else None, forward=self._forward,
                shard=(self.rank, self.world))
        return self._train_scans[key]

    def train_pool(self, pool: dict, steps: int, steps_per_call: int = 10):
        """One training "epoch" of ``steps`` optimizer steps over a
        device-resident pool ({"clean"} or {"input", "target"}, from
        ``data.loader.pool_to_device``): full ``steps_per_call``-step
        calls plus one remainder call, each step picking, augmenting and
        noising its batch on the device.  Under --multihost every rank
        holds the whole pool and keeps its rows of each global batch.

        Step i is seeded with fold_in(seed, i), as in ``train``, so a
        resumed run reproduces the picks and the noise whatever K is.
        Metrics are read one call late, so the host queues call i+1 while
        the device runs call i.  On a card each (K, batch) runs as one CUDA
        graph from its second call on a pool (``steps.make_train_scan``).
        Under a profiler the epoch, each call and the drain's read and
        report are spans (``eld.pool.*``)."""
        with span("eld.pool.epoch", self.epoch):
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
                with span("eld.pool.read"):
                    values = {name: float(v) for name, v in metrics.items()}
                with span("eld.pool.report"):
                    self.history.append((step_idx, values, time.perf_counter()))
                    self.throughput.tick(cfg.batch_size * k)
                    meters.update(values)
                    if self.host0:
                        progress(i, len(launches),
                                 f"{meters} | {self.throughput.items_per_sec:.1f} patches/s",
                                 every=1)
                    if self.writer is not None:
                        write_loss(self.writer, "train", meters, step_idx)

            traced = self._trace_calls(len(launches))
            prof = None
            for i, k in enumerate(launches):
                if i == traced.start:
                    prof = self._start_trace()
                with span("eld.pool.call", host_step):
                    seeds = [fold_in(cfg.seed, host_step + j) for j in range(k)]
                    metrics = self._scan_fn(k)(self.state, pool, seeds)
                    host_step += k
                    if pending is not None:
                        drain(*pending)
                    pending = (i, metrics, host_step, k)
                if prof is not None and i == traced.stop - 1:
                    self._stop_trace(prof, "train_pool")
                    prof = None
            if pending is not None:
                drain(*pending)
            self._end_epoch(t0)
            return meters

    @staticmethod
    def _trace_calls(n: int) -> range:
        """The calls of an epoch of ``n`` that --profile traces: the third
        through the sixth, the first warm replays (the first call of a
        pool runs eagerly, the second captures), or the last where there
        are fewer than three.  eld_tpu traces only the per-step path; the
        pooled one is the port's default."""
        start = 2 if n >= 3 else n - 1
        return range(start, min(start + 4, n))

    # ---- --profile ----
    def _start_trace(self):
        """A started torch.profiler session (CPU activity, and CUDA activity
        on a card) when --profile asks for one: in epoch 0, on rank 0 only;
        else None."""
        if not (self.cfg.profile and self.epoch == 0 and self.host0):
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof, name: str) -> str:
        """Wait for the traced work, stop ``prof`` and write its Chrome
        trace to save_dir/profile/<name>.pt.trace.json; returns the path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.cfg.save_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"{name}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"[i] --profile: trace of {name} written to {path}")
        return path

    def _end_epoch(self, t0: float):
        cfg = self.cfg
        with span("eld.epoch.end", self.epoch):
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

    def _local_items(self, loader):
        """This rank's stride of the items, ``(index, count, item)`` for
        items rank, rank + world, ...  Every rank works concurrently (a
        rank-0-only eval would park the others in the merge).  A batch-1
        Loader that does not shuffle is indexed directly, so skipped items
        are never decoded (full-frame raws are multi-MB); otherwise the skip
        happens after loading."""
        n = len(loader)
        ds = getattr(loader, "dataset", None)
        if (self.world > 1 and ds is not None and getattr(loader, "batch_size", None) == 1
                and not getattr(loader, "shuffle", False)):
            collate = getattr(loader, "collate", lambda items: items[0])
            for i in range(self.rank, n, self.world):
                yield i, n, collate([ds[i]])
            return
        for i, item in enumerate(loader):
            if i % self.world == self.rank:
                yield i, n, item

    def eval(self, loader, dataset_name: str, savedir=None, loss_key=None,
             correct: bool = True, crop: bool = True):
        """Mean metrics over ``loader``'s items.  Item i+1's raw decode runs
        on a thread while item i is scored.  Under --multihost each rank
        scores its stride of the items and the metric sums are merged in
        rank order, so every rank returns identical means.
        With ``loss_key`` a new best value of that metric saves
        model_best_<key>_<name>.pt and then records the value."""
        self._sync_replicas()
        meters = AverageMeters()
        for i, n, item in readahead(self._local_items(loader)):
            meters.update(self.eval_one(item, correct=correct, crop=crop, savedir=savedir))
            if self.host0:
                progress(i, n, str(meters))
        if self.world > 1:
            merged = AverageMeters()
            for part in allgather_objects({k: [meters.sums[k], meters.counts[k]]
                                           for k in meters.keys()}):
                for k, (total, count) in part.items():
                    merged.sums[k] = merged.sums.get(k, 0.0) + total
                    merged.counts[k] = merged.counts.get(k, 0) + count
            meters = merged
        if self.writer is not None:
            write_loss(self.writer, os.path.join("eval", dataset_name), meters, self.epoch)
        self.eval_history.append((self.epoch, dataset_name, meters.as_dict()))
        if loss_key is not None and self._is_new_best(dataset_name, loss_key,
                                                      meters[loss_key]):
            # save first (and wait for the write): a best value recorded
            # before a failed save would keep this quality level from ever
            # being saved after a resume
            self.save(label=f"best_{loss_key}_{dataset_name}", wait=True)
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
        if not self.host0:
            return  # the merged means agree on every rank; one writer
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
        output of an item with a white balance is previewed in sRGB.  Under
        --multihost each rank takes its stride of the items."""
        self._sync_replicas()
        for i, n, item in readahead(self._local_items(loader)):
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
            if self.host0:
                progress(i, n)

    def release_graphs(self):
        """Drop every CUDA graph the Engine holds (the per-step trainer's,
        the pooled trainers', the eval forward's) and with them their
        memory pools, for ``torch.cuda.empty_cache`` to return to the
        card; each path's next call runs eagerly, then captures anew."""
        self._train_scans.clear()
        if self._train_step is not None:
            self._train_step.graphs.clear()
        if self.mesh.spatial == 1:
            self._fwd.graphs.clear()

    # ---- checkpoints ----
    def save(self, label: Optional[str] = None, wait: bool = False) -> str:
        """Write the reference's .pt layout {netG, opt_g, epoch, iterations}
        as model_EEE_IIIIIIII.pt, or model_<label>.pt; asynchronously under
        cfg.async_ckpt (``wait`` blocks until the write lands).  Every rank
        enters; rank 0 writes (the ranks' states are identical)."""
        if not self.host0:
            return ckpt.checkpoint_path(self.cfg.save_dir, self.state, label)
        path = ckpt.save_checkpoint(self.cfg.save_dir, self.state, label,
                                    async_=self.cfg.async_ckpt)
        if wait:
            ckpt.wait_for_saves()
        return path

    def load(self, model_path: Optional[str] = None, resume_epoch: Optional[int] = None) -> str:
        """Restore params, optimizer state, epoch and iterations from
        ``model_path``, or from the save dir's checkpoint of
        ``resume_epoch`` (default: the newest).  Waits for this process's
        saves and then for every rank, so rank 0's write has landed."""
        ckpt.wait_for_saves()
        barrier()
        path = model_path or ckpt.find_checkpoint(self.cfg.save_dir, resume_epoch)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint found in {self.cfg.save_dir} (epoch={resume_epoch})")
        ckpt.load_checkpoint(path, self.state)
        # the optimizer's state tensors are new: no captured graph holds them
        self.release_graphs()
        self._load_best_val()
        print(f"Resume from epoch {self.epoch}, iteration {self.iterations}")
        return path
