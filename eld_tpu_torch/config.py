"""Typed configuration + CLI bridge (counterpart of ``eld_tpu/config.py``).

The same dataclass and flag names as eld_tpu, so command lines carry
across, plus an explicit ``--device`` (default ``cuda``).  ``--profile``
writes a torch.profiler trace of the first train steps under
``save_dir/profile`` (``train.engine.Engine``).  ``--mesh_data`` /
``--mesh_spatial`` resolve in the Engine (``parallel.mesh.MeshSpec.resolve``),
after the entry points have launched the data axis's ranks
(``parallel.launch``), and ``--no-async-ckpt`` makes saves synchronous.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
from typing import Optional

import numpy as onp
import torch


@dataclasses.dataclass
class Config:
    # experiment
    name: Optional[str] = None
    model: str = "eld_model"
    checkpoints_dir: str = "./checkpoints"
    resume: bool = False
    resume_epoch: Optional[int] = None
    seed: int = 2018
    n_threads: int = 8
    chop: bool = False
    no_log: bool = False
    no_verbose: bool = False
    debug: bool = False
    # model/stage
    netG: str = "unet"
    base_width: int = 32       # U-Net level-0 width
    channels: int = 4
    stage_in: str = "raw"
    stage_out: str = "raw"
    stage_eval: str = "raw"
    model_path: Optional[str] = None
    include: Optional[int] = None
    gt_wb: bool = False
    crf: bool = False
    # training
    batch_size: int = 1
    lr: float = 1e-4
    beta1: float = 0.9
    wd: float = 0.0
    max_dataset_size: Optional[int] = None
    loss: str = "l1"
    noise: str = "g"
    exclude: Optional[int] = None
    is_train: bool = False
    save_epoch_freq: int = 100
    # device / execution
    device: str = "cuda"
    mesh_data: int = -1
    mesh_spatial: int = 1
    bf16: bool = False         # bf16 autocast over f32 params
    remat: bool = False        # checkpoint U-Net levels
    skip_mode: str = "split"   # concat-free decoder (same weights)
    skip_bf16: bool = False    # store U-Net skip activations in bf16
    upsample: str = "convt"    # "d2s": 1x1-conv + depth-to-space (same weights)
    k_mode: str = "overridden"  # noise K sampling: overridden|calibrated
    profile: bool = False      # torch.profiler trace of the first train steps
    async_ckpt: bool = True
    multihost: bool = False

    @property
    def in_channels(self) -> int:
        return 3 if self.stage_in == "srgb" else self.channels

    @property
    def out_channels(self) -> int:
        return 3 if self.stage_out == "srgb" else self.channels

    @property
    def run_name(self) -> str:
        return self.name or self.model

    @property
    def save_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.run_name)


def rank_card(device, local_rank: int, cards: int) -> torch.device:
    """The card of the rank with ``local_rank`` on its host when ``--device``
    is ``device`` (``cuda`` or ``cuda:k``): ``cuda:k+local_rank``, k = 0 for
    a bare ``cuda`` -- the ranks of a host take the cards from the first
    one on, as ``--mesh_spatial`` takes its cards (``parallel.mesh.
    spatial_devices``).  A card past the ``cards`` visible ones is refused
    by name; nothing falls back."""
    device = torch.device(device)
    index = (device.index or 0) + local_rank
    if index >= cards:
        raise ValueError(
            f"--device {device} for local rank {local_rank} is cuda:{index}, but {cards} "
            f"CUDA cards are visible (cuda:0..cuda:{cards - 1}): cuda:{index} is missing")
    return torch.device("cuda", index)


def torch_device(name: str) -> torch.device:
    """``torch.device(name)`` for a run: raises for a CUDA device when there
    is no card (nothing falls back to the CPU), and turns TF32 off, so f32
    matmuls and convolutions compute in f32.  Under a launcher (torchrun's
    ``LOCAL_RANK``) a rank's card is ``rank_card``'s, ``cuda:k+LOCAL_RANK``;
    without one an explicit ``cuda:k`` must be a visible card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    if device.type == "cuda" and ("LOCAL_RANK" in os.environ or device.index is not None):
        device = rank_card(device, int(os.environ.get("LOCAL_RANK", 0)),
                           torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _add_flags(p: argparse.ArgumentParser, train: bool):
    g = p.add_argument_group("experiment")
    g.add_argument("--name", type=str, default=None)
    g.add_argument("--model", type=str, default="eld_model")
    g.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    g.add_argument("--resume", "-r", action="store_true")
    g.add_argument("--resume_epoch", "-re", type=int, default=None)
    g.add_argument("--seed", type=int, default=2018)
    g.add_argument("--nThreads", dest="n_threads", type=int, default=8)
    g.add_argument("--chop", action="store_true")
    g.add_argument("--no-log", dest="no_log", action="store_true")
    g.add_argument("--no-verbose", dest="no_verbose", action="store_true")
    g.add_argument("--debug", action="store_true")

    m = p.add_argument_group("model")
    m.add_argument("--netG", type=str, default="unet")
    m.add_argument("--base_width", type=int, default=32)
    m.add_argument("--channels", "-c", type=int, default=4)
    m.add_argument("--stage_in", type=str, default="raw", choices=["raw", "srgb"])
    m.add_argument("--stage_out", type=str, default="raw", choices=["raw", "srgb"])
    m.add_argument("--stage_eval", type=str, default="raw", choices=["raw", "srgb"])
    m.add_argument("--model_path", type=str, default=None)
    m.add_argument("--include", type=int, default=None)
    m.add_argument("--gt_wb", action="store_true")
    m.add_argument("--crf", action="store_true")

    d = p.add_argument_group("device")
    d.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on: cuda, cuda:N or cpu")
    d.add_argument("--mesh_data", type=int, default=-1)
    d.add_argument("--mesh_spatial", type=int, default=1)
    d.add_argument("--bf16", action="store_true")
    d.add_argument("--remat", action="store_true")
    d.add_argument("--skip_mode", type=str, default="split", choices=["concat", "split"])
    d.add_argument("--skip_bf16", action="store_true")
    d.add_argument("--upsample", type=str, default="convt", choices=["convt", "d2s"])
    d.add_argument("--k_mode", type=str, default="overridden",
                   choices=["overridden", "calibrated"])
    d.add_argument("--profile", action="store_true")
    d.add_argument("--multihost", action="store_true")
    d.add_argument("--no-async-ckpt", dest="async_ckpt", action="store_false")

    if train:
        tr = p.add_argument_group("train")
        tr.add_argument("--batchSize", "-b", dest="batch_size", type=int, default=1)
        tr.add_argument("--lr", type=float, default=1e-4)
        tr.add_argument("--beta1", type=float, default=0.9)
        tr.add_argument("--wd", type=float, default=0.0)
        tr.add_argument("--max_dataset_size", type=int, default=None)
        tr.add_argument("--loss", type=str, default="l1")
        tr.add_argument("--noise", type=str, default="g")
        tr.add_argument("--exclude", type=int, default=None)
        tr.add_argument("--save_epoch_freq", type=int, default=100)


def _dump(cfg: Config, write):
    write("------------ Options -------------\n")
    for k, v in sorted(dataclasses.asdict(cfg).items()):
        write(f"{k}: {v}\n")
    write("-------------- End ----------------\n")


def parse(argv=None, train: bool = False, dump: bool = True) -> Config:
    """Parse CLI flags into a Config; seeds host RNGs and dumps opt.txt."""
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_flags(p, train)
    ns = p.parse_args(argv)
    cfg = Config(**{**vars(ns), "is_train": train})

    # host-side determinism; device randomness is explicit generators
    onp.random.seed(cfg.seed)
    random.seed(cfg.seed)

    if cfg.debug:
        cfg = dataclasses.replace(cfg, max_dataset_size=100, n_threads=0)

    if not cfg.no_verbose:
        _dump(cfg, lambda s: print(s, end=""))

    if dump:
        os.makedirs(cfg.save_dir, exist_ok=True)
        with open(os.path.join(cfg.save_dir, "opt.txt"), "w") as f:
            _dump(cfg, f.write)

    return cfg
