"""The data axis's ranks, launched from one command (counterpart of the
single-process half of ``eld_tpu/parallel/mesh.py::make_mesh``).

eld_tpu puts ``--mesh_data D`` local devices on the data axis of one
process, and its default -1 takes "all devices not used by spatial".
PyTorch shards a batch over ranks, one process per card, so an entry
point that finds no launcher around it starts its D ranks itself, as
``torchrun --nproc_per_node D`` would:

  * ``plan_ranks(cfg, cards)`` resolves D from the mesh flags, as eld_tpu
    resolves its mesh, and refuses what cannot run (more ranks than
    cards, eld_tpu's D x S grid);
  * ``launch(target, argv, ranks, device)`` starts D spawned ranks through
    torchrun's own agent (``elastic_launch``: a c10d rendezvous on
    127.0.0.1 at a port it picks, no restarts), each with torchrun's
    variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and ``argv + ["--multihost", "--mesh_data", D]``, so a rank takes the
    torchrun path unchanged: the card ``config.rank_card`` gives it, an
    NCCL group bound to that card (gloo for ``--device cpu``), rank 0 the
    only writer.  If a rank fails, the agent kills the others and
    ``launch`` raises naming the rank; a rank stuck in a collective fails
    at the process group's timeout, so no rank holds the parent forever;
  * ``run_ranks(main, argv, cfg)`` is what the four entry points that
    take the mesh flags (train_syn, train_real, test_sid, test_eld) do
    first: go on in this process (under a launcher, or one rank), or
    return rank 0's result of ``main`` on D launched ranks.  A training
    rank's Engine comes back as its ``RunRecord``.

The parent creates no CUDA context: it counts the cards with
``torch.cuda.device_count()``, which does not initialize CUDA, and each
rank makes its own on its card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import signal
import sys
import threading
from typing import Callable, Optional, Sequence

import torch

from eld_tpu_torch.config import rank_card
from eld_tpu_torch.parallel.multihost import host_shard

# torchrun's variables: any of them means this process is a launched rank
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
_AGENT_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP, signal.SIGQUIT)


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """What a launched training rank hands back in place of its Engine,
    which holds the card's tensors and does not cross a process boundary."""

    rank: int
    world: int
    device: str
    epoch: int
    iterations: int
    history: list       # Engine.history: (iteration, {metric: value}, host time)
    eval_history: list  # Engine.eval_history: (epoch, dataset name, {metric: mean})
    state_dict: dict    # the model's parameters and buffers, on the CPU


def launcher_present() -> bool:
    """Whether this process already is a rank: torchrun's variables (or
    ``launch``'s), or a process group."""
    return (any(k in os.environ for k in _LAUNCHER_ENV)
            or (torch.distributed.is_available() and torch.distributed.is_initialized()))


def visible_cards(device) -> int:
    """The CUDA cards this process sees for ``device`` (0 for a CPU
    device), counted without initializing CUDA."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 0


def plan_ranks(cfg, cards: int) -> int:
    """D, the ranks of the data axis, from ``cfg``'s ``device``,
    ``mesh_data`` and ``mesh_spatial`` and the ``cards`` visible:

      * under a launcher or in a process group: the world size;
      * ``--device cpu``: ``--mesh_data`` (-1: 1); gloo ranks stand in for
        the virtual CPU devices eld_tpu's tests run a data axis on;
      * ``--device cuda[:k]``: -1 is every visible card from cuda:k on
        (eld_tpu's "all devices not used by spatial"), and D > 1 must fit
        in cuda:k..cuda:k+D-1, else it is refused naming the missing card.

    ``--mesh_spatial S > 1`` with ``--mesh_data D > 1`` (eld_tpu's D x S
    grid) is refused; with -1 it is D = 1, said once.  Nothing falls back
    to fewer ranks or to the CPU."""
    if launcher_present():
        return max(host_shard()[1], int(os.environ.get("WORLD_SIZE", "1")))
    data, spatial = cfg.mesh_data, max(1, cfg.mesh_spatial)
    if spatial > 1:
        if data > 1:
            raise ValueError(
                f"--mesh_data {data} with --mesh_spatial {spatial} is a {data} x {spatial} "
                f"grid of {data * spatial} cards in one command (rank r on cuda:k+r*{spatial}.."
                f"cuda:k+r*{spatial}+{spatial - 1}), which is not supported yet: give "
                f"--mesh_data {data} (data-parallel training) or --mesh_spatial {spatial} "
                "(the halo-sharded full-frame eval) alone")
        if data <= 0:
            print(f"[i] --mesh_data -1 with --mesh_spatial {spatial}: the data axis is one "
                  f"rank, the cards go to the spatial axis (a data x spatial grid in one "
                  f"command is not supported yet)", file=sys.stderr)
        return 1
    device = torch.device(cfg.device)
    if device.type != "cuda":
        return max(1, data)
    first = device.index or 0
    if data <= 0:
        return max(1, cards - first)
    if first + data > cards and data > 1:
        raise ValueError(
            f"--mesh_data {data} from --device {cfg.device} needs one card per rank, "
            f"cuda:{first}..cuda:{first + data - 1}, have {cards} visible cards: "
            f"cuda:{max(first, cards)} is missing")
    return data


def launch(target: Callable, argv: Sequence[str], ranks: int, device: str) -> list:
    """Run ``target(argv + ["--multihost", "--mesh_data", str(ranks)])`` in
    ``ranks`` spawned processes, rank r on ``rank_card(device, r)`` (gloo
    ranks for a CPU ``device``), and return each rank's return value in
    rank order (an Engine as its ``RunRecord``).  ``target`` must pickle
    by reference (a module-level function).  A card past the visible ones
    is refused before any process starts; a failed rank raises
    RuntimeError naming it after the others are killed."""
    if torch.device(device).type == "cuda":
        rank_card(device, ranks - 1, visible_cards(device))
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    config = LaunchConfig(min_nodes=1, max_nodes=1, nproc_per_node=ranks,
                          run_id=f"eld-{os.getpid()}", rdzv_backend="c10d",
                          rdzv_endpoint="127.0.0.1:0", max_restarts=0, monitor_interval=0.1,
                          start_method="spawn")
    args = list(argv) + ["--multihost", "--mesh_data", str(ranks)]
    # the agent turns these signals into an exception that stops the ranks;
    # the caller's own handlers come back when the launch ends
    handlers = ({s: signal.getsignal(s) for s in _AGENT_SIGNALS}
                if threading.current_thread() is threading.main_thread() else {})
    try:
        out = elastic_launch(config, _rank)(target, args)
    except ChildFailedError as e:
        rank, failure = e.get_first_failure()
        message = failure.message
        if isinstance(message, dict):
            message = message.get("message", message)
        raise RuntimeError(f"rank {rank} of {ranks} failed (exit code {failure.exitcode}): "
                           f"{message}") from e
    finally:
        for s, handler in handlers.items():
            signal.signal(s, handler)
    return [out[r] for r in range(ranks)]


def run_ranks(main: Callable, argv: Optional[Sequence[str]], cfg) -> Optional[object]:
    """An entry point's first step, after parsing ``cfg`` from ``argv``:
    ``None`` when the run goes on in this process (under a launcher, or
    ``plan_ranks`` gives one rank), else rank 0's return value of
    ``main`` launched on D ranks."""
    ranks = plan_ranks(cfg, visible_cards(cfg.device))
    if ranks == 1 or launcher_present():
        return None
    first = torch.device(cfg.device).index or 0
    where = (f"cuda:{first}..cuda:{first + ranks - 1} over NCCL"
             if torch.device(cfg.device).type == "cuda" else f"{cfg.device} over gloo")
    print(f"[i] --mesh_data {cfg.mesh_data}: launching {ranks} ranks on {where}", flush=True)
    return launch(main, sys.argv[1:] if argv is None else argv, ranks, cfg.device)[0]


def _rank(target: Callable, argv: list):
    """One launched rank: ``target(argv)``, its saves landed, its log
    closed, its CUDA graphs freed and then its group destroyed.  Rank 0's stdout is the run's; the
    others' goes nowhere (a one-process run prints it once), their stderr
    stays.  Past one rank each runs torch on one host thread unless
    OMP_NUM_THREADS says otherwise, as under torchrun."""
    from eld_tpu_torch.train import checkpoints
    from eld_tpu_torch.train.engine import Engine

    if int(os.environ["WORLD_SIZE"]) > 1 and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)
    with contextlib.ExitStack() as stack:
        if int(os.environ["RANK"]) > 0:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        result = target(argv)
        checkpoints.wait_for_saves()
        if isinstance(result, Engine):
            if result.writer is not None:  # its writer thread would outlive the queue it reads
                result.writer.close()
            result = RunRecord(
                rank=result.rank, world=result.world, device=str(result.device),
                epoch=result.epoch, iterations=result.iterations, history=result.history,
                eval_history=result.eval_history,
                state_dict={k: v.detach().cpu().clone()
                            for k, v in result.model.state_dict().items()})
        # NCCL destroys a communicator only after every CUDA graph that
        # captured one of its collectives is gone: free the rank's graphs
        # (an Engine in a reference cycle holds them) before the group
        gc.collect()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return result
