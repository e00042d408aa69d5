"""Multi-process runtime bootstrap (counterpart of
``eld_tpu/parallel/multihost.py``).

One process per card, as torchrun launches them, or as an entry point's
``--mesh_data N`` does itself (``parallel/launch.py``):

  * ``initialize_multihost()`` brings up the default torch.distributed
    process group, from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) or from explicit arguments.  NCCL is the
    backend of CUDA ranks and gloo of CPU ranks; the caller names it, and
    a failed init raises: nothing switches backend or falls back to one
    process behind the caller's back.
  * ``host_shard()`` is the ``(rank, world)`` pair ``data.Loader(shard=)``
    takes, so each rank loads only its rows of every global batch (every
    rank shares the shuffle seed, so the permutations agree).
  * ``broadcast_from_host0`` / ``allgather_objects`` / ``all_hosts_agree``
    carry small JSON objects between ranks: the eval's metric sums, and
    decisions that gate collective code paths.
  * ``train.Engine`` refuses a multi-process run without ``--multihost``,
    saves from rank 0 only (every rank enters ``save()``), stride-shards
    eval items over the ranks and merges their metrics in rank order.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.distributed as dist

from eld_tpu_torch.config import rank_card

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _cluster_env() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         strict: bool = False,
                         backend: str = "nccl",
                         device: str = "cuda") -> tuple:
    """Initialize the default process group and return ``host_shard()``.

    Outcomes (eld_tpu's table):
      * a group is already initialized -> nothing to do;
      * explicit ``coordinator_address`` ("host:port"), ``num_processes``
        and ``process_id`` -> a group over ``tcp://`` with them (all three,
        or raise);
      * torchrun's environment -> a group from it (``env://``);
      * no cluster environment and nothing asked -> single process,
        ``(0, 1)``;
      * no cluster environment but ``strict`` (the user asked for
        ``--multihost``) -> raise: N uncoordinated copies would train on
        duplicate data.
    Under NCCL the group is bound at once to the rank's card, ``config.
    rank_card(device, LOCAL_RANK)`` (torchrun's LOCAL_RANK; the rank
    without it), the card the rank's Engine takes, so a failed NCCL init
    raises here, not at the first collective."""
    if dist.is_initialized():
        return host_shard()
    args = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in args):
        if any(a is None for a in args):
            raise ValueError("initialize_multihost: give coordinator_address, num_processes "
                             f"and process_id together, got {args}")
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id))
    elif _cluster_env():
        kw = dict(init_method="env://")
    elif strict:
        raise ValueError(
            "--multihost was given but no cluster environment was found (torchrun's "
            f"{', '.join(_TORCHRUN_ENV)}): give the entry point --mesh_data N (it launches "
            "its N ranks itself), or launch with `torchrun --nproc_per_node N -m "
            "eld_tpu_torch.tools.<entry point> ... --multihost`; continuing would train N "
            "uncoordinated copies on duplicate data")
    else:
        return (0, 1)
    if backend == "nccl":
        rank = int(process_id) if process_id is not None else int(os.environ["RANK"])
        card = rank_card(device, int(os.environ.get("LOCAL_RANK", rank)),
                         torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, **kw)
    return host_shard()


def maybe_initialize_multihost(cfg) -> tuple:
    """CLI bootstrap: initialize when ``cfg.multihost`` (strict; NCCL for a
    CUDA ``--device``, gloo for ``--device cpu``), then refuse a
    multi-process launch without the flag (the Engine checks again)."""
    if cfg.multihost:
        backend = "gloo" if torch.device(cfg.device).type == "cpu" else "nccl"
        return initialize_multihost(strict=True, backend=backend, device=cfg.device)
    world = max(host_shard()[1], int(os.environ.get("WORLD_SIZE", "1")))
    if world > 1:
        raise RuntimeError(
            f"{world} processes are present but --multihost was not given; every rank would "
            "load duplicate batches. Re-run with --multihost.")
    return (0, 1)


# Length-prefix sentinel marking an over-long payload.  The owning rank
# ENTERS the collective with this marker instead of raising beforehand: a
# rank-local raise would leave every other rank blocked in the collective
# forever; with the marker, every rank decodes it and raises the same error.
_OVERSIZE = (1 << 64) - 1


def _encode(obj, max_bytes: int) -> bytes:
    raw = json.dumps(obj).encode()
    if len(raw) + 8 > max_bytes:
        return _OVERSIZE.to_bytes(8, "little")
    return len(raw).to_bytes(8, "little") + raw


def _decode(buf: bytes, max_bytes: int):
    n = int.from_bytes(buf[:8], "little")
    if n == _OVERSIZE:
        raise ValueError(f"multihost payload exceeded max_bytes={max_bytes}; raised "
                         "collectively on every process")
    return json.loads(buf[8:8 + n].decode())


def broadcast_from_host0(obj, max_bytes: int = 1 << 16):
    """Rank 0's small JSON-serializable ``obj`` on every rank (one process:
    ``obj``).  An oversize payload raises on EVERY rank (see _OVERSIZE)."""
    rank, world = host_shard()
    if world == 1:
        return obj
    box = [_encode(obj, max_bytes) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return _decode(box[0], max_bytes)


def allgather_objects(obj, max_bytes: int = 1 << 16) -> list:
    """Every rank's small JSON-serializable object, ``[obj_from_rank0,
    obj_from_rank1, ...]``, the same list on every rank (one process:
    ``[obj]``).  The eval merges its metric sums in this order, so the
    means are bitwise-identical on every rank and the best-checkpoint
    decision agrees.  An oversize payload raises on EVERY rank."""
    world = host_shard()[1]
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, _encode(obj, max_bytes))
    return [_decode(b, max_bytes) for b in out]


def all_hosts_agree(flag: bool) -> bool:
    """True iff EVERY rank passes True (one process: ``flag``).  For
    decisions that gate collective code paths, such as whether the periodic
    eval runs: a rank that skipped it while the others entered the merge
    would hang them."""
    return all(bool(f) for f in allgather_objects(bool(flag)))


def barrier():
    """Wait for every rank (one process: nothing to wait for)."""
    if host_shard()[1] > 1:
        dist.barrier()


def host_shard() -> tuple:
    """(rank, world) for ``data.Loader(shard=...)``; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (0, 1)


def is_host0() -> bool:
    return host_shard()[0] == 0
