"""The two parallel axes and how they resolve (counterpart of
``eld_tpu/parallel/mesh.py``).

eld_tpu runs one process per host and shards over that host's devices
with a ``jax.sharding.Mesh`` of two named axes.  PyTorch runs one process
per card, so the port maps them so:

  * ``data``    -- one torch.distributed rank per card, launched by the
                   entry point itself from ``--mesh_data N`` (and -1,
                   every visible card from ``--device``'s on;
                   ``parallel/launch.py``) or by ``torchrun
                   --nproc_per_node N ... --multihost``; each rank trains
                   on its rows of every global batch and the ranks
                   average the gradients;
  * ``spatial`` -- the local cards of one process: the full-frame eval
                   forward runs a halo window of the frame on each of them
                   (``parallel/spatial.py``) and needs no collective.

eld_tpu's single-process ``data > 1`` is the entry point's launch: the
one command starts one rank per card, as PyTorch shards a batch.  Its
``data x spatial`` grid in one command is not supported yet.
"""

from __future__ import annotations

import dataclasses

import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 on the data axis means 'every rank'."""

    data: int = -1
    spatial: int = 1

    def resolve(self, world: int, cards: int) -> "MeshSpec":
        """The mesh of a run with ``world`` ranks and ``cards`` visible
        cards.  ``data`` must be the world size (-1 resolves to it), and
        ``spatial`` > 1 needs that many cards; neither falls back."""
        data = world if self.data <= 0 else self.data
        if data != world:
            raise ValueError(
                f"mesh data={data} needs {data} ranks, have {world}: the data axis is one "
                f"rank per card, so run the entry point with --mesh_data {data} and no "
                f"launcher (it launches its {data} ranks itself), or launch `torchrun "
                f"--nproc_per_node {data} -m eld_tpu_torch.tools.<entry point> ... "
                f"--multihost` (or leave --mesh_data -1)")
        spatial = max(1, self.spatial)
        if spatial > cards and spatial > 1:
            raise ValueError(
                f"mesh spatial={spatial} needs {spatial} visible CUDA cards (cuda:0.."
                f"cuda:{spatial - 1}), have {cards}: cuda:{cards} is missing")
        return MeshSpec(data=data, spatial=spatial)


def spatial_devices(device, spatial: int, cards: int) -> list:
    """The ``spatial`` cards a halo-sharded forward runs on: the run's own
    card ``cuda:k`` and the ones after it, ``cuda:k .. cuda:k+S-1``.
    Refuses a device that is not a card, and a range past the ``cards``
    visible ones; neither falls back."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"--mesh_spatial {spatial} shards the forward over CUDA cards, but --device is "
            f"{device}: pass --device cuda[:k] (the first of the {spatial} cards) or "
            "--mesh_spatial 1")
    first = torch.cuda.current_device() if device.index is None else device.index
    if first + spatial > cards:
        raise ValueError(
            f"mesh spatial={spatial} from --device cuda:{first} needs cuda:{first}.."
            f"cuda:{first + spatial - 1}, have {cards} visible cards: cuda:{cards} is missing")
    return [torch.device("cuda", first + i) for i in range(spatial)]


def rank_rows(rank: int, world: int, batch: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``batch`` rows: the
    contiguous block [rank*b, (rank+1)*b), b = batch // world, which is what
    eld_tpu's ``P(DATA_AXIS)`` sharding hands device ``rank``."""
    if batch % world:
        raise ValueError(f"a global batch of {batch} does not split over {world} ranks")
    b = batch // world
    return slice(rank * b, (rank + 1) * b)
