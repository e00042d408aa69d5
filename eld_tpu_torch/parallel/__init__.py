"""Parallel layer (counterpart of ``eld_tpu.parallel``): data parallelism over
torch.distributed ranks, halo-sharded full-frame eval over local cards."""

from eld_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, MeshSpec, rank_rows  # noqa: F401
