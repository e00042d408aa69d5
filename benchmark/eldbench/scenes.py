"""The clean patch pool, made on the card from the seed: a frozen copy of
the scene family of ``eld_tpu_torch/tools/demo_synthetic.py::
make_scenes_device`` (a uniform base, two gradients and six Gaussian
disks of random colour per scene, clipped to [0.02, 0.98]), quantized to
uint16 as the program's ``to_f32`` reads a uint16 pool back."""

from __future__ import annotations

import torch


def make_scenes(gen: torch.Generator, n: int, size: int, chunk: int):
    """Yield ``n`` scenes (c, size, size, 4) in [0.02, 0.98], ``chunk`` at a time."""
    dev = gen.device
    grid = torch.arange(size, device=dev, dtype=torch.float32) / size
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    for lo in range(0, n, chunk):
        c = min(chunk, n - lo)

        def rand(*s):
            return torch.rand((c, *s), generator=gen, device=dev)

        base_c, gy, gx = rand(4), rand(4), rand(4)
        cyx, r, amp = rand(6, 2), 0.05 + 0.2 * rand(6), (rand(6, 4) - 0.5) * 0.8
        base = (base_c[:, None, None] * 0.5
                + yy[None, ..., None] * (gy[:, None, None] - 0.5) * 0.6
                + xx[None, ..., None] * (gx[:, None, None] - 0.5) * 0.6)
        d2 = ((yy[None, None] - cyx[..., 0, None, None]) ** 2
              + (xx[None, None] - cyx[..., 1, None, None]) ** 2)
        masks = torch.exp(-d2 / (r[..., None, None] ** 2))
        base = base + torch.einsum("bkhw,bkc->bhwc", masks, amp)
        yield torch.clamp(base, 0.02, 0.98)


def make_pool(seed: int, n: int, size: int, device, chunk: int = 16) -> torch.Tensor:
    """(n, size, size, 4) uint16 on ``device``: round(scene * 65535)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    # uint16 has few kernels on the card: the codes are written through an
    # int16 view of the same bytes
    pool = torch.empty((n, size, size, 4), dtype=torch.int16, device=device)
    lo = 0
    for scenes in make_scenes(gen, n, size, chunk):
        q = torch.round(scenes * 65535.0).to(torch.int32)
        pool[lo:lo + scenes.shape[0]] = torch.where(q >= 32768, q - 65536, q).to(torch.int16)
        lo += scenes.shape[0]
    return pool.view(torch.uint16)
