"""The frozen yardsticks: the card's peaks and K1's bytes.  A train
step's FLOPs are its architecture's (``archs/<arch>.py::step_flops``).
They are counted from the configuration's shapes, never from what the
program runs, so a later change to the program cannot move them."""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, dense rates
H100_BF16_FLOPS = 989.4e12
H100_HBM_BYTES_PER_S = 3350e9
# K1's parameter rows: 12 f32 a row
K1_PARAM_STRIDE = 12


def k1_bytes(shape) -> int:
    """The bytes one K1 launch must move: the batch read once, the batch
    written once and the (N, 12) f32 parameter rows."""
    n, h, w, c = shape
    return 2 * n * h * w * c * 4 + n * K1_PARAM_STRIDE * 4
