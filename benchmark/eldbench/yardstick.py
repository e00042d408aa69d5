"""The frozen yardsticks: the card's peaks, the train step's FLOPs by
hand and K1's bytes.  They are counted from the configuration's shapes,
never from what the program runs, so a later change to the program
cannot move them."""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, dense rates
H100_BF16_FLOPS = 989.4e12
H100_HBM_BYTES_PER_S = 3350e9
# K1's parameter rows: 12 f32 a row
K1_PARAM_STRIDE = 12


def conv_flops(arch: str, n: int, h: int, w: int, width: int, cin: int = 4,
               cout: int = 4) -> int:
    """One train step's FLOPs: 3x the forward FLOPs of every conv and
    transposed conv (2 a multiply-add; the input gradient and the weight
    gradient cost as much as the forward), less the first conv's input
    gradient, which is never computed, and no recompute.  ``unet_s2d`` is
    the U-Net on (h/2, w/2, 4c)."""
    if arch == "unet_s2d":
        h, w, cin, cout = h // 2, w // 2, cin * 4, cout * 4
    widths = [width * 2 ** i for i in range(5)]
    first = 2 * n * h * w * 9 * cin * widths[0]
    fwd, prev = 0, cin
    for lvl, c in enumerate(widths):
        fwd += 2 * n * h * w * 9 * (prev * c + c * c)
        prev = c
        if lvl < 4:
            h, w = h // 2, w // 2
    for c in widths[3::-1]:
        fwd += 2 * n * h * w * 4 * (2 * c) * c
        h, w = 2 * h, 2 * w
        fwd += 2 * n * h * w * 9 * (2 * c * c + c * c)
    fwd += 2 * n * h * w * widths[0] * cout
    return 3 * fwd - first


def k1_bytes(shape) -> int:
    """The bytes one K1 launch must move: the batch read once, the batch
    written once and the (N, 12) f32 parameter rows."""
    n, h, w, c = shape
    return 2 * n * h * w * c * 4 + n * K1_PARAM_STRIDE * 4
