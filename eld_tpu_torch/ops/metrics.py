"""Image quality metrics: PSNR and SSIM (counterpart of the PSNR/SSIM part
of ``eld_tpu/ops/metrics.py``).

Both match the skimage functions the reference scores with
(``util/index.py:76-81``):

  * PSNR = 10 log10(data_range^2 / MSE);
  * SSIM with a 7x7 box window, K1 = 0.01, K2 = 0.03, sample covariance
    (N/(N-1)), per channel, averaged over the windows that lie wholly
    inside the image (skimage's border crop) and over channels.

They compute in float32 on the tensor's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / mse)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of two (H, W, C) images."""
    # (C, 1, H, W): each channel its own image for the valid box mean
    x = pred.float().permute(2, 0, 1)[:, None]
    y = target.float().permute(2, 0, 1)[:, None]

    def mean(t):
        return F.avg_pool2d(t, win_size, stride=1)

    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    ux, uy = mean(x), mean(y)
    vx = cov_norm * (mean(x * x) - ux * ux)
    vy = cov_norm * (mean(y * y) - uy * uy)
    vxy = cov_norm * (mean(x * y) - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean()


def quality_assess(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0) -> dict:
    """{"PSNR", "SSIM"} of one (H, W, C) image pair, as Python floats."""
    return {"PSNR": float(psnr(pred, target, data_range)),
            "SSIM": float(ssim(pred, target, data_range))}
