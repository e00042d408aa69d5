"""Image quality metrics (counterpart of ``eld_tpu/ops/metrics.py``): PSNR,
SSIM, and the reference's video helpers (``raw2gray``, ``compare_ncc``,
``local_error``, ``quality_assess_video`` with ST-RRED).

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


def _luma(r, g, b):
    """BT.601 luma — the ONE place the gray convention lives."""
    return 0.299 * r + 0.587 * g + 0.114 * b


def raw2gray(bayer_images: torch.Tensor) -> torch.Tensor:
    """Batched packed-raw (T, H, W, 4) -> luma (T, H, W), the reference's
    RGBG->RGB->gray video helper (``util/index.py:9-19``)."""
    x = torch.as_tensor(bayer_images).float()
    return _luma(x[..., 0], 0.5 * (x[..., 1] + x[..., 3]), x[..., 2])


def compare_ncc(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Normalized cross-correlation (``util/index.py:42-43``), population
    standard deviations."""
    x, y = torch.as_tensor(x).float(), torch.as_tensor(y).float()
    return (torch.mean((x - x.mean()) * (y - y.mean()))
            / (x.std(correction=0) * y.std(correction=0)))


def local_error(correct: torch.Tensor, estimate: torch.Tensor, window_size: int,
                window_shift: int) -> torch.Tensor:
    """Scale-invariant local sum-squared error of (H, W, C) images
    (``util/index.py:46-73``): within each window (strided by
    ``window_shift``, wholly inside the image) the estimate may be rescaled
    by the optimal alpha."""
    x = torch.as_tensor(correct).float().permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    y = torch.as_tensor(estimate).float().permute(2, 0, 1)[:, None]

    def wsum(a):
        return F.avg_pool2d(a, window_size, stride=window_shift, divisor_override=1)

    see, sce, scc = wsum(y * y), wsum(x * y), wsum(x * x)
    alpha = torch.where(see > 1e-5, sce / torch.clamp_min(see, 1e-5), torch.zeros_like(see))
    # sum((c - a e)^2) = scc - 2 a sce + a^2 see, per window
    ssq = scc - 2.0 * alpha * sce + alpha * alpha * see
    return torch.sum(ssq) / torch.sum(scc)


def quality_assess_video(pred: torch.Tensor, target: torch.Tensor,
                         data_range: float = 255.0) -> dict:
    """Framewise mean PSNR/SSIM + ST-RRED of (T, H, W, C) clips, the
    reference's video branch (``util/index.py:84-93``); single-frame clips
    report STRRED 0, as in the reference."""
    from eld_tpu_torch.ops.strred import strred

    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    psnrs = torch.stack([psnr(a, b, data_range) for a, b in zip(pred, target)])
    ssims = torch.stack([ssim(a, b, data_range) for a, b in zip(pred, target)])
    out = {"PSNR": float(psnrs.mean()), "SSIM": float(ssims.mean())}
    if pred.shape[0] == 1:
        out["STRRED"] = 0.0
        out["STRREDSN"] = 0.0
        return out

    def gray(x):  # packed raw via raw2gray; RGB via the same luma
        if x.shape[-1] == 4:
            return raw2gray(x)
        if x.shape[-1] != 3:
            raise ValueError(
                f"STRRED expects 3-channel RGB or 4-channel packed-raw clips (the "
                f"reference's domain); got {x.shape[-1]} channels, shape {tuple(x.shape)}")
        x = x.float()
        return _luma(x[..., 0], x[..., 1], x[..., 2])

    # STRRED's GSM noise floor (sigma_nsq = 0.1) is the published constant
    # for 0-255 luma, so the luma is scaled to that range
    scale = 255.0 / data_range
    _, out["STRRED"], out["STRREDSN"] = strred(gray(target) * scale, gray(pred) * scale)
    return out
