"""Full-resolution demosaic and preview rendering (counterpart of
``eld_tpu/core/demosaic.py``), the port's stand-in for the LibRaw
postprocess path the reference renders saved previews with
(``models/ELD_model.py:41-72``).

Two render paths:
  * half-size (LibRaw ``half_size=True``, what the reference's previews
    use): each 2x2 CFA cell -> one RGB pixel, the ISP's ``binning``
    (``core/isp.py::process``);
  * full resolution: bilinear or Malvar-He-Cutler stencils on the mosaic,
    as ``torch.nn.functional.conv2d`` calls on the tensor's device.

Input is the packed (h, w, 4) RGBG tensor (black/white-normalized);
output linear RGB (2h, 2w, 3), channels last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eld_tpu_torch.core import isp
from eld_tpu_torch.core.packing import unpack_bayer

BAYER_OFFSETS = ((0, 0), (0, 1), (1, 1), (1, 0))


def _stencil(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _conv2(x: torch.Tensor, kernel: torch.Tensor, reflect: bool = False) -> torch.Tensor:
    """Cross-correlation of an (H, W) plane with a square kernel, the output
    the input's size: zero padding ("SAME"), or reflect padding (no dark
    borders)."""
    k = kernel.shape[0] // 2
    x = x[None, None]
    if reflect:
        x = F.pad(x, (k, k, k, k), mode="reflect")
    return F.conv2d(x, kernel[None, None], padding=0 if reflect else k)[0, 0]


def _site_mask(shape, offset, device) -> torch.Tensor:
    """1.0 at the mosaic sites of parity ``offset`` = (row, col), else 0."""
    h, w = shape
    rows = (torch.arange(h, device=device) % 2 == offset[0])[:, None]
    cols = (torch.arange(w, device=device) % 2 == offset[1])[None, :]
    return (rows & cols).float()


def demosaic_bilinear(packed: torch.Tensor, offsets=BAYER_OFFSETS) -> torch.Tensor:
    """(h, w, 4) packed RGBG -> (2h, 2w, 3) linear RGB, bilinear stencils:
    green from the plus-shaped neighborhood, red/blue from the box."""
    mosaic = unpack_bayer(packed, offsets=offsets)
    dev = mosaic.device
    site = [_site_mask(mosaic.shape, off, dev) for off in offsets]  # R, G1, B, G2
    masks = (site[0], site[1] + site[3], site[2])
    k_plus = _stencil([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dev) / 4.0
    k_box = _stencil([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dev) / 4.0
    out = []
    for m, kern in zip(masks, (k_box, k_plus, k_box)):
        num = _conv2(mosaic * m, kern)
        den = _conv2(m, kern)
        out.append(num / torch.clamp_min(den, 1e-8))
    return torch.stack(out, dim=-1)


# Malvar-He-Cutler gradient-corrected linear filters (ICASSP 2004), x8.
_MHC_G = ((0, 0, -1, 0, 0),  # G at an R or B site
          (0, 0, 2, 0, 0),
          (-1, 2, 4, 2, -1),
          (0, 0, 2, 0, 0),
          (0, 0, -1, 0, 0))
_MHC_ROW = ((0, 0, 0.5, 0, 0),  # R/B at a G site whose same-color row neighbors match
            (0, -1, 0, -1, 0),
            (-1, 4, 5, 4, -1),
            (0, -1, 0, -1, 0),
            (0, 0, 0.5, 0, 0))
_MHC_X = ((0, 0, -1.5, 0, 0),  # R at a B site / B at an R site
          (0, 2, 0, 2, 0),
          (-1.5, 0, 6, 0, -1.5),
          (0, 2, 0, 2, 0),
          (0, 0, -1.5, 0, 0))


def demosaic_mhc(packed: torch.Tensor, offsets=BAYER_OFFSETS) -> torch.Tensor:
    """(h, w, 4) packed RGBG -> (2h, 2w, 3) via Malvar-He-Cutler: four fixed
    5x5 stencils on the mosaic (reflect-padded) and a per-phase selection;
    the stand-in for LibRaw's full-quality ``postprocess()`` demosaic."""
    mosaic = unpack_bayer(packed, offsets=offsets)
    dev = mosaic.device
    (rr, _), g1, (br, _), g2 = offsets
    k_row = _stencil(_MHC_ROW, dev) / 8.0
    c_g = _conv2(mosaic, _stencil(_MHC_G, dev) / 8.0, reflect=True)
    c_row = _conv2(mosaic, k_row, reflect=True)
    c_col = _conv2(mosaic, k_row.T.contiguous(), reflect=True)
    c_x = _conv2(mosaic, _stencil(_MHC_X, dev) / 8.0, reflect=True)

    m_r, m_g1, m_b, m_g2 = (_site_mask(mosaic.shape, off, dev) for off in offsets)
    G = mosaic * (m_g1 + m_g2) + c_g * (m_r + m_b)
    # R at a green site: the row stencil if that green shares the R row parity
    r_g1 = c_row if g1[0] == rr else c_col
    r_g2 = c_row if g2[0] == rr else c_col
    R = mosaic * m_r + r_g1 * m_g1 + r_g2 * m_g2 + c_x * m_b
    b_g1 = c_row if g1[0] == br else c_col
    b_g2 = c_row if g2[0] == br else c_col
    B = mosaic * m_b + b_g1 * m_g1 + b_g2 * m_g2 + c_x * m_r
    return torch.stack([R, G, B], dim=-1)


def render_preview(packed: torch.Tensor, wb, ccm, gamma: float = 2.2, half_size: bool = True,
                   crf=None, demosaic: str = "mhc") -> torch.Tensor:
    """Packed raw (h, w, 4) -> sRGB preview, mirroring the reference's
    saved-image path.  ``half_size`` matches the released behavior (the
    ISP's binning); full resolution demosaics with Malvar-He-Cutler
    (``demosaic="bilinear"`` for the cheap stencil).  ``wb`` (4,) is
    normalized by its green; ``ccm`` is the top-left 3x3 of what is given;
    ``crf`` an optional (E, fs) pair of (3, K) arrays or tensors."""
    dev = packed.device
    if half_size:
        return isp.raw2rgb(packed, wb, ccm, crf=crf, gamma=gamma)
    wb = isp._tensor(wb, dev)
    wb = wb / wb[1]
    ccm = isp._tensor(ccm, dev)[:3, :3]
    fn = demosaic_mhc if demosaic == "mhc" else demosaic_bilinear
    rgb = fn(torch.clamp(packed * wb.reshape(1, 1, 4), 0.0, 1.0))
    rgb = torch.clamp(isp.apply_ccms(rgb[None], ccm[None])[0], 0.0, 1.0)
    if crf is None:
        return isp.gamma_compression(rgb[None], gamma)[0]
    return isp.apply_crf(rgb[None], isp._tensor(crf[0], dev), isp._tensor(crf[1], dev))[0]
