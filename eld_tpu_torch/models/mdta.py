"""Restormer's transposed attention (MDTA) as one hand-written kernel each
way (``csrc/mdta.cu``), its wrapper and its plain version.

``mdta(qkv, temperature, heads)`` takes the depthwise conv's output, an
(N, H, W, 3·dim) NHWC tensor whose channels are q, k and v, each split
into ``heads`` heads of c = dim / heads channels, and returns the
(N, H, W, dim) attention output.  For each image and head, with q, k and
v the (c, H·W) slices:

    A = softmax_rows(temperature · q̂ k̂ᵀ),  q̂ = q / max(‖q‖, eps) row by row,
    out = A v,                              eps = 1e-12 (``F.normalize``'s),

the "transposed" attention of Zamir et al. (CVPR 2022): a c x c Gram
matrix reduced over every pixel, where a token attention would be
(H·W)².  ``temperature`` is the (heads, 1, 1) f32 parameter.

On the card (bf16 ``qkv``, dense NHWC, c of 48 or 96) the forward is one
pass over the pixels for each head's unnormalised Gram and row norms, a
c x c softmax, and one pass writing A v; the backward one pass for
dv = Aᵀ dOut and dA = dOut vᵀ, the softmax's and the normalisation's
backward on the c x c matrices, and one pass for dq and dk (the kernel's
source has the algebra).  q, k and v are read as channel slices of
``qkv``, never copied; what the backward keeps is ``qkv`` and three c x c
(or 2 x c) f32 matrices a head: A, q̂ k̂ᵀ and the norms.  No float atomics:
the same shape on the same card gives the same bits.  A card tensor the
kernels do not take (f32: Restormer run without ``--bf16``; a head size
other than 48 or 96: a ``--base_width`` other than 48) is refused with a
``ValueError``.  On the CPU the plain composition runs, ``plain_forward``,
in f32 and rounded once to ``qkv``'s dtype; its backward,
``plain_backward``, is the kernel's algebra in PyTorch ops.
Each way is one operator of the dispatcher (``eld_tpu_torch::mdta`` and
``eld_tpu_torch::mdta_backward``), so ``torch.export`` records the call.

``mdta.launches`` counts one per forward and one per backward run on the
card (a replayed CUDA graph adds its own, ``_build.counted``); the
kernels are named ``mdta_*``, so a trace reader finds them inside a
replayed graph.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from eld_tpu_torch import _build
from eld_tpu_torch.utils.logging import span

EPS = 1e-12
HEAD_SIZES = (48, 96)  # the head sizes the kernels are built for
TILE = 32  # pixels a tile of the kernels' passes
_BLOCKS_PER_SM = 2  # blocks of a chunked pass per SM, over all heads and images
_SMS = {}  # by card index

_p, _i64, _i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = _build.Library("mdta", ("mdta.cu",), {
    "eld_mdta_fwd": (_i, [_p] * 8 + [_i64, _i64, _i, _i, _i, _i64, _i, _p]),
    "eld_mdta_bwd": (_i, [_p] * 12 + [_i64, _i64, _i, _i, _i, _i64, _i, _p]),
}, "eld_mdta_error_string")


# ---- the plain version -------------------------------------------------------

def _split(qkv: torch.Tensor, heads: int):
    """q, k, v of (N, H, W, 3·dim) as f32 (N, heads, c, H·W)."""
    n, h, w, c3 = qkv.shape
    dim = c3 // 3
    t = qkv.float().reshape(n, h * w, 3, heads, dim // heads)
    return tuple(t[:, :, s].permute(0, 2, 3, 1) for s in range(3))


def _merge(parts, shape) -> torch.Tensor:
    """(N, heads, c, H·W) tensors -> (N, H, W, len(parts)·dim), parts in
    channel order."""
    n, heads, c, p = parts[0].shape
    t = torch.stack(parts, 1)  # (N, S, heads, c, P)
    return t.permute(0, 4, 1, 2, 3).reshape(*shape[:3], len(parts) * heads * c)


def plain_forward(qkv: torch.Tensor, temperature: torch.Tensor, heads: int):
    """The composition in f32: (out in qkv's dtype, A, q̂ k̂ᵀ, norms), the
    last three f32 (N, heads, c, c), (N, heads, c, c) and (N, heads, 2, c)
    (‖q‖ and ‖k‖ by channel, unclamped)."""
    q, k, v = _split(qkv, heads)
    nq, nk = q.norm(dim=-1), k.norm(dim=-1)
    qh = q / nq.clamp_min(EPS)[..., None]
    kh = k / nk.clamp_min(EPS)[..., None]
    gram = qh @ kh.transpose(-2, -1)
    attn = (gram * temperature.float().reshape(1, -1, 1, 1)).softmax(-1)
    out = _merge([attn @ v], qkv.shape).to(qkv.dtype)
    return out, attn, gram, torch.stack([nq, nk], 2)


def plain_backward(dout: torch.Tensor, qkv: torch.Tensor, temperature: torch.Tensor,
                   heads: int, attn: torch.Tensor, gram: torch.Tensor, norms: torch.Tensor):
    """(dqkv in qkv's dtype, dtemperature f32), by the kernels' algebra:

      dv = Aᵀ dOut;  dA = dOut vᵀ;  dS = A ∘ (dA - rowsum(dA ∘ A));
      dtemperature = Σ dS ∘ Ĝ;  dĜ = temperature · dS;
      M = dĜ / (max(‖q_i‖, eps) max(‖k_j‖, eps));
      α_i = rowsum(dĜ ∘ Ĝ)_i / max(‖q_i‖, eps)² (0 where ‖q_i‖ <= eps),
      β_j = colsum(dĜ ∘ Ĝ)_j / max(‖k_j‖, eps)² (0 where ‖k_j‖ <= eps);
      dq = M k - α q;  dk = Mᵀ q - β k.

    The normalisation's backward needs q̂·dq̂ a row, which is the row sum
    of dĜ ∘ Ĝ: no pass over the pixels."""
    q, k, v = _split(qkv, heads)
    n, h, w, c3 = qkv.shape
    c = c3 // 3 // heads
    g = dout.float().reshape(n, h * w, heads, c).permute(0, 2, 3, 1)
    dv = attn.transpose(-2, -1) @ g
    da = g @ v.transpose(-2, -1)
    ds = attn * (da - (da * attn).sum(-1, keepdim=True))
    dtemp = (ds * gram).sum((0, 2, 3)).reshape(temperature.shape)
    dg = ds * temperature.float().reshape(1, -1, 1, 1)
    nq, nk = norms[:, :, 0], norms[:, :, 1]
    sq, sk = nq.clamp_min(EPS), nk.clamp_min(EPS)
    m = dg / (sq[..., :, None] * sk[..., None, :])
    prod = dg * gram
    alpha = torch.where(nq > EPS, prod.sum(-1) / (sq * sq), 0.0)
    beta = torch.where(nk > EPS, prod.sum(-2) / (sk * sk), 0.0)
    dq = m @ k - alpha[..., None] * q
    dk = m.transpose(-2, -1) @ q - beta[..., None] * k
    return _merge([dq, dk, dv], qkv.shape).to(qkv.dtype), dtemp


# ---- the kernels ---------------------------------------------------------------

def kernel_applies(qkv: torch.Tensor, heads: int) -> bool:
    """Whether the card's kernels take ``qkv``: bf16 on a card, with a head
    size they are built for."""
    return (qkv.device.type == "cuda" and qkv.dtype == torch.bfloat16
            and qkv.shape[-1] % (3 * heads) == 0 and qkv.shape[-1] // 3 // heads in HEAD_SIZES)


def on_card(qkv: torch.Tensor, heads: int) -> bool:
    """True where the kernels run ``qkv``, False for a CPU tensor (the plain
    composition); a ``ValueError`` for a card tensor they do not take."""
    if qkv.device.type == "cpu":
        return False
    if not kernel_applies(qkv, heads):
        c = qkv.shape[-1] // 3 // heads
        raise ValueError(
            f"the mdta kernels take bf16 qkv with {' or '.join(map(str, HEAD_SIZES))} channels "
            f"a head on a card; got {qkv.dtype} with {c} channels a head on {qkv.device} "
            f"(Restormer on a card trains and serves under --bf16 at --base_width 48)")
    return True


def plan(n: int, heads: int, p: int, sms: int) -> Tuple[int, int, int]:
    """(chunks, chunk_len, tile_blocks) of one image's ``p`` pixels: the
    chunked passes (the Gram, dA) give each block ``chunk_len`` pixels, a
    whole number of tiles, so that all images and heads make about
    ``_BLOCKS_PER_SM`` blocks an SM; the tile passes run ``tile_blocks``
    blocks an image and head, each over every ``tile_blocks``-th tile."""
    tiles = -(-p // TILE)
    want = min(tiles, max(1, -(-_BLOCKS_PER_SM * sms // (n * heads))))
    chunk_len = -(-tiles // want) * TILE
    return -(-p // chunk_len), chunk_len, want


def _sms(device: torch.device) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def _check_card(*named):
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the mdta kernel takes dense NHWC tensors on 16-byte boundaries; "
                             f"{name} has strides {t.stride()} for shape {tuple(t.shape)}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def launch_forward(lib: ctypes.CDLL, qkv: torch.Tensor, temperature: torch.Tensor, heads: int):
    """One forward run (three launches) on the current stream: (out, A,
    q̂ k̂ᵀ, norms) as ``plain_forward`` returns them.  Counts nothing."""
    _check_card(("qkv", qkv))
    n, h, w, c3 = qkv.shape
    dim, p = c3 // 3, h * w
    c = dim // heads
    chunks, chunk_len, tile_blocks = plan(n, heads, p, _sms(qkv.device))
    f32 = dict(dtype=torch.float32, device=qkv.device)
    out = qkv.new_empty((n, h, w, dim))
    attn = torch.empty((n, heads, c, c), **f32)
    gram = torch.empty((n, heads, c, c), **f32)
    norms = torch.empty((n, heads, 2, c), **f32)
    gram_part = torch.empty((n * heads, chunks, c, c), **f32)
    norm_part = torch.empty((n * heads, chunks, 2, c), **f32)
    temp = _f32(temperature)
    with torch.cuda.device(qkv.device):
        rc = lib.eld_mdta_fwd(qkv.data_ptr(), temp.data_ptr(), out.data_ptr(), attn.data_ptr(),
                              gram.data_ptr(), norms.data_ptr(), gram_part.data_ptr(),
                              norm_part.data_ptr(), n, p, heads, dim, chunks, chunk_len,
                              tile_blocks, torch.cuda.current_stream(qkv.device).cuda_stream)
    LIBRARY.check(lib, rc, "forward")
    return out, attn, gram, norms


def launch_backward(lib: ctypes.CDLL, dout: torch.Tensor, qkv: torch.Tensor,
                    temperature: torch.Tensor, heads: int, attn: torch.Tensor,
                    gram: torch.Tensor, norms: torch.Tensor):
    """One backward run (three launches and the temperature's sum) on the
    current stream: (dqkv, dtemperature).  Counts nothing."""
    n, h, w, c3 = qkv.shape
    dim, p = c3 // 3, h * w
    c = dim // heads
    if dout.shape != (n, h, w, dim):
        raise ValueError(f"dout must be {(n, h, w, dim)}, got {tuple(dout.shape)}")
    dout = dout.to(qkv.dtype).contiguous()
    _check_card(("qkv", qkv), ("dout", dout))
    chunks, chunk_len, tile_blocks = plan(n, heads, p, _sms(qkv.device))
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    da_part = torch.empty((n * heads, chunks, c, c), **f32)
    m = torch.empty((n, heads, c, c), **f32)
    prod = torch.empty((n, heads, c, c), **f32)
    alpha = torch.empty((n, heads, c), **f32)
    dt_rows = torch.empty((n, heads, c), **f32)
    temp, attn, gram, norms = (_f32(t) for t in (temperature, attn, gram, norms))
    with torch.cuda.device(qkv.device):
        rc = lib.eld_mdta_bwd(dout.data_ptr(), qkv.data_ptr(), temp.data_ptr(),
                              attn.data_ptr(), gram.data_ptr(), norms.data_ptr(),
                              dqkv.data_ptr(), da_part.data_ptr(), m.data_ptr(),
                              prod.data_ptr(), alpha.data_ptr(), dt_rows.data_ptr(), n, p,
                              heads, dim, chunks, chunk_len, tile_blocks,
                              torch.cuda.current_stream(qkv.device).cuda_stream)
    LIBRARY.check(lib, rc, "backward")
    return dqkv, dt_rows.sum((0, 2)).reshape(temperature.shape)


def _check(qkv: torch.Tensor, temperature: torch.Tensor, heads: int):
    if qkv.ndim != 4 or heads < 1 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (N, H, W, 3·dim) with dim a multiple of heads = {heads}, "
                         f"got {tuple(qkv.shape)}")
    if temperature.numel() != heads or temperature.device != qkv.device:
        raise ValueError(f"temperature must hold {heads} values on {qkv.device}, got "
                         f"{tuple(temperature.shape)} on {temperature.device}")


# ---- the two operators ------------------------------------------------------------

@torch.library.custom_op("eld_tpu_torch::mdta", mutates_args=())
def _forward(qkv: torch.Tensor, temperature: torch.Tensor,
             heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if not on_card(qkv, heads):
        with torch.autocast(qkv.device.type, enabled=False):  # f32 inside, also under autocast
            return plain_forward(qkv, temperature, heads)
    outs = launch_forward(LIBRARY.load(), qkv, temperature, heads)
    mdta.launches += 1
    return outs


@_forward.register_fake
def _(qkv, temperature, heads):
    n, h, w, c3 = qkv.shape
    dim = c3 // 3
    c = dim // heads
    return (qkv.new_empty((n, h, w, dim)), qkv.new_empty((n, heads, c, c), dtype=torch.float32),
            qkv.new_empty((n, heads, c, c), dtype=torch.float32),
            qkv.new_empty((n, heads, 2, c), dtype=torch.float32))


@torch.library.custom_op("eld_tpu_torch::mdta_backward", mutates_args=())
def _backward(dout: torch.Tensor, qkv: torch.Tensor, temperature: torch.Tensor, heads: int,
              attn: torch.Tensor, gram: torch.Tensor,
              norms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not on_card(qkv, heads):
        with torch.autocast(qkv.device.type, enabled=False):
            return plain_backward(dout, qkv, temperature, heads, attn, gram, norms)
    grads = launch_backward(LIBRARY.load(), dout, qkv, temperature, heads, attn, gram, norms)
    mdta.launches += 1
    return grads


@_backward.register_fake
def _(dout, qkv, temperature, heads, attn, gram, norms):
    return torch.empty_like(qkv), torch.empty_like(temperature, dtype=torch.float32)


def _save(ctx, inputs, output):
    qkv, temperature, heads = inputs
    _, attn, gram, norms = output
    ctx.save_for_backward(qkv, temperature, attn, gram, norms)
    ctx.heads = heads
    ctx.mark_non_differentiable(attn, gram, norms)


def _gradients(ctx, dout, *_aux):
    qkv, temperature, attn, gram, norms = ctx.saved_tensors
    dqkv, dtemp = _backward(dout, qkv, temperature, ctx.heads, attn, gram, norms)
    return dqkv, dtemp.to(temperature.dtype), None


_forward.register_autograd(_gradients, setup_context=_save)


@_build.counted
def mdta(qkv: torch.Tensor, temperature: torch.Tensor, heads: int) -> torch.Tensor:
    """Transposed attention over (N, H, W, 3·dim) NHWC ``qkv`` with
    ``heads`` heads and the (heads, 1, 1) ``temperature``: (N, H, W, dim),
    in ``qkv``'s dtype."""
    _check(qkv, temperature, heads)
    with span("eld.mdta"):
        return _forward(qkv, temperature, heads)[0]
