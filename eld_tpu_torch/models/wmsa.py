"""Uformer's shifted-window attention (W-MSA / SW-MSA) as one hand-written
kernel each way (``csrc/wmsa.cu``), its wrapper and its plain version.

``window_attention(qkv, bias, table, heads, shift)`` takes the qkv
projection's output, an (N, H, W, 3·C) token map whose channels are q, k
and v, each ``heads`` heads of d = C / heads channels, and returns the
(N, H, W, C) attention output.  The map is shifted cyclically by
``-shift`` pixels both ways (``torch.roll``), cut into win x win windows
(``win² = bias.shape[-1]``), and for each window and head

    S = q kᵀ d^-1/2 + B + M,   out = softmax_rows(S) v,

with B the head's (win², win²) relative-position bias (``bias``, (heads,
win², win²) f32, gathered by the caller from its table) and M the shift
mask, -100 between tokens of a shifted window that come from different
regions of the shifted frame (Swin's three slices each way), 0 elsewhere
and everywhere when ``shift`` is 0.  The windows are merged and shifted
back.  ``table`` is None or a (win², 3·C) f32 table added to every
window's tokens of ``qkv`` at their in-window position: Uformer's
modulator m enters as ``to_q(x + m) = to_q(x) + m Wqᵀ`` (and so for k and
v), so the caller passes ``table = m W_qkvᵀ`` and autograd carries its
gradient, the sum over windows of the tokens' gradients, to m and W.

On a card (bf16 ``qkv``, dense, head size 32, win 8, shift 0 or 4, H and
W multiples of 8) the forward is one kernel that reads q, k, v at their
pixels (the shift and the partition are its addressing: nothing is
rolled or copied), keeps the scores in registers and writes out once and
each row's log-sum-exp; the backward one kernel that recomputes the
scores from q, k and the log-sum-exp and writes dq, dk, dv once, and the
bias's and the table's gradients as per-block sums added in a fixed
order (no float atomics: the same shape on the same card gives the same
bits).  Any other card tensor is refused with a ``ValueError``.  On the
CPU the plain composition runs, ``plain_forward`` (roll, partition,
scores, bias, mask, softmax, P v, reverse, in f32, rounded once to
``qkv``'s dtype); its backward, ``plain_backward``, is the kernels'
algebra in PyTorch ops.  Each way is one operator of the dispatcher
(``eld_tpu_torch::window_attention`` and
``eld_tpu_torch::window_attention_backward``), so ``torch.export``
records the call.

``window_attention.launches`` counts one per forward and one per backward
run on the card (a replayed CUDA graph adds its own, ``_build.counted``);
the kernels are named ``wmsa_*``, so a trace reader finds them inside a
replayed graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from eld_tpu_torch import _build
from eld_tpu_torch.utils.logging import span

HEAD = 32  # the head size the kernels are built for
WIN = 8  # ... and the window
MASK = -100.0  # Swin's, and Uformer's

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = _build.Library("wmsa", ("wmsa.cu",), {
    "eld_wmsa_plan": (_i, [_i] * 7 + [ctypes.POINTER(_i)]),
    "eld_wmsa_fwd": (_i, [_p] * 5 + [_i] * 6 + [_p]),
    "eld_wmsa_bwd": (_i, [_p] * 10 + [_i] * 6 + [_p]),
}, "eld_wmsa_error_string")


# ---- the plain version -------------------------------------------------------

def partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(N, H, W, C) -> (N · H/win · W/win, win², C), windows in row order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def reverse(windows: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """``partition``'s inverse: (N · windows, win², C) -> (N, H, W, C)."""
    win = int(round(windows.shape[1] ** 0.5))
    c = windows.shape[-1]
    x = windows.reshape(n, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, c)


def shift_mask(h: int, w: int, win: int, shift: int, device=None) -> torch.Tensor:
    """The (H/win · W/win, win², win²) mask of a shifted frame: -100 between
    tokens of a window from different regions of Swin's slices, else 0."""
    region = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    label = 0
    for hs in slices:
        for ws in slices:
            region[:, hs, ws, :] = label
            label += 1
    lab = partition(region, win).squeeze(-1)
    diff = lab[:, None, :] - lab[:, :, None]
    return torch.where(diff != 0, MASK, 0.0)


def _windows(qkv: torch.Tensor, table: Optional[torch.Tensor], heads: int, shift: int, win: int):
    """q, k, v of every window and head in f32, (B_, heads, win², d)."""
    x = qkv.float()
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    t = partition(x, win)
    if table is not None:
        t = t + table.float()
    b, tok, c3 = t.shape
    t = t.reshape(b, tok, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def _scores(q, k, bias, shape, heads: int, shift: int, win: int) -> torch.Tensor:
    n, h, w = shape
    s = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5 + bias.float()
    if shift:
        nw = h * w // win ** 2
        mask = shift_mask(h, w, win, shift, q.device)
        s = (s.reshape(n, nw, heads, win * win, win * win) + mask[None, :, None]) \
            .reshape(s.shape)
    return s


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B_, heads, win², d) -> (B_, win², heads · d)."""
    b, heads, tok, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, tok, heads * d)


def _unwindow(t: torch.Tensor, shape, shift: int) -> torch.Tensor:
    x = reverse(t, *shape)
    return torch.roll(x, (shift, shift), (1, 2)) if shift else x


def plain_forward(qkv: torch.Tensor, bias: torch.Tensor, table: Optional[torch.Tensor],
                  heads: int, shift: int):
    """The composition in f32: (out in qkv's dtype, lse), lse the (B_,
    heads, win²) f32 log-sum-exp of each window's score rows."""
    n, h, w, _ = qkv.shape
    win = int(round(bias.shape[-1] ** 0.5))
    q, k, v = _windows(qkv, table, heads, shift, win)
    s = _scores(q, k, bias, (n, h, w), heads, shift, win)
    lse = s.logsumexp(-1)
    out = _merge(torch.exp(s - lse[..., None]) @ v)
    return _unwindow(out, (n, h, w), shift).to(qkv.dtype), lse


def plain_backward(dout: torch.Tensor, qkv: torch.Tensor, bias: torch.Tensor,
                   table: Optional[torch.Tensor], lse: torch.Tensor, heads: int, shift: int):
    """(dqkv in qkv's dtype, dbias f32, dtable f32 or an empty tensor), by
    the kernels' algebra:

      P = exp(S - lse);  dV = Pᵀ dO;  dP = dO Vᵀ;  dS = P ∘ (dP - rowsum(P ∘ dP));
      dQ = dS K d^-1/2;  dK = dSᵀ Q d^-1/2;
      dbias = Σ over windows of dS;  dtable[p] = Σ over windows of d(q|k|v)[p]."""
    n, h, w, _ = qkv.shape
    win = int(round(bias.shape[-1] ** 0.5))
    q, k, v = _windows(qkv, table, heads, shift, win)
    p = torch.exp(_scores(q, k, bias, (n, h, w), heads, shift, win) - lse[..., None])
    g = dout.float()
    if shift:
        g = torch.roll(g, (-shift, -shift), (1, 2))
    g = partition(g, win)
    g = g.reshape(g.shape[0], g.shape[1], heads, -1).permute(0, 2, 1, 3)
    dv = p.transpose(-2, -1) @ g
    dp = g @ v.transpose(-2, -1)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    scale = q.shape[-1] ** -0.5
    dq = ds @ k * scale
    dk = ds.transpose(-2, -1) @ q * scale
    dwin = torch.cat([_merge(dq), _merge(dk), _merge(dv)], -1)
    dtable = dwin.sum(0) if table is not None else dwin.new_empty((0,))
    dqkv = _unwindow(dwin, (n, h, w), shift).to(qkv.dtype)
    return dqkv, ds.sum(0), dtable


# ---- the kernels ---------------------------------------------------------------

def kernel_applies(qkv: torch.Tensor, bias: torch.Tensor, heads: int, shift: int) -> bool:
    """Whether the card's kernels take these: bf16 ``qkv`` on a card, head
    size 32, window 8, shift 0 or 4, H and W multiples of 8."""
    n, h, w, c3 = qkv.shape
    return (qkv.device.type == "cuda" and qkv.dtype == torch.bfloat16
            and c3 == 3 * HEAD * heads and bias.shape[-1] == WIN * WIN
            and shift in (0, WIN // 2) and h % WIN == 0 and w % WIN == 0)


def on_card(qkv: torch.Tensor, bias: torch.Tensor, heads: int, shift: int) -> bool:
    """True where the kernels run, False for a CPU tensor (the plain
    composition); a ``ValueError`` for a card tensor they do not take."""
    if qkv.device.type == "cpu":
        return False
    if not kernel_applies(qkv, bias, heads, shift):
        n, h, w, c3 = qkv.shape
        win = int(round(bias.shape[-1] ** 0.5))
        raise ValueError(
            f"the wmsa kernels take bf16 qkv with {HEAD} channels a head, windows of {WIN} "
            f"and a shift of 0 or {WIN // 2} on H and W multiples of {WIN}; got {qkv.dtype} "
            f"with {c3 // 3 // heads} channels a head, windows of {win}, shift {shift} on "
            f"{h} x {w} on {qkv.device} (Uformer on a card trains and serves under --bf16 at "
            f"--base_width 32)")
    return True


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` dense on a 16-byte boundary (the kernels move 16-byte pieces),
    copied only where it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _plan(lib: ctypes.CDLL, qkv: torch.Tensor, heads: int, shift: int, modulated: bool,
          backward: bool) -> int:
    n, h, w, _ = qkv.shape
    ctas = ctypes.c_int(0)
    rc = lib.eld_wmsa_plan(n, h, w, heads, shift, int(modulated), int(backward),
                           ctypes.byref(ctas))
    LIBRARY.check(lib, rc, "plan")
    return ctas.value


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else _dense(t.float())


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_forward(lib: ctypes.CDLL, qkv: torch.Tensor, bias: torch.Tensor,
                   table: Optional[torch.Tensor], heads: int, shift: int):
    """One forward launch on the current stream: (out, lse) as
    ``plain_forward`` returns them.  Counts nothing."""
    qkv = _dense(qkv)
    n, h, w, c3 = qkv.shape
    bias, table = _f32(bias), _f32(table)
    out = qkv.new_empty((n, h, w, c3 // 3))
    lse = torch.empty((n * (h // WIN) * (w // WIN), heads, WIN * WIN), dtype=torch.float32,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        ctas = _plan(lib, qkv, heads, shift, table is not None, False)
        rc = lib.eld_wmsa_fwd(qkv.data_ptr(), bias.data_ptr(), _ptr(table), out.data_ptr(),
                              lse.data_ptr(), n, h, w, heads, shift, ctas,
                              torch.cuda.current_stream(qkv.device).cuda_stream)
    LIBRARY.check(lib, rc, "forward")
    return out, lse


def launch_backward(lib: ctypes.CDLL, dout: torch.Tensor, qkv: torch.Tensor, bias: torch.Tensor,
                    table: Optional[torch.Tensor], lse: torch.Tensor, heads: int, shift: int):
    """One backward run (the kernel and the sums of its workspaces) on the
    current stream: (dqkv, dbias, dtable or an empty tensor).  Counts
    nothing."""
    qkv = _dense(qkv)
    n, h, w, c3 = qkv.shape
    if dout.shape != (n, h, w, c3 // 3):
        raise ValueError(f"dout must be {(n, h, w, c3 // 3)}, got {tuple(dout.shape)}")
    dout = _dense(dout.to(qkv.dtype))
    bias, table, lse = _f32(bias), _f32(table), _f32(lse)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    tok, tab = WIN * WIN, 3 * HEAD
    dbias = torch.empty((heads, tok, tok), **f32)
    with torch.cuda.device(qkv.device):
        ctas = _plan(lib, qkv, heads, shift, table is not None, True)
        part_b = torch.empty((heads, ctas, tok, tok), **f32)
        part_t = dtab = None
        if table is not None:
            part_t = torch.empty((heads, ctas, tok, tab), **f32)
            dtab = torch.empty((heads, tok, tab), **f32)
        rc = lib.eld_wmsa_bwd(dout.data_ptr(), qkv.data_ptr(), bias.data_ptr(), _ptr(table),
                              lse.data_ptr(), dqkv.data_ptr(), part_b.data_ptr(), _ptr(part_t),
                              dbias.data_ptr(), _ptr(dtab), n, h, w, heads, shift, ctas,
                              torch.cuda.current_stream(qkv.device).cuda_stream)
    LIBRARY.check(lib, rc, "backward")
    if dtab is None:
        return dqkv, dbias, dqkv.new_empty((0,), dtype=torch.float32)
    # (heads, win², [q | k | v] of the head) -> (win², 3 C), channels q | k | v, each by head
    dtable = dtab.reshape(heads, tok, 3, HEAD).permute(1, 2, 0, 3).reshape(tok, c3)
    return dqkv, dbias, dtable


def _check(qkv: torch.Tensor, bias: torch.Tensor, table: Optional[torch.Tensor], heads: int,
           shift: int):
    if qkv.ndim != 4 or heads < 1 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (N, H, W, 3·C) with C a multiple of heads = {heads}, "
                         f"got {tuple(qkv.shape)}")
    tok = bias.shape[-1]
    win = int(round(tok ** 0.5))
    n, h, w, c3 = qkv.shape
    if bias.shape != (heads, tok, tok) or win * win != tok or h % win or w % win:
        raise ValueError(f"bias must be (heads, win², win²) of a window dividing {h} x {w}, "
                         f"got {tuple(bias.shape)} for {heads} heads")
    if not 0 <= shift < win:
        raise ValueError(f"the shift must lie in [0, {win}), got {shift}")
    if table is not None and table.shape != (tok, c3):
        raise ValueError(f"the modulator's table must be {(tok, c3)}, got {tuple(table.shape)}")
    for name, t in (("bias", bias), ("table", table)):
        if t is not None and t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")


# ---- the two operators ------------------------------------------------------------

@torch.library.custom_op("eld_tpu_torch::window_attention", mutates_args=())
def _forward(qkv: torch.Tensor, bias: torch.Tensor, table: Optional[torch.Tensor], heads: int,
             shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if not on_card(qkv, bias, heads, shift):
        with torch.autocast(qkv.device.type, enabled=False):  # f32 inside, also under autocast
            return plain_forward(qkv, bias, table, heads, shift)
    outs = launch_forward(LIBRARY.load(), qkv, bias, table, heads, shift)
    window_attention.launches += 1
    return outs


@_forward.register_fake
def _(qkv, bias, table, heads, shift):
    n, h, w, c3 = qkv.shape
    tok = bias.shape[-1]
    wins = n * h * w // tok
    return qkv.new_empty((n, h, w, c3 // 3)), qkv.new_empty((wins, heads, tok),
                                                           dtype=torch.float32)


@torch.library.custom_op("eld_tpu_torch::window_attention_backward", mutates_args=())
def _backward(dout: torch.Tensor, qkv: torch.Tensor, bias: torch.Tensor,
              table: Optional[torch.Tensor], lse: torch.Tensor, heads: int,
              shift: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not on_card(qkv, bias, heads, shift):
        with torch.autocast(qkv.device.type, enabled=False):
            return plain_backward(dout, qkv, bias, table, lse, heads, shift)
    grads = launch_backward(LIBRARY.load(), dout, qkv, bias, table, lse, heads, shift)
    window_attention.launches += 1
    return grads


@_backward.register_fake
def _(dout, qkv, bias, table, lse, heads, shift):
    dtable = (qkv.new_empty(table.shape, dtype=torch.float32) if table is not None
              else qkv.new_empty((0,), dtype=torch.float32))
    return torch.empty_like(qkv), qkv.new_empty(bias.shape, dtype=torch.float32), dtable


def _save(ctx, inputs, output):
    qkv, bias, table, heads, shift = inputs
    ctx.save_for_backward(qkv, bias, table, output[1])
    ctx.heads, ctx.shift = heads, shift
    ctx.mark_non_differentiable(output[1])


def _gradients(ctx, dout, _dlse):
    qkv, bias, table, lse = ctx.saved_tensors
    dqkv, dbias, dtable = _backward(dout, qkv, bias, table, lse, ctx.heads, ctx.shift)
    return (dqkv, dbias.to(bias.dtype), None if table is None else dtable.to(table.dtype),
            None, None)


_forward.register_autograd(_gradients, setup_context=_save)


@_build.counted
def window_attention(qkv: torch.Tensor, bias: torch.Tensor, table: Optional[torch.Tensor],
                     heads: int, shift: int) -> torch.Tensor:
    """Shifted-window attention over (N, H, W, 3·C) ``qkv`` with ``heads``
    heads, the (heads, win², win²) relative-position ``bias``, the modulator's
    (win², 3·C) ``table`` or None, and a cyclic ``shift``: (N, H, W, C), in
    ``qkv``'s dtype."""
    _check(qkv, bias, table, heads, shift)
    with span("eld.wmsa"):
        return _forward(qkv, bias, table, heads, shift)[0]
