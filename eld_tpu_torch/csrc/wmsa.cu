// Uformer's shifted-window attention (W-MSA / SW-MSA) for NVIDIA Hopper (sm_90a), one pass each
// way.
//
// Replaces no TPU kernel: eld_tpu has no Uformer.  It exists because no PyTorch call computes
// windowed softmax attention with a learned additive bias whose gradient is needed (the fused
// SDPA backends take no trainable bias), and the composition writes the scores, adds the bias
// and the shift mask in passes of their own, keeps every probability for its backward, and
// copies x and the output through `roll` and the window partition each way.  For one image,
// one 8 x 8 window of 64 tokens (after the cyclic shift by `shift` pixels, 0 or 4) and one
// head of d = 32 channels, with q, k, v the (64, d) rows of the qkv projection's output, T the
// modulator's (64, 3 C) table (m W_qkv^T, added to every window's tokens at their in-window
// position; zero for a block without a modulator), B the head's (64, 64) relative-position
// bias and M the shift mask (-100 between tokens of different regions of a shifted window):
//
//   forward   S = (q + Tq)(k + Tk)^T d^-1/2 + B + M,   P = softmax_rows(S),   O = P (v + Tv)
//             lse_i = log sum_j exp S_ij                               (saved, f32)
//   backward  P = exp(S - lse)   (S recomputed from q, k and T)
//             dV = P^T dO,  dP = dO V^T,  D_i = rowsum(P o dP)_i,  dS = P o (dP - D)
//             dQ = dS K d^-1/2,  dK = dS^T Q d^-1/2
//             dB = sum over every window and image of dS,   dT[p] = sum over windows of d(q|k|v)[p]
//
// D_i = dO_i . O_i, the row's share of the softmax's backward, is rowsum(P o dP): the whole row
// lives in one block, so the backward reads no O.  models/wmsa.py's plain_backward is the same
// algebra in PyTorch ops.
//
// What bounds it on an H100: bytes.  A window's products are 64 x 64 x 32 per head, 32 FLOPs
// per byte of bf16 moved, a ninth of the card's ~295, so the least time is q, k, v read and
// out written forward, q, k, v, dO read and dq, dk, dv written backward: 22 bytes per
// channel-pixel.  The design:
//
//  - The cyclic shift and the window partition, and their reverses, are the kernels'
//    addressing: token (py, px) of window (wy, wx) is pixel ((8 wy + py + shift) mod H,
//    (8 wx + px + shift) mod W) of the image, read from and written to the (N, H, W, .) token
//    layout in 16-byte pieces.  Nothing is rolled or copied.
//  - A block of 4 warps takes one head and walks windows b, b + G, ... (G blocks a head, one
//    wave of the card); warp w owns the window's queries 16 w ... 16 w + 15.  The products run
//    on the tensor cores (mma.sync m16n8k16 bf16, f32 sums) from shared-memory tiles read by
//    ldmatrix; S stays in registers, and its accumulator layout is the next product's operand
//    layout, so P is never stored forward.  The next window's tiles are loaded into registers
//    while the current one computes.
//  - The softmax is f32 from the f32 scores; P is rounded to bf16 for P V (as autocast rounds
//    it for its matmul); each output is staged in shared memory and written once in 16-byte
//    pieces.
//  - The sums over windows (dB, and dT where a modulator is given) are deterministic, with no
//    float atomics: each thread owns fixed entries and adds its windows in order, each block
//    writes one row of an f32 workspace, and wmsa_sum adds the rows in a fixed order.  The same
//    shape on the same card gives the same bits, so a CUDA graph replays what the eager call
//    computed.
//
// Kernels: wmsa_fwd forward; wmsa_bwd and wmsa_sum backward (a trace names each;
// benchmark/metrics/wmsa.roofline_pct.py sums them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWin = 8;           // window side
constexpr int kTok = kWin * kWin;  // tokens a window
constexpr int kHead = 32;         // channels a head
constexpr int kWarps = 4;         // a warp 16 queries (forward) or 16 queries then 16 keys
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kHead + 8;    // bf16 row stride of a token tile (80 bytes: ldmatrix's rows
                                  // fall on distinct 16-byte bank groups)
constexpr int kLdP = kTok + 8;    // bf16 row stride of a 64 x 64 tile (144 bytes)
constexpr int kLdB = kTok + 8;    // f32 row stride of the bias tile
constexpr int kTab = 3 * kHead;   // a head's channels of the modulator's table: q, k, v
constexpr int kLdT = kTab + 8;    // f32 row stride of dT's tile
constexpr int kPieces = kHead / 8;                // 16-byte pieces of a token's head
constexpr int kTilePieces = kTok * kPieces;       // ... of a tile
constexpr int kSumSlices = 32;
constexpr float kMask = -100.0f;  // Swin's, and Uformer's
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kTilePieces % kThreads == 0, "whole pieces a thread");

constexpr int kTabSmem = kTok * kLdT * 4;  // a head's share of the table, and of dT's sums
constexpr int kFwdSmem = (3 * kTok * kLd) * 2 + kTok * kLdB * 4;
constexpr int kFwdSmemMod = kFwdSmem + kTabSmem;
// the modulated backward reads the bias from L1 in place of a tile of its own, so that two
// blocks fit an SM with the table and dT's sums
constexpr int kBwdSmem = (4 * kTok * kLd + 2 * kTok * kLdP) * 2 + 2 * kTok * kLdB * 4;
constexpr int kBwdSmemMod = kBwdSmem - kTok * kLdB * 4 + 2 * kTabSmem;

// The windows of a launch: n images of h x w pixels, windows of kWin x kWin after a cyclic
// shift by `shift`, heads of kHead channels, c = heads * kHead the attention's width.
struct Geo {
  int n, h, w, heads, c, shift, wins_x, wins;
  int64_t total;  // windows in all: n * wins
};

__device__ inline uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

__device__ inline void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

// d += a b, a 16 x 16 (row major), b 16 x 8 (column major), bf16 in, f32 sums
__device__ inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of rows r0 ... r0 + 15 and columns k0 ... k0 + 15 of a row-major tile.
__device__ inline void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The A operand of the transpose of a row-major tile: rows (of the transpose) m0 ... m0 + 15,
// columns k0 ... k0 + 15, i.e. the tile's rows k0 ... and columns m0 ....
__device__ inline void load_a_t(uint32_t (&a)[4], const bf16* tile, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_t(a, tile + (k0 + (mi >> 1) * 8 + (lane & 7)) * ld + m0 + (mi & 1) * 8);
}

// The B operands of a product with a tile stored [n][k] (B = the tile's transpose): n-tile
// n0 ... n0 + 7 over k = 0 ... 31, two k-steps: b[0], b[1] the first's, b[2], b[3] the second's.
__device__ inline void load_b_nk(uint32_t (&b)[4], const bf16* tile, int ld, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm(b, tile + (n0 + (lane & 7)) * ld + (lane >> 3) * 8);
}

// The B operands of a product with a tile stored [k][n]: the k-step k0 ... k0 + 15 of the
// n-tiles n0 ... n0 + 7 (b[0], b[1]) and n0 + 8 ... n0 + 15 (b[2], b[3]).
__device__ inline void load_b_kn(uint32_t (&b)[4], const bf16* tile, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_t(b, tile + (k0 + (mi & 1) * 8 + (lane & 7)) * ld + n0 + (mi >> 1) * 8);
}

// Where a window's tokens live: the pixel of token p of window `win`, and its shift region
// (3 lh + lw, Swin's slices of the shifted frame; 0 unshifted).
struct Window {
  int64_t pix0;  // the image's first pixel
  int y0, x0;    // the window's corner in the shifted frame
};

__device__ inline Window window_of(const Geo& g, int64_t win) {
  Window o;
  const int64_t img = win / g.wins;
  const int r = static_cast<int>(win - img * g.wins);
  const int wy = r / g.wins_x;
  o.pix0 = img * g.h * g.w;
  o.y0 = wy * kWin;
  o.x0 = (r - wy * g.wins_x) * kWin;
  return o;
}

__device__ inline int64_t pixel_of(const Geo& g, const Window& o, int p) {
  int y = o.y0 + (p >> 3) + g.shift, x = o.x0 + (p & 7) + g.shift;
  if (y >= g.h) y -= g.h;
  if (x >= g.w) x -= g.w;
  return o.pix0 + static_cast<int64_t>(y) * g.w + x;
}

__device__ inline int region_of(const Geo& g, const Window& o, int p) {
  const int y = o.y0 + (p >> 3), x = o.x0 + (p & 7);
  const int lh = y < g.h - kWin ? 0 : (y < g.h - g.shift ? 1 : 2);
  const int lw = x < g.w - kWin ? 0 : (x < g.w - g.shift ? 1 : 2);
  return 3 * lh + lw;
}

// A thread's pieces of `tiles` token tiles of a window (tile t: channels off[t] ... + 31 of
// each token, row stride ld[t] elements of src[t]), held in registers between the load and
// the store into shared memory.
template <int TILES>
struct Pieces {
  static constexpr int M = TILES * kTilePieces / kThreads;
  uint4 v[M];

  __device__ void load(const Geo& g, const Window& o, const bf16* const (&src)[TILES],
                       const int64_t (&ld)[TILES]) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = threadIdx.x + m * kThreads, t = e / kTilePieces, r = e % kTilePieces;
      const int p = r / kPieces, k = r % kPieces;
      v[m] = *reinterpret_cast<const uint4*>(src[t] + pixel_of(g, o, p) * ld[t] + k * 8);
    }
  }

  // into tiles dst[t] ([kTok][kLd]); tile t < 3 gets the head's table row p (the shared
  // [kTok][kLdT] `tab`: q's, k's, v's 32 channels) added where MOD, and is rounded once more
  template <bool MOD>
  __device__ void store(bf16* const (&dst)[TILES], const float* tab) const {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = threadIdx.x + m * kThreads, t = e / kTilePieces, r = e % kTilePieces;
      const int p = r / kPieces, k = r % kPieces;
      uint4 val = v[m];
      if (MOD && t < 3) {
        const float* row = tab + p * kLdT + t * kHead + k * 8;
        bf16* h = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int u = 0; u < 8; ++u) h[u] = __float2bfloat16_rn(__bfloat162float(h[u]) + row[u]);
      }
      *reinterpret_cast<uint4*>(dst[t] + p * kLd + k * 8) = val;
    }
  }
};

// Rows r0 ... r0 + 15 of a warp's f32 results acc[nt] (16 x 32: columns 8 nt + 2 t, + 1) into
// its rows of the bf16 tile `stage`; then the warp writes them to their tokens' pixels of dst
// (row stride ld elements, from channel col), 16 bytes a piece.
__device__ inline void write_rows(const Geo& g, const Window& o, bf16* stage, int r0,
                                  const float (&acc)[4][4], float scale, bf16* __restrict__ dst,
                                  int64_t ld, int col) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<uint32_t*>(stage + (r0 + gr) * kLd + nt * 8 + tc) =
        pack(acc[nt][0] * scale, acc[nt][1] * scale);
    *reinterpret_cast<uint32_t*>(stage + (r0 + gr + 8) * kLd + nt * 8 + tc) =
        pack(acc[nt][2] * scale, acc[nt][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = lane + 32 * m, p = r0 + (e >> 2), k = e & 3;
    *reinterpret_cast<uint4*>(dst + pixel_of(g, o, p) * ld + col + k * 8) =
        *reinterpret_cast<const uint4*>(stage + p * kLd + k * 8);
  }
}

// The warp's 16 x 64 scores S = Q K^T d^-1/2 + B (+ M), rows r0 ... r0 + 15: s[nt] holds rows
// r0 + gr (s[nt][0..1]) and r0 + gr + 8 (s[nt][2..3]), keys 8 nt + tc, + 1.
template <bool SHIFT>
__device__ inline void scores(float (&s)[8][4], const Geo& g, const Window& o, const bf16* sq,
                              const bf16* sk, const float* sb, int ldb, int r0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tc = (lane & 3) * 2;
  const float scale = rsqrtf(static_cast<float>(kHead));
  uint32_t qa[2][4];
  load_a(qa[0], sq, kLd, r0, 0);
  load_a(qa[1], sq, kLd, r0, 16);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    uint32_t kb[4];
    load_b_nk(kb, sk, kLd, nt * 8);
    mma(s[nt], qa[0], kb[0], kb[1]);
    mma(s[nt], qa[1], kb[2], kb[3]);
  }
  int reg0 = 0, reg1 = 0;
  if (SHIFT) {
    reg0 = region_of(g, o, r0 + gr);
    reg1 = region_of(g, o, r0 + gr + 8);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + tc + e;
      float m0 = sb[(r0 + gr) * ldb + j], m1 = sb[(r0 + gr + 8) * ldb + j];
      if (SHIFT) {
        const int rj = region_of(g, o, j);
        if (rj != reg0) m0 += kMask;
        if (rj != reg1) m1 += kMask;
      }
      s[nt][e] = fmaf(s[nt][e], scale, m0);
      s[nt][2 + e] = fmaf(s[nt][2 + e], scale, m1);
    }
  }
}

__device__ inline float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ inline float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the bias of the block's head into the shared [kTok][kLdB] tile
__device__ inline void load_bias(float* sb, const float* __restrict__ bias, int head) {
  const float* b = bias + static_cast<int64_t>(head) * kTok * kTok;
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) sb[(e / kTok) * kLdB + e % kTok] = b[e];
}

// the head's channels of the (kTok, 3 c) table into the shared [kTok][kLdT] tile: q's, k's, v's
__device__ inline void load_table(float* st, const float* __restrict__ table, int head, int c) {
  for (int e = threadIdx.x; e < kTok * kTab; e += kThreads) {
    const int p = e / kTab, j = e % kTab, t = j / kHead;
    st[p * kLdT + j] = table[static_cast<int64_t>(p) * 3 * c + t * c + head * kHead + j % kHead];
  }
}

// ---- forward -------------------------------------------------------------------------------

// Block (b, head), over windows b, b + gridDim.x, ...: out and lse.  Dynamic shared memory
// kFwdSmem (kFwdSmemMod): q, k, v tiles, the bias, the head's table.
template <bool SHIFT, bool MOD>
__global__ void __launch_bounds__(kThreads)
    wmsa_fwd(const bf16* __restrict__ qkv, const float* __restrict__ bias,
             const float* __restrict__ table, bf16* __restrict__ out, float* __restrict__ lse,
             Geo g) {
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* sq = reinterpret_cast<bf16*>(raw);
  bf16* sk = sq + kTok * kLd;
  bf16* sv = sk + kTok * kLd;
  float* sb = reinterpret_cast<float*>(sv + kTok * kLd);
  float* stab = sb + kTok * kLdB;  // MOD only
  const int head = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = (lane & 3) * 2, r0 = warp * 16;
  const int64_t ld = 3 * static_cast<int64_t>(g.c);
  const bf16* const src[3] = {qkv + head * kHead, qkv + g.c + head * kHead,
                              qkv + 2 * g.c + head * kHead};
  const int64_t lds[3] = {ld, ld, ld};
  bf16* const dst[3] = {sq, sk, sv};
  load_bias(sb, bias, head);
  if (MOD) load_table(stab, table, head, g.c);
  Pieces<3> next;
  int64_t win = blockIdx.x;
  if (win < g.total) next.load(g, window_of(g, win), src, lds);
  for (; win < g.total; win += gridDim.x) {
    const Window o = window_of(g, win);
    __syncthreads();  // the last window's tiles are read
    next.template store<MOD>(dst, stab);
    __syncthreads();
    if (win + gridDim.x < g.total) next.load(g, window_of(g, win + gridDim.x), src, lds);
    float s[8][4];
    scores<SHIFT>(s, g, o, sq, sk, sb, kLdB, r0);
    // the softmax of rows r0 + gr and r0 + gr + 8, in base 2
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
    m0 = quad_max(m0) * kLog2e;
    m1 = quad_max(m1) * kLog2e;
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], kLog2e, -m0));
        s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], kLog2e, -m1));
        l0 += s[nt][e];
        l1 += s[nt][2 + e];
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if ((lane & 3) == 0) {
      float* row = lse + (win * g.heads + head) * kTok + r0 + gr;
      row[0] = (m0 + log2f(l0)) * kLn2;
      row[8] = (m1 + log2f(l1)) * kLn2;
    }
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
    // O = P V: P's accumulator layout is the A operand's, keys 16 kk ... 16 kk + 15
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0] * i0, s[2 * kk][1] * i0),
                              pack(s[2 * kk][2] * i1, s[2 * kk][3] * i1),
                              pack(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0),
                              pack(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1)};
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t vb[4];
        load_b_kn(vb, sv, kLd, kk * 16, np * 16);
        mma(acc[2 * np], pa, vb[0], vb[1]);
        mma(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    // the warp's rows of sq are its own and read: stage O there
    write_rows(g, o, sq, r0, acc, 1.0f, out, g.c, head * kHead);
  }
}

// ---- backward ------------------------------------------------------------------------------

// Block (b, head), over windows b, b + gridDim.x, ...: dqkv, and the block's rows of the
// workspaces: part_b[head][b] its windows' sum of dS ([kTok][kTok]), part_t[head][b] their sum
// of dq, dk, dv by in-window position ([kTok][kTab], MOD only).  Dynamic shared memory
// kBwdSmem (kBwdSmemMod): q, k, v, dO tiles, P and dS, dB's sums, then the bias tile (or, MOD,
// the head's table and dT's sums, the bias read through L1).
template <bool SHIFT, bool MOD>
__global__ void __launch_bounds__(kThreads)
    wmsa_bwd(const bf16* __restrict__ dout, const bf16* __restrict__ qkv,
             const float* __restrict__ bias, const float* __restrict__ table,
             const float* __restrict__ lse, bf16* __restrict__ dqkv, float* __restrict__ part_b,
             float* __restrict__ part_t, Geo g) {
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* sq = reinterpret_cast<bf16*>(raw);
  bf16* sk = sq + kTok * kLd;
  bf16* sv = sk + kTok * kLd;
  bf16* sd = sv + kTok * kLd;
  bf16* sp = sd + kTok * kLd;
  bf16* sds = sp + kTok * kLdP;
  float* sdb = reinterpret_cast<float*>(sds + kTok * kLdP);
  float* sb = sdb + kTok * kLdB;    // !MOD
  float* stab = sdb + kTok * kLdB;  // MOD, in the bias tile's place
  float* st = stab + kTok * kLdT;   // MOD
  const int head = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = (lane & 3) * 2, r0 = warp * 16;
  const float scale = rsqrtf(static_cast<float>(kHead));
  const int64_t ld = 3 * static_cast<int64_t>(g.c);
  const bf16* const src[4] = {qkv + head * kHead, qkv + g.c + head * kHead,
                              qkv + 2 * g.c + head * kHead, dout + head * kHead};
  const int64_t lds[4] = {ld, ld, ld, g.c};
  bf16* const dst[4] = {sq, sk, sv, sd};
  const float* bsrc = MOD ? bias + static_cast<int64_t>(head) * kTok * kTok : sb;
  const int ldb = MOD ? kTok : kLdB;
  if (MOD)
    load_table(stab, table, head, g.c);
  else
    load_bias(sb, bias, head);
  // dB's sums: each thread adds to its own entries, rows r0 + gr, + 8, keys 8 nt + tc, + 1
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) sdb[(e / kTok) * kLdB + e % kTok] = 0.0f;
  if (MOD)
    for (int e = threadIdx.x; e < kTok * kTab; e += kThreads) st[(e / kTab) * kLdT + e % kTab] = 0.0f;
  Pieces<4> next;
  int64_t win = blockIdx.x;
  if (win < g.total) next.load(g, window_of(g, win), src, lds);
  for (; win < g.total; win += gridDim.x) {
    const Window o = window_of(g, win);
    __syncthreads();  // the last window's tiles and stages are read
    next.template store<MOD>(dst, stab);
    __syncthreads();
    if (win + gridDim.x < g.total) next.load(g, window_of(g, win + gridDim.x), src, lds);
    // P, recomputed from the scores and the saved lse
    float p[8][4];
    scores<SHIFT>(p, g, o, sq, sk, bsrc, ldb, r0);
    const float* lrow = lse + (win * g.heads + head) * kTok + r0 + gr;
    const float l0 = lrow[0] * kLog2e, l1 = lrow[8] * kLog2e;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      p[nt][0] = exp2f(fmaf(p[nt][0], kLog2e, -l0));
      p[nt][1] = exp2f(fmaf(p[nt][1], kLog2e, -l0));
      p[nt][2] = exp2f(fmaf(p[nt][2], kLog2e, -l1));
      p[nt][3] = exp2f(fmaf(p[nt][3], kLog2e, -l1));
    }
    // dP = dO V^T, then dS = P o (dP - rowsum(P o dP))
    float ds[8][4];
    {
      uint32_t da[2][4];
      load_a(da[0], sd, kLd, r0, 0);
      load_a(da[1], sd, kLd, r0, 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.0f;
        uint32_t vb[4];
        load_b_nk(vb, sv, kLd, nt * 8);
        mma(ds[nt], da[0], vb[0], vb[1]);
        mma(ds[nt], da[1], vb[2], vb[3]);
      }
    }
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      d0 = fmaf(p[nt][0], ds[nt][0], fmaf(p[nt][1], ds[nt][1], d0));
      d1 = fmaf(p[nt][2], ds[nt][2], fmaf(p[nt][3], ds[nt][3], d1));
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ds[nt][0] = p[nt][0] * (ds[nt][0] - d0);
      ds[nt][1] = p[nt][1] * (ds[nt][1] - d0);
      ds[nt][2] = p[nt][2] * (ds[nt][2] - d1);
      ds[nt][3] = p[nt][3] * (ds[nt][3] - d1);
      const int j = nt * 8 + tc;
      float* b0 = sdb + (r0 + gr) * kLdB + j;
      float* b1 = sdb + (r0 + gr + 8) * kLdB + j;
      b0[0] += ds[nt][0];
      b0[1] += ds[nt][1];
      b1[0] += ds[nt][2];
      b1[1] += ds[nt][3];
      *reinterpret_cast<uint32_t*>(sp + (r0 + gr) * kLdP + j) = pack(p[nt][0], p[nt][1]);
      *reinterpret_cast<uint32_t*>(sp + (r0 + gr + 8) * kLdP + j) = pack(p[nt][2], p[nt][3]);
      *reinterpret_cast<uint32_t*>(sds + (r0 + gr) * kLdP + j) = pack(ds[nt][0], ds[nt][1]);
      *reinterpret_cast<uint32_t*>(sds + (r0 + gr + 8) * kLdP + j) = pack(ds[nt][2], ds[nt][3]);
    }
    // dQ = dS K (d^-1/2 at the write), the warp's queries
    float dq[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack(ds[2 * kk][0], ds[2 * kk][1]), pack(ds[2 * kk][2], ds[2 * kk][3]),
                             pack(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                             pack(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4];
        load_b_kn(kb, sk, kLd, kk * 16, np * 16);
        mma(dq[2 * np], a, kb[0], kb[1]);
        mma(dq[2 * np + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();  // P and dS complete
    // dV = P^T dO and dK = dS^T Q (d^-1/2 at the write), the warp's keys r0 ... r0 + 15
    float dv[4][4], dk[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[nt][e] = dk[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], sa[4];
      load_a_t(pa, sp, kLdP, r0, kk * 16);
      load_a_t(sa, sds, kLdP, r0, kk * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t ob[4], qb[4];
        load_b_kn(ob, sd, kLd, kk * 16, np * 16);
        load_b_kn(qb, sq, kLd, kk * 16, np * 16);
        mma(dv[2 * np], pa, ob[0], ob[1]);
        mma(dv[2 * np + 1], pa, ob[2], ob[3]);
        mma(dk[2 * np], sa, qb[0], qb[1]);
        mma(dk[2 * np + 1], sa, qb[2], qb[3]);
      }
    }
    if (MOD) {  // the thread's entries of dT: its rows, channels 8 nt + tc, + 1 of q, k, v
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = nt * 8 + tc;
        float* a = st + (r0 + gr) * kLdT + c;
        float* b = st + (r0 + gr + 8) * kLdT + c;
        a[0] += dq[nt][0] * scale;
        a[1] += dq[nt][1] * scale;
        b[0] += dq[nt][2] * scale;
        b[1] += dq[nt][3] * scale;
        a[kHead] += dk[nt][0] * scale;
        a[kHead + 1] += dk[nt][1] * scale;
        b[kHead] += dk[nt][2] * scale;
        b[kHead + 1] += dk[nt][3] * scale;
        a[2 * kHead] += dv[nt][0];
        a[2 * kHead + 1] += dv[nt][1];
        b[2 * kHead] += dv[nt][2];
        b[2 * kHead + 1] += dv[nt][3];
      }
    }
    __syncthreads();  // every warp has read q, k, v and dO: their tiles stage the outputs
    write_rows(g, o, sq, r0, dq, scale, dqkv, ld, head * kHead);
    write_rows(g, o, sk, r0, dk, scale, dqkv, ld, g.c + head * kHead);
    write_rows(g, o, sv, r0, dv, 1.0f, dqkv, ld, 2 * g.c + head * kHead);
  }
  // the block's rows of the workspaces
  __syncthreads();
  const int64_t slot = static_cast<int64_t>(head) * gridDim.x + blockIdx.x;
  float* pb = part_b + slot * kTok * kTok;
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) pb[e] = sdb[(e / kTok) * kLdB + e % kTok];
  if (MOD) {
    float* pt = part_t + slot * kTok * kTab;
    for (int e = threadIdx.x; e < kTok * kTab; e += kThreads) pt[e] = st[(e / kTab) * kLdT + e % kTab];
  }
}

// out[y][e] = sum over rows b of partial[y][b][e], in a fixed order: slice ty of the 32 sums
// rows ty, ty + 32, ... in turn, then slice 0 adds the slices.  blockIdx.y: the head.
__global__ void __launch_bounds__(32 * kSumSlices)
    wmsa_sum(const float* __restrict__ partial, float* __restrict__ out, int rows, int entries) {
  __shared__ float part[kSumSlices][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const float* src = partial + static_cast<int64_t>(blockIdx.y) * rows * entries;
  float acc = 0.0f;
  if (e < entries)
    for (int b = threadIdx.y; b < rows; b += kSumSlices)
      acc = __fadd_rn(acc, src[static_cast<int64_t>(b) * entries + e]);
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < entries) {
    float s = part[0][threadIdx.x];
    for (int i = 1; i < kSumSlices; ++i) s = __fadd_rn(s, part[i][threadIdx.x]);
    out[static_cast<int64_t>(blockIdx.y) * entries + e] = s;
  }
}

bool make_geo(int n, int h, int w, int heads, int shift, Geo* g) {
  if (n < 1 || h < kWin || w < kWin || h % kWin || w % kWin || heads < 1 || heads > 65535 ||
      (shift != 0 && shift != kWin / 2))
    return false;
  g->n = n;
  g->h = h;
  g->w = w;
  g->heads = heads;
  g->c = heads * kHead;
  g->shift = shift;
  g->wins_x = w / kWin;
  g->wins = (h / kWin) * g->wins_x;
  g->total = static_cast<int64_t>(n) * g->wins;
  return true;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool SHIFT, bool MOD>
int launch_fwd(const bf16* qkv, const float* bias, const float* table, bf16* out, float* lse,
               const Geo& g, int ctas, cudaStream_t s) {
  auto* k = wmsa_fwd<SHIFT, MOD>;
  const int bytes = MOD ? kFwdSmemMod : kFwdSmem;
  int rc = static_cast<int>(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 bytes));
  if (rc != 0) return rc;
  k<<<dim3(ctas, g.heads), kThreads, bytes, s>>>(qkv, bias, table, out, lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool SHIFT, bool MOD>
int launch_bwd(const bf16* dout, const bf16* qkv, const float* bias, const float* table,
               const float* lse, bf16* dqkv, float* part_b, float* part_t, const Geo& g, int ctas,
               cudaStream_t s) {
  auto* k = wmsa_bwd<SHIFT, MOD>;
  const int bytes = MOD ? kBwdSmemMod : kBwdSmem;
  int rc = static_cast<int>(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 bytes));
  if (rc != 0) return rc;
  k<<<dim3(ctas, g.heads), kThreads, bytes, s>>>(dout, qkv, bias, table, lse, dqkv, part_b,
                                                 part_t, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool SHIFT, bool MOD>
int occupancy(int backward, int* per_sm) {
  if (backward) {
    auto* k = wmsa_bwd<SHIFT, MOD>;
    const int bytes = MOD ? kBwdSmemMod : kBwdSmem;
    int rc = static_cast<int>(
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (rc != 0) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, kThreads,
                                                                          bytes));
  }
  auto* k = wmsa_fwd<SHIFT, MOD>;
  const int bytes = MOD ? kFwdSmemMod : kFwdSmem;
  int rc = static_cast<int>(
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, kThreads,
                                                                        bytes));
}

}  // namespace

extern "C" {

// qkv: (n, h, w, 3 c) bf16, dense, channels q | k | v, each heads x 32; out, dout: (n, h, w, c)
// bf16; dqkv like qkv, every element written.  bias: (heads, 64, 64) f32.  table: null or the
// modulator's (64, 3 c) f32 table.  lse: (n * windows, heads, 64) f32.  h and w are multiples
// of 8, shift 0 or 4, `ctas` the blocks a head (eld_wmsa_plan).  part_b: (heads, ctas, 64, 64)
// f32 and dbias (heads, 64, 64); part_t: (heads, ctas, 64, 96) f32 and dtable (heads, 64, 96),
// q's, k's then v's 32 channels of the head (table given only).  Each returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for arguments it does not
// take.

// The blocks a head: one wave of the card that is current, at most the windows.
int eld_wmsa_plan(int n, int h, int w, int heads, int shift, int modulated, int backward,
                  int* ctas) {
  Geo g;
  if (!make_geo(n, h, w, heads, shift, &g)) return static_cast<int>(cudaErrorInvalidValue);
  int device, sms, per_sm = 0;
  int rc = static_cast<int>(cudaGetDevice(&device));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (rc == 0) {
    if (shift)
      rc = modulated ? occupancy<true, true>(backward, &per_sm)
                     : occupancy<true, false>(backward, &per_sm);
    else
      rc = modulated ? occupancy<false, true>(backward, &per_sm)
                     : occupancy<false, false>(backward, &per_sm);
  }
  if (rc != 0) return rc;
  const int64_t want = (static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) + heads - 1) / heads;
  const int64_t c = want < g.total ? want : g.total;
  *ctas = static_cast<int>(c < 65535 ? c : 65535);
  return 0;
}

int eld_wmsa_fwd(const void* qkv, const float* bias, const float* table, void* out, float* lse,
                 int n, int h, int w, int heads, int shift, int ctas, void* stream) {
  Geo g;
  if (!make_geo(n, h, w, heads, shift, &g) || ctas < 1 || ctas > 65535 || !aligned(qkv) ||
      !aligned(out) || !aligned(table))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const bf16*>(qkv);
  auto* o = static_cast<bf16*>(out);
  if (shift)
    return table ? launch_fwd<true, true>(x, bias, table, o, lse, g, ctas, s)
                 : launch_fwd<true, false>(x, bias, table, o, lse, g, ctas, s);
  return table ? launch_fwd<false, true>(x, bias, table, o, lse, g, ctas, s)
               : launch_fwd<false, false>(x, bias, table, o, lse, g, ctas, s);
}

int eld_wmsa_bwd(const void* dout, const void* qkv, const float* bias, const float* table,
                 const float* lse, void* dqkv, float* part_b, float* part_t, float* dbias,
                 float* dtable, int n, int h, int w, int heads, int shift, int ctas,
                 void* stream) {
  Geo g;
  if (!make_geo(n, h, w, heads, shift, &g) || ctas < 1 || ctas > 65535 || !aligned(qkv) ||
      !aligned(dout) || !aligned(dqkv) || (table && (!part_t || !dtable)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* go = static_cast<const bf16*>(dout);
  const auto* x = static_cast<const bf16*>(qkv);
  auto* dx = static_cast<bf16*>(dqkv);
  int rc;
  if (shift)
    rc = table ? launch_bwd<true, true>(go, x, bias, table, lse, dx, part_b, part_t, g, ctas, s)
               : launch_bwd<true, false>(go, x, bias, table, lse, dx, part_b, part_t, g, ctas, s);
  else
    rc = table ? launch_bwd<false, true>(go, x, bias, table, lse, dx, part_b, part_t, g, ctas, s)
               : launch_bwd<false, false>(go, x, bias, table, lse, dx, part_b, part_t, g, ctas,
                                          s);
  if (rc != 0) return rc;
  const dim3 block(32, kSumSlices);
  wmsa_sum<<<dim3((kTok * kTok + 31) / 32, heads), block, 0, s>>>(part_b, dbias, ctas,
                                                                  kTok * kTok);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !table) return rc;
  wmsa_sum<<<dim3((kTok * kTab + 31) / 32, heads), block, 0, s>>>(part_t, dtable, ctas,
                                                                  kTok * kTab);
  return static_cast<int>(cudaGetLastError());
}

const char* eld_wmsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
