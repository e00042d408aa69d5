// Restormer's transposed attention (MDTA) for NVIDIA Hopper (sm_90a), one run each way.
//
// Replaces no TPU kernel: eld_tpu has no Restormer.  It exists because no single PyTorch call
// computes normalise -> Gram -> softmax -> A v, and the composition under bf16 autocast writes
// and keeps f32 copies of the normalised q and k, runs each Gram as a batched GEMM with
// M = N = c and K = H*W, and repeats every pass in its backward.  For one image and one head,
// with q, k, v the (c, P) channel slices of the depthwise conv's output (c = 48 or 96 channels,
// P = H*W pixels) and t the head's temperature:
//
//   forward   G = q k^T,  nq_i = |q_i|,  nk_j = |k_j|       (one pass over the pixels)
//             Gh = G / (max(nq_i, eps) max(nk_j, eps)),  A = softmax_rows(t Gh)   (c x c)
//             out = A v                                     (one pass over the pixels)
//   backward  dv = A^T dOut,  dA = dOut v^T                 (one pass over the pixels)
//             dS = A o (dA - rowsum(dA o A)),  dt = sum(dS o Gh),  dGh = t dS,
//             M = dGh / (max(nq_i, eps) max(nk_j, eps)),
//             alpha_i = rowsum(dGh o Gh)_i / max(nq_i, eps)^2, beta_j = colsum(dGh o Gh)_j / ..
//             (0 where the norm is at most eps: the clamp passes no gradient)    (c x c)
//             dq = M k - alpha o q,  dk = M^T q - beta o k  (one pass over the pixels)
//
// The normalisation's backward needs q^.dq^ for each row, which is rowsum(dGh o Gh): the
// c x c matrices carry it, and no pass over the pixels does.  models/mdta.py's plain_backward
// is the same algebra in PyTorch ops.
//
// What bounds it on an H100: bytes.  The products are c x c x P, 2c FLOPs per byte of bf16
// read at c = 48, under the card's ~295 FLOP/byte, so every pass over the pixels is
// memory-bound, and the least bytes are q, k, v read and out written forward, dOut, v, q, k
// read and dv, dq, dk written backward: 22 bytes per channel-pixel.  The design:
//
//  - q, k and v are read in place as channel slices of the NHWC (N, H, W, 3 dim) tensor, in
//    tiles of 32 pixels x c channels by 16-byte loads into shared memory; every product over a
//    tile runs on the tensor cores (WMMA bf16 16x16x16, f32 sums).  A warp owns one 16-wide
//    slice of the head's channels: c / 16 warps, 2c threads a block.
//  - The passes that reduce over the pixels (G and the norms, dA) give each block a chunk of
//    whole tiles and write its f32 partials; a per-row kernel adds them in a fixed order, so
//    there are no float atomics and the same shape on the same card gives the same bits (a
//    CUDA graph replays what the eager call computed).
//  - The c x c matrices (A, M) are rounded to bf16 once a block into shared memory, as the
//    composition's autocast rounds them for its matmuls; a pass's output tile is staged in
//    f32 and rounded once.
//
// Kernels: mdta_gram, mdta_softmax, mdta_apply forward; mdta_dv_da, mdta_softmax_bwd,
// mdta_dq_dk backward (a trace names each; benchmark/metrics/mdta.roofline_pct.py sums them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 32;         // pixels a tile
constexpr int kRowThreads = 128;  // threads of the per-row kernels (c <= 128)
constexpr float kEps = 1e-12f;    // F.normalize's

template <int C>
struct Shape {
  static constexpr int kWarps = C / 16;  // a warp a 16-wide slice of the head's channels
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = C + 8;   // bf16 row stride in shared memory, off the banks' period
  static constexpr int kLdf = C + 4;  // f32 row stride of the staging tile
  static constexpr int kVec = C / 8;  // 16-byte chunks in a row of c bf16
};

#if defined(__CUDA_ARCH__)
namespace wmma = nvcuda::wmma;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ inline int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// `rows` rows (pixels) of c channels at src, row stride ld elements, into the shared tile
// [kTile][kLd]; the rows past them are zero, so they add nothing to any product.
template <int C>
__device__ inline void load_tile(bf16* __restrict__ dst, const bf16* __restrict__ src, int64_t ld,
                                 int rows) {
  using S = Shape<C>;
  for (int e = threadIdx.x; e < kTile * S::kVec; e += S::kThreads) {
    const int r = e / S::kVec, v = e - r * S::kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * ld + v * 8);
    *reinterpret_cast<uint4*>(dst + r * S::kLd + v * 8) = val;
  }
}

// a c x c f32 matrix (row-major) rounded to bf16 into the shared [c][kLd]
template <int C>
__device__ inline void load_square(bf16* __restrict__ dst, const float* __restrict__ src) {
  for (int e = threadIdx.x; e < C * C; e += Shape<C>::kThreads) {
    const int r = e / C, c = e - r * C;
    dst[r * Shape<C>::kLd + c] = __float2bfloat16_rn(src[e]);
  }
}

// the first `rows` rows of the f32 staging tile [kTile][kLdf], less scale[c] * x[r][c] where x
// (a shared bf16 tile) is given, rounded to bf16 and written to dst (row stride ld elements)
template <int C>
__device__ inline void store_tile(bf16* __restrict__ dst, int64_t ld, int rows,
                                  const float* __restrict__ stage, const bf16* __restrict__ x,
                                  const float* __restrict__ scale) {
  using S = Shape<C>;
  for (int e = threadIdx.x; e < kTile * S::kVec; e += S::kThreads) {
    const int r = e / S::kVec, v = e - r * S::kVec;
    if (r >= rows) continue;
    uint4 raw;
    bf16* o = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = v * 8 + u;
      float f = stage[r * S::kLdf + c];
      if (x != nullptr) f -= scale[c] * __bfloat162float(x[r * S::kLd + c]);
      o[u] = __float2bfloat16_rn(f);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + v * 8) = raw;
  }
}

// the sum (or the largest) over the kRowThreads threads of a block, in a fixed order; every
// thread gets it.  A butterfly gives every lane the same bits: a + b == b + a.
template <bool kMax>
__device__ inline float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();  // red is written again by the next reduction
  return t;
}
#endif  // __CUDA_ARCH__

// ---- forward -------------------------------------------------------------------------------

// Block (chunk, n * heads + head): the chunk's partial G = q k^T ([c][c]) and its sums of
// squares of q's and k's channels ([2][c]).  Warp w computes G's rows 16w..16w+15.
template <int C>
__global__ void __launch_bounds__(Shape<C>::kThreads)
    mdta_gram(const bf16* __restrict__ qkv, float* __restrict__ gram_part,
              float* __restrict__ norm_part, int64_t p, int heads, int dim, int chunks,
              int64_t chunk_len) {
#if defined(__CUDA_ARCH__)
  using S = Shape<C>;
  __shared__ __align__(128) bf16 sq[kTile * S::kLd];
  __shared__ __align__(128) bf16 sk[kTile * S::kLd];
  const int nh = blockIdx.y, n = nh / heads, head = nh - n * heads;
  const int warp = threadIdx.x / 32;
  const int64_t ld = 3 * static_cast<int64_t>(dim);
  const bf16* q = qkv + n * p * ld + head * C;
  const bf16* k = q + dim;
  const int64_t begin = blockIdx.x * chunk_len, end = min64(begin + chunk_len, p);
  Acc acc[S::kWarps];
#pragma unroll
  for (int j = 0; j < S::kWarps; ++j) wmma::fill_fragment(acc[j], 0.0f);
  // thread t < c sums q's channel t, thread c + t k's
  const bf16* col = (threadIdx.x < C ? sq : sk) + threadIdx.x % C;
  float sumsq = 0.0f;
  for (int64_t p0 = begin; p0 < end; p0 += kTile) {
    const int rows = static_cast<int>(min64(kTile, end - p0));
    load_tile<C>(sq, q + p0 * ld, ld, rows);
    load_tile<C>(sk, k + p0 * ld, ld, rows);
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float x = __bfloat162float(col[r * S::kLd]);
      sumsq = fmaf(x, x, sumsq);
    }
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      FragACol a;  // q^T: rows i, columns pixels
      wmma::load_matrix_sync(a, sq + kk * S::kLd + warp * 16, S::kLd);
#pragma unroll
      for (int j = 0; j < S::kWarps; ++j) {
        FragBRow b;  // k: rows pixels, columns j
        wmma::load_matrix_sync(b, sk + kk * S::kLd + j * 16, S::kLd);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // the tiles are loaded again
  }
  const int64_t slot = static_cast<int64_t>(nh) * chunks + blockIdx.x;
  float* g = gram_part + slot * C * C + warp * 16 * C;
#pragma unroll
  for (int j = 0; j < S::kWarps; ++j)
    wmma::store_matrix_sync(g + j * 16, acc[j], C, wmma::mem_row_major);
  norm_part[slot * 2 * C + threadIdx.x] = sumsq;
#endif
}

// Block (row i, n * heads + head): the chunks' partials of G's row i and of the norms added in
// chunk order, Gh's row, and A's row by a softmax of t Gh.  Thread j takes column j.
template <int C>
__global__ void __launch_bounds__(kRowThreads)
    mdta_softmax(const float* __restrict__ gram_part, const float* __restrict__ norm_part,
                 const float* __restrict__ temperature, float* __restrict__ attn,
                 float* __restrict__ gram, float* __restrict__ norms, int heads, int chunks) {
#if defined(__CUDA_ARCH__)
  __shared__ float red[kRowThreads / 32];
  __shared__ float row_norm;
  const int i = blockIdx.x, nh = blockIdx.y, head = nh % heads, j = threadIdx.x;
  const bool on = j < C;
  float g = 0.0f, sq = 0.0f, sk = 0.0f;
  if (on) {
    const float* gp = gram_part + static_cast<int64_t>(nh) * chunks * C * C + i * C + j;
    const float* np = norm_part + static_cast<int64_t>(nh) * chunks * 2 * C + j;
    for (int b = 0; b < chunks; ++b) {
      g += gp[static_cast<int64_t>(b) * C * C];
      sq += np[static_cast<int64_t>(b) * 2 * C];
      sk += np[static_cast<int64_t>(b) * 2 * C + C];
    }
  }
  if (j == i) row_norm = sqrtf(sq);
  __syncthreads();
  const float nq = row_norm, nk = sqrtf(sk);
  if (j == i) {
    norms[static_cast<int64_t>(nh) * 2 * C + i] = nq;
    norms[static_cast<int64_t>(nh) * 2 * C + C + i] = nk;
  }
  const int64_t o = (static_cast<int64_t>(nh) * C + i) * C + j;
  const float gh = on ? g / (fmaxf(nq, kEps) * fmaxf(nk, kEps)) : 0.0f;
  if (on) gram[o] = gh;
  const float s = on ? gh * temperature[head] : -INFINITY;
  const float top = block_reduce<true>(s, red);
  const float e = on ? expf(s - top) : 0.0f;
  const float sum = block_reduce<false>(e, red);
  if (on) attn[o] = e / sum;
#endif
}

// Block (b, n * heads + head), over tiles b, b + gridDim.x, ...: out = v A^T, a pixel's row of
// out being A times its row of v.  Warp w computes out's channels 16w..16w+15.
template <int C>
__global__ void __launch_bounds__(Shape<C>::kThreads)
    mdta_apply(const bf16* __restrict__ qkv, const float* __restrict__ attn, bf16* __restrict__ out,
               int64_t p, int heads, int dim) {
#if defined(__CUDA_ARCH__)
  using S = Shape<C>;
  __shared__ __align__(128) bf16 sa[C * S::kLd];
  __shared__ __align__(128) bf16 sv[kTile * S::kLd];
  __shared__ __align__(128) float stage[kTile * S::kLdf];
  const int nh = blockIdx.y, n = nh / heads, head = nh - n * heads;
  const int warp = threadIdx.x / 32;
  const int64_t ld = 3 * static_cast<int64_t>(dim);
  const bf16* v = qkv + n * p * ld + 2 * dim + head * C;
  bf16* o = out + n * p * dim + head * C;
  load_square<C>(sa, attn + static_cast<int64_t>(nh) * C * C);
  const int64_t tiles = (p + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t p0 = t * kTile;
    const int rows = static_cast<int>(min64(kTile, p - p0));
    load_tile<C>(sv, v + p0 * ld, ld, rows);
    __syncthreads();
#pragma unroll
    for (int pt = 0; pt < kTile / 16; ++pt) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int jt = 0; jt < S::kWarps; ++jt) {
        FragARow a;  // v: rows pixels, columns j
        FragBCol b;  // A^T: rows j, columns i
        wmma::load_matrix_sync(a, sv + pt * 16 * S::kLd + jt * 16, S::kLd);
        wmma::load_matrix_sync(b, sa + warp * 16 * S::kLd + jt * 16, S::kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage + pt * 16 * S::kLdf + warp * 16, acc, S::kLdf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    store_tile<C>(o + p0 * dim, dim, rows, stage, nullptr, nullptr);
    __syncthreads();  // sv and stage are written again
  }
#endif
}

// ---- backward ------------------------------------------------------------------------------

// Block (chunk, n * heads + head): dv = dOut A for the chunk's pixels (a pixel's row of dv is
// A^T times its row of dOut), written into dqkv's v slice, and the chunk's partial
// dA = dOut^T v.  Warp w computes dv's channels 16w..16w+15 and dA's rows 16w..16w+15.
template <int C>
__global__ void __launch_bounds__(Shape<C>::kThreads)
    mdta_dv_da(const bf16* __restrict__ dout, const bf16* __restrict__ qkv,
               const float* __restrict__ attn, bf16* __restrict__ dqkv,
               float* __restrict__ da_part, int64_t p, int heads, int dim, int chunks,
               int64_t chunk_len) {
#if defined(__CUDA_ARCH__)
  using S = Shape<C>;
  __shared__ __align__(128) bf16 sa[C * S::kLd];
  __shared__ __align__(128) bf16 sg[kTile * S::kLd];
  __shared__ __align__(128) bf16 sv[kTile * S::kLd];
  __shared__ __align__(128) float stage[kTile * S::kLdf];
  const int nh = blockIdx.y, n = nh / heads, head = nh - n * heads;
  const int warp = threadIdx.x / 32;
  const int64_t ld = 3 * static_cast<int64_t>(dim);
  const bf16* g = dout + n * p * dim + head * C;
  const bf16* v = qkv + n * p * ld + 2 * dim + head * C;
  bf16* dv = dqkv + n * p * ld + 2 * dim + head * C;
  load_square<C>(sa, attn + static_cast<int64_t>(nh) * C * C);
  const int64_t begin = blockIdx.x * chunk_len, end = min64(begin + chunk_len, p);
  Acc da[S::kWarps];
#pragma unroll
  for (int j = 0; j < S::kWarps; ++j) wmma::fill_fragment(da[j], 0.0f);
  for (int64_t p0 = begin; p0 < end; p0 += kTile) {
    const int rows = static_cast<int>(min64(kTile, end - p0));
    load_tile<C>(sg, g + p0 * dim, dim, rows);
    load_tile<C>(sv, v + p0 * ld, ld, rows);
    __syncthreads();
#pragma unroll
    for (int pt = 0; pt < kTile / 16; ++pt) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int it = 0; it < S::kWarps; ++it) {
        FragARow a;  // dOut: rows pixels, columns i
        FragBRow b;  // A: rows i, columns j
        wmma::load_matrix_sync(a, sg + pt * 16 * S::kLd + it * 16, S::kLd);
        wmma::load_matrix_sync(b, sa + it * 16 * S::kLd + warp * 16, S::kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage + pt * 16 * S::kLdf + warp * 16, acc, S::kLdf,
                              wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      FragACol a;  // dOut^T: rows i, columns pixels
      wmma::load_matrix_sync(a, sg + kk * S::kLd + warp * 16, S::kLd);
#pragma unroll
      for (int jt = 0; jt < S::kWarps; ++jt) {
        FragBRow b;  // v: rows pixels, columns j
        wmma::load_matrix_sync(b, sv + kk * S::kLd + jt * 16, S::kLd);
        wmma::mma_sync(da[jt], a, b, da[jt]);
      }
    }
    __syncthreads();
    store_tile<C>(dv + p0 * ld, ld, rows, stage, nullptr, nullptr);
    __syncthreads();  // sg, sv and stage are written again
  }
  const int64_t slot = static_cast<int64_t>(nh) * chunks + blockIdx.x;
  float* d = da_part + slot * C * C + warp * 16 * C;
#pragma unroll
  for (int jt = 0; jt < S::kWarps; ++jt)
    wmma::store_matrix_sync(d + jt * 16, da[jt], C, wmma::mem_row_major);
#endif
}

// Block (row i, n * heads + head): dA's row i (the chunks' partials added in chunk order), dS's
// row, the row's share of dt, and M's and (dGh o Gh)'s rows and alpha_i.  Thread j: column j.
template <int C>
__global__ void __launch_bounds__(kRowThreads)
    mdta_softmax_bwd(const float* __restrict__ da_part, const float* __restrict__ attn,
                     const float* __restrict__ gram, const float* __restrict__ norms,
                     const float* __restrict__ temperature, float* __restrict__ m,
                     float* __restrict__ prod, float* __restrict__ alpha,
                     float* __restrict__ dt_rows, int heads, int chunks) {
#if defined(__CUDA_ARCH__)
  __shared__ float red[kRowThreads / 32];
  const int i = blockIdx.x, nh = blockIdx.y, head = nh % heads, j = threadIdx.x;
  const bool on = j < C;
  const int64_t o = (static_cast<int64_t>(nh) * C + i) * C + j;
  float da = 0.0f, a = 0.0f, gh = 0.0f, sk = 1.0f;
  const float* nr = norms + static_cast<int64_t>(nh) * 2 * C;
  if (on) {
    const float* dp = da_part + static_cast<int64_t>(nh) * chunks * C * C + i * C + j;
    for (int b = 0; b < chunks; ++b) da += dp[static_cast<int64_t>(b) * C * C];
    a = attn[o];
    gh = gram[o];
    sk = fmaxf(nr[C + j], kEps);
  }
  const float dot = block_reduce<false>(da * a, red);
  const float ds = a * (da - dot);
  const float dt = block_reduce<false>(ds * gh, red);
  const float dg = ds * temperature[head];
  const float nq = nr[i], sq = fmaxf(nq, kEps);
  const float pr = dg * gh;
  if (on) {
    m[o] = dg / (sq * sk);
    prod[o] = pr;
  }
  const float r = block_reduce<false>(pr, red);
  if (j == 0) {
    dt_rows[static_cast<int64_t>(nh) * C + i] = dt;
    alpha[static_cast<int64_t>(nh) * C + i] = nq > kEps ? r / (sq * sq) : 0.0f;
  }
#endif
}

// Block (b, n * heads + head), over tiles b, b + gridDim.x, ...: dq = M k - alpha o q and
// dk = M^T q - beta o k, written into dqkv's q and k slices; beta_j, the column sums of
// dGh o Gh over the squared clamped norm, is made by each block.  Warp w computes dq's and then
// dk's channels 16w..16w+15.
template <int C>
__global__ void __launch_bounds__(Shape<C>::kThreads)
    mdta_dq_dk(const bf16* __restrict__ qkv, const float* __restrict__ m,
               const float* __restrict__ prod, const float* __restrict__ alpha,
               const float* __restrict__ norms, bf16* __restrict__ dqkv, int64_t p, int heads,
               int dim) {
#if defined(__CUDA_ARCH__)
  using S = Shape<C>;
  __shared__ __align__(128) bf16 sm[C * S::kLd];
  __shared__ __align__(128) bf16 sq[kTile * S::kLd];
  __shared__ __align__(128) bf16 sk[kTile * S::kLd];
  __shared__ __align__(128) float stage[kTile * S::kLdf];
  __shared__ float coef[2 * C];  // alpha, then beta
  const int nh = blockIdx.y, n = nh / heads, head = nh - n * heads;
  const int warp = threadIdx.x / 32;
  const int64_t ld = 3 * static_cast<int64_t>(dim);
  load_square<C>(sm, m + static_cast<int64_t>(nh) * C * C);
  if (threadIdx.x < C) {
    coef[threadIdx.x] = alpha[static_cast<int64_t>(nh) * C + threadIdx.x];
  } else {
    const int j = threadIdx.x - C;
    const float* pc = prod + static_cast<int64_t>(nh) * C * C + j;
    float s = 0.0f;
    for (int i = 0; i < C; ++i) s += pc[i * C];
    const float nk = norms[static_cast<int64_t>(nh) * 2 * C + C + j], sk2 = fmaxf(nk, kEps);
    coef[C + j] = nk > kEps ? s / (sk2 * sk2) : 0.0f;
  }
  const bf16* q = qkv + n * p * ld + head * C;
  const bf16* k = q + dim;
  bf16* dq = dqkv + n * p * ld + head * C;
  bf16* dk = dq + dim;
  const int64_t tiles = (p + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t p0 = t * kTile;
    const int rows = static_cast<int>(min64(kTile, p - p0));
    load_tile<C>(sq, q + p0 * ld, ld, rows);
    load_tile<C>(sk, k + p0 * ld, ld, rows);
    __syncthreads();
#pragma unroll
    for (int pt = 0; pt < kTile / 16; ++pt) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int jt = 0; jt < S::kWarps; ++jt) {
        FragARow a;  // k: rows pixels, columns j
        FragBCol b;  // M^T: rows j, columns i
        wmma::load_matrix_sync(a, sk + pt * 16 * S::kLd + jt * 16, S::kLd);
        wmma::load_matrix_sync(b, sm + warp * 16 * S::kLd + jt * 16, S::kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage + pt * 16 * S::kLdf + warp * 16, acc, S::kLdf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    store_tile<C>(dq + p0 * ld, ld, rows, stage, sq, coef);
    __syncthreads();  // stage is written again
#pragma unroll
    for (int pt = 0; pt < kTile / 16; ++pt) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int it = 0; it < S::kWarps; ++it) {
        FragARow a;  // q: rows pixels, columns i
        FragBRow b;  // M: rows i, columns j
        wmma::load_matrix_sync(a, sq + pt * 16 * S::kLd + it * 16, S::kLd);
        wmma::load_matrix_sync(b, sm + it * 16 * S::kLd + warp * 16, S::kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage + pt * 16 * S::kLdf + warp * 16, acc, S::kLdf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    store_tile<C>(dk + p0 * ld, ld, rows, stage, sk, coef + C);
    __syncthreads();  // sq, sk and stage are written again
  }
#endif
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <int C>
int fwd(const bf16* qkv, const float* temperature, bf16* out, float* attn, float* gram,
        float* norms, float* gram_part, float* norm_part, int64_t n, int64_t p, int heads,
        int dim, int chunks, int64_t chunk_len, int tile_blocks, cudaStream_t s) {
  const unsigned nh = static_cast<unsigned>(n * heads);
  mdta_gram<C><<<dim3(chunks, nh), Shape<C>::kThreads, 0, s>>>(qkv, gram_part, norm_part, p,
                                                               heads, dim, chunks, chunk_len);
  int rc = last_error();
  if (rc != 0) return rc;
  mdta_softmax<C><<<dim3(C, nh), kRowThreads, 0, s>>>(gram_part, norm_part, temperature, attn,
                                                      gram, norms, heads, chunks);
  rc = last_error();
  if (rc != 0) return rc;
  mdta_apply<C><<<dim3(tile_blocks, nh), Shape<C>::kThreads, 0, s>>>(qkv, attn, out, p, heads,
                                                                     dim);
  return last_error();
}

template <int C>
int bwd(const bf16* dout, const bf16* qkv, const float* temperature, const float* attn,
        const float* gram, const float* norms, bf16* dqkv, float* da_part, float* m, float* prod,
        float* alpha, float* dt_rows, int64_t n, int64_t p, int heads, int dim, int chunks,
        int64_t chunk_len, int tile_blocks, cudaStream_t s) {
  const unsigned nh = static_cast<unsigned>(n * heads);
  mdta_dv_da<C><<<dim3(chunks, nh), Shape<C>::kThreads, 0, s>>>(dout, qkv, attn, dqkv, da_part,
                                                                p, heads, dim, chunks, chunk_len);
  int rc = last_error();
  if (rc != 0) return rc;
  mdta_softmax_bwd<C><<<dim3(C, nh), kRowThreads, 0, s>>>(da_part, attn, gram, norms,
                                                          temperature, m, prod, alpha, dt_rows,
                                                          heads, chunks);
  rc = last_error();
  if (rc != 0) return rc;
  mdta_dq_dk<C><<<dim3(tile_blocks, nh), Shape<C>::kThreads, 0, s>>>(qkv, m, prod, alpha, norms,
                                                                     dqkv, p, heads, dim);
  return last_error();
}

bool bad(int64_t n, int64_t p, int heads, int dim, int chunks, int64_t chunk_len,
         int tile_blocks) {
  return n < 1 || p < 1 || heads < 1 || dim % heads != 0 || chunks < 1 || chunk_len < 1 ||
         chunk_len % kTile != 0 || (chunks - 1) * chunk_len >= p || chunks * chunk_len < p ||
         tile_blocks < 1 ||
         n * heads > 65535;
}

}  // namespace

extern "C" {

// qkv: (n, p, 3 dim) bf16, dense NHWC, p = H * W pixels of an image, dim = heads * c with c of
// 48 or 96; out: (n, p, dim) bf16.  temperature: heads f32.  attn, gram: (n, heads, c, c) f32;
// norms: (n, heads, 2, c) f32, the unclamped norms of q's and k's channels.  gram_part and
// norm_part: workspaces of (n * heads, chunks, c, c) and (n * heads, chunks, 2, c) f32.  Each
// image's pixels are `chunks` chunks of chunk_len (a multiple of 32) in the passes that reduce
// over them, and tile_blocks blocks an image and head in the others.  Each returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for arguments it does not take.
int eld_mdta_fwd(const void* qkv, const void* temperature, void* out, void* attn, void* gram,
                 void* norms, void* gram_part, void* norm_part, int64_t n, int64_t p, int heads,
                 int dim, int chunks, int64_t chunk_len, int tile_blocks, void* stream) {
  if (bad(n, p, heads, dim, chunks, chunk_len, tile_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const bf16*>(qkv);
  const auto* t = static_cast<const float*>(temperature);
  auto* o = static_cast<bf16*>(out);
  auto *a = static_cast<float*>(attn), *g = static_cast<float*>(gram);
  auto *nr = static_cast<float*>(norms), *gp = static_cast<float*>(gram_part);
  auto* np = static_cast<float*>(norm_part);
  switch (dim / heads) {
    case 48:
      return fwd<48>(x, t, o, a, g, nr, gp, np, n, p, heads, dim, chunks, chunk_len, tile_blocks,
                     s);
    case 96:
      return fwd<96>(x, t, o, a, g, nr, gp, np, n, p, heads, dim, chunks, chunk_len, tile_blocks,
                     s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dout: (n, p, dim) bf16; dqkv: (n, p, 3 dim) bf16, every element written.  da_part: (n * heads,
// chunks, c, c) f32; m, prod: (n, heads, c, c) f32; alpha, dt_rows: (n, heads, c) f32, dt_rows
// the rows' shares of the temperature's gradient (the caller sums them over n and the rows).
int eld_mdta_bwd(const void* dout, const void* qkv, const void* temperature, const void* attn,
                 const void* gram, const void* norms, void* dqkv, void* da_part, void* m,
                 void* prod, void* alpha, void* dt_rows, int64_t n, int64_t p, int heads,
                 int dim, int chunks, int64_t chunk_len, int tile_blocks, void* stream) {
  if (bad(n, p, heads, dim, chunks, chunk_len, tile_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* go = static_cast<const bf16*>(dout);
  const auto* x = static_cast<const bf16*>(qkv);
  const auto* t = static_cast<const float*>(temperature);
  const auto *a = static_cast<const float*>(attn), *g = static_cast<const float*>(gram);
  const auto* nr = static_cast<const float*>(norms);
  auto* dx = static_cast<bf16*>(dqkv);
  auto *dp = static_cast<float*>(da_part), *mm = static_cast<float*>(m);
  auto *pr = static_cast<float*>(prod), *al = static_cast<float*>(alpha);
  auto* dt = static_cast<float*>(dt_rows);
  switch (dim / heads) {
    case 48:
      return bwd<48>(go, x, t, a, g, nr, dx, dp, mm, pr, al, dt, n, p, heads, dim, chunks,
                     chunk_len, tile_blocks, s);
    case 96:
      return bwd<96>(go, x, t, a, g, nr, dx, dp, mm, pr, al, dt, n, p, heads, dim, chunks,
                     chunk_len, tile_blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* eld_mdta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
