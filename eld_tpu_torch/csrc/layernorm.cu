// Restormer's BiasFree LayerNorm for NVIDIA Hopper (sm_90a), one pass each way.
//
// Replaces no TPU kernel: eld_tpu has no Restormer.  Under PyTorch the norm was
// four f32 ops forward (the cast, the variance's Welford reduce, the division,
// the product with the weight) and about twice as many backward, each a pass
// over a channels-last tensor with a broadcast or a strided channel reduce:
// ~50 ms of a 147 ms train step at batch 4 of 256^2 on an H100, where these
// kernels take ~3.  For x in NHWC order, C channels a pixel, and the f32
// weight w:
//
//   forward   m = mean_c(x), var = mean_c((x - m)^2) (biased, centred: the
//             formula of x.var(unbiased=False), not E[x^2] - m^2),
//             r = 1 / sqrt(var + 1e-5), y = x * r * w  (x is not centred),
//             in f32, rounded once to x's type
//   backward  gx = r * w * gy - (r^3 / C) * (x - m) * sum_c(gy * w * x),
//             in f32, rounded once to x's type, and
//             gw[c] = sum over the pixels of gy * x * r, in f32
//
// The backward recomputes m and r from x: it keeps nothing but x, which the
// forward's caller holds anyway.
//
// What bounds it on an H100: bytes.  The forward reads x and writes y, the
// backward reads x and gy and writes gx: 4 and 6 bytes a channel-pixel in
// bf16, with a few tens of f32 operations each.  The design answers that bound
// with one pass each way:
//
//  - A pixel's C channels live in the registers of a group of L lanes (L a
//    power of two), each lane holding N 16-byte chunks (8 bf16 or 4 f32
//    channels), chunk k of lane l being the pixel's chunk l + k * L.  So each
//    of a warp's N loads reads L neighbouring chunks of 32 / L neighbouring
//    pixels: whole 32-byte sectors.  L and N come from C at launch: the
//    smallest L with N <= 4, so a pixel of up to 2 KiB; C = 48, 96, 192 and
//    384 in bf16 give N = 3 with L = 2, 4, 8, 16.  The chunks stay packed in
//    registers as loaded, and each lane loads its next pixel before it works
//    on the current one, so its warp has loads in flight while it reduces.
//    The weight sits in shared memory.
//  - The channel sums (the mean, the centred variance, the backward's
//    sum(gy w x)) are a lane's own in a fixed order, then a butterfly of warp
//    shuffles inside the group, which leaves every lane of the group the same
//    bits.
//  - A grid-stride loop of whole warps over the pixels, with as many blocks of
//    256 threads as one wave of the card holds (the wrapper asks
//    eld_bfln_blocks), so no tail wave and no launch per pixel tile.
//  - The weight gradient is deterministic, with no float atomics: each lane
//    adds its pixels' terms in registers; the block adds its warps' sums
//    (shuffles across the groups, then the warps' rows in shared memory in a
//    fixed order) into one row of an f32 workspace of [blocks, C]; a second
//    kernel adds the rows in a fixed order.  The same shape on the same card
//    gives the same bits, so a CUDA graph replays what the eager call computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 128;  // 4 chunks a lane of 32: a pixel of at most 2 KiB
constexpr int kSumSlices = 32;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T from_f32(float v);
template <>
__device__ inline float from_f32<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// the channels of a 16-byte chunk
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// element i of a 16-byte chunk of T as f32
template <typename T>
__device__ inline float elem(const uint4& raw, int i) {
  return to_f32(reinterpret_cast<const T*>(&raw)[i]);
}

template <typename T>
__device__ inline void store(T* p, const float (&v)[vec<T>()]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < vec<T>(); ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// the sum over a group of `lanes` lanes (a power of two), the same bits in each
__device__ inline float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Where a lane works: its group (pixel slot) in the warp, its chunk offset in
// the group, the first pixel of its warp and the pixels a step of the grid
// covers.
struct Lane {
  int group, lane_in_group;
  int64_t first, stride;
};

__device__ inline Lane lane_of(int lanes) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;
  Lane l;
  l.lane_in_group = lane & (lanes - 1);
  l.group = lane / lanes;
  l.first = (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * per_warp;
  l.stride = static_cast<int64_t>(gridDim.x) * kWarps * per_warp;
  return l;
}

// A pixel's chunks as loaded, raw[k] being chunk lane_in_group + k * lanes of
// the pixel at `row`; chunks at or past `chunks`, and every chunk of a pixel
// past the last (`active` false), read 0.
template <typename T, int N>
__device__ inline void fetch(const T* row, bool active, int lane_in_group, int lanes, int chunks,
                             uint4 (&raw)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int q = lane_in_group + k * lanes;
    raw[k] = active && q < chunks ? *reinterpret_cast<const uint4*>(row + q * vec<T>())
                                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the weight in shared memory, read by every pixel of the block
__device__ inline void stage_weight(const float* __restrict__ w, float* ws, int c) {
  for (int ch = threadIdx.x; ch < c; ch += kThreads) ws[ch] = w[ch];
  __syncthreads();
}

// m and r = 1 / sqrt(var + eps) of a pixel whose chunks are in x (the
// variance centred, over the c channels only)
template <typename T, int N>
__device__ inline void moments(const uint4 (&x)[N], int lane_in_group, int lanes, int chunks,
                               int c, float& m, float& r) {
  constexpr int V = vec<T>();
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s = __fadd_rn(s, elem<T>(x[k], i));
  m = __fdiv_rn(group_sum(s, lanes), static_cast<float>(c));
  float d = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (lane_in_group + k * lanes < chunks) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float e = __fsub_rn(elem<T>(x[k], i), m);
        d = __fmaf_rn(e, e, d);
      }
    }
  }
  const float var = __fdiv_rn(group_sum(d, lanes), static_cast<float>(c));
  r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
}

// y = x * r * w over `pixels` pixels of c channels.  Each lane loads its next
// pixel's chunks before it works on the current one's, so a warp has loads in
// flight while it reduces.  Dynamic shared memory: c floats.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    bfln_fwd(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
             int64_t pixels, int c, int lanes) {
  constexpr int V = vec<T>();
  extern __shared__ float ws[];
  const int chunks = c / V;
  const Lane l = lane_of(lanes);
  stage_weight(w, ws, c);
  uint4 cur[N];
  int64_t p = l.first + l.group;
  fetch<T, N>(x + p * c, p < pixels, l.lane_in_group, lanes, chunks, cur);
  for (int64_t first = l.first; first < pixels; first += l.stride, p += l.stride) {
    uint4 next[N];
    fetch<T, N>(x + (p + l.stride) * c, p + l.stride < pixels, l.lane_in_group, lanes, chunks,
                next);
    float m, r;
    moments<T, N>(cur, l.lane_in_group, lanes, chunks, c, m, r);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int q = l.lane_in_group + k * lanes;
      if (p < pixels && q < chunks) {
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[i] = __fmul_rn(__fmul_rn(elem<T>(cur[k], i), r), ws[q * V + i]);
        store<T>(y + p * c + q * V, v);
      }
      cur[k] = next[k];
    }
  }
}

// gx over `pixels` pixels of c channels, and partial[blockIdx.x][ch] = the
// block's f32 sum of gy * x * r; the next pixel loaded ahead as in the
// forward.  Dynamic shared memory: (kWarps + 1) * c floats.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    bfln_bwd(const T* __restrict__ x, const T* __restrict__ gy, const float* __restrict__ w,
             T* __restrict__ gx, float* __restrict__ partial, int64_t pixels, int c, int lanes) {
  constexpr int V = vec<T>();
  extern __shared__ float smem[];
  float* ws = smem;        // [ch]
  float* rows = smem + c;  // [warp][ch]
  const int chunks = c / V;
  const Lane l = lane_of(lanes);
  stage_weight(w, ws, c);
  float acc[N][V];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
  const float inv_c = __fdiv_rn(1.0f, static_cast<float>(c));
  uint4 cx[N], cg[N];
  int64_t p = l.first + l.group;
  fetch<T, N>(x + p * c, p < pixels, l.lane_in_group, lanes, chunks, cx);
  fetch<T, N>(gy + p * c, p < pixels, l.lane_in_group, lanes, chunks, cg);
  for (int64_t first = l.first; first < pixels; first += l.stride, p += l.stride) {
    uint4 nx[N], ng[N];
    const bool ahead = p + l.stride < pixels;
    fetch<T, N>(x + (p + l.stride) * c, ahead, l.lane_in_group, lanes, chunks, nx);
    fetch<T, N>(gy + (p + l.stride) * c, ahead, l.lane_in_group, lanes, chunks, ng);
    float m, r;
    moments<T, N>(cx, l.lane_in_group, lanes, chunks, c, m, r);
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int q = l.lane_in_group + k * lanes;
      if (q < chunks) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          dot = __fmaf_rn(__fmul_rn(elem<T>(cg[k], i), ws[q * V + i]), elem<T>(cx[k], i), dot);
      }
    }
    dot = group_sum(dot, lanes);
    // (r^3 / C) * sum(gy w x), the coefficient of (x - m)
    const float coef = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), inv_c), dot);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int q = l.lane_in_group + k * lanes;
      if (q < chunks) {
        float g[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float gi = elem<T>(cg[k], i), xi = elem<T>(cx[k], i);
          acc[k][i] = __fmaf_rn(__fmul_rn(gi, xi), r, acc[k][i]);
          g[i] = __fsub_rn(__fmul_rn(__fmul_rn(r, ws[q * V + i]), gi),
                           __fmul_rn(coef, __fsub_rn(xi, m)));
        }
        if (p < pixels) store<T>(gx + p * c + q * V, g);
      }
      cx[k] = nx[k];
      cg[k] = ng[k];
    }
  }
  // the warp's groups hold the same channels: add them by a butterfly over
  // the lanes L, 2L, ... apart, then each warp's lanes 0..L-1 write its row
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[k][i] = __fadd_rn(acc[k][i], __shfl_xor_sync(0xffffffffu, acc[k][i], o));
  }
  const int warp = threadIdx.x / 32;
  if (l.group == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int q = l.lane_in_group + k * lanes;
      if (q < chunks) {
#pragma unroll
        for (int i = 0; i < V; ++i) rows[warp * c + q * V + i] = acc[k][i];
      }
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float t = rows[ch];
    for (int wi = 1; wi < kWarps; ++wi) t = __fadd_rn(t, rows[wi * c + ch]);
    partial[static_cast<int64_t>(blockIdx.x) * c + ch] = t;
  }
}

// gw[ch] = the blocks' rows added in a fixed order: slice ty of the 32 sums
// blocks ty, ty + 32, ... in turn, then slice 0 adds the slices.
__global__ void __launch_bounds__(32 * kSumSlices)
    bfln_wsum(const float* __restrict__ partial, float* __restrict__ gw, int blocks, int c) {
  __shared__ float part[kSumSlices][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (ch < c) {
    for (int b = threadIdx.y; b < blocks; b += kSumSlices)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * c + ch]);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float t = part[0][threadIdx.x];
    for (int s = 1; s < kSumSlices; ++s) t = __fadd_rn(t, part[s][threadIdx.x]);
    gw[ch] = t;
  }
}

// The lane mapping of c channels: L lanes a pixel, N <= 4 chunks a lane, the
// smallest L that holds them.  False where c is not a whole number of chunks
// or is more than kMaxChunks of them.
bool plan(int c, int v, int& lanes, int& n) {
  if (c < 1 || c % v != 0 || c / v > kMaxChunks) return false;
  const int chunks = c / v;
  for (lanes = 1; (chunks + lanes - 1) / lanes > 4; lanes *= 2) {
  }
  n = (chunks + lanes - 1) / lanes;
  return true;
}

// the dynamic shared memory of each kernel
size_t fwd_smem(int c) { return sizeof(float) * c; }
size_t bwd_smem(int c) { return sizeof(float) * (kWarps + 1) * c; }

// Calls F<T, N>::run(args...) for the runtime n.
template <typename T, template <typename, int> class F, typename... A>
int by_n(int n, A... args) {
  switch (n) {
    case 1: return F<T, 1>::run(args...);
    case 2: return F<T, 2>::run(args...);
    case 3: return F<T, 3>::run(args...);
    default: return F<T, 4>::run(args...);
  }
}

template <typename T, int N>
struct Fwd {
  static int run(const void* x, const float* w, void* y, int64_t pixels, int c, int lanes,
                 int blocks, cudaStream_t s) {
    bfln_fwd<T, N><<<blocks, kThreads, fwd_smem(c), s>>>(static_cast<const T*>(x), w,
                                                         static_cast<T*>(y), pixels, c, lanes);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int N>
struct Bwd {
  static int run(const void* x, const void* gy, const float* w, void* gx, float* partial,
                 int64_t pixels, int c, int lanes, int blocks, cudaStream_t s) {
    bfln_bwd<T, N><<<blocks, kThreads, bwd_smem(c), s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gy), w, static_cast<T*>(gx), partial,
        pixels, c, lanes);
    return static_cast<int>(cudaGetLastError());
  }
};

// the blocks of the (T, N) kernel one SM holds
template <typename T, int N>
struct PerSM {
  static int run(bool backward, int c, int* blocks) {
    return static_cast<int>(
        backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bfln_bwd<T, N>,
                                                                 kThreads, bwd_smem(c))
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bfln_fwd<T, N>,
                                                                 kThreads, fwd_smem(c)));
  }
};

int chunk_channels(int dtype) { return dtype == 1 ? vec<__nv_bfloat16>() : vec<float>(); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, for x, y, gy and gx; w, partial and gw are
// float32.  Tensors are dense NHWC: `pixels` = N*H*W pixels of c channels, c a
// multiple of 8 and a pixel at most 2 KiB (1024 bf16 or 512 f32 channels),
// every pointer on a 16-byte boundary.  Each returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments it does not take.

// The blocks of a launch over `pixels` pixels: one wave of the card that is
// current (at most), and no more than the pixels fill.
int eld_bfln_blocks(int64_t pixels, int c, int dtype, int backward, int* blocks) {
  int lanes, n;
  if ((dtype != 0 && dtype != 1) || !plan(c, chunk_channels(dtype), lanes, n))
    return static_cast<int>(cudaErrorInvalidValue);
  int device, sms, per_sm = 0;
  int rc = static_cast<int>(cudaGetDevice(&device));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (rc == 0) {
    rc = dtype == 1 ? by_n<__nv_bfloat16, PerSM>(n, backward != 0, c, &per_sm)
                    : by_n<float, PerSM>(n, backward != 0, c, &per_sm);
  }
  if (rc != 0) return rc;
  const int64_t per_block = static_cast<int64_t>(kWarps) * (32 / lanes);
  const int64_t need = (pixels + per_block - 1) / per_block;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < 1 ? 1 : (need < wave ? need : wave));
  return 0;
}

// y = x / sqrt(var_c(x) + 1e-5) * w over blocks blocks.
int eld_bfln_fwd(const void* x, const float* w, void* y, int64_t pixels, int c, int dtype,
                 int blocks, void* stream) {
  int lanes, n;
  if ((dtype != 0 && dtype != 1) || blocks < 1 || !plan(c, chunk_channels(dtype), lanes, n) ||
      !aligned16(x) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? by_n<__nv_bfloat16, Fwd>(n, x, w, y, pixels, c, lanes, blocks, s)
                    : by_n<float, Fwd>(n, x, w, y, pixels, c, lanes, blocks, s);
}

// gx and gw; partial is the [blocks, c] f32 workspace.
int eld_bfln_bwd(const void* x, const void* gy, const float* w, void* gx, float* partial,
                 float* gw, int64_t pixels, int c, int dtype, int blocks, void* stream) {
  int lanes, n;
  if ((dtype != 0 && dtype != 1) || blocks < 1 || !plan(c, chunk_channels(dtype), lanes, n) ||
      !aligned16(x) || !aligned16(gy) || !aligned16(gx))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (pixels == 0) return static_cast<int>(cudaMemsetAsync(gw, 0, sizeof(float) * c, s));
  const int rc = dtype == 1
      ? by_n<__nv_bfloat16, Bwd>(n, x, gy, w, gx, partial, pixels, c, lanes, blocks, s)
      : by_n<float, Bwd>(n, x, gy, w, gx, partial, pixels, c, lanes, blocks, s);
  if (rc != 0) return rc;
  bfln_wsum<<<(c + 31) / 32, dim3(32, kSumSlices), 0, s>>>(partial, gw, blocks, c);
  return static_cast<int>(cudaGetLastError());
}

const char* eld_bfln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
