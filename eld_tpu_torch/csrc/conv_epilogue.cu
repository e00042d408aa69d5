// The U-Net's convolution epilogue for NVIDIA Hopper (sm_90a), one pass each way.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add and the LeakyReLU
// into the convolution on its own.  Under PyTorch the same epilogue was four
// memory-bound passes a convolution (cuDNN's bias add, LeakyReLU, LeakyReLU's
// backward, the bias gradient's reduction), and in bf16 they took more device
// time than the convolutions themselves.  For a convolution output z (and, in
// the `split` decoder, the second half's output z2) in NHWC order, C channels:
//
//   forward   y = lrelu(z [+ z2] + bias, 0.2), in f32, rounded once to z's type
//   backward  gz = gy * (y > 0 ? 1 : 0.2), written in gy's type, and
//             gbias[c] = sum over N, H, W of the f32 gz (before its rounding)
//
// The mask comes from y: LeakyReLU with a positive slope keeps the sign, and
// y == 0 takes the 0.2 branch, as PyTorch's leaky_relu_backward does.  The
// products with the slope are explicitly rounded (__fmul_rn), so no FMA folds
// one into the sum: the arithmetic is the plain PyTorch version's
// (models/epilogue.py), f32 throughout.
//
// What bounds it on an H100: bytes.  A pass does a few f32 operations for each
// element it moves: the forward reads 2 tensors and writes one (3 and 1 in
// `split`), the backward reads 2 and writes 1.  At the U-Net's widest level (8,
// 32, 512, 512) in bf16 a backward moves 3 x 134 MB, 120 us at 3.35 TB/s.  The
// design answers that bound with one pass each way:
//
//  - Rows of C channels.  A block of at most 256 threads is X channel chunks
//    wide and Y = 256 / X rows tall; a chunk is 16 bytes (8 bf16 or 4 f32
//    channels) where C and every pointer allow it, else one channel (the
//    scalar path).  A warp's lanes read neighbouring chunks of neighbouring
//    rows: one contiguous stretch of memory.  Each thread keeps its chunk's
//    bias and its f32 sums in registers and walks the rows with a grid stride,
//    two rows per step so that two loads are in flight.  C wider than 256
//    chunks loops over groups of chunks.
//  - Four blocks of 256 threads an SM (launch bounds cap the registers at 64),
//    and as many blocks as fill the card's SMs once: one wave, no tail.
//  - The bias gradient is deterministic, with no float atomics: each block sums
//    its fixed rows in registers, then its Y rows in shared memory by a fixed
//    tree, into a row of f32 partials in a workspace the wrapper allocates; a
//    second kernel adds the partials in a fixed order.  The same shape on the
//    same card gives the same bits, so a CUDA graph replays what the eager
//    call computed.
//
// TMA and shared-memory tiles give nothing here: no element is read twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSlope = 0.2f;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kMaxVec = 8;  // channels in a 16-byte chunk of bf16
constexpr int kSumSlices = 32;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T from_f32(float v);
template <>
__device__ inline float from_f32<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// V consecutive elements at p as f32: one 16-byte load where V > 1
template <typename T, int V>
__device__ inline void load(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector chunk is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ inline void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

__device__ inline float lrelu(float v) { return v > 0.0f ? v : __fmul_rn(v, kSlope); }

// y = lrelu(z [+ z2] + bias) on rows x c, c = chunks * V.  Block (X, Y): thread
// (tx, ty) takes chunk g * X + tx of rows blockIdx.x * Y + ty + k * gridDim.x * Y.
template <typename T, int V, bool kZ2>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    bias_lrelu_fwd(const T* __restrict__ z, const T* __restrict__ z2,
                   const float* __restrict__ bias, T* __restrict__ y, int64_t rows, int c) {
  const int chunks = c / V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.y;
  for (int cv = threadIdx.x; cv < chunks; cv += blockDim.x) {
    const int ch = cv * V;
    float b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) b[i] = bias[ch + i];
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y; r < rows;
         r += 2 * step) {
      const int64_t r2 = r + step;
      const bool two = r2 < rows;
      const int64_t o = r * c + ch, o2 = r2 * c + ch;
      float a[V], a2[V], s[V], s2[V];
      load<T, V>(z + o, a);
      if (two) load<T, V>(z + o2, a2);
      if constexpr (kZ2) {
        load<T, V>(z2 + o, s);
        if (two) load<T, V>(z2 + o2, s2);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (kZ2) a[i] = __fadd_rn(a[i], s[i]);
        a[i] = lrelu(__fadd_rn(a[i], b[i]));
      }
      store<T, V>(y + o, a);
      if (two) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if constexpr (kZ2) a2[i] = __fadd_rn(a2[i], s2[i]);
          a2[i] = lrelu(__fadd_rn(a2[i], b[i]));
        }
        store<T, V>(y + o2, a2);
      }
    }
  }
}

__device__ inline float dlrelu(float g, float y) { return y > 0.0f ? g : __fmul_rn(g, kSlope); }

// gz = gy * lrelu'(y) on rows x c, and partial[blockIdx.x][ch] = the block's
// f32 sum of gz over its rows.  The same grid as the forward; every thread
// runs every group (chunk beyond c or not) so that all reach the barriers.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    lrelu_bwd_partial(const T* __restrict__ gy, const T* __restrict__ y, T* __restrict__ gz,
                      float* __restrict__ partial, int64_t rows, int c) {
  __shared__ float red[kThreads * V];  // [ty][tx * V + i]
  const int chunks = c / V;
  const int width = blockDim.x * V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.y;
  // the largest power of two at or below Y: the rows above it fold in first
  int half = 1;
  while (2 * half <= static_cast<int>(blockDim.y)) half *= 2;
  for (int g0 = 0; g0 < chunks; g0 += blockDim.x) {
    const int cv = g0 + threadIdx.x;
    const bool active = cv < chunks;
    const int ch = cv * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    if (active) {
      for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y; r < rows;
           r += 2 * step) {
        const int64_t r2 = r + step;
        const bool two = r2 < rows;
        const int64_t o = r * c + ch, o2 = r2 * c + ch;
        float g[V], v[V], g2[V], v2[V];
        load<T, V>(gy + o, g);
        load<T, V>(y + o, v);
        if (two) {
          load<T, V>(gy + o2, g2);
          load<T, V>(y + o2, v2);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          g[i] = dlrelu(g[i], v[i]);
          acc[i] = __fadd_rn(acc[i], g[i]);
        }
        store<T, V>(gz + o, g);
        if (two) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            g2[i] = dlrelu(g2[i], v2[i]);
            acc[i] = __fadd_rn(acc[i], g2[i]);
          }
          store<T, V>(gz + o2, g2);
        }
      }
    }
    float* mine = red + threadIdx.y * width + threadIdx.x * V;
#pragma unroll
    for (int i = 0; i < V; ++i) mine[i] = acc[i];
    __syncthreads();
    if (threadIdx.y >= half) {
#pragma unroll
      for (int i = 0; i < V; ++i) red[(threadIdx.y - half) * width + threadIdx.x * V + i] += mine[i];
    }
    __syncthreads();
    for (int s = half / 2; s > 0; s /= 2) {
      if (threadIdx.y < s) {
#pragma unroll
        for (int i = 0; i < V; ++i) mine[i] += mine[s * width + i];
      }
      __syncthreads();
    }
    if (threadIdx.y == 0 && active) {
#pragma unroll
      for (int i = 0; i < V; ++i) partial[static_cast<int64_t>(blockIdx.x) * c + ch + i] = mine[i];
    }
    __syncthreads();  // red is written again by the next group
  }
}

// gbias[ch] = the blocks' partials added in a fixed order: slice ty of the
// 32 sums blocks ty, ty + 32, ... in turn, then slice 0 adds the slices.
__global__ void __launch_bounds__(32 * kSumSlices)
    sum_partials(const float* __restrict__ partial, float* __restrict__ gbias, int blocks, int c) {
  __shared__ float part[kSumSlices][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (ch < c) {
#pragma unroll 4
    for (int b = threadIdx.y; b < blocks; b += kSumSlices)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * c + ch]);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float t = part[0][threadIdx.x];
    for (int s = 1; s < kSumSlices; ++s) t = __fadd_rn(t, part[s][threadIdx.x]);
    gbias[ch] = t;
  }
}

struct Grid {
  dim3 block;
  unsigned blocks;
};

// X chunks wide, 256 / X rows tall; one wave of at most max_blocks blocks
Grid grid(int64_t rows, int chunks, int max_blocks) {
  const int x = chunks < kThreads ? chunks : kThreads;
  const int y = kThreads / x;
  int64_t blocks = (rows + y - 1) / y;
  if (blocks > max_blocks) blocks = max_blocks;
  return Grid{dim3(x, y), static_cast<unsigned>(blocks)};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int V>
int fwd(const void* z, const void* z2, const float* bias, void* y, int64_t rows, int c,
        int max_blocks, cudaStream_t stream) {
  const Grid g = grid(rows, c / V, max_blocks);
  if (z2 != nullptr) {
    bias_lrelu_fwd<T, V, true><<<g.blocks, g.block, 0, stream>>>(
        static_cast<const T*>(z), static_cast<const T*>(z2), bias, static_cast<T*>(y), rows, c);
  } else {
    bias_lrelu_fwd<T, V, false><<<g.blocks, g.block, 0, stream>>>(
        static_cast<const T*>(z), nullptr, bias, static_cast<T*>(y), rows, c);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int bwd(const void* gy, const void* y, void* gz, float* partial, float* gbias, int64_t rows,
        int c, int max_blocks, cudaStream_t stream) {
  const Grid g = grid(rows, c / V, max_blocks);
  lrelu_bwd_partial<T, V><<<g.blocks, g.block, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const T*>(y), static_cast<T*>(gz), partial, rows, c);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  sum_partials<<<(c + 31) / 32, dim3(32, kSumSlices), 0, stream>>>(partial, gbias,
                                                                   static_cast<int>(g.blocks), c);
  return static_cast<int>(cudaGetLastError());
}

// the chunk width: 16 bytes where c and every pointer allow it, else 1
int vec(int dtype, int c, const void* a, const void* b, const void* d) {
  const int v = dtype == 1 ? kMaxVec : 4;
  const bool ok = c % v == 0 && aligned16(a) && aligned16(b) && (d == nullptr || aligned16(d));
  return ok ? v : 1;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, for z, z2, y (and gy, gz); bias, partial and
// gbias are float32.  Tensors are dense NHWC: rows = N*H*W rows of c channels.
// max_blocks bounds the grid (the rows of the backward's workspace `partial`,
// max_blocks x c floats).  Each returns cudaGetLastError() after its launches,
// or cudaErrorInvalidValue for arguments it does not take.

// y = lrelu(z [+ z2] + bias, 0.2); z2 may be null.
int eld_bias_lrelu_fwd(const void* z, const void* z2, const float* bias, void* y, int64_t rows,
                       int c, int dtype, int max_blocks, void* stream) {
  if (c < 1 || max_blocks < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = vec(dtype, c, z, y, z2);
  if (dtype == 1) {
    return v == 1 ? fwd<__nv_bfloat16, 1>(z, z2, bias, y, rows, c, max_blocks, s)
                  : fwd<__nv_bfloat16, kMaxVec>(z, z2, bias, y, rows, c, max_blocks, s);
  }
  return v == 1 ? fwd<float, 1>(z, z2, bias, y, rows, c, max_blocks, s)
                : fwd<float, 4>(z, z2, bias, y, rows, c, max_blocks, s);
}

// gz = gy * (y > 0 ? 1 : 0.2) and gbias = the f32 sum of gz over the rows.
int eld_lrelu_bias_bwd(const void* gy, const void* y, void* gz, float* partial, float* gbias,
                       int64_t rows, int c, int dtype, int max_blocks, void* stream) {
  if (c < 1 || max_blocks < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return static_cast<int>(cudaMemsetAsync(gbias, 0, sizeof(float) * c, s));
  const int v = vec(dtype, c, gy, y, gz);
  if (dtype == 1) {
    return v == 1 ? bwd<__nv_bfloat16, 1>(gy, y, gz, partial, gbias, rows, c, max_blocks, s)
                  : bwd<__nv_bfloat16, kMaxVec>(gy, y, gz, partial, gbias, rows, c, max_blocks, s);
  }
  return v == 1 ? bwd<float, 1>(gy, y, gz, partial, gbias, rows, c, max_blocks, s)
                : bwd<float, 4>(gy, y, gz, partial, gbias, rows, c, max_blocks, s);
}

// blocks a launch may hold for each SM: the wrapper's workspace is
// (SMs x this) rows of c floats
int eld_epilogue_blocks_per_sm() { return kBlocksPerSM; }

const char* eld_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
