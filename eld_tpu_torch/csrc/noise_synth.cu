// Fused ELD noise synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces eld_tpu/noise/kernels.py::synthesize_pallas (the Pallas TPU kernel
// _noise_kernel, pallas_call at kernels.py:182).  For a clean NHWC batch and
// per-image parameters it computes, in one read and one write of the batch:
//
//   y = x * sat / ratio
//   shot  'P' hybrid Poisson(y/K)*K: 40-term inverse CDF for lam <= 12, else
//             max(rint(lam + sqrt(lam)*n), 0);   'p' y + n*sqrt(max(K*y,1e-10))
//   read  'g' + n * max(g_scale, 1e-10);  'G' + TukeyLambda(lam) * max(G_scale, 1e-10)
//   row   'r' + one N(0,1) per packed row * R_scale; channels (0,1) take the
//             even-row draw, (2,3) the odd-row draw; C != 4 takes the even draw
//   quant 'q' + U(-1/2, 1/2);   bias 'c' + color_bias[channel] (C == 4 only)
//   out = z * ratio / sat, optionally clipped to [0, 1]
//
// Random numbers come from a Philox4x32-10 generator written out below, keyed
// by the 64-bit step seed (k0, k1) = (seed & 0xffffffff, seed >> 32).  The
// counter is the element's flat index i = ((n*H + h)*W + w)*C + ch, split into
// (i_lo, i_hi), and word 2 selects the stream: 0 gives the element's four
// uniforms, 1 a second block for models that need more than four, and 2 the
// row noise, counter (row_lo, row_hi, 2, 0) with row = n*H + h.  A different
// seed is a different key, so consecutive step seeds never replay a stream.
//
// Uniform use per element (stream 0 = a0..a3): the shot component takes
// (a0, a1): a0 is the small-lam inverse-CDF uniform, and the large-lam branch
// (an exclusive case of the same element) takes the Box-Muller cosine leg of
// (a0, a1); 'p' takes the cosine leg.  Read noise 'g' takes the sine leg when
// 'p' is present, the cosine leg of (a0, a1) when there is no shot component,
// and stream 1 otherwise.  'G' takes a2, 'q' takes a3.  The row's (even, odd)
// pair is the (cosine, sine) legs of its first two uniforms.
//
// Numerics: built without --use_fast_math, so expf/logf/log1pf/powf/sincosf
// are the accurate versions; the Poisson loop keeps the reference's linear-
// space recursion with compile-time f32 reciprocals and the pk > 1e-12 gate,
// and uses explicitly rounded multiplies/adds so that no contraction changes
// its counts against the plain PyTorch version (noise/model.py::noise_core).
//
// What bounds it on an H100.  At the training shape (8, 512, 512, 4) f32 it
// reads 33.5 MB and writes 33.5 MB, 20.0 us at 3.35 TB/s; its f32 operations
// (each add, multiply, division and transcendental once) need ~7 us at
// 67 TFLOP/s, so by the roofline it is bound by bytes.  Neither is what
// limits it: counted on the SASS, an element of the full model issues about
// 400 instructions: one Philox call (~50), four IEEE divisions (~9 each), the
// Tukey-lambda's two accurate powf (~185 with its clamp and division), and
// the Poisson step (expf and 7 per loop term, or a ~70-instruction
// Box-Muller; a warp whose lanes straddle lam = 12 runs both).  8.4 M
// elements at 400 each are ~100 us at the H100's issue rate (132 SMs x 4
// warp instructions per clock at 1.98 GHz), five times the memory bound:
// instruction issue limits the kernel.  It runs in ~0.145 ms alone on an
// H100 80GB HBM3 at 700 W (PERF.md).  The design takes out the instructions
// that were not the noise model's own:
//
//  - The grid runs over the global packed rows n*H + h: a block of 512
//    threads takes one row of up to 512 pixels (W = 512: one pixel per
//    thread), or several narrower rows, each with the power of two of
//    threads at or above its width (at least a warp).  Wider rows loop.
//    Image and row come from blockIdx in 32-bit arithmetic and the flat
//    index is row*W*C + col with one 64-bit multiply per row: no element
//    pays a 64-bit division.
//  - One thread per row reads the image's parameters and makes the row's
//    (even, odd) draw into shared memory, behind a single __syncthreads()
//    (a second one first with the device seed):
//    one Philox call and one Box-Muller per row instead of per element.
//  - The ten Philox round keys are computed once on the host and passed in,
//    so each round reads its key from the constant bank.  The second entry,
//    eld_noise_synth_dev, takes the seed as a device pointer instead, as the
//    TPU kernel takes its seed from SMEM (seed_ref): one thread of each
//    block reads it into shared memory, and every thread derives the round
//    keys from it into registers (ten adds per key word, once per thread).
//    A CUDA graph captures kernel arguments by value, so only this entry
//    lets a captured launch draw a new step's noise on every replay: the
//    graph's seed buffer is rewritten before each replay.  Both entries run
//    one kernel body (the kDevSeed template flag), and the same seed value
//    gives the same keys, so their outputs are bit-identical.
//  - For C = 4 each lane takes one pixel: one 16-byte load, the four channels
//    in a loop unrolled at compile time (channel index, row leg and colour
//    bias are constants), one 16-byte store.  A warp's 32 lanes then run the
//    same channel of 32 neighbouring pixels, so on smooth images they share
//    the Poisson branch and similar loop counts.  C = 9, or pointers that are
//    not 16-byte aligned, take a scalar path with the same grid and numerics.
//
// TMA, shared-memory tiles and wgmma give nothing here: no element is read
// twice, and there is no matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kModelP = 1, kModelp = 2, kModelg = 4, kModelG = 8;
constexpr int kModelr = 16, kModelq = 32, kModelc = 64;
// per-image parameter row: K g G lam R sat ratio cb0 cb1 cb2 cb3 (pad)
constexpr int kParamStride = 12;
constexpr float kSmallMax = 12.0f;
constexpr int kTerms = 40;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kBlockThreads = 512;
constexpr int kMaxRowsPerBlock = kBlockThreads / 32;

// f32 reciprocal 1/(k+1); with the loop unrolled, k is a constant and the
// IEEE division folds at compile time
__host__ __device__ constexpr float recip(int k) { return 1.0f / static_cast<float>(k + 1); }

struct U4 {
  uint32_t x, y, z, w;
};

// The ten round keys of a (k0, k1) key.  The host-seed kernel takes them as
// an argument, so each round reads its key from the constant bank instead of
// adding it up for every element; the device-seed kernel derives them once
// per thread.
struct RoundKeys {
  uint32_t k0[10], k1[10];
};

__host__ __device__ inline RoundKeys round_keys(uint32_t k0, uint32_t k1) {
  RoundKeys k;
  for (int i = 0; i < 10; ++i) {
    k.k0[i] = k0;
    k.k1[i] = k1;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return k;
}

__host__ __device__ inline uint32_t mulhilo(uint32_t a, uint32_t b, uint32_t* hi) {
  const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  *hi = static_cast<uint32_t>(p >> 32);
  return static_cast<uint32_t>(p);
}

// Philox4x32-10 (Salmon et al., SC'11), the Random123 round and key schedule.
__host__ __device__ inline U4 philox4x32_10(U4 c, const RoundKeys& k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo(0xD2511F53u, c.x, &hi0);
    const uint32_t lo1 = mulhilo(0xCD9E8D57u, c.z, &hi1);
    c = U4{hi1 ^ c.y ^ k.k0[i], lo1, hi0 ^ c.w ^ k.k1[i], lo0};
  }
  return c;
}

// top 24 bits -> [0, 1) exactly representable in f32
__device__ inline float u01(uint32_t x) { return static_cast<float>(x >> 8) * 5.9604644775390625e-8f; }

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }

// Box-Muller: cosine and sine legs of one (u1, u2) pair
__device__ inline void box_muller(float u1, float u2, float* cos_leg, float* sin_leg) {
  const float r = sqrtf(mul(-2.0f, logf(fmaxf(u1, 1e-7f))));
  float s, c;
  sincosf(mul(kTwoPi, u2), &s, &c);
  *cos_leg = mul(r, c);
  *sin_leg = mul(r, s);
}

// count = #{k : F(k) < u} over 40 PMF terms; once a term is dead every later
// term is too (cdf only grows, and pk <= 1e-12 happens only past the mode),
// so the early exit gives the same count as the fixed 40-term loop
__device__ inline float poisson_small(float lam, float u) {
  float pk = expf(-lam);
  float cdf = pk;
  float count = 0.0f;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    if (!(cdf < u && pk > 1e-12f)) break;
    count += 1.0f;
    pk = mul(pk, mul(lam, recip(k)));
    cdf = add(cdf, pk);
  }
  return count;
}

// What one packed row shares: its image's parameters (the read scales
// already floored at 1e-10) and its row noise, R_scale times each leg.
struct RowConsts {
  float K, g, G, lam, sat, ratio, row_even, row_odd;
};

// One element: clean value x, flat index (lo, hi); row_add is the row leg
// this channel takes, bias its colour bias (used when has_bias).
__device__ __forceinline__ float synth_element(float x, uint32_t lo, uint32_t hi, float row_add,
                                               float bias, bool has_bias, const RowConsts& p,
                                               int model, int clip, const RoundKeys& keys) {
  const float y = __fdiv_rn(mul(x, p.sat), p.ratio);
  const U4 a = philox4x32_10(U4{lo, hi, 0u, 0u}, keys);
  const float a0 = u01(a.x), a1 = u01(a.y);

  float z = y;
  float shot_sin = 0.0f;
  if (model & kModelP) {
    const float lam = fmaxf(__fdiv_rn(y, p.K), 0.0f);
    float count;
    if (lam > kSmallMax) {
      float n, unused;
      box_muller(a0, a1, &n, &unused);
      count = fmaxf(rintf(add(lam, mul(sqrtf(lam), n))), 0.0f);
    } else {
      count = poisson_small(lam, fmaxf(a0, 1e-12f));
    }
    z = mul(count, p.K);
  } else if (model & kModelp) {
    float n;
    box_muller(a0, a1, &n, &shot_sin);
    z = add(y, mul(n, sqrtf(fmaxf(mul(p.K, y), 1e-10f))));
  }

  if (model & kModelg) {
    float n, unused;
    if (model & kModelP) {
      const U4 b = philox4x32_10(U4{lo, hi, 1u, 0u}, keys);
      box_muller(u01(b.x), u01(b.y), &n, &unused);
    } else if (model & kModelp) {
      n = shot_sin;
    } else {
      box_muller(a0, a1, &n, &unused);
    }
    z = add(z, mul(n, p.g));
  }

  if (model & kModelG) {
    const float u = fminf(fmaxf(u01(a.z), 1e-7f), 0.9999999f);
    float tl;
    if (fabsf(p.lam) < 1e-6f) {
      tl = logf(u) - log1pf(-u);
    } else {
      tl = __fdiv_rn(powf(u, p.lam) - powf(1.0f - u, p.lam), p.lam);
    }
    z = add(z, mul(tl, p.G));
  }

  if (model & kModelr) z = add(z, row_add);
  if (model & kModelq) z = add(z, u01(a.w) - 0.5f);
  if ((model & kModelc) && has_bias) z = add(z, bias);

  const float o = __fdiv_rn(mul(z, p.ratio), p.sat);
  return clip ? fminf(fmaxf(o, 0.0f), 1.0f) : o;
}

// The round keys a block draws with: the host's (kDevSeed false), or those
// of the 64-bit seed at dev_seed, which thread (0, 0) reads once for the
// block (kDevSeed true; every thread of the block calls this).
template <bool kDevSeed>
__device__ __forceinline__ RoundKeys block_keys(const RoundKeys& host_keys,
                                                const uint64_t* __restrict__ dev_seed) {
  if constexpr (kDevSeed) {
    __shared__ uint64_t s_seed;
    if (threadIdx.x == 0 && threadIdx.y == 0) s_seed = *dev_seed;
    __syncthreads();
    const uint64_t seed = s_seed;
    return round_keys(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  } else {
    return host_keys;
  }
}

// Block (blockDim.x, blockDim.y) = (threads per row, rows per block); row
// threadIdx.y of the block is the global packed row n*H + h.  kPixel4: C == 4
// with 16-byte aligned clean/out, one float4 per lane; else one pixel per
// lane, its C channels one by one.  kDevSeed: the keys come from the seed
// at dev_seed, and host_keys is not read.
template <bool kPixel4, bool kDevSeed>
__global__ void __launch_bounds__(kBlockThreads)
    noise_synth_kernel(const float* __restrict__ clean, float* __restrict__ out,
                       const float* __restrict__ params, int rows, int h, int w, int c,
                       int model, int clip, const RoundKeys host_keys,
                       const uint64_t* __restrict__ dev_seed) {
  __shared__ float s_par[kMaxRowsPerBlock][kParamStride];
  __shared__ float s_row[kMaxRowsPerBlock][2];
  const RoundKeys keys = block_keys<kDevSeed>(host_keys, dev_seed);
  const int r = threadIdx.y;
  const int row = blockIdx.x * blockDim.y + r;
  if (threadIdx.x == 0 && row < rows) {
    const float* pp = params + (row / h) * kParamStride;
    for (int j = 0; j < kParamStride; ++j) s_par[r][j] = pp[j];
    if (model & kModelr) {
      // row < 2^31, so the counter's high word is 0
      const U4 d = philox4x32_10(U4{static_cast<uint32_t>(row), 0u, 2u, 0u}, keys);
      float even, odd;
      box_muller(u01(d.x), u01(d.y), &even, &odd);
      s_row[r][0] = mul(even, pp[4]);
      s_row[r][1] = mul(odd, pp[4]);
    }
  }
  __syncthreads();
  if (row >= rows) return;

  RowConsts p;
  p.K = s_par[r][0];
  p.g = fmaxf(s_par[r][1], 1e-10f);
  p.G = fmaxf(s_par[r][2], 1e-10f);
  p.lam = s_par[r][3];
  p.sat = s_par[r][5];
  p.ratio = s_par[r][6];
  p.row_even = (model & kModelr) ? s_row[r][0] : 0.0f;
  p.row_odd = (model & kModelr) ? s_row[r][1] : 0.0f;
  // flat index of the row's first element: one 64-bit multiply per row
  const uint64_t base = static_cast<uint64_t>(row) * static_cast<uint32_t>(w * c);

  if constexpr (kPixel4) {
    float cb[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) cb[ch] = s_par[r][7 + ch];
    const float4* src = reinterpret_cast<const float4*>(clean + base);
    float4* dst = reinterpret_cast<float4*>(out + base);
    for (int px = threadIdx.x; px < w; px += blockDim.x) {
      // base and 4*px are multiples of 4, so lo + ch never carries into hi
      const uint64_t i = base + 4u * static_cast<uint32_t>(px);
      const uint32_t lo = static_cast<uint32_t>(i), hi = static_cast<uint32_t>(i >> 32);
      const float4 v = src[px];
      const float x[4] = {v.x, v.y, v.z, v.w};
      float o[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        o[ch] = synth_element(x[ch], lo + ch, hi, ch < 2 ? p.row_even : p.row_odd, cb[ch], true,
                              p, model, clip, keys);
      }
      dst[px] = make_float4(o[0], o[1], o[2], o[3]);
    }
  } else {
    const bool bayer = c == 4;
    for (int px = threadIdx.x; px < w; px += blockDim.x) {
      const uint64_t i0 = base + static_cast<uint32_t>(px * c);
      for (int ch = 0; ch < c; ++ch) {
        const uint64_t i = i0 + static_cast<uint32_t>(ch);
        const float row_add = (bayer && ch >= 2) ? p.row_odd : p.row_even;
        const float bias = bayer ? s_par[r][7 + ch] : 0.0f;
        out[i] = synth_element(clean[i], static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32),
                               row_add, bias, bayer, p, model, clip, keys);
      }
    }
  }
}

// One launch of the kernel for (keys, dev_seed) on ``stream``; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the grid cannot index (N*H or W*C not below 2^31).
template <bool kDevSeed>
int launch(const float* clean, float* out, const float* params, int64_t n, int64_t h, int64_t w,
           int64_t c, int model, int clip, const RoundKeys& keys, const uint64_t* dev_seed,
           void* stream) {
  if (n * h * w * c == 0) return 0;
  const int64_t rows = n * h;
  if (rows > INT32_MAX || w * c > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // threads per row: the row's pixels rounded up to a power of two, at least
  // a warp and at most the block; the block's other threads take more rows
  int tx = 32;
  while (tx < kBlockThreads && tx < w) tx *= 2;
  const dim3 block(tx, kBlockThreads / tx);
  const int64_t blocks = (rows + block.y - 1) / block.y;
  const bool pixel4 = c == 4 && reinterpret_cast<uintptr_t>(clean) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto kernel =
      pixel4 ? noise_synth_kernel<true, kDevSeed> : noise_synth_kernel<false, kDevSeed>;
  kernel<<<static_cast<unsigned>(blocks), block, 0, static_cast<cudaStream_t>(stream)>>>(
      clean, out, params, static_cast<int>(rows), static_cast<int>(h), static_cast<int>(w),
      static_cast<int>(c), model, clip, keys, dev_seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` with the 64-bit step seed ``seed``;
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the grid cannot index (N*H or W*C not below 2^31).  clean/out:
// contiguous f32 (n, h, w, c); params: f32 (n, 12) as laid out above.
int eld_noise_synth(const float* clean, float* out, const float* params, int64_t n, int64_t h,
                    int64_t w, int64_t c, int model, int clip, uint64_t seed, void* stream) {
  return launch<false>(clean, out, params, n, h, w, c, model, clip,
                       round_keys(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)),
                       nullptr, stream);
}

// The same launch with the seed read on the device from ``seed`` (one
// uint64 in device memory) when the kernel runs, not when it is launched:
// a captured launch replays with whatever the buffer then holds.  Its
// output equals eld_noise_synth's for the same seed value, bit for bit.
int eld_noise_synth_dev(const float* clean, float* out, const float* params, int64_t n,
                        int64_t h, int64_t w, int64_t c, int model, int clip,
                        const uint64_t* seed, void* stream) {
  if (seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(clean, out, params, n, h, w, c, model, clip, RoundKeys{}, seed, stream);
}

// The kernel's generator on the host, for known-answer checks.
void eld_philox4x32_10(const uint32_t* ctr, const uint32_t* key, uint32_t* out) {
  const U4 r = philox4x32_10(U4{ctr[0], ctr[1], ctr[2], ctr[3]}, round_keys(key[0], key[1]));
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}

const char* eld_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
