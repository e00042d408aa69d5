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
// Design.  One thread per element of the flat (N*H*W*C) array in a
// grid-stride loop; image, packed row and channel come from the index, so
// there is no alignment constraint on W*C or H.  Random numbers come from a
// Philox4x32-10 generator written out below, keyed by the 64-bit step seed,
// with the element index as the counter: counter word 2 selects the stream
// (0: the element's four uniforms, 1: a second block for models that need
// more than four, 2: row noise, indexed by global packed row n*H + h, so every
// element of a row computes the same two draws).  A different seed is a
// different key, so consecutive step seeds never replay each other's streams.
//
// Uniform use per element (stream 0 = a0..a3): the shot component takes
// (a0, a1): a0 is the small-lam inverse-CDF uniform, and the large-lam branch
// (an exclusive case of the same element) takes the Box-Muller cosine leg of
// (a0, a1); 'p' takes the cosine leg.  Read noise 'g' takes the sine leg when
// 'p' is present, the cosine leg of (a0, a1) when there is no shot component,
// and stream 1 otherwise.  'G' takes a2, 'q' takes a3.  So the full model
// 'PGrqc' needs one Philox call per element plus the row call.
//
// Numerics: built without --use_fast_math, so expf/logf/log1pf/powf/sincosf
// are the accurate versions; the Poisson loop keeps the reference's linear-
// space recursion with compile-time f32 reciprocals and the pk > 1e-12 gate,
// and uses explicitly rounded multiplies/adds so that no contraction changes
// its counts against the plain PyTorch version (noise/model.py::noise_core).
//
// What bounds it on an H100: at the slice's shape (8, 512, 512, 4) it moves
// 33.5 MB in and 33.5 MB out, about 20 us at 3.35 TB/s.  Its arithmetic is one
// Philox call (10 rounds of two 32x32 multiplies) and up to 40 terms of the
// Poisson loop per element, which is of the same order; so it is neither
// clearly memory- nor compute-bound, and it is small next to the U-Net step.

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

// f32 reciprocal 1/(k+1); with the loop unrolled, k is a constant and the
// IEEE division folds at compile time
__host__ __device__ constexpr float recip(int k) { return 1.0f / static_cast<float>(k + 1); }

struct U4 {
  uint32_t x, y, z, w;
};

__host__ __device__ inline uint32_t mulhilo(uint32_t a, uint32_t b, uint32_t* hi) {
  const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  *hi = static_cast<uint32_t>(p >> 32);
  return static_cast<uint32_t>(p);
}

// Philox4x32-10 (Salmon et al., SC'11), the Random123 round and key schedule.
__host__ __device__ inline U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo(0xD2511F53u, c.x, &hi0);
    const uint32_t lo1 = mulhilo(0xCD9E8D57u, c.z, &hi1);
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
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

__global__ void noise_synth_kernel(const float* __restrict__ clean, float* __restrict__ out,
                                   const float* __restrict__ params, int64_t total, int64_t hwc,
                                   int64_t wc, int c, int model, int clip, uint32_t k0,
                                   uint32_t k1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t img = i / hwc;
    const int64_t row = i / wc;  // global packed row n*H + h
    const int ch = static_cast<int>(i % c);
    const float* pp = params + img * kParamStride;
    const float K = pp[0], sat = pp[5], ratio = pp[6];
    const float y = __fdiv_rn(mul(clean[i], sat), ratio);

    const uint32_t lo = static_cast<uint32_t>(i);
    const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
    const U4 a = philox4x32_10(U4{lo, hi, 0u, 0u}, k0, k1);
    const float a0 = u01(a.x), a1 = u01(a.y);

    float z = y;
    float shot_sin = 0.0f;
    if (model & kModelP) {
      const float lam = fmaxf(__fdiv_rn(y, K), 0.0f);
      float count;
      if (lam > kSmallMax) {
        float n, unused;
        box_muller(a0, a1, &n, &unused);
        count = fmaxf(rintf(add(lam, mul(sqrtf(lam), n))), 0.0f);
      } else {
        count = poisson_small(lam, fmaxf(a0, 1e-12f));
      }
      z = mul(count, K);
    } else if (model & kModelp) {
      float n;
      box_muller(a0, a1, &n, &shot_sin);
      z = add(y, mul(n, sqrtf(fmaxf(mul(K, y), 1e-10f))));
    }

    if (model & kModelg) {
      float n, unused;
      if (model & kModelP) {
        const U4 b = philox4x32_10(U4{lo, hi, 1u, 0u}, k0, k1);
        box_muller(u01(b.x), u01(b.y), &n, &unused);
      } else if (model & kModelp) {
        n = shot_sin;
      } else {
        box_muller(a0, a1, &n, &unused);
      }
      z = add(z, mul(n, fmaxf(pp[1], 1e-10f)));
    }

    if (model & kModelG) {
      const float lam = pp[3];
      const float u = fminf(fmaxf(u01(a.z), 1e-7f), 0.9999999f);
      float tl;
      if (fabsf(lam) < 1e-6f) {
        tl = logf(u) - log1pf(-u);
      } else {
        tl = __fdiv_rn(powf(u, lam) - powf(1.0f - u, lam), lam);
      }
      z = add(z, mul(tl, fmaxf(pp[2], 1e-10f)));
    }

    if (model & kModelr) {
      const uint32_t rlo = static_cast<uint32_t>(row);
      const uint32_t rhi = static_cast<uint32_t>(static_cast<uint64_t>(row) >> 32);
      const U4 r = philox4x32_10(U4{rlo, rhi, 2u, 0u}, k0, k1);
      float even, odd;
      box_muller(u01(r.x), u01(r.y), &even, &odd);
      const float rn = (c == 4 && ch >= 2) ? odd : even;
      z = add(z, mul(rn, pp[4]));
    }

    if (model & kModelq) z = add(z, u01(a.w) - 0.5f);
    if ((model & kModelc) && c == 4) z = add(z, pp[7 + ch]);

    float o = __fdiv_rn(mul(z, ratio), sat);
    if (clip) o = fminf(fmaxf(o, 0.0f), 1.0f);
    out[i] = o;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream``; returns cudaGetLastError() after the launch.
// clean/out: contiguous f32 (n, h, w, c); params: f32 (n, 12) as laid out above.
int eld_noise_synth(const float* clean, float* out, const float* params, int64_t n, int64_t h,
                    int64_t w, int64_t c, int model, int clip, uint64_t seed, void* stream) {
  const int64_t total = n * h * w * c;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride covers the rest
  noise_synth_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      clean, out, params, total, h * w * c, w * c, static_cast<int>(c), model, clip,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's generator on the host, for known-answer checks.
void eld_philox4x32_10(const uint32_t* ctr, const uint32_t* key, uint32_t* out) {
  const U4 r = philox4x32_10(U4{ctr[0], ctr[1], ctr[2], ctr[3]}, key[0], key[1]);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}

const char* eld_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
