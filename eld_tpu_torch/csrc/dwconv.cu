// The 3x3 depthwise convolutions of Restormer and of Uformer's LeFF for NVIDIA Hopper (sm_90a),
// one pass each way.
//
// Replaces no TPU kernel: eld_tpu has neither model.  Each Restormer transformer block runs two
// depthwise 3x3 convolutions (zero padding 1, stride 1, no bias): MDTA's over its q, k, v
// (3 dim channels) and GDFN's over its two gate halves (2 int(2.66 dim) channels: 254, 510,
// 1020 and 2042 at dim 48).  cuDNN ran each as three kernels (forward, dgrad, wgrad), each
// reading its own operands: ~27.8 ms of a ~97 ms train step at batch 4 of 256^2 on an H100.
// For x in NHWC order, C channels a pixel, and the (C, 1, 3, 3) weight k with taps
// d = (i - 1, j - 1):
//
//   forward   y(p)      = sum_d x(p + d) k[d] (+ b)    (x zero outside the frame)
//   backward  gx(q)     = sum_d gy(q - d) k[d]         (the flipped stencil of gy)
//             gw[c][d]  = sum_p gy(p) x(p + d) = sum_q x(q) gy(q - d)
//             gb[c]     = sum_q gy(q)                  (with a bias)
//
// in f32 from bf16 operands, with k (and b) rounded to bf16 as autocast rounded them for
// cuDNN; y and gx are rounded once to bf16, gw and gb stay f32.  All backward terms read the
// same 3x3 window of gy around q and x at q alone, so the backward is one pass over x and gy.
// The bias is optional (Uformer's LeFF has one, Restormer's convs none): a template parameter,
// so that the kernels without it are the code they were before it existed.
//
// What bounds it on an H100: bytes.  The forward reads x and writes y, the backward reads x
// and gy and writes gx: 4 and 6 bytes a channel-pixel in bf16, against 18 f32 FMAs a
// channel-pixel each way.  A step's 88 convolutions cover 3.137e9 channel-pixels: 31.4 GB,
// 9.36 ms at 3,350 GB/s.  The design answers that bound with one pass each way:
//
//  - Any even C: a lane owns a channel pair (two bf16, one aligned 32-bit word of every
//    pixel, since an even C keeps each pixel 4-byte aligned), and a warp's 32 lanes own 32
//    neighbouring pairs, so each of its stores is 128 contiguous bytes.  254, 510 and 2042
//    channels (half of GDFN's counts, 63% of the bytes with 1020) are no multiple of 8.
//  - A block owns a tile of 32 pairs x kTileCols pixels across and walks a band of
//    `rows` pixel rows down it.  The rows stream through a ring in shared memory (a
//    one-pixel halo each side) by 16-byte cp.async: each pixel's run of the chunk's pairs
//    from the 16-byte piece it starts in, zero-filled outside the frame, its pairs then at a
//    word offset 0-3 that follows from the pixel's index.  kAhead iterations' rows are in
//    flight while a warp computes, whatever its registers.
//  - Issue slots, not bytes, bound these kernels on an H100: with its loads and stores
//    taken out the forward still took three quarters of its time.  So what a lane does a
//    byte is cut down: a warp computes kFwdStep (forward) or kBwdStep (backward) output
//    rows at once and walks its window a column at a time, so each window word is read and
//    unpacked once for up to 3 x kStep outputs; the word offsets are 32-bit arithmetic
//    (only their low two bits count); where each of a thread's copies lies in a ring row
//    is worked out once a block.  Alone, a step's 88 convolutions take about twice the
//    byte bound, where cuDNN's three kernels took about three times it.
//  - `rows` falls from 64 until the bands give the card two waves of blocks; the blocks
//    that read a pixel's chunks, and neighbouring bands, run side by side, so a band's halo
//    rows and a partly written 32-byte sector are mostly met in L2.  The plan comes from C,
//    H and W as observed.
//  - The weight gradient is deterministic, with no float atomics: each lane adds its 9 taps
//    of its two channels in registers over its band; the block adds its warps' sums in a
//    fixed order into one row of an f32 workspace of [tiles, C, 9]; dwconv3_wsum adds the
//    rows in a fixed order; the bias's gradient likewise, from a tenth row of sums.  The same
//    shape on the same card gives the same bits, so a CUDA graph replays what the eager call
//    computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;      // channel pairs a warp, and a chunk of a tile
constexpr int kWarps = 4;       // warps a block, side by side across the tile's pixels
constexpr int kCols = 4;        // pixels across a warp's share of a row
constexpr int kThreads = kLanes * kWarps;
constexpr int kTileCols = kWarps * kCols;  // pixels across a tile
constexpr int kFwdStep = 4;     // output rows a forward iteration
constexpr int kBwdStep = 2;     // ... a backward iteration
constexpr int kAhead = 1;       // iterations' rows in flight beyond the next's
constexpr int kMaxRows = 64;    // pixel rows of a band, at most (a multiple of both steps)
constexpr int kMinRows = 4;     // ... and at least
constexpr int kWaves = 2;       // waves of blocks the bands should fill
constexpr int kTaps = 9;
constexpr int kSumSlices = 32;
// A pixel's run of a chunk in the ring: its pairs after 0-3 words of the 16-byte piece they
// start in, copied as kPieces pieces of 16 bytes.
constexpr int kPixelWords = kLanes + 4;
constexpr int kPieces = kPixelWords / 4;
constexpr int kRingWords = (kTileCols + 2) * kPixelWords;  // a row of the ring: tile and halo
constexpr int kXWords = kTileCols * kPixelWords;           // a row of x in the backward's ring

// rows of a ring whose iterations compute STEP rows: the STEP + 2 they read, the STEP the
// next iteration adds, and kAhead x STEP more in flight
template <int STEP>
__host__ __device__ constexpr int stages() { return (2 + kAhead) * STEP + 2; }

constexpr size_t kFwdSmem = sizeof(uint32_t) * stages<kFwdStep>() * kRingWords;
constexpr size_t kBwdSmem = sizeof(uint32_t) * stages<kBwdStep>() * (kRingWords + kXWords);

static_assert(kMinRows % kFwdStep == 0 && kMinRows % kBwdStep == 0, "whole iterations a band");
static_assert(kFwdSmem <= 48 * 1024 && kBwdSmem <= 48 * 1024,
              "each ring fits the default shared memory of a block");
static_assert(kBwdSmem >= sizeof(float) * kWarps * 2 * (kTaps + 1) * (kLanes + 1),
              "the backward's ring holds the warps' weight- and bias-gradient sums at the end");

// the two channels of a pair as f32 (the lower address is the first channel)
__device__ inline float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ inline float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ inline uint32_t pack(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ inline float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// A 16-byte copy from global to shared memory, zeros where `valid` is false (nothing read).
__device__ inline void copy16(uint32_t* dst, const uint4* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ inline void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tiles of a launch: n images of h x w pixels, `pairs` channel pairs in `chunks` chunks
// of kLanes; a block's tile is (chunk, band of `rows` rows, column tile, image), chunks
// fastest, so the blocks that read a pixel's chunks run side by side.
struct Tiles {
  int n, h, w, pairs, chunks, rows, col_tiles, bands;
};

// A block's tile, and where a lane works in it: its warp's share of the tile's pixels, its
// channel pair.
struct Tile {
  int chunk, img, c0, r0, r1, index;  // index: the tile's row of the weight-gradient rows
  int lane, warp, first;              // first: the warp's first pixel of the tile
  int pair;
  bool live;                          // whether the lane has a pair (the last chunk's may not)
};

__device__ inline Tile tile_of(const Tiles& g) {
  Tile t;
  int id = blockIdx.x;
  t.chunk = id % g.chunks;
  id /= g.chunks;
  const int band = id % g.bands;
  id /= g.bands;
  const int ct = id % g.col_tiles;
  t.img = id / g.col_tiles;
  t.c0 = ct * kTileCols;
  t.r0 = band * g.rows;
  t.r1 = min(t.r0 + g.rows, g.h);
  t.index = (t.img * g.col_tiles + ct) * g.bands + band;
  t.lane = threadIdx.x % kLanes;
  t.warp = threadIdx.x / kLanes;
  t.first = t.warp * kCols;
  t.pair = t.chunk * kLanes + t.lane;
  t.live = t.pair < g.pairs;
  return t;
}

// the weight's 9 taps of the lane's two channels, rounded to bf16
__device__ inline void taps(const float* __restrict__ wt, const Tile& t, float (&k0)[kTaps],
                            float (&k1)[kTaps]) {
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    k0[i] = t.live ? round_bf16(wt[(2 * t.pair) * kTaps + i]) : 0.0f;
    k1[i] = t.live ? round_bf16(wt[(2 * t.pair + 1) * kTaps + i]) : 0.0f;
  }
}

// A thread's share of copying rows of the tile's chunk, `cols` pixels from column c0 + from
// on, into a ring row ([cols][kPixelWords] words): each pixel's run of live pairs by the
// 16-byte pieces that hold it, from the one it starts in, all zeros for a pixel outside the
// frame.  A pixel's pairs then start at word (its index x pairs) & 3 of its run.  The thread
// takes pieces threadIdx.x, threadIdx.x + kThreads, ... of the row; where each lies is worked
// out once, so a row costs a thread a few instructions a piece.
template <int COLS>
struct RowCopy {
  static constexpr int M = (COLS * kPieces + kThreads - 1) / kThreads;  // pieces a thread
  int64_t word[M];  // the piece's pixel's first word, less the row's
  int dst[M];       // the piece's word in a ring row
  int k[M];         // which piece of its pixel's run it is
  bool in[M];       // whether the piece exists and its pixel's column is in the frame
  bool used[M];
  int live;         // the chunk's pairs

  __device__ RowCopy(const Tiles& g, const Tile& t, int from) {
    live = min(kLanes, g.pairs - t.chunk * kLanes);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = threadIdx.x + m * kThreads, p = i / kPieces, col = t.c0 + from + p;
      used[m] = i < COLS * kPieces;
      k[m] = i - p * kPieces;
      dst[m] = p * kPixelWords + 4 * k[m];
      in[m] = used[m] && col >= 0 && col < g.w;
      word[m] = static_cast<int64_t>(col) * g.pairs + t.chunk * kLanes;
    }
  }

  // row q of `src` into `ring_row`; all the block's threads take part
  __device__ void row(const uint32_t* __restrict__ src, const Tiles& g, const Tile& t, int q,
                      uint32_t* ring_row) const {
    const bool row_in = q >= 0 && q < g.h;
    const int64_t row_word = (static_cast<int64_t>(t.img) * g.h + q) * g.w * g.pairs;
    const uint4* pieces = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!used[m]) continue;
      const bool ok = row_in && in[m];
      const int64_t w = row_word + word[m];
      if (!ok || 4 * k[m] < static_cast<int>(w & 3) + live)
        copy16(ring_row + dst[m], ok ? pieces + (w >> 2) + k[m] : pieces, ok);
    }
  }
};

// The ring of a band whose iterations compute STEP rows: row q in slot (q - r0 + 1) % S.
template <int STEP>
struct Ring {
  static constexpr int S = stages<STEP>();
  int r0, r_end;  // the band's first row, and its end rounded up to whole iterations

  __device__ explicit Ring(const Tile& t)
      : r0(t.r0), r_end(t.r0 + (t.r1 - t.r0 + STEP - 1) / STEP * STEP) {}
  __device__ int slot(int q) const { return (q - r0 + 1) % S; }

  // Issue rows r0 - 1 ... r0 + S - STEP - 2, one commit group each, by issue(q, slot).
  template <typename F>
  __device__ void prologue(F issue) const {
    for (int q = r0 - 1; q <= r0 + S - STEP - 2; ++q) {
      if (q <= r_end) issue(q, slot(q));
      commit();
    }
  }

  // Before the iteration of rows r ... r + STEP - 1: wait for rows up to r + STEP, then
  // issue the STEP rows into the slots the last iteration read and this one does not.
  template <typename F>
  __device__ void advance(int r, F issue) const {
    wait_pending<S - 2 * STEP - 2>();
    __syncthreads();
    for (int q = r + S - STEP - 1; q <= r + S - 2; ++q) {
      if (q <= r_end) issue(q, slot(q));
      commit();
    }
  }
};

// the low two bits of the first word of pixel (q, col), in 32-bit arithmetic
__device__ inline unsigned word_bits(const Tiles& g, const Tile& t, int q, int col) {
  return (static_cast<unsigned>(t.img * g.h + q) * g.w + col) * static_cast<unsigned>(g.pairs);
}

// y over the block's tile (plus the bias b where BIAS).  Dynamic shared memory: kFwdSmem.
template <bool BIAS>
__global__ void __launch_bounds__(kThreads) dwconv3_fwd(const uint32_t* __restrict__ x,
                                                        const float* __restrict__ wt,
                                                        const float* __restrict__ b,
                                                        uint32_t* __restrict__ y, Tiles g) {
  constexpr int STEP = kFwdStep;
  extern __shared__ uint32_t ring[];
  const Tile t = tile_of(g);
  const Ring<STEP> rg(t);
  float k0[kTaps], k1[kTaps];
  taps(wt, t, k0, k1);
  float b0 = 0.0f, b1 = 0.0f;
  if constexpr (BIAS) {
    if (t.live) {
      b0 = round_bf16(b[2 * t.pair]);
      b1 = round_bf16(b[2 * t.pair + 1]);
    }
  }
  const RowCopy<kTileCols + 2> copy(g, t, -1);
  auto issue = [&](int q, int s) { copy.row(x, g, t, q, ring + s * kRingWords); };
  rg.prologue(issue);
  const unsigned row_bits = static_cast<unsigned>(g.w) * g.pairs, col_bits = g.pairs;
  for (int r = t.r0; r < rg.r_end; r += STEP) {
    rg.advance(r, issue);
    // the window: rows r - 1 ... r + STEP, pixel columns c0 + first - 1 ... c0 + first + kCols
    const uint32_t* rows[STEP + 2];
#pragma unroll
    for (int i = 0; i < STEP + 2; ++i)
      rows[i] = ring + rg.slot(r - 1 + i) * kRingWords + t.first * kPixelWords + t.lane;
    const unsigned bits = word_bits(g, t, r - 1, t.c0 + t.first - 1);
    float a0[STEP][kCols], a1[STEP][kCols];
#pragma unroll
    for (int o = 0; o < STEP; ++o)
#pragma unroll
      for (int j = 0; j < kCols; ++j) a0[o][j] = a1[o][j] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kCols + 2; ++jj) {
      float f0[STEP + 2], f1[STEP + 2];
#pragma unroll
      for (int i = 0; i < STEP + 2; ++i) {
        const uint32_t u = rows[i][jj * kPixelWords + ((bits + i * row_bits + jj * col_bits) & 3)];
        f0[i] = lo(u);
        f1[i] = hi(u);
      }
      // column jj is tap column dj of output column jj - dj
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int j = jj - dj;
        if (j < 0 || j >= kCols) continue;
#pragma unroll
        for (int o = 0; o < STEP; ++o)
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            a0[o][j] = __fmaf_rn(f0[o + di], k0[3 * di + dj], a0[o][j]);
            a1[o][j] = __fmaf_rn(f1[o + di], k1[3 * di + dj], a1[o][j]);
          }
      }
    }
    if (!t.live) continue;
#pragma unroll
    for (int o = 0; o < STEP; ++o) {
      if (r + o >= t.r1) break;
      const int64_t out =
          ((static_cast<int64_t>(t.img) * g.h + r + o) * g.w + t.c0 + t.first) * g.pairs + t.pair;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if constexpr (BIAS) {
          a0[o][j] += b0;
          a1[o][j] += b1;
        }
        if (t.c0 + t.first + j < g.w) y[out + j * g.pairs] = pack(a0[o][j], a1[o][j]);
      }
    }
  }
  wait_pending<0>();  // no copy outlives the block
}

// gx over the block's tile, and partial[tile][ch][tap] = the tile's f32 sum of
// gy(q - d) x(q) (and, where BIAS, partial_b[tile][ch] = its sum of gy(q)).  Dynamic shared
// memory: kBwdSmem, gy's ring then x's.
template <bool BIAS>
__global__ void __launch_bounds__(kThreads)
    dwconv3_bwd(const uint32_t* __restrict__ x, const uint32_t* __restrict__ gy,
                const float* __restrict__ wt, uint32_t* __restrict__ gx,
                float* __restrict__ partial, float* __restrict__ partial_b, Tiles g) {
  constexpr int STEP = kBwdStep;
  extern __shared__ uint32_t ring[];
  uint32_t* xring = ring + stages<STEP>() * kRingWords;
  const Tile t = tile_of(g);
  const Ring<STEP> rg(t);
  float k0[kTaps], k1[kTaps], w0[kTaps], w1[kTaps];
  taps(wt, t, k0, k1);
#pragma unroll
  for (int i = 0; i < kTaps; ++i) w0[i] = w1[i] = 0.0f;
  float gb0 = 0.0f, gb1 = 0.0f;  // the bias's gradient: the centre tap's gy, every output once
  const RowCopy<kTileCols + 2> copy_gy(g, t, -1);
  const RowCopy<kTileCols> copy_x(g, t, 0);
  auto issue = [&](int q, int s) {  // gy row q with its halo; x row q where the band reads it
    copy_gy.row(gy, g, t, q, ring + s * kRingWords);
    if (q >= t.r0 && q < rg.r_end) copy_x.row(x, g, t, q, xring + s * kXWords);
  };
  rg.prologue(issue);
  const unsigned row_bits = static_cast<unsigned>(g.w) * g.pairs, col_bits = g.pairs;
  for (int r = t.r0; r < rg.r_end; r += STEP) {
    rg.advance(r, issue);
    // gy's window: rows r - 1 ... r + STEP, pixel columns c0 + first - 1 ... c0 + first +
    // kCols; x: rows r ... r + STEP - 1, columns c0 + first ... (0 past the frame)
    const uint32_t* rows[STEP + 2];
#pragma unroll
    for (int i = 0; i < STEP + 2; ++i)
      rows[i] = ring + rg.slot(r - 1 + i) * kRingWords + t.first * kPixelWords + t.lane;
    const unsigned bits = word_bits(g, t, r - 1, t.c0 + t.first - 1);
    float x0[STEP][kCols], x1[STEP][kCols], g0[STEP][kCols], g1[STEP][kCols];
#pragma unroll
    for (int o = 0; o < STEP; ++o) {
      const uint32_t* xrow = xring + rg.slot(r + o) * kXWords + t.first * kPixelWords + t.lane;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint32_t u =
            xrow[j * kPixelWords + ((bits + (o + 1) * row_bits + (j + 1) * col_bits) & 3)];
        x0[o][j] = lo(u);
        x1[o][j] = hi(u);
        g0[o][j] = g1[o][j] = 0.0f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols + 2; ++jj) {
      float f0[STEP + 2], f1[STEP + 2];
#pragma unroll
      for (int i = 0; i < STEP + 2; ++i) {
        const uint32_t u = rows[i][jj * kPixelWords + ((bits + i * row_bits + jj * col_bits) & 3)];
        f0[i] = lo(u);
        f1[i] = hi(u);
      }
      // tap (di, dj) of output (o, j) reads gy at window row o + 2 - di, column j + 2 - dj:
      // column jj serves output column jj - 2 + dj
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int j = jj - 2 + dj;
        if (j < 0 || j >= kCols) continue;
#pragma unroll
        for (int o = 0; o < STEP; ++o)
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            const int tap = 3 * di + dj;
            g0[o][j] = __fmaf_rn(f0[o + 2 - di], k0[tap], g0[o][j]);
            g1[o][j] = __fmaf_rn(f1[o + 2 - di], k1[tap], g1[o][j]);
            w0[tap] = __fmaf_rn(f0[o + 2 - di], x0[o][j], w0[tap]);
            w1[tap] = __fmaf_rn(f1[o + 2 - di], x1[o][j], w1[tap]);
            if constexpr (BIAS) {
              if (tap == 4) {
                gb0 = __fadd_rn(gb0, f0[o + 1]);
                gb1 = __fadd_rn(gb1, f1[o + 1]);
              }
            }
          }
      }
    }
    if (!t.live) continue;
#pragma unroll
    for (int o = 0; o < STEP; ++o) {
      if (r + o >= t.r1) break;
      const int64_t out =
          ((static_cast<int64_t>(t.img) * g.h + r + o) * g.w + t.c0 + t.first) * g.pairs + t.pair;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (t.c0 + t.first + j < g.w) gx[out + j * g.pairs] = pack(g0[o][j], g1[o][j]);
    }
  }
  // the warps hold the same channels: warp 0 adds their sums in order, in the ring's memory
  wait_pending<0>();
  __syncthreads();
  constexpr int kSums = 2 * kTaps + (BIAS ? 2 : 0);  // a warp's rows of sums
  float* sums = reinterpret_cast<float*>(ring);  // [warp][kSums][kLanes + 1]
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    sums[(t.warp * kSums + i) * (kLanes + 1) + t.lane] = w0[i];
    sums[(t.warp * kSums + kTaps + i) * (kLanes + 1) + t.lane] = w1[i];
  }
  if constexpr (BIAS) {
    sums[(t.warp * kSums + 2 * kTaps) * (kLanes + 1) + t.lane] = gb0;
    sums[(t.warp * kSums + 2 * kTaps + 1) * (kLanes + 1) + t.lane] = gb1;
  }
  __syncthreads();
  if (t.warp == 0 && t.live) {
    float* row = partial + (static_cast<int64_t>(t.index) * g.pairs + t.pair) * 2 * kTaps;
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      float v = sums[i * (kLanes + 1) + t.lane];
      for (int wi = 1; wi < kWarps; ++wi)
        v = __fadd_rn(v, sums[(wi * kSums + i) * (kLanes + 1) + t.lane]);
      if (i < 2 * kTaps) {
        row[i] = v;  // [channel 2 pair, 2 pair + 1][tap]
      } else if constexpr (BIAS) {
        partial_b[static_cast<int64_t>(t.index) * 2 * g.pairs + 2 * t.pair + i - 2 * kTaps] = v;
      }
    }
  }
}

// gw[e] = the tiles' rows added in a fixed order, e over the C * 9 entries: slice ty of the
// 32 sums rows ty, ty + 32, ... in turn, then slice 0 adds the slices.
__global__ void __launch_bounds__(32 * kSumSlices)
    dwconv3_wsum(const float* __restrict__ partial, float* __restrict__ gw, int rows,
                 int entries) {
  __shared__ float part[kSumSlices][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (e < entries) {
    for (int b = threadIdx.y; b < rows; b += kSumSlices)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * entries + e]);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < entries) {
    float s = part[0][threadIdx.x];
    for (int i = 1; i < kSumSlices; ++i) s = __fadd_rn(s, part[i][threadIdx.x]);
    gw[e] = s;
  }
}

Tiles tiles_of(int n, int h, int w, int c, int rows) {
  Tiles g;
  g.n = n;
  g.h = h;
  g.w = w;
  g.pairs = c / 2;
  g.chunks = (g.pairs + kLanes - 1) / kLanes;
  g.rows = rows;
  g.col_tiles = (w + kTileCols - 1) / kTileCols;
  g.bands = (h + rows - 1) / rows;
  return g;
}

int64_t blocks_of(const Tiles& g) {
  return static_cast<int64_t>(g.chunks) * g.n * g.col_tiles * g.bands;
}

bool takes(int n, int h, int w, int c) {
  return n >= 0 && h >= 0 && w >= 0 && c >= 2 && c % 2 == 0;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

// x, y, gy and gx are dense NHWC bf16 of n images of h x w pixels and c channels, c even,
// x and gy on a 16-byte boundary, y and gx on a 4-byte one; w is the (c, 1, 3, 3) f32
// weight, partial an f32 workspace of [tiles, c, 9] and gw the f32 (c, 1, 3, 3) gradient; b,
// partial_b ([tiles, c]) and gb the optional bias, its workspace and its f32 gradient.
// Each returns cudaGetLastError() after its launches, or cudaErrorInvalidValue for
// arguments it does not take.

// The plan of a launch: `rows` pixel rows a band, from kMaxRows down until the blocks fill
// kWaves waves of the card that is current (or reach kMinRows), and the backward's `tiles`,
// the rows of its weight-gradient workspace.
int eld_dwconv3_plan(int n, int h, int w, int c, int backward, int* rows, int* tiles) {
  if (!takes(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  int device, sms, per_sm = 0;
  int rc = static_cast<int>(cudaGetDevice(&device));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (rc == 0) {
    // the plan is the bias-free kernels': the same tiles with or without a bias
    rc = static_cast<int>(
        backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dwconv3_bwd<false>,
                                                                 kThreads, kBwdSmem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dwconv3_fwd<false>,
                                                                 kThreads, kFwdSmem));
  }
  if (rc != 0) return rc;
  const int64_t want = static_cast<int64_t>(kWaves) * sms * (per_sm > 0 ? per_sm : 1);
  int r = kMaxRows;
  while (r > kMinRows && blocks_of(tiles_of(n, h, w, c, r)) < want) r /= 2;
  const Tiles g = tiles_of(n, h, w, c, r);
  *rows = r;
  *tiles = g.n * g.col_tiles * g.bands;
  return 0;
}

// y = the depthwise 3x3 convolution of x with w, plus the (c) f32 bias b unless b is null.
int eld_dwconv3_fwd(const void* x, const float* w, const float* b, void* y, int n, int h, int wd,
                    int c, int rows, void* stream) {
  if (!takes(n, h, wd, c) || rows < 1 || rows % kFwdStep || !aligned(x, 16) || !aligned(y, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiles g = tiles_of(n, h, wd, c, rows);
  const int64_t blocks = blocks_of(g);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const uint32_t*>(x);
  auto* ys = static_cast<uint32_t*>(y);
  if (b)
    dwconv3_fwd<true><<<static_cast<unsigned>(blocks), kThreads, kFwdSmem, s>>>(xs, w, b, ys, g);
  else
    dwconv3_fwd<false><<<static_cast<unsigned>(blocks), kThreads, kFwdSmem, s>>>(xs, w, b, ys, g);
  return static_cast<int>(cudaGetLastError());
}

// gx and gw, and gb unless it is null; partial holds n * ceil(wd / kTileCols) * ceil(h / rows)
// rows of c * 9 floats, partial_b (with gb) as many rows of c floats.
int eld_dwconv3_bwd(const void* x, const void* gy, const float* w, void* gx, float* partial,
                    float* gw, float* partial_b, float* gb, int n, int h, int wd, int c, int rows,
                    void* stream) {
  if (!takes(n, h, wd, c) || rows < 1 || rows % kBwdStep || !aligned(x, 16) ||
      !aligned(gy, 16) || !aligned(gx, 4) || (gb && !partial_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const Tiles g = tiles_of(n, h, wd, c, rows);
  const int64_t blocks = blocks_of(g);
  if (blocks == 0) {
    int rc = static_cast<int>(cudaMemsetAsync(gw, 0, sizeof(float) * kTaps * c, s));
    if (rc == 0 && gb) rc = static_cast<int>(cudaMemsetAsync(gb, 0, sizeof(float) * c, s));
    return rc;
  }
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* gys = static_cast<const uint32_t*>(gy);
  auto* gxs = static_cast<uint32_t*>(gx);
  if (gb)
    dwconv3_bwd<true><<<static_cast<unsigned>(blocks), kThreads, kBwdSmem, s>>>(
        xs, gys, w, gxs, partial, partial_b, g);
  else
    dwconv3_bwd<false><<<static_cast<unsigned>(blocks), kThreads, kBwdSmem, s>>>(
        xs, gys, w, gxs, partial, partial_b, g);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int rows_all = g.n * g.col_tiles * g.bands;
  const int entries = kTaps * c;
  dwconv3_wsum<<<(entries + 31) / 32, dim3(32, kSumSlices), 0, s>>>(partial, gw, rows_all,
                                                                    entries);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !gb) return rc;
  dwconv3_wsum<<<(c + 31) / 32, dim3(32, kSumSlices), 0, s>>>(partial_b, gb, rows_all, c);
  return static_cast<int>(cudaGetLastError());
}

const char* eld_dwconv3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
