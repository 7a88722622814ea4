// Eval-mode PointNet shape encoder (ShapeEncoderPC with BatchNorm folded),
// fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel pose3d_tpu/ops/pointnet_fused.py
// _pallas_pointnet_eval (_kernel). Same function as
// pose3d_tpu_torch/ops/pointnet.py pointnet_eval_plain, on folded f32
// parameters:
//   out[n, :] = max_p ( relu(relu(x_p W1 + b1) W2 + b2) W3 + b3 )
// with x_p the p-th point (3 floats) of cloud n, W1 (3, 64), W2 (64, 128),
// W3 (128, D). The (N, P, D) activation never reaches device memory.
//
// What bounds it: at the recipe's N 64, P 2500, D 1024 the three products
// are 2 * 64 * 2500 * (192 + 8,192 + 131,072) = 44.6 GFLOP against 1.9 MB
// of points read, so the kernel is bound by operations: 0.67 ms at the
// H100's 67 TFLOP/s f32 rate on the CUDA cores, 0.27 ms as split TF32 on
// the tensor cores (three TF32 products per f32 product at 495 TFLOP/s).
// Layer 3 is 94 % of the operations at D 1024, so it runs on the tensor
// cores; layer 1 (3 -> 64) and layer 2 (64 -> 128) stay f32 FMA.
//
// Split TF32 (as csrc/vgg_stem.cu and csrc/info_nce.cu): each f32 operand v
// is big = rna(v) plus small = rna(v - big), both TF32 (cvt.rna), and each
// product is small.big + big.small + big.big by mma.sync.m16n8k8 in f32
// accumulators; the dropped small.small and the rounding of small leave
// about 2^-21 of each product, where one TF32 product leaves 2^-11. Each
// operand is split once: W3 by a first small kernel into a scratch buffer
// in b-fragment order (a lane's fragment, both parts, is one 16-byte load),
// h2 as layer 2 writes it, into shared memory in a-fragment order (two
// 16-byte loads). Layer 3's sums run over K 128, 16 k-steps; the tensor
// cores' f32 accumulation truncates, and one long mma chain on one
// accumulator cost the NCE kernel accuracy (PERF.md), so each k-step's
// three products go into a fresh accumulator that an FADD (round to
// nearest) adds to the running sum: chains of three mma.
//
// Design. The TPU kernel carries the max across a sequential grid axis in
// its output block; Hopper's blocks run in parallel and in no order, so a
// block owns whole outputs:
//   * grid (cloud n, point segment, column group). A block walks its
//     segment of the cloud in tiles of 128 points. Per tile it computes
//     layers 1 and 2 once, for all of D. In layer 2 a lane computes its
//     a-fragments of 4 m-tiles at 4 k-steps: 8 points (rows g, g + 8) x 8
//     channels (8 k + t, 8 k + t + 4), 64 FMA for 2 16-byte loads of W2
//     (kept in shared memory permuted so that the 4 t of a quarter-warp hit
//     4 bank groups) and 2 of h1, so h2 goes to shared memory split and in
//     fragment order by 16-byte stores. h2's parts take 128 KB.
//   * Layer 3 then walks the block's columns in passes of 256. W3's parts
//     stream from L2 one k-step (16 KB) at a time through a 3-stage cp.async
//     ring, two k-steps ahead of the products; warp (wm, wn) takes points
//     64 wm .. 64 wm + 63 and columns 64 wn .. 64 wn + 63 of the pass: 4 x 8
//     m16n8 tiles, 128 accumulators a lane (255 registers). The two warps
//     of a 64-column slice (one wn) are the only readers of its quarter of
//     each stage, so they copy it and wait for each other at a named
//     barrier, not for the whole block at every k-step (a block barrier
//     there cost about a tenth of the time, PERF.md). At a pass's
//     end each column's max over the tile's valid points (rows past the
//     cloud's end are left out) goes through registers, shuffles and the
//     slice's shared memory into the block's row of the output, where the
//     slice's thread that owns the column keeps the running max over the
//     segment's tiles. The max starts at the first tile's value (the last
//     layer has no ReLU, so not at 0).
//   * One block an SM (213 KB of shared memory). When clouds x tiles leave
//     SMs idle (serving at batch 1) the columns are split into groups, each
//     block a group's passes, and layers 1-2 are computed once a group;
//     when the clouds' tiles exceed the SMs, each cloud's tiles are split
//     into segments so that the waves come out even: each segment's block
//     then writes its partial max into a scratch (N, S, D) buffer and a
//     last small kernel takes the max over the segments and adds b3. No
//     atomics: the result is deterministic.
//   * b3 is added after the max: rounding is monotone, so
//     max_p fl(a_p + b) == fl(max_p a_p + b) exactly.
// So a call is 2 CUDA launches (the W3 split, the encoder), 3 with segments.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // a block of the encoder
constexpr int kThreads = 32 * kWarps;
constexpr int kC1 = 64;                // layer-1 width
constexpr int kC2 = 128;               // layer-2 width, layer 3's K
constexpr int kKSteps = kC2 / 8;       // layer 3's k-steps
constexpr int kTileP = 128;            // points a tile: 8 m-tiles
constexpr int kChunkD = 256;           // W3 columns a pass: 32 n-tiles
constexpr int kStages = 3;             // the W3 ring
constexpr int kLdH1 = kC1 + 4;         // h1 row stride, against bank conflicts
constexpr int kMT = 4, kNT = 8;        // layer 3: m16 x n8 tiles a warp
constexpr int kWarpsM = kTileP / (16 * kMT);  // warps along the points
constexpr int kSliceThreads = 32 * kWarpsM;   // a column slice: the warps of 8 kNT columns
constexpr int kL2M = 32 / kWarps;      // layer 2: m-tiles a warp, at 4 k-steps

// shared memory, in 32-bit words, in this order
constexpr int kH2 = (kTileP / 16) * kKSteps * 256;  // h2 split: [m-tile][k-step][256]
constexpr int kStage = (kChunkD / 8) * 128;         // one k-step of W3 split
constexpr int kRing = kStages * kStage;             // h1 [kTileP][kLdH1] aliases it
constexpr int kW2 = kC1 * kC2;                      // W2 permuted, w2_slot order
constexpr int kW1 = 3 * kC1;
constexpr int kX = 3 * kTileP;
constexpr int kRed = kWarpsM * kChunkD;             // a pass's max, per point range
constexpr int kSmemWords = kH2 + kRing + kW2 + kW1 + kC1 + kC2 + kX + kRed;
constexpr size_t kSmemBytes = sizeof(float) * kSmemWords;  // 218,112
static_assert(kSmemBytes <= 232448, "over Hopper's 227 KB a block");
static_assert(kTileP * kLdH1 <= kRing, "h1 lives in the ring during layers 1-2");
static_assert(kWarpsM * kChunkD / (8 * kNT) == kWarps, "layer 3's warps cover a pass");
static_assert(kTileP / (16 * kL2M) * kKSteps / 4 == kWarps, "layer 2's warps cover h2");
static_assert(kSliceThreads == 8 * kNT, "a slice's thread a column of its pass");
static_assert(kWarps / kWarpsM <= 15, "a named barrier a column slice");

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// Asynchronous copies, global -> shared, 16 bytes, through L2 only

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a barrier over column slice wn's kSliceThreads threads (named barrier
// 1 + wn; __syncthreads takes barrier 0)
__device__ __forceinline__ void slice_sync(int wn) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wn), "r"(kSliceThreads) : "memory");
}

// ---------------------------------------------------------------------------
// Split TF32 on the tensor cores (the helpers of csrc/info_nce.cu)

// cvt.rna: f32 to TF32, to nearest with ties away from zero (the low 13 bits 0)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, both TF32: small is the remainder, rounded
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// c += a . b over one m16n8k8 TF32 tile, f32 accumulators (PTX fragment
// layout: lane 4g + t holds a rows g, g + 8 x cols t, t + 4; b rows t, t + 4
// x col g; c rows g, g + 8 x cols 2t, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

// A from parts in fragment order: tile i's big parts, lane l's four at
// [256 i + 4 l], then its small parts 128 words on
__device__ __forceinline__ FragA load_a_split(const uint32_t* parts, int i) {
  const uint32_t* p = parts + 256 * i + 4 * (threadIdx.x % 32);
  const uint4 big = *reinterpret_cast<const uint4*>(p);
  const uint4 small = *reinterpret_cast<const uint4*>(p + 128);
  return {{big.x, big.y, big.z, big.w}, {small.x, small.y, small.z, small.w}};
}

// B from parts in fragment order: n-tile j's lane l holds big (k t, t + 4)
// then small (k t, t + 4) at [128 j + 4 l]
__device__ __forceinline__ FragB load_b_split(const uint32_t* parts, int j) {
  const uint4 v = *reinterpret_cast<const uint4*>(parts + 128 * j + 4 * (threadIdx.x % 32));
  return {{v.x, v.y}, {v.z, v.w}};
}

// acc += a . b over one k-step in split TF32: small.big, big.small, big.big
// into a fresh accumulator, then one FADD a value
__device__ __forceinline__ void add_step(float (&acc)[4], const FragA& a, const FragB& b) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(part, a.small, b.big[0], b.big[1]);
  mma_tf32(part, a.big, b.small[0], b.small[1]);
  mma_tf32(part, a.big, b.big[0], b.big[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += part[j];
}

// W2's column c in the permuted layout [k][quarter][t][8]: lane t's
// channels of k-steps 4 quarter .. 4 quarter + 3, 8 k' + t and 8 k' + t + 4,
// at positions 2 (k' % 4) and 2 (k' % 4) + 1 (a lane's 8 are 2 16-byte
// loads, the 4 t of a quarter-warp 4 bank groups apart)
__device__ __forceinline__ int w2_slot(int c) {
  return (c >> 5) * 32 + (c & 3) * 8 + 2 * ((c >> 3) & 3) + ((c >> 2) & 1);
}

// ---------------------------------------------------------------------------
// W3 (128, d) split into parts in b-fragment order, zero past column d:
// k-step ks, n-tile j (of ntiles), lane 4g + t: {big, small} of W3 rows
// 8 ks + t and 8 ks + t + 4 at column 8 j + g, as [big, big, small, small]
__global__ void __launch_bounds__(kThreads)
pne_split_w3_kernel(const float* __restrict__ w3, uint32_t* __restrict__ parts, int d, int ntiles) {
  const long long total = 64LL * kKSteps * ntiles;  // (k-step, n-tile, lane, row)
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int e = static_cast<int>(i & 1), lane = static_cast<int>((i >> 1) & 31);
    const long long tile = i >> 6;  // ks * ntiles + j
    const int j = static_cast<int>(tile % ntiles), ks = static_cast<int>(tile / ntiles);
    const int k = 8 * ks + (lane & 3) + 4 * e, col = 8 * j + (lane >> 2);
    uint32_t big, small;
    split_tf32(col < d ? w3[static_cast<long long>(k) * d + col] : 0.0f, big, small);
    uint32_t* out = parts + 128 * tile + 4 * lane;
    out[e] = big;
    out[2 + e] = small;
  }
}

// dst is the block's output rows: (n, segments, d) with dst's row
// n * segments + segment; with add_bias (one segment) b3 is added at the end
__global__ void __launch_bounds__(kThreads, 1)
pne_encoder_kernel(const float* __restrict__ points,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const uint32_t* __restrict__ w3parts, const float* __restrict__ b3,
                     float* __restrict__ dst, int p_total, int d_total, int ntiles,
                     int tiles_per_segment, int passes_per_group, int add_bias) {
  extern __shared__ float4 smem4[];
  uint32_t* h2s = reinterpret_cast<uint32_t*>(smem4);  // [8][kKSteps][256]: h2's a-fragments
  uint32_t* ring = h2s + kH2;                           // [kStages][kStage]: W3's b-fragments
  float* h1 = reinterpret_cast<float*>(ring);           // [kTileP][kLdH1], layers 1-2 only
  float* w2s = reinterpret_cast<float*>(ring + kRing);  // [kC1][4][4][8], w2_slot order
  float* w1s = w2s + kW2;                               // [3][kC1]
  float* b1s = w1s + kW1;
  float* b2s = b1s + kC1;                               // [4][4][8], w2_slot order
  float* xs = b2s + kC2;                                // [kTileP][3]
  float* red = xs + kX;                                 // [kWarpsM][kChunkD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long n = blockIdx.x;
  const int segment = blockIdx.y;
  const int pass_lo = blockIdx.z * passes_per_group;
  const int pass_hi = min(ntiles / (kChunkD / 8), pass_lo + passes_per_group);
  if (pass_lo >= pass_hi) return;  // a group with no columns
  float* row = dst + (n * gridDim.y + segment) * d_total;
  const int col_hi = min(d_total, pass_hi * kChunkD);

  const int tiles = (p_total + kTileP - 1) / kTileP;
  const int tile_lo = segment * tiles_per_segment;
  const int tile_hi = min(tiles, tile_lo + tiles_per_segment);
  if (tile_lo >= tile_hi) {  // a segment with no points: the max's identity
    for (int c = pass_lo * kChunkD + tid; c < col_hi; c += kThreads) row[c] = -CUDART_INF_F;
    return;
  }

  for (int i = tid; i < kW2; i += kThreads) w2s[(i / kC2) * kC2 + w2_slot(i % kC2)] = w2[i];
  if (tid < kW1) w1s[tid] = w1[tid];
  if (tid < kC1) b1s[tid] = b1[tid];
  if (tid < kC2) b2s[w2_slot(tid)] = b2[tid];

  const float* cloud = points + n * p_total * 3;
  // layer 3: warp (wm, wn) takes points 16 kMT wm.., columns 8 kNT wn.. of a pass
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int steps = (pass_hi - pass_lo) * kKSteps;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int p0 = tile * kTileP;
    const int valid = min(kTileP, p_total - p0);
    __syncthreads();  // the previous tile's ring and h2 are read; the weights stored
    for (int i = tid; i < kX; i += kThreads) xs[i] = i < 3 * valid ? cloud[3LL * p0 + i] : 0.0f;
    __syncthreads();

    {  // layer 1: h1[p][k] = relu(x_p W1[:, k] + b1[k]); channel tid % 64
      const int k = tid % kC1;
      const float wa = w1s[k], wb = w1s[kC1 + k], wc = w1s[2 * kC1 + k], bk = b1s[k];
      for (int p = tid / kC1; p < kTileP; p += kThreads / kC1) {
        const float* x = xs + 3 * p;
        h1[p * kLdH1 + k] = relu(fmaf(x[2], wc, fmaf(x[1], wb, x[0] * wa)) + bk);
      }
    }
    __syncthreads();

    {  // layer 2 for the lane's a-fragments of m-tiles kL2M mq .. kL2M mq +
       // kL2M - 1 at k-steps 4 kq .. 4 kq + 3: points 16 (kL2M mq + i) + g +
       // 8 r (acc[2 i + r]), channels 8 (4 kq + k') + t + 4 hi (acc[.][2 k' +
       // hi])
      const int mq = warp / 4, kq = warp % 4;
      float acc[2 * kL2M][8];
#pragma unroll
      for (int i = 0; i < 2 * kL2M; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      const float* hp = h1 + (16 * kL2M * mq + g) * kLdH1;  // + 8 (2 i + r) rows
      const float* wt = w2s + 32 * kq + 8 * t;
#pragma unroll 1
      for (int k = 0; k < kC1; k += 4) {
        float av[2 * kL2M][4];
#pragma unroll
        for (int i = 0; i < 2 * kL2M; ++i) {
          const float4 v = ld4(hp + 8 * i * kLdH1 + k);
          av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wl = ld4(wt + (k + kk) * kC2), wh = ld4(wt + (k + kk) * kC2 + 4);
          const float wv[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
          for (int i = 0; i < 2 * kL2M; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i][kk], wv[j], acc[i][j]);
        }
      }
      // h2 = relu(acc + b2), split: the a-fragment (g, t), (g + 8, t),
      // (g, t + 4), (g + 8, t + 4) of m-tile kL2M mq + i at k-step 4 kq + k'
      const float* bt = b2s + 32 * kq + 8 * t;
#pragma unroll
      for (int i = 0; i < kL2M; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float lo = bt[2 * kk], hi = bt[2 * kk + 1];
          const float v[4] = {relu(acc[2 * i][2 * kk] + lo), relu(acc[2 * i + 1][2 * kk] + lo),
                              relu(acc[2 * i][2 * kk + 1] + hi),
                              relu(acc[2 * i + 1][2 * kk + 1] + hi)};
          uint32_t big[4], small[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(v[q], big[q], small[q]);
          uint32_t* out = h2s + ((kL2M * mq + i) * kKSteps + 4 * kq + kk) * 256 + 4 * lane;
          *reinterpret_cast<uint4*>(out) = make_uint4(big[0], big[1], big[2], big[3]);
          *reinterpret_cast<uint4*>(out + 128) =
              make_uint4(small[0], small[1], small[2], small[3]);
        }
    }
    __syncthreads();  // h2 is stored; h1 (the ring) is free

    // layer 3: W3's k-steps through the ring, two ahead of the products;
    // each column slice copies and reads only its n-tiles of a stage, so
    // only its own warps wait for each other
    auto issue = [&](int s) {
      if (s < steps) {
        const int pass = pass_lo + s / kKSteps, ks = s % kKSteps;
        const uint32_t* src = w3parts + (static_cast<long long>(ks) * ntiles +
                                         pass * (kChunkD / 8) + kNT * wn) * 128;
        uint32_t* buf = ring + (s % kStages) * kStage + kNT * wn * 128;
        for (int i = tid % kSliceThreads; i < kNT * 32; i += kSliceThreads)
          cp_async16(buf + 4 * i, src + 4 * i);
      }
      cp_async_commit();  // an empty group past the end keeps the count
    };
    issue(0);
    issue(1);
    for (int pass = pass_lo, s = 0; pass < pass_hi; ++pass) {
      float acc[kMT][kNT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < kKSteps; ++ks, ++s) {
        cp_async_wait_one();  // this thread's copies of step s
        slice_sync(wn);       // the slice's; and the slice has read step s - 1's
        issue(s + 2);
        const uint32_t* buf = ring + (s % kStages) * kStage;
        FragA a[kMT];
#pragma unroll
        for (int i = 0; i < kMT; ++i) a[i] = load_a_split(h2s, (kMT * wm + i) * kKSteps + ks);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const FragB b = load_b_split(buf, kNT * wn + j);
#pragma unroll
          for (int i = 0; i < kMT; ++i) add_step(acc[i][j], a[i], b);
        }
      }
      // the pass's max over the tile's valid points: lane (g, t) holds rows
      // g, g + 8 of each m-tile at columns 2t, 2t + 1 of each n-tile
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int r = 16 * (kMT * wm + i) + g;
          if (r < valid) {
            m0 = fmaxf(m0, acc[i][j][0]);
            m1 = fmaxf(m1, acc[i][j][1]);
          }
          if (r + 8 < valid) {
            m0 = fmaxf(m0, acc[i][j][2]);
            m1 = fmaxf(m1, acc[i][j][3]);
          }
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
        }
        if (g == 0) {
          red[wm * kChunkD + 8 * (kNT * wn + j) + 2 * t] = m0;
          red[wm * kChunkD + 8 * (kNT * wn + j) + 2 * t + 1] = m1;
        }
      }
      slice_sync(wn);  // the slice's columns' maxima are in red
      const int c = pass * kChunkD + tid;  // a column of the slice's
      if (c < col_hi) {
        float m = red[tid];
#pragma unroll
        for (int r = 1; r < kWarpsM; ++r) m = fmaxf(m, red[r * kChunkD + tid]);
        row[c] = tile == tile_lo ? m : fmaxf(row[c], m);
      }
    }
  }
  if (add_bias && tid < kChunkD)  // by the thread that owns the column
    for (int c = pass_lo * kChunkD + tid; c < col_hi; c += kChunkD) row[c] += b3[c];
}

// out[n, d] = max_s partial[n, s, d] + b3[d]
__global__ void __launch_bounds__(kThreads)
pne_segment_max_kernel(const float* __restrict__ partial, const float* __restrict__ b3,
                   float* __restrict__ out, long long rows, int segments, int d_total) {
  const long long total = rows * d_total;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / d_total;
    const int d = static_cast<int>(i % d_total);
    const float* src = partial + row * segments * d_total + d;
    float m = src[0];
    for (int s = 1; s < segments; ++s) m = fmaxf(m, src[static_cast<long long>(s) * d_total]);
    out[i] = m + b3[d];
  }
}

long long padded_d(long long d) { return (d + kChunkD - 1) / kChunkD * kChunkD; }

}  // namespace

// The dynamic shared memory a block of the main kernel takes, in bytes.
extern "C" int pointnet_eval_smem_bytes() { return static_cast<int>(kSmemBytes); }

// The scratch a call takes, in floats: W3's parts (128 rows x d padded to a
// multiple of 256, big and small) and, with segments > 1, the partial
// maxima (n, segments, d).
extern "C" long long pointnet_eval_scratch_floats(long long n, long long d, int segments) {
  return 2 * kC2 * padded_d(d) + (segments > 1 ? n * segments * d : 0);
}

// points: (n, p, 3) float32; w1 (3, 64), b1 (64), w2 (64, 128), b2 (128),
// w3 (128, d), b3 (d): the folded parameters, float32; all contiguous on
// the current device. out: (n, d) float32. scratch: float32, 16-byte
// aligned, of pointnet_eval_scratch_floats(n, d, segments). segments:
// blocks a cloud along the points, each a run of whole 128-point tiles;
// groups: blocks a cloud along the columns, each a run of whole 256-column
// passes (1 and 1: one block a cloud). Launches on `stream` and returns the
// first cudaError_t (0 on success); it neither synchronises nor allocates.
// The caller keeps n < 2^31, 3p < 2^31, segments and groups <= 65535.
extern "C" int pointnet_eval(const float* points, const float* w1, const float* b1,
                             const float* w2, const float* b2, const float* w3,
                             const float* b3, float* out, float* scratch, long long n,
                             long long p, long long d, int segments, int groups, void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || segments <= 0 || groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pne_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dpad = padded_d(d), ntiles = dpad / 8, passes = dpad / kChunkD;
  uint32_t* parts = reinterpret_cast<uint32_t*>(scratch);
  long long blocks = (64LL * kKSteps * ntiles + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  pne_split_w3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      w3, parts, static_cast<int>(d), static_cast<int>(ntiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (p + kTileP - 1) / kTileP;
  const int tiles_per_segment = static_cast<int>((tiles + segments - 1) / segments);
  const int passes_per_group = static_cast<int>((passes + groups - 1) / groups);
  float* partial = scratch + 2 * kC2 * dpad;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(segments),
                  static_cast<unsigned>(groups));
  pne_encoder_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      points, w1, b1, w2, b2, parts, b3, segments == 1 ? out : partial, static_cast<int>(p),
      static_cast<int>(d), static_cast<int>(ntiles), tiles_per_segment, passes_per_group,
      segments == 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return static_cast<int>(err);
  blocks = (n * d + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  pne_segment_max_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, b3, out, n, segments, static_cast<int>(d));
  return static_cast<int>(cudaGetLastError());
}
