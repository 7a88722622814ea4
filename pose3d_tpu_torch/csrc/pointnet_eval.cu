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
//
// The bf16 instance (--bf16: flax's ShapeEncoderPC with dtype=bfloat16 in
// eval mode, pose3d_tpu/models/pointnet.py dense_bn_forward). Folding BN
// into W cannot reproduce flax's rounding points, so the layers come
// unfolded: W (in, out) and b in bf16, and the eval BN as f32 (mean,
// rsqrt(var + eps) * scale, shift). Each layer is
//   h = bf16(x W)   (f32 accumulation; bf16 products are exact in f32)
//   h = bf16(h + b)
//   y = bf16((h - mean) * mul + shift)   (f32), ReLU on layers 1 and 2
// and the output the max over the points of layer 3's y, in bf16.
//   * Layer 1 (K 3) on the CUDA cores: each warp computes the a-fragments
//     of layer 2 for its own 16 points in registers.
//   * Layer 2 (K 64) and layer 3 (K 128) on the bf16 tensor cores,
//     mma.m16n8k16 with f32 accumulators, one product each (no split). The
//     C fragments of two adjacent n-tiles of layer 2 are, rounded and packed,
//     the A fragment of one k-step of layer 3: each warp stores h2's
//     fragments for its 16 points in shared memory (32 KB for the tile).
//   * Layer 3 walks 256-column passes as the f32 kernel does: W3 packed once
//     a call into scratch in b-fragment order, streamed one k-step (8 KB) at a
//     time through the 3-stage cp.async ring of each column slice, warp (wm,
//     wn) taking 4 x 8 m16n8 tiles.
//   * The max. y is a monotone function of the accumulator (each step
//     rounds monotonically; it rises with it where mul >= 0 and falls where
//     mul < 0), so the max over the points of y is y at the accumulators'
//     max, or at their min where mul < 0. The pack kernel negates W3's
//     columns where mul < 0 (exact in bf16), the encoder keeps the f32 max of
//     the accumulators as the f32 kernel keeps its max, and the epilogue is
//     applied once a column at the end, to the max negated back.
// At (64, 2500, 1024) the products are 44.6 GFLOP: 0.045 ms at 989 TFLOP/s
// dense bf16; the bytes (under 1 MB) take well under that.

#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// The bf16 instance: unfolded layers, flax's rounding points, bf16 tensor cores

constexpr int kKB2 = kC1 / 16;                       // layer 2's k-steps of 16
constexpr int kKB3 = kC2 / 16;                       // layer 3's k-steps of 16
constexpr int kNT2 = kC2 / 8;                        // layer 2's n-tiles
// shared memory, in 32-bit words, in this order
constexpr int kBH2 = (kTileP / 16) * kKB3 * 128;     // h2's a-fragments: [m-tile][k-step][32][4]
constexpr int kBStage = (kChunkD / 8) * 64;          // one k-step of W3 packed: [n-tile][32][2]
constexpr int kBRing = kStages * kBStage;
constexpr int kBW2 = kNT2 * kKB2 * 64;               // W2's b-fragments: [n-tile][k-step][32][2]
constexpr int kBBn1 = 3 * kC1, kBBn2 = 3 * kC2;      // (mean, mul, shift) a channel
constexpr int kBSmemWords = kBH2 + kBRing + kBW2 + 3 * kC1 + kC1 + kBBn1 + kC2 + kBBn2 + kX + kRed;
constexpr size_t kBSmemBytes = sizeof(float) * kBSmemWords;
static_assert(kBSmemBytes <= 232448, "over Hopper's 227 KB a block");
static_assert(kTileP / 16 == kWarps, "layers 1-2: a warp an m-tile of the tile");

__device__ __forceinline__ float bf_val(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two values already in bf16's range, packed as a b32 operand (lo first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// flax's rounding points after a dense layer's f32 sum: bf16(acc), + b in
// bf16, then the eval BN in f32 (no contraction into an FMA), rounded
__device__ __forceinline__ float dense_bn_bf16(float acc, float b, float mean, float mul,
                                               float shift) {
  const float h = round_bf16(__fadd_rn(round_bf16(acc), b));
  return round_bf16(__fadd_rn(__fmul_rn(__fsub_rn(h, mean), mul), shift));
}

// c += a . b over one m16n8k16 bf16 tile, f32 accumulators (PTX fragment
// layout: lane 4g + t holds a rows g (a0, a2) and g + 8 (a1, a3) x cols 2t,
// 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3), the lower column in the low
// half; b rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) x col g; c rows g,
// g + 8 x cols 2t, 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// layer 3's output at column c from the accumulators' max m over the
// points, which is the max of the negated accumulators where mul < 0 (the
// pack kernel negated those columns of W3)
__device__ __forceinline__ float layer3_out(float m, int c, const uint16_t* __restrict__ b3,
                                            const float* __restrict__ bn3, int d) {
  const float mul = bn3[d + c];
  return dense_bn_bf16(mul < 0.0f ? -m : m, bf_val(b3[c]), bn3[c], mul, bn3[2 * d + c]);
}

// W3 (128, d) bf16 packed in b-fragment order, zero past column d, each
// column negated where its BN multiplier is negative: k-step ks, n-tile j
// (of ntiles), lane 4g + t: words (rows 16 ks + 2t, + 1) and (16 ks + 2t + 8,
// + 9) at column 8 j + g
__global__ void __launch_bounds__(kThreads)
pne_pack_w3_bf16_kernel(const uint16_t* __restrict__ w3, const float* __restrict__ bn3,
                        uint32_t* __restrict__ parts, int d, int ntiles) {
  const long long total = 64LL * kKB3 * ntiles;  // (k-step, n-tile, lane, word)
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int e = static_cast<int>(i & 1), lane = static_cast<int>((i >> 1) & 31);
    const long long tile = i >> 6;  // ks * ntiles + j
    const int j = static_cast<int>(tile % ntiles), ks = static_cast<int>(tile / ntiles);
    const int k = 16 * ks + 2 * (lane & 3) + 8 * e, col = 8 * j + (lane >> 2);
    uint32_t word = 0;
    if (col < d) {
      word = static_cast<uint32_t>(w3[static_cast<long long>(k) * d + col]) |
             (static_cast<uint32_t>(w3[static_cast<long long>(k + 1) * d + col]) << 16);
      if (bn3[d + col] < 0.0f) word ^= 0x80008000u;  // both halves negated, exactly
    }
    parts[i] = word;
  }
}

// dst: the block's rows of the accumulators' running max, (n, segments, d)
// f32; with finish (one segment) the block writes its columns of out (n,
// d) bf16 at the end
__global__ void __launch_bounds__(kThreads, 1)
pne_encoder_bf16_kernel(const uint16_t* __restrict__ points,
                        const uint16_t* __restrict__ w1, const uint16_t* __restrict__ b1,
                        const float* __restrict__ bn1,
                        const uint16_t* __restrict__ w2, const uint16_t* __restrict__ b2,
                        const float* __restrict__ bn2,
                        const uint32_t* __restrict__ w3parts, const uint16_t* __restrict__ b3,
                        const float* __restrict__ bn3, float* __restrict__ dst,
                        __nv_bfloat16* __restrict__ out, int p_total, int d_total, int ntiles,
                        int tiles_per_segment, int passes_per_group, int finish) {
  extern __shared__ float4 smem4[];
  uint32_t* h2s = reinterpret_cast<uint32_t*>(smem4);   // [8][kKB3][32][4]: h2's a-fragments
  uint32_t* ring = h2s + kBH2;                           // [kStages][kBStage]: W3's b-fragments
  uint32_t* w2f = ring + kBRing;                         // [kNT2][kKB2][32][2]
  float* w1s = reinterpret_cast<float*>(w2f + kBW2);     // [3][kC1]
  float* b1s = w1s + 3 * kC1;                            // [kC1]
  float* bn1s = b1s + kC1;                               // [3][kC1]: mean, mul, shift
  float* b2s = bn1s + kBBn1;                             // [kC2]
  float* bn2s = b2s + kC2;                               // [3][kC2]
  float* xs = bn2s + kBBn2;                              // [kTileP][3]
  float* red = xs + kX;                                  // [kWarpsM][kChunkD]

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

  // W2 in b-fragment order: element (k, c) sits in n-tile c / 8, k-step
  // k / 16, lane 4 (c % 8) + (k % 8) / 2, word (k % 16) / 8, half k % 2
  for (int i = tid; i < kBW2; i += kThreads) {
    const int e = i & 1, ln = (i >> 1) & 31, j = (i >> 6) % kKB2, nt = (i >> 6) / kKB2;
    const int k = 16 * j + 2 * (ln & 3) + 8 * e, c = 8 * nt + (ln >> 2);
    w2f[i] = static_cast<uint32_t>(w2[k * kC2 + c]) |
             (static_cast<uint32_t>(w2[(k + 1) * kC2 + c]) << 16);
  }
  for (int i = tid; i < 3 * kC1; i += kThreads) {
    w1s[i] = bf_val(w1[i]);
    bn1s[i] = bn1[i];
  }
  if (tid < kC1) b1s[tid] = bf_val(b1[tid]);
  for (int i = tid; i < kBBn2; i += kThreads) bn2s[i] = bn2[i];
  if (tid < kC2) b2s[tid] = bf_val(b2[tid]);

  const uint16_t* cloud = points + n * p_total * 3;
  // layer 3: warp (wm, wn) takes points 16 kMT wm.., columns 8 kNT wn.. of a pass
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int steps = (pass_hi - pass_lo) * kKB3;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int p0 = tile * kTileP;
    const int valid = min(kTileP, p_total - p0);
    __syncthreads();  // the previous tile's ring and h2 are read; the weights stored
    for (int i = tid; i < kX; i += kThreads)
      xs[i] = i < 3 * valid ? bf_val(cloud[3LL * p0 + i]) : 0.0f;
    __syncthreads();

    {  // layers 1 and 2 for the warp's m-tile (points 16 warp + g, + 8)
      // layer 1 into layer 2's a-fragments: k-step j, register r holds
      // point g + 8 (r % 2), channels 16 j + 2 t + 8 (r / 2) and the next
      uint32_t a1[kKB2][4];
#pragma unroll
      for (int j = 0; j < kKB2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = xs + 3 * (16 * warp + g + 8 * (r & 1));
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 16 * j + 2 * t + 8 * (r >> 1) + h;
            const float acc = fmaf(x[2], w1s[2 * kC1 + c], fmaf(x[1], w1s[kC1 + c], x[0] * w1s[c]));
            v[h] = relu(dense_bn_bf16(acc, b1s[c], bn1s[c], bn1s[kC1 + c], bn1s[2 * kC1 + c]));
          }
          a1[j][r] = pack_bf16(v[0], v[1]);
        }
      // layer 2: n-tiles 2 kk and 2 kk + 1 give layer 3's k-step kk
#pragma unroll 1
      for (int kk = 0; kk < kKB3; ++kk) {
        float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < kKB2; ++j) {
          const uint2 bl =
              *reinterpret_cast<const uint2*>(w2f + ((2 * kk * kKB2 + j) * 32 + lane) * 2);
          const uint2 bh =
              *reinterpret_cast<const uint2*>(w2f + (((2 * kk + 1) * kKB2 + j) * 32 + lane) * 2);
          mma_bf16(c0, a1[j], bl.x, bl.y);
          mma_bf16(c1, a1[j], bh.x, bh.y);
        }
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // c0 then c1: rows g, g, g + 8, g + 8
          const int c = 16 * kk + 2 * t + 8 * (q >> 2) + (q & 1);
          v[q] = relu(dense_bn_bf16(q < 4 ? c0[q] : c1[q - 4], b2s[c], bn2s[c], bn2s[kC2 + c],
                                    bn2s[2 * kC2 + c]));
        }
        *reinterpret_cast<uint4*>(h2s + ((warp * kKB3 + kk) * 32 + lane) * 4) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      }
    }
    __syncthreads();  // h2 is stored

    // layer 3: W3's k-steps through the ring, two ahead of the products;
    // each column slice copies and reads only its n-tiles of a stage
    auto issue = [&](int s) {
      if (s < steps) {
        const int pass = pass_lo + s / kKB3, ks = s % kKB3;
        const uint32_t* src = w3parts + (static_cast<long long>(ks) * ntiles +
                                         pass * (kChunkD / 8) + kNT * wn) * 64;
        uint32_t* buf = ring + (s % kStages) * kBStage + kNT * wn * 64;
        for (int i = tid % kSliceThreads; i < kNT * 16; i += kSliceThreads)
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
      for (int ks = 0; ks < kKB3; ++ks, ++s) {
        cp_async_wait_one();  // this thread's copies of step s
        slice_sync(wn);       // the slice's; and the slice has read step s - 1's
        issue(s + 2);
        const uint32_t* buf = ring + (s % kStages) * kBStage;
        uint32_t a[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(h2s + (((kMT * wm + i) * kKB3 + ks) * 32 + lane) * 4);
          a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint2 b = *reinterpret_cast<const uint2*>(buf + (kNT * wn + j) * 64 + lane * 2);
#pragma unroll
          for (int i = 0; i < kMT; ++i) mma_bf16(acc[i][j], a[i], b.x, b.y);
        }
      }
      // the pass's max over the tile's valid points, as the f32 kernel's
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
  if (finish && tid < kChunkD)  // by the thread that owns the column
    for (int c = pass_lo * kChunkD + tid; c < col_hi; c += kChunkD)
      out[n * d_total + c] = __float2bfloat16_rn(layer3_out(row[c], c, b3, bn3, d_total));
}

// out[n, d] = layer 3's output at max_s partial[n, s, d], in bf16
__global__ void __launch_bounds__(kThreads)
pne_segment_max_bf16_kernel(const float* __restrict__ partial, const uint16_t* __restrict__ b3,
                            const float* __restrict__ bn3, __nv_bfloat16* __restrict__ out,
                            long long rows, int segments, int d_total) {
  const long long total = rows * d_total;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / d_total;
    const int d = static_cast<int>(i % d_total);
    const float* src = partial + row * segments * d_total + d;
    float m = src[0];
    for (int s = 1; s < segments; ++s) m = fmaxf(m, src[static_cast<long long>(s) * d_total]);
    out[i] = __float2bfloat16_rn(layer3_out(m, d, b3, bn3, d_total));
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

// The bf16 instance's dynamic shared memory a block, in bytes.
extern "C" int pointnet_eval_bf16_smem_bytes() { return static_cast<int>(kBSmemBytes); }

// The bf16 instance's scratch, in 32-bit words: W3 packed (64 words a
// column of d padded to a multiple of 256) and the accumulators' running max
// (n, segments, d) f32.
extern "C" long long pointnet_eval_bf16_scratch_words(long long n, long long d, int segments) {
  return 64 * padded_d(d) + n * segments * d;
}

// The bf16 instance. points (n, p, 3) bf16; per layer W (in, out) and b
// (out) bf16 and bn (3, out) f32: the running mean, rsqrt(var + eps) *
// scale, and the shift; widths 3 -> 64 -> 128 -> d. out (n, d) bf16;
// scratch: 16-byte aligned, pointnet_eval_bf16_scratch_words(n, d,
// segments) words. segments and groups as pointnet_eval's. The same
// launch contract: 2 CUDA launches (the W3 pack, the encoder), 3 with
// segments.
extern "C" int pointnet_eval_bf16(const void* points, const void* w1, const void* b1,
                                  const float* bn1, const void* w2, const void* b2,
                                  const float* bn2, const void* w3, const void* b3,
                                  const float* bn3, void* out, void* scratch, long long n,
                                  long long p, long long d, int segments, int groups,
                                  void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || segments <= 0 || groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pne_encoder_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dpad = padded_d(d), ntiles = dpad / 8, passes = dpad / kChunkD;
  uint32_t* parts = static_cast<uint32_t*>(scratch);
  long long blocks = (64LL * kKB3 * ntiles + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  pne_pack_w3_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint16_t*>(w3), bn3, parts, static_cast<int>(d),
      static_cast<int>(ntiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (p + kTileP - 1) / kTileP;
  const int tiles_per_segment = static_cast<int>((tiles + segments - 1) / segments);
  const int passes_per_group = static_cast<int>((passes + groups - 1) / groups);
  float* rows = reinterpret_cast<float*>(parts + 64 * dpad);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(segments),
                  static_cast<unsigned>(groups));
  pne_encoder_bf16_kernel<<<grid, kThreads, kBSmemBytes, s>>>(
      static_cast<const uint16_t*>(points), static_cast<const uint16_t*>(w1),
      static_cast<const uint16_t*>(b1), bn1, static_cast<const uint16_t*>(w2),
      static_cast<const uint16_t*>(b2), bn2, parts, static_cast<const uint16_t*>(b3), bn3, rows,
      static_cast<__nv_bfloat16*>(out), static_cast<int>(p), static_cast<int>(d),
      static_cast<int>(ntiles), tiles_per_segment, passes_per_group, segments == 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return static_cast<int>(err);
  blocks = (n * d + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  pne_segment_max_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      rows, static_cast<const uint16_t*>(b3), bn3, static_cast<__nv_bfloat16*>(out), n, segments,
      static_cast<int>(d));
  return static_cast<int>(cudaGetLastError());
}
