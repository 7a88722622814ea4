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
// What bounds it. At (64, 2500, 1024) the products are 44.6 GFLOP: 0.045 ms
// at 989 TFLOP/s dense bf16; W3, the points and the output are under 1 MB.
// So the kernel is bound by operations, and only wgmma reaches the card's
// bf16 rate. What stands between the products and that rate is everything
// else a point costs: layers 1-2 (about 700 roundings to bf16 a point) and
// the max over the points (a max a point and column), all on the CUDA
// cores, and W3's 256 KB, which no block can hold.
// The design (PERF.md has the measured split):
//   * Persistent blocks (one an SM, 217 KB of shared memory) walk a
//     contiguous run of the (column group, cloud, 256-point tile) units, so
//     that W2 (staged swizzled for wgmma) and the BN tables are set up once
//     a block. A group is whole 128-column chunks of W3, at most 1024
//     columns: at D 1024 one group, so layers 1-2 run once a tile.
//   * Warpgroup 2 feeds W3's chunks in the units' order: one thread by TMA
//     (a 2-D tensor map of W3 (128, D) as it lies, two 64-column boxes a
//     chunk in the 128-byte swizzle, zero past D) into a ring of 4 stages
//     on mbarriers, streamed once a tile, or loaded once a run where a
//     group fits the ring (D <= 512); its 128 threads then negate the
//     columns whose BN multiplier is negative in shared memory (both bf16
//     halves of a word by their sign bits, from a mask table built once a
//     group). A D that 8 does not divide is first copied into rows of a
//     multiple of 8 columns (TMA reads rows of a multiple of 16 bytes). The
//     producer gives back its registers (setmaxnreg) to the consumers.
//   * Warpgroups 0 and 1 each take 128 points of a tile, as two 64-point
//     halves. Layer 1 runs on the CUDA cores straight into layer 2's A
//     fragments; layer 2 is wgmma m64n128k16 with A from registers and W2
//     MN-major (the transpose bit); its accumulators, rounded two values an
//     instruction (cvt.rn.bf16x2.f32, flax's order of rounding points), are
//     layer 3's A fragments, so h2 never leaves registers. Layer 3 is
//     wgmma m64n128k16 a half and chunk, B the ring's stage. Rows past a
//     cloud's end repeat the tile's first point, which leaves the max as it
//     is. The next tile's layer 1 runs under a tile's last products.
//   * The max. y is a monotone function of the accumulator (each step
//     rounds monotonically; it rises with it where mul >= 0 and falls where
//     mul < 0), so the max over the points of y is y at the accumulators'
//     max, or at their min where mul < 0: the columns negated in shared
//     memory make it a max everywhere. A thread's row pairs of both halves,
//     then the warp's 32 rows through its 8 rows of shared memory, then the
//     warp's running max of each column over the run's tiles in shared
//     memory; at a piece's end (its cloud or group changes) the 8 warps'
//     maxima merge in order and layer 3's epilogue is applied once a
//     column, negated back. A cloud that several blocks share merges their
//     pieces in block order in a last small kernel. No atomics: the same
//     bits on every call.
// So a call is 1 to 3 CUDA launches (the W3 copy where D % 8 != 0, the
// encoder, the merge where a block's run starts inside a cloud).

#include <cuda.h>
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
// The bf16 instance: unfolded layers, flax's rounding points, Hopper's wgmma

constexpr int kKB2 = kC1 / 16;              // layer 2's k-steps of 16
constexpr int kKB3 = kC2 / 16;              // layer 3's k-steps of 16
constexpr int kBTile = 256;                 // points a block step: two warpgroups x 128
constexpr int kBChunk = 128;                // W3's columns a product: wgmma's n
constexpr int kBStages = 4;                 // W3's ring, one 128-column chunk a stage
constexpr int kBGroupMax = 1024;            // a column group's columns, at most
constexpr int kBChunksMax = kBGroupMax / kBChunk;
constexpr int kBConsumers = 256;            // the two consumer warpgroups
constexpr int kBThreads = kBConsumers + 128;  // and a producer warpgroup
// registers a thread: 168 at launch (three warps a scheduler share its
// 16,384); the producer gives back all but 40, the consumers take 232
constexpr int kBProducerRegs = 40, kBConsumerRegs = 232;
static_assert(4 * kBProducerRegs + 8 * kBConsumerRegs <= 65536 / 32, "the register file");
constexpr int kBChunkBytes = kBChunk * kC2 * 2;     // 32 KB: two TMA boxes of 64 columns
constexpr int kBW2Bytes = kC1 * kC2 * 2;            // 16 KB
constexpr int kBRunBytes = 8 * kBGroupMax * 4;      // a warp's running max a column
constexpr int kBL1Bytes = (kC1 / 2) * 16 * 4;       // a channel pair: 16 floats
constexpr int kBL2Bytes = (kC2 / 2) * 8 * 4;        // a channel pair: 8 floats
constexpr int kBMaskBytes = kBChunksMax * 2 * 8 * 16;  // [chunk][box][column block] sign masks
constexpr int kBFoldStride = kBChunk + 8;  // floats a fold row: 8 mod 32, no bank conflicts
constexpr int kBFoldBytes = 8 * 8 * kBFoldStride * 4;  // [warp][g][column]
constexpr int kBSmemBytes = 1024 + kBStages * kBChunkBytes + kBW2Bytes + kBRunBytes +
                            kBL1Bytes + kBL2Bytes + kBMaskBytes + kBFoldBytes + 3 * kBStages * 8;
static_assert(kBSmemBytes <= 232448, "over Hopper's 227 KB a block");

__device__ __forceinline__ float bf_val(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// flax's rounding points after a dense layer's f32 sum: bf16(acc), + b in
// bf16, then the eval BN in f32 (no contraction into an FMA), rounded
__device__ __forceinline__ float dense_bn_bf16(float acc, float b, float mean, float mul,
                                               float shift) {
  const float h = round_bf16(__fadd_rn(round_bf16(acc), b));
  return round_bf16(__fadd_rn(__fmul_rn(__fsub_rn(h, mean), mul), shift));
}

// Rounding to bf16 is a conversion, whose unit's rate bounds the epilogues:
// two values an instruction (cvt.rn.bf16x2.f32, round to nearest even as
// __float2bfloat16_rn), bf16(lo) in the low half, bf16(hi) in the high half
__device__ __forceinline__ uint32_t bf2_bits(float lo, float hi) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(hi), "f"(lo));
  return w;
}
__device__ __forceinline__ float lo_val(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_val(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// dense_bn_bf16 of a channel pair (lo, hi) at one point, ReLU'd, packed as
// layer 2's or layer 3's A operand: bf16's sign is its 16-bit integer's
__device__ __forceinline__ uint32_t dense_bn_relu2(float a0, float a1, float2 b, float2 mean,
                                                   float2 mul, float2 shift) {
  uint32_t w = bf2_bits(a0, a1);
  w = bf2_bits(__fadd_rn(lo_val(w), b.x), __fadd_rn(hi_val(w), b.y));
  w = bf2_bits(__fadd_rn(__fmul_rn(__fsub_rn(lo_val(w), mean.x), mul.x), shift.x),
               __fadd_rn(__fmul_rn(__fsub_rn(hi_val(w), mean.y), mul.y), shift.y));
  return __vmaxs2(w, 0u);
}

// layer 3's output at column c from the accumulators' max m over the
// points, which is the max of the negated accumulators where mul < 0 (the
// encoder flips those columns' signs before it takes the max)
__device__ __forceinline__ float layer3_out(float m, long long c, const uint16_t* __restrict__ b3,
                                            const float* __restrict__ bn3, long long d) {
  const float mul = bn3[d + c];
  return dense_bn_bf16(mul < 0.0f ? -m : m, bf_val(b3[c]), bn3[c], mul, bn3[2 * d + c]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Operands in shared memory sit in the 128-byte swizzle that wgmma's
// descriptors and TMA name: a K x N block of bf16, N contiguous (MN-major,
// read through wgmma's transpose bit), stored as column blocks of 64 N
// (128 bytes a row), R rows each, the 16-byte chunk q of row r at q ^ (r %
// 8). The descriptor of k-step s (16 rows): start + 2048 s, the column
// blocks R * 128 bytes apart (leading byte offset), 8-row groups 1024 bytes
// apart (stride byte offset).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving the accumulators' reads and writes across
// the asynchronous products' issue and wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128): A bf16 from registers (a
// warp's 16 rows as mma.m16n8k16's A fragment: lane 4g + t holds rows g
// (a0, a2) and g + 8 (a1, a3) x k 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9
// (a2, a3)), B bf16 MN-major from shared memory; scale_d 0 starts the sum.
// The accumulators: warp w % 4 of the warpgroup holds rows 16 (w % 4) + g
// (+ 8: h = 1), d[4 j + 2 h + e] column 8 j + 2 t + e.
__device__ __forceinline__ void wgmma_ra(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(db));
}

// a product over K = 16 kSteps of A: kSteps k-steps from A's fragments
// a[], B's k-step s at b + 2048 s (column blocks lbo bytes apart), issued as
// one group; product_wait waits for it
template <int kSteps>
__device__ __forceinline__ void product_issue(float (&acc)[64], const uint32_t (&a)[kSteps][4],
                                              uint32_t b, uint32_t lbo) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) wgmma_ra(acc, a[s], mn_desc(b + 2048 * s, lbo), s);
  wgmma_commit();
}
__device__ __forceinline__ void product_wait(float (&acc)[64]) {
  wgmma_wait_all();
  fence_acc(acc);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of the given parity to complete. A wait that never
// ends (a lost copy) traps after ~2^26 polls: a launch failure the wrapper
// reports, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 26)) __trap();
  }
}
// one box {64 columns, 128 rows} of W3 at column c0, swizzled, into dst
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(0), "r"(bar)
      : "memory");
}
// a 128-column chunk of W3 (two boxes) into its stage, completing on bar
__device__ __forceinline__ void tma_chunk(uint32_t stage, const CUtensorMap* map, uint32_t bar,
                                          long long c0) {
  mbar_expect_tx(bar, kBChunkBytes);
  tma_box(stage, map, bar, static_cast<int>(c0));
  tma_box(stage + kBChunkBytes / 2, map, bar, static_cast<int>(c0 + 64));
}

// consumers-only barrier (named barrier 1; the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBConsumers) : "memory");
}

// The max of a warp's rows (lane (g, t) holds rows g, g + 8 of both
// halves: m[2 j + e] column 8 j + 2 t + e of the chunk) by column, through
// the warp's 8 rows of shared memory: row g takes lane (g, t)'s values, then
// lane l reads columns 4 l.. 4 l + 3 of all 8 rows (two 8-byte stores, one
// 16-byte load a step, no bank conflicts at a row stride of 8 mod 32)
__device__ __forceinline__ float4 fold_columns(const float (&m)[32], float* rows, int g, int t,
                                               int lane) {
  __syncwarp();  // the previous chunk's reads are done
#pragma unroll
  for (int j = 0; j < kBChunk / 8; ++j)
    *reinterpret_cast<float2*>(rows + g * kBFoldStride + 8 * j + 2 * t) =
        make_float2(m[2 * j], m[2 * j + 1]);
  __syncwarp();
  float4 v = *reinterpret_cast<const float4*>(rows + 4 * lane);
#pragma unroll
  for (int r = 1; r < 8; ++r) {
    const float4 o = *reinterpret_cast<const float4*>(rows + r * kBFoldStride + 4 * lane);
    v = make_float4(fmaxf(v.x, o.x), fmaxf(v.y, o.y), fmaxf(v.z, o.z), fmaxf(v.w, o.w));
  }
  return v;
}

struct BParams {
  const uint16_t* points;          // (n, p, 3)
  const uint16_t* w1;              // (3, 64)
  const uint16_t* b1;
  const float* bn1;                // (3, 64): mean, mul, shift
  const uint16_t* w2;              // (64, 128), 16-byte aligned
  const uint16_t* b2;
  const float* bn2;
  const uint16_t* b3;
  const float* bn3;                // (3, d)
  float* partial;                  // (blocks, 2, d): the shared clouds' pieces
  __nv_bfloat16* out;              // (n, d)
  long long n, p, d;
  long long tiles;                 // kBTile-point tiles a cloud
  long long units;                 // groups x n x tiles
  int group_w;                     // columns a group, a multiple of kBChunk
  int resident;                    // every group's chunks fit the ring
};

// The block's run of units: [lo, hi) of the (group, cloud, tile) list
__device__ __forceinline__ long long unit_lo(long long b, long long units, long long blocks) {
  return b * units / blocks;
}

// Layer 1 on the CUDA cores, straight into layer 2's A fragments: register
// r of k-step j holds point row h = r % 2 and channels 16 j + 8 (r / 2) +
// 2 t and the next. x[h]: the row's three coordinates. l1s: a channel pair
// (16 floats: W1's three rows, b, mean, mul, shift, each lo then hi) at
// 16 (pair).
__device__ __forceinline__ void layer1(uint32_t (&a)[kKB2][4], const float (&x)[2][3],
                                       const float* l1s, int t) {
#pragma unroll
  for (int j = 0; j < kKB2; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* e = l1s + 16 * (8 * j + 4 * q + t);
      const float4 w01 = *reinterpret_cast<const float4*>(e);      // w0 lo, hi; w1 lo, hi
      const float4 w2b = *reinterpret_cast<const float4*>(e + 4);  // w2 lo, hi; b lo, hi
      const float4 mm = *reinterpret_cast<const float4*>(e + 8);   // mean lo, hi; mul lo, hi
      const float2 sh = *reinterpret_cast<const float2*>(e + 12);  // shift lo, hi
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = fmaf(x[h][2], w2b.x, fmaf(x[h][1], w01.z, x[h][0] * w01.x));
        const float a1 = fmaf(x[h][2], w2b.y, fmaf(x[h][1], w01.w, x[h][0] * w01.y));
        a[j][h + 2 * q] = dense_bn_relu2(a0, a1, make_float2(w2b.z, w2b.w),
                                         make_float2(mm.x, mm.y), make_float2(mm.z, mm.w), sh);
      }
    }
}

// Layer 2's epilogue into layer 3's A fragments: n-tiles 2 kk and 2 kk + 1
// of layer 2's accumulators, rounded and packed, are layer 3's k-step kk.
// l2s: a channel pair (b, mean, mul, shift, each lo then hi) at 8 (pair).
__device__ __forceinline__ void layer2_out(uint32_t (&a)[kKB3][4], const float (&acc)[64],
                                           const float* l2s, int t) {
#pragma unroll
  for (int j = 0; j < kC2 / 8; ++j) {
    const float4 bm = *reinterpret_cast<const float4*>(l2s + 8 * (4 * j + t));
    const float4 ms = *reinterpret_cast<const float4*>(l2s + 8 * (4 * j + t) + 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a[j >> 1][2 * (j & 1) + h] =
          dense_bn_relu2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], make_float2(bm.x, bm.y),
                         make_float2(bm.z, bm.w), make_float2(ms.x, ms.y),
                         make_float2(ms.z, ms.w));
  }
}

// The row pairs' max of a chunk's accumulators (the columns whose BN
// multiplier is negative were negated in shared memory): m[2 j + e] holds
// column 8 j + 2 t + e; into m, or max'd with it
__device__ __forceinline__ void rows_max(float (&m)[32], const float (&acc)[64], bool first) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = i >> 1, e = i & 1;
    const float v = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
    m[i] = first ? v : fmaxf(m[i], v);
  }
}

// Persistent blocks over the (column group, cloud, tile) units, dealt out
// in contiguous runs. Warpgroup 2 feeds W3's chunks in the units' order: its
// first thread by TMA into a ring of kBStages stages (mbarriers full, when a
// chunk has landed, and empty, when both consumers are done with it), then
// all its threads negate the columns whose BN multiplier is negative in
// shared memory (mbarrier ready). Warpgroups 0 and 1 each take 128 points
// of a 256-point tile: layer 1 (the next tile's under this tile's last
// products), layer 2 and each chunk of the group's columns as products of
// 64-point halves on wgmma; the max over the rows folded into the warp's
// running max in shared memory. At a
// piece's end (its cloud or group changes) the 8 warps' maxima are merged
// in order: into out where the block covered the whole cloud, else into
// partial (slot 0 for the block's first piece, 1 for its last).
__global__ void __launch_bounds__(kBThreads, 1)
pne_encoder_bf16_kernel(const BParams prm, const __grid_constant__ CUtensorMap w3map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* w2s = ring + kBStages * kBChunkBytes;
  float* run = reinterpret_cast<float*>(w2s + kBW2Bytes);     // [8 warps][kBGroupMax]
  float* l1s = run + 8 * kBGroupMax;                          // [32 pairs][16]
  float* l2s = l1s + kBL1Bytes / 4;                           // [64 pairs][8]
  uint4* masks = reinterpret_cast<uint4*>(l2s + kBL2Bytes / 4);      // the group's, kBMaskBytes
  float* folds = reinterpret_cast<float*>(masks + kBMaskBytes / 16);  // [8 warps][8][kBFoldStride]
  uint64_t* bars = reinterpret_cast<uint64_t*>(folds + kBFoldBytes / 4);  // full, ready, empty
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t ring_a = smem_addr(ring), w2_a = smem_addr(w2s);
  const uint32_t full_a = smem_addr(bars), ready_a = full_a + 8 * kBStages,
                 empty_a = ready_a + 8 * kBStages;
  const long long blocks = gridDim.x;
  const long long lo = unit_lo(blockIdx.x, prm.units, blocks);
  const long long hi = unit_lo(blockIdx.x + 1, prm.units, blocks);
  const long long per_group = prm.n * prm.tiles;
  const long long d = prm.d;
  auto chunks_of = [&](long long grp) {
    const long long c0 = grp * prm.group_w;
    return static_cast<int>((min(d, c0 + prm.group_w) - c0 + kBChunk - 1) / kBChunk);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(ready_a + 8 * s, 4);  // the producer's warps
      mbar_init(empty_a + 8 * s, kBConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // W2 swizzled (64 rows k, two column blocks of 64), 16 bytes a copy
  for (int i = tid; i < kC1 * kC2 / 8; i += kBThreads) {
    const int k = i >> 4, q = i & 15;
    *reinterpret_cast<uint4*>(w2s + (q >> 3) * (kC1 * 128) + k * 128 + (((q & 7) ^ (k & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(prm.w2 + k * kC2 + 8 * q);
  }
  for (int pr = tid; pr < kC1 / 2; pr += kBThreads) {
    float* e = l1s + 16 * pr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * pr + h;
      e[h] = bf_val(prm.w1[c]);
      e[2 + h] = bf_val(prm.w1[kC1 + c]);
      e[4 + h] = bf_val(prm.w1[2 * kC1 + c]);
      e[6 + h] = bf_val(prm.b1[c]);
      e[8 + h] = prm.bn1[c];
      e[10 + h] = prm.bn1[kC1 + c];
      e[12 + h] = prm.bn1[2 * kC1 + c];
      e[14 + h] = 0.0f;
    }
  }
  for (int pr = tid; pr < kC2 / 2; pr += kBThreads) {
    float* e = l2s + 8 * pr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * pr + h;
      e[h] = bf_val(prm.b2[c]);
      e[2 + h] = prm.bn2[c];
      e[4 + h] = prm.bn2[kC2 + c];
      e[6 + h] = prm.bn2[2 * kC2 + c];
    }
  }
  fence_proxy_async();  // W2 for the products
  __syncthreads();

  if (warp >= kBConsumers / 32) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBProducerRegs));
    // thread pt's 16-byte pieces of a stage: row pt / 8 + 16 r of each box,
    // swizzled chunk pt % 8, which holds the box's columns 8 cb.. 8 cb + 7
    const int pt = tid - kBConsumers, cb = (pt & 7) ^ ((pt >> 3) & 7);
    const int piece = (pt >> 3) * 128 + (pt & 7) * 16;
    auto producer_sync = [] { asm volatile("bar.sync 4, 128;\n" ::: "memory"); };
    // the group's sign masks: thread pt the 8 columns of entry pt ([chunk
    // pt / 16][box pt / 8 % 2][column block pt % 8]), a word's two bf16
    // halves by their sign bits where the column's multiplier is negative
    auto build_masks = [&](long long grp) {
      const long long col =
          grp * prm.group_w + kBChunk * (pt >> 4) + 64 * ((pt >> 3) & 1) + 8 * (pt & 7);
      uint32_t mk[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        mk[w] = (col + 2 * w < d && prm.bn3[d + col + 2 * w] < 0.0f ? 0x8000u : 0u) |
                (col + 2 * w + 1 < d && prm.bn3[d + col + 2 * w + 1] < 0.0f ? 0x80000000u : 0u);
      producer_sync();  // the previous group's masks are used
      masks[pt] = make_uint4(mk[0], mk[1], mk[2], mk[3]);
      producer_sync();
    };
    // load L (chunk c of its group) landed: negate its columns whose
    // multiplier is negative
    auto negate = [&](long long L, int c) {
      const int s = static_cast<int>(L % kBStages);
      mbar_wait(full_a + 8 * s, static_cast<uint32_t>((L / kBStages) & 1));
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        const uint4 mk = masks[16 * c + 8 * box + cb];
        if (mk.x | mk.y | mk.z | mk.w) {
          unsigned char* p = ring + s * kBChunkBytes + box * (kBChunkBytes / 2) + piece;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            uint4* v = reinterpret_cast<uint4*>(p + 2048 * r);
            const uint4 x = *v;
            *v = make_uint4(x.x ^ mk.x, x.y ^ mk.y, x.z ^ mk.z, x.w ^ mk.w);
          }
        }
      }
      fence_proxy_async();  // for the products
      __syncwarp();
      if (lane == 0) mbar_arrive(ready_a + 8 * s);
    };
    long long loads = 0, prev = -1;
    int pending = -1;  // the chunk of load loads - 1, not yet negated
    for (long long u = lo; u < hi; ++u) {
      const long long grp = u / per_group;
      if (grp != prev) {
        if (pending >= 0) negate(loads - 1, pending);
        pending = -1;
        build_masks(grp);
      }
      if (!prm.resident || grp != prev) {
        const int nch = chunks_of(grp);
        for (int c = 0; c < nch; ++c, ++loads) {
          if (pt == 0) {
            const int s = static_cast<int>(loads % kBStages);
            const long long use = loads / kBStages;
            if (use > 0) mbar_wait(empty_a + 8 * s, static_cast<uint32_t>((use - 1) & 1));
            tma_chunk(ring_a + s * kBChunkBytes, &w3map, full_a + 8 * s,
                      grp * prm.group_w + c * kBChunk);
          }
          if (pending >= 0) negate(loads - 1, pending);  // the previous load, this one in flight
          pending = c;
        }
      }
      prev = grp;
    }
    if (pending >= 0) negate(loads - 1, pending);
    return;
  }

  // the consumers: warpgroup wg, its warp wq, lane (g, t)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBConsumerRegs));
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  float* my_run = run + warp * kBGroupMax;
  float* my_fold = folds + warp * 8 * kBFoldStride;
  // the thread's points: row 128 wg + 64 mt + 16 wq + g + 8 h of a tile
  auto load_x = [&](long long u, float (&x)[2][2][3]) {
    const long long rem = u % per_group, cloud = rem / prm.tiles, tile = rem % prm.tiles;
    const long long valid = min(static_cast<long long>(kBTile), prm.p - tile * kBTile);
    const uint16_t* base = prm.points + (cloud * prm.p + tile * kBTile) * 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 128 * wg + 64 * mt + 16 * wq + g + 8 * h;
        const uint16_t* pt = base + 3 * (r < valid ? r : 0);  // past the end: the tile's first point
#pragma unroll
        for (int k = 0; k < 3; ++k) x[mt][h][k] = bf_val(pt[k]);
      }
  };

  float x[2][2][3];
  uint32_t a1[2][kKB2][4];  // the unit's layer-2 A fragments
  load_x(lo, x);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) layer1(a1[mt], x[mt], l1s, t);
  long long loads = 0, prev_grp = -1, piece_lo = lo;
  int base = 0;
  for (long long u = lo; u < hi; ++u) {
    const long long grp = u / per_group, rem = u % per_group;
    const long long cloud = rem / prm.tiles, tile = rem % prm.tiles;
    const int nch = chunks_of(grp);
    const bool first = u == piece_lo;
    if (!prm.resident || grp != prev_grp) {
      base = static_cast<int>(loads % (2 * kBStages));
      loads += nch;
    }
    const long long next = u + 1;
    const bool more = next < hi;
    const bool group_ends = !more || next / per_group != grp;
    const bool release = !prm.resident || group_ends;
    const bool piece_ends = group_ends || (next % per_group) / prm.tiles != cloud;
    if (more) load_x(next, x);

    uint32_t a2[2][kKB3][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[64];
      product_issue<kKB2>(acc, a1[mt], w2_a, kC1 * 128);
      product_wait(acc);
      layer2_out(a2[mt], acc, l2s, t);
    }

    for (int c = 0; c < nch; ++c) {
      const int use = base + c;
      const int s = use % kBStages;
      mbar_wait(ready_a + 8 * s, static_cast<uint32_t>((use / kBStages) & 1));
      const uint32_t stage = ring_a + s * kBChunkBytes;
      float m[32];
      {
        float acc[64];
        product_issue<kKB3>(acc, a2[0], stage, kBChunkBytes / 2);
        if (c == nch - 1 && more) {  // the next unit's layer 1 under these products
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) layer1(a1[mt], x[mt], l1s, t);
        }
        product_wait(acc);
        rows_max(m, acc, true);
        product_issue<kKB3>(acc, a2[1], stage, kBChunkBytes / 2);
        product_wait(acc);
        rows_max(m, acc, false);
      }
      if (release) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_a + 8 * s);
      }
      // the warp's max of columns 4 lane.. 4 lane + 3 over its rows, into its
      // running max
      const float4 v = fold_columns(m, my_fold, g, t, lane);
      float4* slot = reinterpret_cast<float4*>(my_run + c * kBChunk + 4 * lane);
      if (first) {
        *slot = v;
      } else {
        const float4 o = *slot;
        *slot = make_float4(fmaxf(o.x, v.x), fmaxf(o.y, v.y), fmaxf(o.z, v.z), fmaxf(o.w, v.w));
      }
    }
    prev_grp = grp;

    if (piece_ends) {  // the 8 warps' maxima in order, by column
      consumer_sync();
      const long long c0 = grp * prm.group_w;
      const int width = static_cast<int>(min(static_cast<long long>(prm.group_w), d - c0));
      const bool whole = (piece_lo % per_group) % prm.tiles == 0 && tile == prm.tiles - 1;
      float* part = prm.partial + (2 * static_cast<long long>(blockIdx.x) + (piece_lo == lo ? 0 : 1)) * d;
      for (int col = tid; col < width; col += kBConsumers) {
        float mx = run[col];
#pragma unroll
        for (int w = 1; w < 8; ++w) mx = fmaxf(mx, run[w * kBGroupMax + col]);
        if (whole)
          prm.out[cloud * d + c0 + col] = __float2bfloat16_rn(layer3_out(mx, c0 + col, prm.b3, prm.bn3, d));
        else
          part[c0 + col] = mx;
      }
      consumer_sync();
      piece_lo = next;
    }
  }
}

// W3 (128, d) bf16 into rows of dp columns (dp = d rounded up to 8, zero
// past d), so that a TMA map can read it: the route of any d % 8 != 0
__global__ void __launch_bounds__(256)
pne_pack_w3_bf16_kernel(const uint16_t* __restrict__ w3, uint16_t* __restrict__ packed,
                        long long d, long long dp) {
  const long long total = kC2 * dp;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k = i / dp, c = i % dp;
    packed[i] = c < d ? w3[k * d + c] : static_cast<uint16_t>(0);
  }
}

// out[n, c] for the clouds that several blocks shared: their pieces'
// maxima merged in block order (the first block's from its slot 1, unless
// the cloud starts its run), then layer 3's output
__global__ void __launch_bounds__(256)
pne_segment_max_bf16_kernel(const float* __restrict__ partial, const uint16_t* __restrict__ b3,
                            const float* __restrict__ bn3, __nv_bfloat16* __restrict__ out,
                            long long n, long long d, long long tiles, long long units,
                            long long blocks, int group_w) {
  const long long total = n * d;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long cloud = i / d, c = i % d;
    const long long u0 = ((c / group_w) * n + cloud) * tiles, u1 = u0 + tiles - 1;
    const long long b0 = ((u0 + 1) * blocks - 1) / units, b1 = ((u1 + 1) * blocks - 1) / units;
    if (b0 == b1) continue;  // one block's piece: written by the encoder
    float m = partial[(2 * b0 + (unit_lo(b0, units, blocks) == u0 ? 0 : 1)) * d + c];
    for (long long b = b0 + 1; b <= b1; ++b) m = fmaxf(m, partial[2 * b * d + c]);
    out[i] = __float2bfloat16_rn(layer3_out(m, c, b3, bn3, d));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
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
extern "C" int pointnet_eval_bf16_smem_bytes() { return kBSmemBytes; }

// The points of the bf16 instance's tile (a unit of its split).
extern "C" int pointnet_eval_bf16_tile_points() { return kBTile; }

// The bf16 instance's scratch, in 32-bit words: where d % 8 != 0, W3 in
// rows of d rounded up to 8 (TMA reads rows of a multiple of 16 bytes);
// then the shared clouds' pieces, (blocks, 2, d) f32.
extern "C" long long pointnet_eval_bf16_scratch_words(long long n, long long d, int blocks) {
  (void)n;
  const long long dp = (d + 7) / 8 * 8;
  return (d % 8 ? kC2 * dp / 2 : 0) + 2LL * blocks * d;
}

// The bf16 instance. points (n, p, 3) bf16; per layer W (in, out) and b
// (out) bf16 and bn (3, out) f32: the running mean, rsqrt(var + eps) *
// scale, and the shift; widths 3 -> 64 -> 128 -> d; W2 and W3 16-byte
// aligned. out (n, d) bf16; scratch: 16-byte aligned,
// pointnet_eval_bf16_scratch_words(n, d, segments) words. The work is the
// list of (column group, cloud, 256-point tile) units, groups column groups
// of whole 128-column chunks of at most 1024 columns; `segments` persistent
// blocks take contiguous runs of it. Launches: the encoder; before it, W3's
// copy into rows of a multiple of 8 columns where d % 8 != 0; after it, the
// merge of the pieces of the clouds that several blocks shared, where a
// block's run starts inside a cloud. So 1 to 3 CUDA launches a call.
// Returns 0, a cudaError_t, -1 (no cuTensorMapEncodeTiled) or -1000 -
// CUresult (W3's tensor map refused).
extern "C" int pointnet_eval_bf16(const void* points, const void* w1, const void* b1,
                                  const float* bn1, const void* w2, const void* b2,
                                  const float* bn2, const void* w3, const void* b3,
                                  const float* bn3, void* out, void* scratch, long long n,
                                  long long p, long long d, int segments, int groups,
                                  void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || segments <= 0 || groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (d + kBChunk - 1) / kBChunk;
  const long long per_group = (chunks + groups - 1) / groups;
  if (per_group > kBChunksMax) return static_cast<int>(cudaErrorInvalidValue);
  BParams prm;
  prm.points = static_cast<const uint16_t*>(points);
  prm.w1 = static_cast<const uint16_t*>(w1);
  prm.b1 = static_cast<const uint16_t*>(b1);
  prm.bn1 = bn1;
  prm.w2 = static_cast<const uint16_t*>(w2);
  prm.b2 = static_cast<const uint16_t*>(b2);
  prm.bn2 = bn2;
  prm.b3 = static_cast<const uint16_t*>(b3);
  prm.bn3 = bn3;
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.n = n;
  prm.p = p;
  prm.d = d;
  prm.tiles = (p + kBTile - 1) / kBTile;
  prm.group_w = static_cast<int>(per_group * kBChunk);
  prm.resident = per_group <= kBStages;
  prm.units = (chunks + per_group - 1) / per_group * n * prm.tiles;
  const long long blocks = segments < prm.units ? segments : prm.units;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dp = (d + 7) / 8 * 8;
  const void* w3rows = w3;
  uint16_t* packed = static_cast<uint16_t*>(scratch);
  prm.partial = reinterpret_cast<float*>(static_cast<uint32_t*>(scratch) + (d % 8 ? kC2 * dp / 2 : 0));
  if (d % 8) {
    long long grid = (kC2 * dp + 255) / 256;
    if (grid > 132 * 8) grid = 132 * 8;
    pne_pack_w3_bf16_kernel<<<static_cast<unsigned>(grid), 256, 0, s>>>(
        static_cast<const uint16_t*>(w3), packed, d, dp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    w3rows = packed;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dp), static_cast<cuuint64_t>(kC2)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(2 * dp)};  // bytes from row to row
  const cuuint32_t box[2] = {64, kC2};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w3rows),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // past dp: zeros
  if (r != CUDA_SUCCESS) return -static_cast<int>(r) - 1000;
  static bool sized = false;  // the shared-memory allowance, set once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        pne_encoder_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  pne_encoder_bf16_kernel<<<static_cast<unsigned>(blocks), kBThreads, kBSmemBytes, s>>>(prm, map);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bool shared = false;  // a block's run that starts inside a cloud
  for (long long b = 1; b < blocks && !shared; ++b)
    shared = b * prm.units / blocks % prm.tiles != 0;
  if (!shared) return 0;
  long long grid = (n * d + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  pne_segment_max_bf16_kernel<<<static_cast<unsigned>(grid), 256, 0, s>>>(
      prm.partial, prm.b3, bn3, prm.out, n, d, prm.tiles, prm.units, blocks, prm.group_w);
  return static_cast<int>(cudaGetLastError());
}
