// Train-mode PointNet shape encoder (ShapeEncoderPC with batch-statistics
// BatchNorm), forward and parameter gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pose3d_tpu/ops/pointnet_train_fused.py (_call,
// the seven Pallas passes F1-F4 and B1-B3 behind pointnet_train_fused).
// pose3d_tpu_torch/ops/pointnet_train.py wraps it; pointnet_train_plain
// there is the same function in plain PyTorch:
//
//   a_k = h_{k-1} W_k + b_k   (h_0 the points, widths 3 -> 64 -> 128 -> D)
//   mu_k, var_k: per channel over every point of every valid cloud,
//                var = max(0, E[a^2] - mu^2)
//   h_k = relu((a_k - mu_k) * rsqrt(var_k + 1e-5) * gamma_k + beta_k), k = 1, 2
//   y_3 = the same affine map of a_3, without the ReLU
//   out[n, d] = max over the points of y_3, idx[n, d] = the first point
//               that takes it
//
// and the gradient of out with respect to W, b, gamma, beta of the three
// layers (the points take none). The gradient of the max goes entirely to
// the stored argmax point, by an integer compare of the point index, never
// by comparing recomputed floats. Each BatchNorm's backward goes through its
// statistics: with sums over every point (padded clouds included, since
// their outputs depend on the statistics too),
//   dbeta = sum dy, dgamma = sum dy * xhat,
//   da = gamma * r * (dy - [valid] (dbeta + xhat * dgamma) / m),
// r = rsqrt(var + eps) and m the valid points. dgamma_3 and dbeta_3 come
// from g and xhat_3 at each argmax point, recomputed bit for bit as the
// forward computed it (so gamma_3 = 0 needs no special case).
//
// Layer 3 from h2's Gram matrix. Layer 3 has no ReLU, and its gradient is
// nonzero only at the N D argmax rows, so what it needs of the points is
// G = sum h2 h2^T (128 x 128), s = sum h2 and m, over the valid rows:
//   mu3_c = hbar . w_c + b3_c, var3_c = max(0, w_c^T C w_c),
//   hbar = s / m, C = G / m - hbar hbar^T   (in f64)
// and, with r = rsqrt(var3 + eps), u = gamma r dbeta3 / m, v = gamma r
// dgamma3 / m,
//   dW3 = S - s u^T - (G W3 + s (b3 - mu3)^T) diag(r v),
//         S[k][c] = gamma_c r_c sum_n g(n,c) h2[n, idx(n,c), k]
//   db3 = gamma r dbeta3 - m u - r v (s . w_c + m (b3 - mu3))  (0 exactly)
//   dh2[row] = sum over the c with idx(n,c) = row of gamma_c r_c g(n,c) w_c
//              - [valid] (k0 + M h2[row]),
//         M = W3 diag(r v) W3^T (128 x 128), k0 = W3 (u + r v (b3 - mu3)),
// with G, s and m over the valid clouds' rows, S, dbeta3 and dgamma3 over
// every cloud.
// So the D-wide layer is computed once, for the max; the backward makes no
// D-wide product over the points (tests/test_torch_pointnet_train.py holds
// these forms against autograd in f64).
//
// What bounds it: the useful work is 2 (3*64 + 64*128 + 128*D) FLOP a point
// forward and 2 (3*64 + 2*64*128 + 128*128) backward (layers 1-2, M h2): at
// the teacher step's (160, 2500, 256) 32.9 and 26.4 GFLOP, 0.49 and 0.39 ms
// at the H100's 67 TFLOP/s f32 rate outside the tensor cores; the bytes
// that must move (4.8 MB of points, the weights, the outputs) take
// microseconds. So it is bound by operations. It uses f32 (or f64) FMA on
// the CUDA cores, so that it agrees with the plain version to rounding;
// the small closed-form kernels run in f64. Tensor cores are later work.
//
// Design. Blocks run in parallel and in no order, so every per-channel sum
// is a grid-wide reduction: each block writes a fixed-size partial sum and
// a second kernel adds the partials in a fixed order. No atomics: the
// result is the same bits on every run. The forward statistics' sums are
// compensated (f32 pairs of a sum and its rounding error, see
// stats_partial): a ReLU input's error then comes from its own layer's
// products and no longer from its channel's mean and variance, which would
// shift every point of the channel at once. G's entries are summed a tile
// (64 points) at a time in registers, the tiles in the block's sums and
// the blocks in f64. A tile is 64 consecutive points of one cloud; the
// narrow passes give each block the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; the max pass gives a block a 64-column chunk of W3 in
// shared memory and a strided set of tiles.
//   forward   l1_stats   points        -> sums of a1, a1^2           (+ stats)
//             l2_stats   points        -> h1 stored, sums of a2, a2^2 (+ stats)
//             l2_forward h1            -> h2 stored, G and s partials
//             gram                     -> G, s (f64, kept for the backward)
//             stats3     G, s          -> mu3, var3
//             max        h2            -> per-tile max and argmax
//             max_reduce               -> out, idx
//   backward  bn3_terms  g, idx, h2    -> g xhat3 at each argmax
//             bn3_sum                  -> dgamma3, dbeta3; u, r v (f64)
//             l3_grad    G, s, h2 rows -> dW3, db3; M, k0, W3^T
//             dh2        h1, h2, g,    -> dy2 stored, dgamma2, dbeta2 (+ sum)
//                        idx, M
//             b2         h1, dy2, pts  -> dW2, db2, dy1 stored,
//                                         dgamma1, dbeta1             (+ sums)
//             b3         points, dy1   -> dW1, db1                    (+ sum)
// 9 launches forward, 10 backward (the kernels are named pnt_<pass>_kernel).
// The D-wide activation never reaches memory. h1 (64 channels) and h2 (128)
// are stored (307 MB in f32 at (160, 2500)) rather than recomputed from the
// points in each pass that reads them: a write and a few reads of them cost
// about what recomputing layer 2 would (8.4 k FMAs a point a pass), and
// storing keeps each pass simple. dy2 and dy1 are stored for the same
// reason, as the TPU kernels do.
//
// Types: f32 with f32 sums, and an f64 instantiation (the card-vs-CPU step
// check runs the model in f64).
//
// The bf16 instance (--bf16: flax's ShapeEncoderPC(dtype=bfloat16) in
// train mode, pose3d_tpu/models/pointnet.py dense_bn_forward and the
// jnp.max after it; bf16 is TPU kernel 3's own dtype,
// pointnet_train_fused(..., dtype=bfloat16)). Each layer rounds where
// flax's does:
//   a_k = bf16(bf16(h_{k-1} W_k) + b_k)        (f32 accumulation)
//   mu_k, var_k in f32 from those rounded values (E[a^2] - mu^2, >= 0)
//   y_k = bf16((a_k - mu_k) (rsqrt(var_k + eps) gamma_k) + beta_k), in f32
//   h_k = relu(y_k), k = 1, 2;  out = the max over the points of y_3
// Layer 3's statistics come from the rounded a_3, which no Gram form of h2
// gives, so the D-wide layer runs in three passes (its statistics, the
// max, the backward), each recomputing a_3 on the tensor cores by one
// device function (layer3_issue: the same wgmma instruction, operands and
// k order), so that a_3 and y_3 are the same bits in every pass. Ties at
// the max are common in bf16 (2-14 % of the (cloud, channel) maxima at
// 2,500 points), and JAX's VJP of jnp.max splits them evenly: the max pass
// keeps, per cloud and channel, the maximum, the number of points that
// reach it and the sum of their a_3 - mu_3 (dgamma3 needs each tied
// point's own a_3: points with equal y_3 can differ in a_3), merged over
// tiles in a fixed order (an equal maximum adds its count and sum, a
// larger one restarts them); the backward gives bf16(g / count) to each
// point whose recomputed y_3 equals the stored maximum, an equality of two
// results of the same computation.
// The f32 and f64 instances keep their first-argmax rule (ties there are
// rare, and each tie is one gradient-equivalent point in practice).
// The backward rounds where JAX's autodiff of those layers does: the
// gradient of a BatchNorm's input is bf16(dy mul) + bf16(A + B a) summed in
// bf16 (the cotangents of JAX's two widenings of a: the normalisation and
// the statistics, the latter over the valid clouds' points only), the
// products' dW = bf16(h^T da), dh = bf16(da W^T), db = bf16(sum da), the
// BatchNorm parameters' gradients in f32.
// Passes (pnb_<pass>_kernel), with what bounds each on the H100 at the
// teacher step's (160, 2500, 256) (400,000 points; 3.35 TB/s, 989 TFLOP/s
// bf16):
//   forward   l1_stats    points -> a1 stored, sums of a1, a1^2   (+ stats)
//                         bytes: a1 51 MB written
//             l2          a1 -> h1 -> a2 stored, sums of a2, a2^2 (+ stats)
//                         bytes: 153 MB (a1 read, a2 written), 46 us
//             l3<false>   a2 -> h2 -> a3: sums of a3, a3^2       (+ stats)
//             l3<true>    a3 -> y3: each tile's max, count, sum
//                         each: 102 MB of a2 (31 us) beside 26 GFLOP (27 us)
//             max_reduce  -> out, count, tsum
//   backward  bn3         g, count, tsum -> bf16(g / count), dgamma3,
//                         dbeta3, BN3's coefficients (and W3 in bf16 above
//                         D 256)
//             l3_back     a3, y3 again -> da3 (shared memory); dW3 (h2^T
//                         da3), db3; up to D 256 also dh2 = da3 W3^T -> dy2
//                         stored, BN2's sums: 79 GFLOP (80 us) beside 204
//                         MB (a2 read, dy2 written; 61 us). Above D 256 da3
//                         is stored and
//             dh2         da3 W3^T (mma.sync) -> dy2 stored; BN2's sums
//             sum_round   -> dW3, db3 rounded to bf16
//             bn_back     -> dgamma2, dbeta2, BN2's coefficients
//             l2_back     -> da2; dW2 (h1^T da2), db2; da2 W2^T -> dy1
//                         stored; BN1's sums: bytes, 306 MB (91 us)
//             sum_round   -> dW2, db2;  bn_back -> dgamma1, dbeta1, BN1's
//             l1_back     -> da1; dW1, db1;  sum_round -> dW1, db1
// (+ stats) is pnb_stats_kernel: pnt_stats_kernel<float>'s sums in its
// order, its loads issued 16 blocks ahead of their use (one block, latency-
// bound). 8 launches forward, 9 backward up to D 256 (10 above). The narrow
// passes (layers 1-2) run mma.sync m16n8k16 bf16 products on 64-point
// tiles. The D-wide passes (l3, l3_back) are what the layer's width makes
// expensive, and they run on Hopper's wgmma: persistent blocks of two
// warpgroups walk 128-point tiles across a group of 256 columns of W3,
// staged once a block in shared memory (64 KB of bf16, 128-byte swizzle);
// h2 = relu(bn2(a2)) is normalised once a tile into the swizzled layout the
// products read; the next tile's a2 lands by cp.async while this one's
// products and epilogue run. The epilogues work on the accumulators: the
// bias, the rounding, the statistics or BN3 and the max / count / sum,
// reduced over a thread's two rows, then the 8 lanes of a column by
// shuffles, then the 8 warps through a small shared array in row order.
// Their cost is the bound today, not the products or the bytes: the
// products of a tile take about a microsecond, its epilogue several on 8
// warps an SM, where the bf16 roundings (a conversion each, at a fraction of
// the FP32 rate; two a conversion here, bf2_bits) and the lane shuffles
// lead. The backward fuses dh2 into layer 3's
// pass: da3 goes from the accumulators into shared memory (swizzled),
// feeds dW3 += h2^T da3 and dh2 = da3 W3^T as two more wgmma products (h2,
// da3 and W3 read down their columns through wgmma's transpose bit), and
// never reaches device memory; dW3's 128 x 256 f32 sums stay in registers
// over the block's tiles (128 a thread), which is why a3 is recomputed
// there one 128-column product at a time (the forward keeps both in
// flight). a1 and a2 (the dense layers' rounded outputs, 384 bytes a point)
// are stored and h1, h2 recomputed from them where a pass reads them: h =
// relu(bn(a)) is a few exact operations a value, and the backward's
// BatchNorm needs a itself. dy2 and dy1 are stored for the passes after
// them, as the TPU kernels store d_y2 and d_y1. The narrow bf16 kernels
// declare __launch_bounds__(kThreads), the D-wide ones (kThreads, 1); all
// are launched with kThreads threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 64;        // points a tile
constexpr int kC1 = 64;           // layer-1 width
constexpr int kC2 = 128;          // layer-2 width
constexpr int kChunk = 64;        // W3 columns a max block holds
constexpr int kLd = kTileP + 4;   // row stride of transposed activations [c][p]
constexpr int kLd2 = kC2 + 4;     // row stride of a dy2 tile [p][c]
// row strides of W3's chunk and W2 where they are also read down a column
// (odd, so that the 16 columns a warp reads fall in different banks)
constexpr int kLdW3 = kChunk + 1;
constexpr int kLdW2 = kC2 + 1;
constexpr double kEps = 1e-5;
// the partial sums each narrow block writes, by pass
constexpr int kB2Partial = kC1 * kC2 + kC2 + 2 * kC1;  // dW2, db2, dgamma1, dbeta1

// the packed parameters (and their gradients): per layer W (in, out), b,
// gamma, beta
__host__ __device__ constexpr long long off_w1() { return 0; }
__host__ __device__ constexpr long long off_l1() { return 3 * kC1; }  // b1, g1, be1
__host__ __device__ constexpr long long off_w2() { return 6 * kC1; }
__host__ __device__ constexpr long long off_l2() { return 6 * kC1 + kC1 * kC2; }
__host__ __device__ constexpr long long off_w3() { return off_l2() + 3 * kC2; }
__host__ __device__ inline long long off_l3(long long d) { return off_w3() + kC2 * d; }
// the stats: mu1, var1, mu2, var2, mu3, var3
constexpr long long kStats1 = 0, kStats2 = 2 * kC1, kStats3 = 2 * kC1 + 2 * kC2;

template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
template <>
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__device__ __forceinline__ T rstd(T var) { return T(1) / sqrt(var + T(kEps)); }

template <typename T>
__device__ __forceinline__ T relu(T v) { return v > T(0) ? v : T(0); }

// the first layer's pre-activation of one point: the same chain everywhere
template <typename T>
__device__ __forceinline__ T layer1(const T* x, T wa, T wb, T wc, T b) {
  return fma_t(x[2], wc, fma_t(x[1], wb, x[0] * wa)) + b;
}

// valid points of the batch: the valid clouds times p
__device__ __forceinline__ long long valid_points(const uint8_t* valid, long long n,
                                                  long long p) {
  if (valid == nullptr) return n * p;
  long long c = 0;
  for (long long i = 0; i < n; ++i) c += valid[i] != 0;
  return c * p;
}

struct Tile {
  long long cloud, row0;  // the cloud, and the tile's first row of (n * p)
  int np;                 // real points in the tile (the last one is ragged)
  bool valid;             // the cloud counts in the statistics
};

template <int TP = kTileP>
__device__ __forceinline__ Tile tile_of(long long tile, long long p, const uint8_t* valid) {
  const long long tpc = (p + TP - 1) / TP;
  Tile t;
  t.cloud = tile / tpc;
  const long long p0 = (tile % tpc) * TP;
  t.row0 = t.cloud * p + p0;
  t.np = static_cast<int>(min(static_cast<long long>(TP), p - p0));
  t.valid = valid == nullptr || valid[t.cloud] != 0;
  return t;
}

// a tile of a (rows, C) activation into dst[c][p] (stride kLd); rows past
// the tile's end read as 0
template <typename T, int C>
__device__ __forceinline__ void load_t(T* dst, const T* src, const Tile& t) {
  for (int i = threadIdx.x; i < C * kTileP; i += kThreads) {
    const int pp = i / C, k = i % C;
    dst[k * kLd + pp] = pp < t.np ? src[(t.row0 + pp) * C + k] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void load_points(T* xs, const T* points, const Tile& t) {
  if (threadIdx.x < 3 * kTileP)
    xs[threadIdx.x] = threadIdx.x < 3 * t.np ? points[3 * t.row0 + threadIdx.x] : T(0);
}

// the layer-2 thread map: 4 points (4 * ty2 ..) x 8 channels (two runs of 4)
__device__ __forceinline__ int c2_of(int tx2, int j) {
  return (j < 4 ? 0 : kC1) + 4 * tx2 + (j & 3);
}

// acc[i][j] = sum_k h1[k][4 ty2 + i] w2[k][c_j], k in order from 0
template <typename T>
__device__ __forceinline__ void layer2_acc(T (&acc)[4][8], const T* h1t, const T* w2, int ldw,
                                           int ty2, int tx2) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
#pragma unroll 4
  for (int k = 0; k < kC1; ++k) {
    T av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = h1t[k * kLd + 4 * ty2 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = w2[k * ldw + c2_of(tx2, j)];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fma_t(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] = sum_k h2[k][4 ty + i] w3c[k][4 tx + j] (w3c's rows kLdW3
// apart), k in order from 0: the
// same chain as pnt_bn3_terms_kernel's, so a3 is the same bits in every pass
template <typename T>
__device__ __forceinline__ void layer3_acc(T (&acc)[4][4], const T* h2t, const T* w3c, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
#pragma unroll 4
  for (int k = 0; k < kC2; ++k) {
    T av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = h2t[k * kLd + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = w3c[k * kLdW3 + 4 * tx + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(av[i], bv[j], acc[i][j]);
  }
}

// red[g][c] for g < groups summed in order into out[c], c < width
template <typename T>
__device__ __forceinline__ T sum_groups(const T* red, int groups, int width, int c) {
  T s = red[c];
  for (int g = 1; g < groups; ++g) s += red[g * width + c];
  return s;
}

// s += x with its rounding error added to c (Fast2Sum: the error is exact
// while |s| >= |x|, as in a running sum of many like terms; where x is the
// larger, it is off by at most about a rounding of s, small beside x's):
// s + c carries the sum to about one rounding of the result
template <typename T>
__device__ __forceinline__ void add_c(T& s, T& c, T x) {
  const T t = s + x;
  c += x - (t - s);
  s = t;
}

// the compensated form of sum_groups: hi[g][c] and lo[g][c] (a sum and its
// error each) summed in order into (s, c)
template <typename T>
__device__ __forceinline__ void sum_groups_c(const T* hi, const T* lo, int groups, int width,
                                             int c, T& s, T& e) {
  s = hi[c];
  e = lo[c];
  for (int g = 1; g < groups; ++g) {
    add_c(s, e, hi[g * width + c]);
    e += lo[g * width + c];
  }
}

// ------------------------------------------------------------- forward

// Statistics partials: a block writes [4][C] (the sums of a and a^2, then
// their errors). Each thread sums its points of a tile plainly and adds the
// tile's sum into a compensated (sum, error) pair; the thread groups and
// the blocks are added the same way. So a channel's sums over 400,000
// points carry about one rounding of the result, not one for each of the
// hundreds of running additions, and the statistics meet float64's to
// f32 rounding.

// a thread's sums (s, q) and errors (cs, cq) of channel c, thread group g
// of `groups`, into red [4][groups][width] (after a barrier)
template <typename T>
__device__ __forceinline__ void stats_to_shared(T* red, int groups, int width, int g, int c, T s,
                                                T cs, T q, T cq) {
  red[g * width + c] = s;
  red[(groups + g) * width + c] = q;
  red[(2 * groups + g) * width + c] = cs;
  red[(3 * groups + g) * width + c] = cq;
}

// red's groups added in order -> the block's partial, out[k * stride + c]
// for k < 4 and c < width, by the first 2 width threads
template <typename T>
__device__ __forceinline__ void stats_partial(const T* red, int groups, int width,
                                              T* __restrict__ out, long long stride) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * width) {
    const int which = t / width, c = t % width;  // 0: a, 1: a^2
    T hi, lo;
    sum_groups_c(red + which * groups * width, red + (2 + which) * groups * width, groups, width,
                 c, hi, lo);
    out[which * stride + c] = hi;
    out[(2 + which) * stride + c] = lo;
  }
}

// sums of a1 and a1^2 over the valid clouds' points -> partial[block][4][64]
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_l1_stats_kernel(const T* __restrict__ points, const uint8_t* __restrict__ valid, long long n,
                    long long p, const T* __restrict__ prm, T* __restrict__ partial) {
  __shared__ T xs[3 * kTileP];
  __shared__ T red[4 * 4 * kC1];
  const int t = threadIdx.x, k = t % kC1, pg = t / kC1;
  const T* w1 = prm + off_w1();
  const T wa = w1[k], wb = w1[kC1 + k], wc = w1[2 * kC1 + k], bk = prm[off_l1() + k];
  T s = T(0), q = T(0), cs = T(0), cq = T(0);
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    load_points(xs, points, tl);
    __syncthreads();
    if (!tl.valid) continue;
    T ts = T(0), tq = T(0);
    for (int i = 0; i < 16; ++i) {
      const int pp = 16 * pg + i;
      if (pp < tl.np) {
        const T a = layer1(xs + 3 * pp, wa, wb, wc, bk);
        ts += a;
        tq = fma_t(a, a, tq);
      }
    }
    add_c(s, cs, ts);
    add_c(q, cq, tq);
  }
  stats_to_shared(red, 4, kC1, pg, k, s, cs, q, cq);
  stats_partial(red, 4, kC1, partial + blockIdx.x * 4 * kC1, kC1);
}

// h1 = relu(bn1(a1)), stored; sums of a2 and a2^2 -> partial[block][4][128]
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_l2_stats_kernel(const T* __restrict__ points, const uint8_t* __restrict__ valid, long long n,
                    long long p, const T* __restrict__ prm, const T* __restrict__ stats,
                    T* __restrict__ h1, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2s = reinterpret_cast<T*>(smem_raw);  // [64][128]
  T* h1t = w2s + kC1 * kC2;                 // [64][kLd]
  T* xs = h1t + kC1 * kLd;                  // [64][3]
  const int t = threadIdx.x;
  for (int i = t; i < kC1 * kC2; i += kThreads) w2s[i] = prm[off_w2() + i];
  const int k = t % kC1, pg = t / kC1;
  const T* w1 = prm + off_w1();
  const T wa = w1[k], wb = w1[kC1 + k], wc = w1[2 * kC1 + k], bk = prm[off_l1() + k];
  const T mu1 = stats[kStats1 + k];
  const T mul1 = rstd(stats[kStats1 + kC1 + k]) * prm[off_l1() + kC1 + k];
  const T be1 = prm[off_l1() + 2 * kC1 + k];
  const int ty2 = t / 16, tx2 = t % 16;
  T b2[8], s[8], q[8], cs[8], cq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b2[j] = prm[off_l2() + c2_of(tx2, j)];
    s[j] = q[j] = cs[j] = cq[j] = T(0);
  }
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    load_points(xs, points, tl);
    __syncthreads();
    for (int i = 0; i < 16; ++i) {  // layer 1: column k of 16 points
      const int pp = 16 * pg + i;
      const T h = relu((layer1(xs + 3 * pp, wa, wb, wc, bk) - mu1) * mul1 + be1);
      h1t[k * kLd + pp] = h;
      if (pp < tl.np) h1[(tl.row0 + pp) * kC1 + k] = h;
    }
    __syncthreads();
    if (!tl.valid) continue;
    T acc[4][8];
    layer2_acc(acc, h1t, w2s, kC2, ty2, tx2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T ts = T(0), tq = T(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * ty2 + i < tl.np) {
          const T a = acc[i][j] + b2[j];
          ts += a;
          tq = fma_t(a, a, tq);
        }
      }
      add_c(s[j], cs[j], ts);
      add_c(q[j], cq[j], tq);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) stats_to_shared(w2s, 16, kC2, ty2, c2_of(tx2, j), s[j], cs[j], q[j],
                                              cq[j]);
  stats_partial(w2s, 16, kC2, partial + blockIdx.x * 4 * kC2, kC2);
}

// ------------------------------------------------ h2's Gram matrix

// G = sum h2 h2^T over the valid rows is symmetric: a block keeps its upper
// 8 x 8 blocks (bi <= bj, 136 of 256), one a thread, and the column sums s
constexpr int kGramBlocks = 136;              // 16 * 17 / 2
constexpr int kGramSlots = 64 * kGramBlocks;  // 8704 entries a block keeps
constexpr int kLdH = kC2 + 4;                 // row stride of an h2 tile [p][c]
constexpr int kGramPartial = kGramSlots + 2 * kC2;  // G's entries, s, s's errors

// the 8 x 8 block (bi, bj), bi <= bj, that thread `item` keeps
__host__ __device__ inline void gram_block(int item, int& bi, int& bj) {
  bi = 0;
  while (item >= 16 - bi) item -= 16 - bi++;
  bj = bi + item;
}

// h2 = relu(bn2(h1 W2 + b2)), stored; for the valid clouds, G and s into
// partial[block][kGramPartial]: each tile's products summed plainly in
// registers (64 points), added into the block's sums in shared memory;
// s's tile sums added into a compensated pair, as stats_partial's
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
pnt_l2_forward_kernel(const T* __restrict__ h1, const uint8_t* __restrict__ valid, long long n,
                      long long p, const T* __restrict__ prm, const T* __restrict__ stats,
                      T* __restrict__ h2, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2s = reinterpret_cast<T*>(smem_raw);  // [64][128]
  T* h1t = w2s + kC1 * kC2;                 // [64][kLd]; h2s [64][kLdH] in its place
  T* h2s = h1t;
  T* run = h1t + kTileP * kLdH;             // [64][136]: the block's sums of G
  const int t = threadIdx.x;
  for (int i = t; i < kC1 * kC2; i += kThreads) w2s[i] = prm[off_w2() + i];
  for (int i = t; i < kGramSlots; i += kThreads) run[i] = T(0);
  const int ty2 = t / 16, tx2 = t % 16;
  T b2[8], mu[8], mul[8], be[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c2_of(tx2, j);
    b2[j] = prm[off_l2() + c];
    mu[j] = stats[kStats2 + c];
    mul[j] = rstd(stats[kStats2 + kC2 + c]) * prm[off_l2() + kC2 + c];
    be[j] = prm[off_l2() + 2 * kC2 + c];
  }
  int bi = 0, bj = 0;
  if (t < kGramBlocks) gram_block(t, bi, bj);
  const int cs = t - (kThreads - kC2);  // the channel of s this thread sums
  T s_hi = T(0), s_lo = T(0);
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    load_t<T, kC1>(h1t, h1, tl);
    __syncthreads();
    T acc[4][8];
    layer2_acc(acc, h1t, w2s, kC2, ty2, tx2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pp = 4 * ty2 + i;
        const T h = relu((acc[i][j] + b2[j] - mu[j]) * mul[j] + be[j]);
        acc[i][j] = pp < tl.np ? h : T(0);
        if (pp < tl.np) h2[(tl.row0 + pp) * kC2 + c2_of(tx2, j)] = h;
      }
    }
    if (!tl.valid) continue;
    __syncthreads();  // h1t is read; h2s takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) h2s[(4 * ty2 + i) * kLdH + c2_of(tx2, j)] = acc[i][j];
    __syncthreads();
    if (t < kGramBlocks) {
      T g[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) g[a][b] = T(0);
      for (int pp = 0; pp < kTileP; ++pp) {
        T u[8], v[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          u[a] = h2s[pp * kLdH + 8 * bi + a];
          v[a] = h2s[pp * kLdH + 8 * bj + a];
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) g[a][b] = fma_t(u[a], v[b], g[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) run[(8 * a + b) * kGramBlocks + t] += g[a][b];
    }
    if (cs >= 0) {
      T ts = T(0);
      for (int pp = 0; pp < kTileP; ++pp) ts += h2s[pp * kLdH + cs];
      add_c(s_hi, s_lo, ts);
    }
  }
  __syncthreads();
  T* out = partial + static_cast<long long>(blockIdx.x) * kGramPartial;
  for (int i = t; i < kGramSlots; i += kThreads) out[i] = run[i];
  if (cs >= 0) {
    out[kGramSlots + cs] = s_hi;
    out[kGramSlots + kC2 + cs] = s_lo;
  }
}

// the blocks' partials summed in block order in f64 -> gram: G (128 x 128,
// both halves), then s (128)
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_gram_kernel(const T* __restrict__ partial, int blocks, double* __restrict__ gram) {
  for (int slot = blockIdx.x * kThreads + threadIdx.x; slot < kGramSlots + kC2;
       slot += gridDim.x * kThreads) {
    double sum = 0.0;
    if (slot < kGramSlots) {
      for (int b = 0; b < blocks; ++b) sum += static_cast<double>(partial[b * kGramPartial + slot]);
      int bi, bj;
      gram_block(slot % kGramBlocks, bi, bj);
      const int e = slot / kGramBlocks, r = 8 * bi + e / 8, c = 8 * bj + e % 8;
      if (r <= c) {  // a diagonal block's lower entries repeat its upper ones
        gram[r * kC2 + c] = sum;
        gram[c * kC2 + r] = sum;
      }
    } else {
      const int c = slot - kGramSlots;
      for (int b = 0; b < blocks; ++b)
        sum += static_cast<double>(partial[b * kGramPartial + kGramSlots + c]) +
               static_cast<double>(partial[b * kGramPartial + kGramSlots + kC2 + c]);
      gram[kC2 * kC2 + c] = sum;
    }
  }
}

// layer 3's statistics from the Gram sums, in f64, a block of 128 threads a
// channel: with hbar = s / m and C = G / m - hbar hbar^T,
//   mu3 = hbar . w_c + b3_c,  var3 = max(0, w_c^T C w_c)
// (no __launch_bounds__: built with __launch_bounds__(kC2) by nvcc 12.9,
// this kernel read wrong values on the H100, and without it right ones;
// the fault is already in the PTX the front end emits for the unrolled cw
// loop under .maxntid 128, in f32 and f64 and at any ptxas level, and
// goes with that loop's unrolling: ROADMAP.md Queue 3)
template <typename T>
__global__ void
pnt_stats3_kernel(const double* __restrict__ gram, const uint8_t* __restrict__ valid, long long n,
                  long long p, long long d, const T* __restrict__ prm, T* __restrict__ stats) {
  __shared__ double red[2][kC2];
  __shared__ double hbar[kC2];
  __shared__ long long m_s;
  const int k = threadIdx.x;
  if (k == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const double inv_m = 1.0 / static_cast<double>(m_s);
  const double hk = gram[kC2 * kC2 + k] * inv_m;
  hbar[k] = hk;
  __syncthreads();
  const T* w3 = prm + off_w3();
  for (long long c = blockIdx.x; c < d; c += gridDim.x) {
    double cw = 0.0;  // (C w_c)_k, G read down its column k (= its row)
    for (int l = 0; l < kC2; ++l)
      cw = fma(fma(gram[l * kC2 + k], inv_m, -hk * hbar[l]), static_cast<double>(w3[l * d + c]),
               cw);
    const double wk = static_cast<double>(w3[k * d + c]);
    __syncthreads();
    red[0][k] = wk * cw;
    red[1][k] = wk * hk;
    __syncthreads();
    if (k < 2) {
      double sum = 0.0;
      for (int l = 0; l < kC2; ++l) sum += red[k][l];
      if (k == 0)
        stats[kStats3 + d + c] = static_cast<T>(sum > 0.0 ? sum : 0.0);
      else
        stats[kStats3 + c] = static_cast<T>(sum + static_cast<double>(prm[off_l3(d) + c]));
    }
  }
}

// ------------------------------------------------ layer 3's max, in 64-column chunks

__host__ __device__ constexpr int max_smem_t() {  // T elements
  return kC2 * kLdW3 + kC2 * kLd + 16 * kChunk;
}
__host__ __device__ constexpr int max_smem_i() { return 16 * kChunk; }  // ints

// grid (segments, d / 64): the block holds columns d0 .. d0 + 63 of W3 and
// walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...: each tile's max
// of y3 and its first point -> pmax, pidx [tile][d]. The one pass over the
// points that computes the D-wide layer.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
pnt_max_kernel(const T* __restrict__ h2, long long n, long long p, long long d,
               const T* __restrict__ prm, const T* __restrict__ stats, T* __restrict__ pmax,
               int* __restrict__ pidx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w3c = reinterpret_cast<T*>(smem_raw);  // [128][kLdW3]
  T* h2t = w3c + kC2 * kLdW3;               // [128][kLd]
  T* red = h2t + kC2 * kLd;                 // [16][64]
  int* red_i = reinterpret_cast<int*>(red + 16 * kChunk);  // [16][64]

  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const long long d0 = static_cast<long long>(blockIdx.y) * kChunk;
  const T* w3 = prm + off_w3();
  for (int i = t; i < kC2 * kChunk; i += kThreads)
    w3c[(i / kChunk) * kLdW3 + i % kChunk] = w3[(i / kChunk) * d + d0 + i % kChunk];
  T b3[4], mu[4], r[4], gam[4], be[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long dd = d0 + 4 * tx + j;
    b3[j] = prm[off_l3(d) + dd];
    gam[j] = prm[off_l3(d) + d + dd];
    be[j] = prm[off_l3(d) + 2 * d + dd];
    mu[j] = stats[kStats3 + dd];
    r[j] = rstd(stats[kStats3 + d + dd]);
  }

  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, nullptr);
    const long long p0 = tl.row0 - tl.cloud * p;
    __syncthreads();
    load_t<T, kC2>(h2t, h2, tl);
    __syncthreads();
    T acc[4][4];
    layer3_acc(acc, h2t, w3c, ty, tx);
    // the thread's 4 points in order, then the 16 groups in order: a
    // strict > keeps the first maximum
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T best = -CUDART_INF;
      int at = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T y = (acc[i][j] + b3[j] - mu[j]) * (r[j] * gam[j]) + be[j];
        if (4 * ty + i < tl.np && (at < 0 || y > best)) {
          best = y;
          at = static_cast<int>(p0) + 4 * ty + i;
        }
      }
      red[ty * kChunk + 4 * tx + j] = best;
      red_i[ty * kChunk + 4 * tx + j] = at;
    }
    __syncthreads();
    if (t < kChunk) {
      T best = red[t];
      int at = red_i[t];
      for (int gq = 1; gq < 16; ++gq) {
        const int cand = red_i[gq * kChunk + t];
        if (cand >= 0 && (at < 0 || red[gq * kChunk + t] > best)) {
          best = red[gq * kChunk + t];
          at = cand;
        }
      }
      pmax[tile * d + d0 + t] = best;
      pidx[tile * d + d0 + t] = at;
    }
  }
}

// out[n, c] and idx[n, c]: the first of the cloud's tiles with the largest
// value (a tile's own maximum already is its first)
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_max_reduce_kernel(const T* __restrict__ pmax, const int* __restrict__ pidx, long long n,
                      long long tpc, long long d, T* __restrict__ out, int* __restrict__ idx) {
  const long long total = n * d;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long cloud = i / d, c = i % d;
    const long long base = cloud * tpc * d + c;
    T best = pmax[base];
    int at = pidx[base];
    for (long long tt = 1; tt < tpc; ++tt) {
      const T v = pmax[base + tt * d];
      if (v > best) {
        best = v;
        at = pidx[base + tt * d];
      }
    }
    out[i] = best;
    idx[i] = at;
  }
}

// per channel c < C: mu = sum / m, var = max(0, sumsq / m - mu^2) from the
// blocks' compensated partials [block][4][C], added in block order
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_stats_kernel(const T* __restrict__ partial, int blocks, long long ch,
                 const uint8_t* __restrict__ valid, long long n, long long p, T* __restrict__ out) {
  __shared__ long long m_s;
  if (threadIdx.x == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const T m = static_cast<T>(m_s);
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; c < ch;
       c += static_cast<long long>(gridDim.x) * kThreads) {
    T s = T(0), q = T(0), cs = T(0), cq = T(0);
    for (int b = 0; b < blocks; ++b) {
      const T* part = partial + b * 4 * ch + c;
      add_c(s, cs, part[0]);
      add_c(q, cq, part[ch]);
      cs += part[2 * ch];
      cq += part[3 * ch];
    }
    const T mu = (s + cs) / m;
    const T var = (q + cq) / m - mu * mu;
    out[c] = mu;
    out[ch + c] = var > T(0) ? var : T(0);
  }
}

// out[e] = sum over blocks b, in order, of partial[b * stride + offset + e]
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_sum_kernel(const T* __restrict__ partial, int blocks, long long stride, long long offset,
               long long count, T* __restrict__ out) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < count;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    T s = T(0);
    for (int b = 0; b < blocks; ++b) s += partial[b * stride + offset + e];
    out[e] = s;
  }
}

// ------------------------------------------------------------- backward

// terms[n][c] = g[n][c] * xhat3 at the cloud's argmax point, with a3
// recomputed by layer3_acc's chain; summed over the clouds (with g's own
// sum) they are dgamma3 and dbeta3
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_bn3_terms_kernel(const T* __restrict__ h2, const T* __restrict__ g, const int* __restrict__ idx,
                     long long n, long long p, long long d, const T* __restrict__ prm,
                     const T* __restrict__ stats, T* __restrict__ terms) {
  const T* w3 = prm + off_w3();
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n * d;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long cloud = i / d, c = i % d;
    const T* row = h2 + (cloud * p + idx[i]) * kC2;
    T acc = T(0);
    for (int k = 0; k < kC2; ++k) acc = fma_t(row[k], w3[k * d + c], acc);
    terms[i] = g[i] * ((acc + prm[off_l3(d) + c] - stats[kStats3 + c]) *
                       rstd(stats[kStats3 + d + c]));
  }
}

// dgamma3 = sum_n terms[n][c], dbeta3 = sum_n g[n][c] (every cloud, in
// order) -> grads; and, in f64 for the closed forms, coef [4][d]: gamma r,
// u = gamma r dbeta3 / m, r v = r gamma r dgamma3 / m, b3 - mu3
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_bn3_sum_kernel(const T* __restrict__ terms, const T* __restrict__ g,
                   const uint8_t* __restrict__ valid, long long n, long long p, long long d,
                   const T* __restrict__ prm, const T* __restrict__ stats, T* __restrict__ grads,
                   double* __restrict__ coef) {
  __shared__ long long m_s;
  if (threadIdx.x == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const double m = static_cast<double>(m_s);
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; c < d;
       c += static_cast<long long>(gridDim.x) * kThreads) {
    T dg = T(0), db = T(0);
    for (long long i = 0; i < n; ++i) {
      dg += terms[i * d + c];
      db += g[i * d + c];
    }
    grads[off_l3(d) + d + c] = dg;
    grads[off_l3(d) + 2 * d + c] = db;
    const double r = 1.0 / sqrt(static_cast<double>(stats[kStats3 + d + c]) + kEps);
    const double gr = static_cast<double>(prm[off_l3(d) + d + c]) * r;
    coef[c] = gr;
    coef[d + c] = gr * static_cast<double>(db) / m;
    coef[2 * d + c] = r * gr * static_cast<double>(dg) / m;
    coef[3 * d + c] =
        static_cast<double>(prm[off_l3(d) + c]) - static_cast<double>(stats[kStats3 + c]);
  }
}

// Layer 3's gradients in closed form, in f64, from G, s and m (`gram`),
// the argmax rows of h2 and coef (gamma r, u, r v, b3 - mu3 by channel):
//   dW3[k][c] = gamma r sum_n g(n,c) h2[n, idx(n,c), k] - s_k u_c
//               - ((G W3)[k][c] + s_k (b3 - mu3)_c) (r v)_c
//   db3_c     = gamma r dbeta3 - m u - (r v) (s . w_c + m (b3 - mu3))
// (0 in exact arithmetic), and for dh2: M = W3 diag(r v) W3^T and
// k0 = W3 (u + (r v)(b3 - mu3)) -> mk [128 * 128 + 128], W3^T -> wt [d][128],
// gamma r -> gr [d]. A thread an entry of dW3 and db3; a warp an entry of
// M and k0 (its lanes take every 32nd channel, then a fixed shuffle tree).
// G is symmetric, so it is read down its columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_l3_grad_kernel(const double* __restrict__ gram, const double* __restrict__ coef,
                   const T* __restrict__ h2, const int* __restrict__ idx, const T* __restrict__ g,
                   const uint8_t* __restrict__ valid, long long n, long long p, long long d,
                   const T* __restrict__ prm, T* __restrict__ grads, T* __restrict__ mk,
                   T* __restrict__ wt, T* __restrict__ gr) {
  __shared__ long long m_s;
  if (threadIdx.x == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const double m = static_cast<double>(m_s);
  const T* w3 = prm + off_w3();
  const double* s = gram + kC2 * kC2;
  const double *cgr = coef, *cu = coef + d, *crv = coef + 2 * d, *csh = coef + 3 * d;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long e = first; e < (kC2 + 1) * d; e += threads) {
    if (e < kC2 * d) {  // k fastest: the argmax rows of h2 are read along k
      const long long c = e / kC2, k = e % kC2;
      double gw = 0.0, sg = 0.0;
      for (int l = 0; l < kC2; ++l)
        gw = fma(gram[l * kC2 + k], static_cast<double>(w3[l * d + c]), gw);
      for (long long i = 0; i < n; ++i)
        sg = fma(static_cast<double>(g[i * d + c]),
                 static_cast<double>(h2[(i * p + idx[i * d + c]) * kC2 + k]), sg);
      grads[off_w3() + k * d + c] =
          static_cast<T>(cgr[c] * sg - s[k] * cu[c] - (gw + s[k] * csh[c]) * crv[c]);
      wt[e] = w3[k * d + c];
    } else {
      const long long c = e - kC2 * d;
      double sw = 0.0;
      for (int k = 0; k < kC2; ++k) sw = fma(s[k], static_cast<double>(w3[k * d + c]), sw);
      grads[off_l3(d) + c] = static_cast<T>(
          cgr[c] * static_cast<double>(grads[off_l3(d) + 2 * d + c]) - m * cu[c] -
          crv[c] * (sw + m * csh[c]));
      gr[c] = static_cast<T>(cgr[c]);
    }
  }
  const int lane = threadIdx.x % 32;
  for (long long q = first / 32; q < kC2 * kC2 + kC2; q += threads / 32) {
    double acc = 0.0;
    if (q < kC2 * kC2) {
      const long long k = q / kC2, l = q % kC2;
      for (long long c = lane; c < d; c += 32)
        acc = fma(static_cast<double>(w3[k * d + c]) * crv[c], static_cast<double>(w3[l * d + c]),
                  acc);
    } else {
      const long long k = q - kC2 * kC2;
      for (long long c = lane; c < d; c += 32)
        acc = fma(static_cast<double>(w3[k * d + c]), cu[c] + crv[c] * csh[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) mk[q] = static_cast<T>(acc);
  }
}

constexpr int kHits = kThreads;  // argmax hits a dh2 block takes in one round

__host__ __device__ constexpr int dh2_smem_t() {
  return kC1 * kC2 + kC2 * kLd + kC1 * kLd + kHits;
}
__host__ __device__ constexpr int dh2_smem_i() { return 2 * kHits + kThreads / 32; }

// dh2 = routed - [valid] (k0 + M h2): routed[row][k] = sum over the channels
// c whose argmax is this row, in channel order, of gamma_c r_c g(n,c)
// W3[k][c]. Each round takes 256 channels: the tile's hits (idx(n,c) in
// the tile, an integer range check) are compacted in channel order into
// shared memory, and each (row, k) thread adds its row's hits in that
// order. Then dy2 = dh2 [h2 > 0] stored; the sums dgamma2 = sum dy2 xhat2
// and dbeta2 = sum dy2 -> partial[block][256]
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
pnt_dh2_kernel(const T* __restrict__ h1, const T* __restrict__ h2,
               const uint8_t* __restrict__ valid, long long n, long long p, long long d,
               const T* __restrict__ prm, const T* __restrict__ stats, const T* __restrict__ g,
               const int* __restrict__ idx, const T* __restrict__ mk, const T* __restrict__ wt,
               const T* __restrict__ gr, T* __restrict__ dy2, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2s = reinterpret_cast<T*>(smem_raw);  // [64][128]; the reduction
  T* h2t = w2s + kC1 * kC2;                 // [128][kLd]
  T* h1t = h2t + kC2 * kLd;                 // [64][kLd]
  T* hv = h1t + kC1 * kLd;                  // [kHits]: gamma r g of each hit
  int* hrow = reinterpret_cast<int*>(hv + kHits);  // [kHits]: its row in the tile
  int* hch = hrow + kHits;                          // [kHits]: its channel
  int* wcount = hch + kHits;                        // [8]: hits a warp found
  const int t = threadIdx.x, ty = t / 16, tx = t % 16, lane = t % 32, warp = t / 32;
  for (int i = t; i < kC1 * kC2; i += kThreads) w2s[i] = prm[off_w2() + i];
  T b2[8], mu2[8], r2[8], k0[8], s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c2_of(tx, j);
    b2[j] = prm[off_l2() + c];
    mu2[j] = stats[kStats2 + c];
    r2[j] = rstd(stats[kStats2 + kC2 + c]);
    k0[j] = mk[kC2 * kC2 + c];
    s[j] = q[j] = T(0);
  }
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    const long long p0 = tl.row0 - tl.cloud * p;
    __syncthreads();
    load_t<T, kC2>(h2t, h2, tl);
    load_t<T, kC1>(h1t, h1, tl);
    __syncthreads();
    T dh[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dh[i][j] = T(0);
    if (tl.valid) {  // -(k0 + M h2), M symmetric: read by its rows
#pragma unroll 2
      for (int l = 0; l < kC2; ++l) {
        T av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = h2t[l * kLd + 4 * ty + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = __ldg(mk + l * kC2 + c2_of(tx, j));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dh[i][j] = fma_t(av[i], bv[j], dh[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dh[i][j] = -(k0[j] + dh[i][j]);
    }
    for (long long c0 = 0; c0 < d; c0 += kHits) {
      const long long c = c0 + t;
      const long long row = c < d ? idx[tl.cloud * d + c] - p0 : -1;
      const bool hit = row >= 0 && row < tl.np;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) wcount[warp] = __popc(mask);
      __syncthreads();
      int base = 0, total = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        base += w < warp ? wcount[w] : 0;
        total += wcount[w];
      }
      if (hit) {
        const int at = base + __popc(mask & ((1u << lane) - 1u));
        hv[at] = gr[c] * g[tl.cloud * d + c];
        hrow[at] = static_cast<int>(row);
        hch[at] = static_cast<int>(c);
      }
      __syncthreads();
      for (int h = 0; h < total; ++h) {
        const int r = hrow[h];
        if (r / 4 != ty) continue;
        const T v = hv[h];
        const T* col = wt + static_cast<long long>(hch[h]) * kC2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const T w = __ldg(col + c2_of(tx, j));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r % 4 == i) dh[i][j] = fma_t(v, w, dh[i][j]);
        }
      }
      __syncthreads();  // the next round's hits take these' place
    }
    T acc2[4][8];
    layer2_acc(acc2, h1t, w2s, kC2, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = 4 * ty + i;
      if (pp >= tl.np) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c2_of(tx, j);
        const T dy = h2t[c * kLd + pp] > T(0) ? dh[i][j] : T(0);
        dy2[(tl.row0 + pp) * kC2 + c] = dy;
        const T xhat = (acc2[i][j] + b2[j] - mu2[j]) * r2[j];
        s[j] += dy;
        q[j] = fma_t(dy, xhat, q[j]);
      }
    }
  }
  __syncthreads();
  T* red = w2s;  // [2][16][128]: dgamma2's sums, then dbeta2's
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[ty * kC2 + c2_of(tx, j)] = q[j];
    red[(16 + ty) * kC2 + c2_of(tx, j)] = s[j];
  }
  __syncthreads();
  partial[blockIdx.x * 2 * kC2 + t] = sum_groups(red + (t / kC2) * 16 * kC2, 16, kC2, t % kC2);
}

__host__ __device__ constexpr int b2_smem_t() {
  return kC1 * kLdW2 + kC1 * kLd + kTileP * kLd2 + 3 * kTileP;
}

// BN2's backward: da2; dW2 = h1^T da2, db2; dy1 = (da2 W2^T) [h1 > 0]
// stored; dgamma1 = sum dy1 xhat1, dbeta1 = sum dy1 -> partial[block][kB2Partial]
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
pnt_b2_kernel(const T* __restrict__ points, const T* __restrict__ h1, const T* __restrict__ dy2,
              const uint8_t* __restrict__ valid, long long n, long long p,
              const T* __restrict__ prm, const T* __restrict__ stats, const T* __restrict__ grads,
              T* __restrict__ dy1, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2s = reinterpret_cast<T*>(smem_raw);  // [64][kLdW2]
  T* h1t = w2s + kC1 * kLdW2;               // [64][kLd]
  T* d2s = h1t + kC1 * kLd;                 // [64][kLd2]: dy2, then da2; the reduction
  T* xs = d2s + kTileP * kLd2;              // [64][3]
  __shared__ long long m_s;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  for (int i = t; i < kC1 * kC2; i += kThreads)
    w2s[(i / kC2) * kLdW2 + i % kC2] = prm[off_w2() + i];
  if (t == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const T m = static_cast<T>(m_s);
  // layer 2 on the layer-2 map (4 points x 8 channels)
  T b2[8], mu2[8], r2[8], gam2[8], c12[8], c22[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c2_of(tx, j);
    b2[j] = prm[off_l2() + c];
    gam2[j] = prm[off_l2() + kC2 + c];
    mu2[j] = stats[kStats2 + c];
    r2[j] = rstd(stats[kStats2 + kC2 + c]);
    c12[j] = grads[off_l2() + 2 * kC2 + c] / m;
    c22[j] = grads[off_l2() + kC2 + c] / m;
  }
  // layer 1 on its own map: 4 points (4 ty ..) x 4 channels (4 tx ..)
  T wa[4], wb[4], wc[4], b1[4], mu1[4], r1[4], s1[4], q1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * tx + j;
    wa[j] = prm[off_w1() + k];
    wb[j] = prm[off_w1() + kC1 + k];
    wc[j] = prm[off_w1() + 2 * kC1 + k];
    b1[j] = prm[off_l1() + k];
    mu1[j] = stats[kStats1 + k];
    r1[j] = rstd(stats[kStats1 + kC1 + k]);
    s1[j] = q1[j] = T(0);
  }
  // dW2's map: rows 8 (t / 32) .., columns 4 (t % 32) ..
  const int k0 = 8 * (t / 32), cc = 4 * (t % 32);
  T wacc[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) wacc[k][j] = T(0);
  T dbacc = T(0);

  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    load_points(xs, points, tl);
    load_t<T, kC1>(h1t, h1, tl);
    for (int i = t; i < kTileP * kC2; i += kThreads) {
      const int pp = i / kC2, c = i % kC2;
      d2s[pp * kLd2 + c] = pp < tl.np ? dy2[(tl.row0 + pp) * kC2 + c] : T(0);
    }
    __syncthreads();
    {
      T acc[4][8];
      layer2_acc(acc, h1t, w2s, kLdW2, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c2_of(tx, j);
          const T xhat = (acc[i][j] + b2[j] - mu2[j]) * r2[j];
          T da = T(0);
          if (pp < tl.np)
            da = gam2[j] * r2[j] *
                 (d2s[pp * kLd2 + c] - (tl.valid ? c12[j] + xhat * c22[j] : T(0)));
          d2s[pp * kLd2 + c] = da;  // only this thread reads or writes it here
        }
      }
    }
    __syncthreads();
    for (int pp = 0; pp < kTileP; ++pp) {
      T dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = d2s[pp * kLd2 + cc + j];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const T h = h1t[(k0 + k) * kLd + pp];
#pragma unroll
        for (int j = 0; j < 4; ++j) wacc[k][j] = fma_t(h, dv[j], wacc[k][j]);
      }
    }
    if (t < kC2)
      for (int pp = 0; pp < kTileP; ++pp) dbacc += d2s[pp * kLd2 + t];
    T dh[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[i][j] = T(0);
    for (int c = 0; c < kC2; ++c) {
      T wv[4], dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w2s[(4 * tx + j) * kLdW2 + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = d2s[(4 * ty + i) * kLd2 + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[i][j] = fma_t(dv[i], wv[j], dh[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = 4 * ty + i;
      if (pp >= tl.np) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * tx + j;
        const T dy = h1t[k * kLd + pp] > T(0) ? dh[i][j] : T(0);
        dy1[(tl.row0 + pp) * kC1 + k] = dy;
        const T xhat = (layer1(xs + 3 * pp, wa[j], wb[j], wc[j], b1[j]) - mu1[j]) * r1[j];
        s1[j] += dy;
        q1[j] = fma_t(dy, xhat, q1[j]);
      }
    }
  }
  T* out = partial + static_cast<long long>(blockIdx.x) * kB2Partial;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(k0 + k) * kC2 + cc + j] = wacc[k][j];
  if (t < kC2) out[kC1 * kC2 + t] = dbacc;
  __syncthreads();
  T* red = d2s;  // [2][16][64]: dgamma1's sums, then dbeta1's
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty * kC1 + 4 * tx + j] = q1[j];
    red[(16 + ty) * kC1 + 4 * tx + j] = s1[j];
  }
  __syncthreads();
  if (t < 2 * kC1)
    out[kC1 * kC2 + kC2 + t] = sum_groups(red + (t / kC1) * 16 * kC1, 16, kC1, t % kC1);
}

// BN1's backward: da1; dW1 = x^T da1, db1 -> partial[block][256]
template <typename T>
__global__ void __launch_bounds__(kThreads)
pnt_b3_kernel(const T* __restrict__ points, const T* __restrict__ dy1,
              const uint8_t* __restrict__ valid, long long n, long long p,
              const T* __restrict__ prm, const T* __restrict__ stats, const T* __restrict__ grads,
              T* __restrict__ partial) {
  __shared__ T xs[3 * kTileP];
  __shared__ T red[4][4][kC1];
  __shared__ long long m_s;
  const int t = threadIdx.x, k = t % kC1, pg = t / kC1;
  if (t == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const T m = static_cast<T>(m_s);
  const T wa = prm[off_w1() + k], wb = prm[off_w1() + kC1 + k];
  const T wc = prm[off_w1() + 2 * kC1 + k], b1 = prm[off_l1() + k];
  const T gam = prm[off_l1() + kC1 + k], mu = stats[kStats1 + k];
  const T r = rstd(stats[kStats1 + kC1 + k]);
  const T c1 = grads[off_l1() + 2 * kC1 + k] / m, c2 = grads[off_l1() + kC1 + k] / m;
  T acc[4] = {T(0), T(0), T(0), T(0)};  // dW1 rows 0..2, db1
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    load_points(xs, points, tl);
    __syncthreads();
    for (int i = 0; i < 16; ++i) {
      const int pp = 16 * pg + i;
      if (pp >= tl.np) break;
      const T* x = xs + 3 * pp;
      const T xhat = (layer1(x, wa, wb, wc, b1) - mu) * r;
      const T dy = dy1[(tl.row0 + pp) * kC1 + k];
      const T da = gam * r * (dy - (tl.valid ? c1 + xhat * c2 : T(0)));
      acc[0] = fma_t(x[0], da, acc[0]);
      acc[1] = fma_t(x[1], da, acc[1]);
      acc[2] = fma_t(x[2], da, acc[2]);
      acc[3] += da;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[j][pg][k] = acc[j];
  __syncthreads();
  partial[blockIdx.x * 4 * kC1 + t] = sum_groups(&red[t / kC1][0][0], 4, kC1, t % kC1);
}

// ------------------------------------------------------------- the bf16 instance
//
// flax's ShapeEncoderPC(dtype=bfloat16) in train mode (the header's
// "bf16 instance"): the layers round where flax's do, and the passes work
// on the rounded values, so no Gram form applies. Every product runs on
// the bf16 tensor cores with f32 accumulators, except layer 1's (K 3) on
// the CUDA cores: layer 3's on wgmma (below), the narrow passes' and the
// separate dh2's on mma.sync m16n8k16. For those, the a-fragments of a
// row-major tile [row][k] and the b-fragments of a tile stored [n][k] are
// single 32-bit loads from shared memory (two bf16 each), so each product
// whose operand is the transpose of a stored tile has that tile staged in
// both layouts.

constexpr int kLdB = kC2 + 8;        // row stride (bf16) of a tile 128 wide
constexpr int kLdB64 = kTileP + 8;   // row stride (bf16) of a tile 64 wide
constexpr int kLdA2 = kC2 + 4;       // row stride (f32) of layer 2's tile
constexpr int kL3Rows = kC2 + 1;     // a segment's layer-3 gradient rows: dW3, db3
// dh2 holds W3 (bf16) in shared memory up to this size (D 768); beyond it
// reads W3 from L2 for each tile
constexpr size_t kDh2StagedBytes = 2 * kC2 * (768 + 8);

__device__ __forceinline__ float bf_val(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint16_t bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// two bf16 values as one b32 word, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(bf_bits(lo)) | (static_cast<uint32_t>(bf_bits(hi)) << 16);
}
// flax's Dense after its f32 sum: x W rounded to bf16, + b rounded again
__device__ __forceinline__ float dense_bf16(float acc, float b) {
  return bf_round(__fadd_rn(bf_round(acc), b));
}
// flax's BatchNorm on a rounded value: (a - mu) * mul + beta in f32 (no
// contraction into an FMA), rounded to bf16
__device__ __forceinline__ float bn_bf16(float a, float mu, float mul, float beta) {
  return bf_round(__fadd_rn(__fmul_rn(__fsub_rn(a, mu), mul), beta));
}
// mul = rsqrt(var + eps) * gamma in f32
__device__ __forceinline__ float bn_mul_bf16(float var, float gamma) {
  return __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(var, 1e-5f))), gamma);
}

// c += a . b over one m16n8k16 bf16 tile, f32 accumulators (PTX fragment
// layout: lane 4g + t holds a rows g (a0, a2) and g + 8 (a1, a3) x cols
// 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3); b rows 2t, 2t + 1 (b0)
// and 2t + 8, 2t + 9 (b1) x col g; c rows g (c0, c1), g + 8 (c2, c3) x
// cols 2t, 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the a-fragment of rows r0.., k-columns k0.. of a row-major bf16 tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* s, int ld, int r0, int k0,
                                       int lane) {
  const uint16_t* q = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = word(q);
  a[1] = word(q + 8 * ld);
  a[2] = word(q + 8);
  a[3] = word(q + 8 * ld + 8);
}

// the b-fragment of k-rows k0.., columns n0.. of B, stored transposed:
// s[n][k] row-major
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const uint16_t* s, long long ld,
                                       int n0, int k0, int lane) {
  const uint16_t* q = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = word(q);
  b1 = word(q + 8);
}

// the tile's 16-byte vectors of a (rows, C) bf16 tensor, a thread's j-th:
// the point pp and first channel k0. With kByRow the warp's threads take
// consecutive vectors of a row (coalesced reads, row-major stores); else
// consecutive points of one channel group (the transposed stores [k][p] of
// consecutive points then fall in consecutive banks)
template <int C, bool kByRow>
__device__ __forceinline__ void vector_of(int j, int& pp, int& k0) {
  const int v = threadIdx.x + j * kThreads;
  if (kByRow) {
    pp = v / (C / 8);
    k0 = 8 * (v % (C / 8));
  } else {
    pp = v % kTileP;
    k0 = 8 * (v / kTileP);
  }
}

// 8 bf16 values (16 bytes) of a row of a (rows, C) tensor for each of the
// thread's vectors, 0 past the tile's end: each thread issues its loads of
// a tile first
template <int C, bool kByRow, int N>
__device__ __forceinline__ void load_rows(uint4 (&raw)[N], const uint16_t* src, const Tile& tl) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int pp, k0;
    vector_of<C, kByRow>(j, pp, k0);
    raw[j] = pp < tl.np ? *reinterpret_cast<const uint4*>(src + (tl.row0 + pp) * C + k0)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ float half_of(const uint4& w, int e) {
  const uint32_t word = e < 2 ? w.x : e < 4 ? w.y : e < 6 ? w.z : w.w;
  return bf_val(static_cast<uint16_t>(word >> (16 * (e & 1))));
}

// h = relu(bn(a)) of a tile of a (rows, C) bf16 tensor (bn: mu, mul, beta
// by channel) from the thread's vectors `raw` (`load_rows<C, !ht>`), rows
// past the tile's end 0: with hs, [p][k] into hs (row stride ld, 16-byte
// stores); with ht, [k][p] into ht (row stride kLdB64)
template <int C, int N>
__device__ __forceinline__ void store_h(const uint4 (&raw)[N], uint16_t* hs, int ld,
                                        uint16_t* ht, const Tile& tl, const float* bn) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int pp, k0;
    if (ht == nullptr)
      vector_of<C, true>(j, pp, k0);
    else
      vector_of<C, false>(j, pp, k0);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 2 * q + e;
        h[e] = pp < tl.np ? relu(bn_bf16(half_of(raw[j], 2 * q + e), bn[k], bn[C + k],
                                         bn[2 * C + k]))
                          : 0.0f;
      }
      w[q] = pack_bf16(h[0], h[1]);
    }
    if (hs != nullptr)
      *reinterpret_cast<uint4*>(hs + pp * ld + k0) = make_uint4(w[0], w[1], w[2], w[3]);
    if (ht != nullptr)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ht[(k0 + e) * kLdB64 + pp] = static_cast<uint16_t>(w[e / 2] >> (16 * (e & 1)));
  }
}

// load_rows and store_h in one: a tile of h from a, for the narrow passes
template <int C>
__device__ __forceinline__ void load_h(uint16_t* hs, int ld, uint16_t* ht, const uint16_t* a,
                                       const Tile& tl, const float* bn) {
  uint4 raw[kTileP * C / 8 / kThreads];
  if (ht == nullptr)
    load_rows<C, true>(raw, a, tl);
  else
    load_rows<C, false>(raw, a, tl);
  store_h<C>(raw, hs, ld, ht, tl, bn);
}

// a1 = bf16(bf16(x W1) + b1) stored for every point; the sums of a1 and
// a1^2 over the valid clouds' points -> partial[block][4][64], as
// pnt_l1_stats_kernel's
__global__ void __launch_bounds__(kThreads)
pnb_l1_stats_kernel(const uint16_t* __restrict__ points, const uint8_t* __restrict__ valid,
                    long long n, long long p, const float* __restrict__ prm,
                    uint16_t* __restrict__ a1, float* __restrict__ partial) {
  __shared__ float xs[3 * kTileP];
  __shared__ float red[4 * 4 * kC1];
  const int t = threadIdx.x, k = t % kC1, pg = t / kC1;
  const float* w1 = prm + off_w1();
  const float wa = bf_round(w1[k]), wb = bf_round(w1[kC1 + k]), wc = bf_round(w1[2 * kC1 + k]);
  const float bk = bf_round(prm[off_l1() + k]);
  float s = 0.0f, q = 0.0f, cs = 0.0f, cq = 0.0f;
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    if (t < 3 * kTileP) xs[t] = t < 3 * tl.np ? bf_val(points[3 * tl.row0 + t]) : 0.0f;
    __syncthreads();
    float ts = 0.0f, tq = 0.0f;
    for (int i = 0; i < 16; ++i) {
      const int pp = 16 * pg + i;
      if (pp < tl.np) {
        const float* x = xs + 3 * pp;
        const float a = dense_bf16(fmaf(x[2], wc, fmaf(x[1], wb, x[0] * wa)), bk);
        a1[(tl.row0 + pp) * kC1 + k] = bf_bits(a);
        ts += a;
        tq = fmaf(a, a, tq);
      }
    }
    if (tl.valid) {
      add_c(s, cs, ts);
      add_c(q, cq, tq);
    }
  }
  stats_to_shared(red, 4, kC1, pg, k, s, cs, q, cq);
  stats_partial(red, 4, kC1, partial + blockIdx.x * 4 * kC1, kC1);
}

// pnt_stats_kernel<float>'s statistics, its sums in its order, the
// partials' loads issued 16 blocks ahead of their use: in one block the
// loop's load latency, not its adds, was the pass's time
__global__ void __launch_bounds__(kThreads)
pnb_stats_kernel(const float* __restrict__ partial, int blocks, long long ch,
                 const uint8_t* __restrict__ valid, long long n, long long p,
                 float* __restrict__ out) {
  constexpr int kAhead = 16;
  __shared__ long long m_s;
  if (threadIdx.x == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  const float m = static_cast<float>(m_s);
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; c < ch;
       c += static_cast<long long>(gridDim.x) * kThreads) {
    float s = 0.0f, q = 0.0f, cs = 0.0f, cq = 0.0f;
    for (int b0 = 0; b0 < blocks; b0 += kAhead) {
      float v[kAhead][4];
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[i][k] = b0 + i < blocks ? partial[(b0 + i) * 4 * ch + k * ch + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (b0 + i >= blocks) break;
        add_c(s, cs, v[i][0]);
        add_c(q, cq, v[i][1]);
        cs += v[i][2];
        cq += v[i][3];
      }
    }
    const float mu = (s + cs) / m;
    const float var = (q + cq) / m - mu * mu;
    out[c] = mu;
    out[ch + c] = var > 0.0f ? var : 0.0f;
  }
}

__host__ __device__ constexpr int l2b_smem_bytes() {
  return 2 * (kC2 * kLdB64 + kTileP * kLdB64) + 4 * (kTileP * kLdA2 + 3 * kC1 + kC2);
}

// h1 = relu(bn1(a1)) a tile at a time; a2 = bf16(bf16(h1 W2) + b2) on the
// tensor cores (warp w: points 16 (w % 4).., channels 64 (w / 4) + 8 j..),
// stored for every point; the sums of a2 and a2^2 over the valid clouds'
// points -> partial[block][4][128]
__global__ void __launch_bounds__(kThreads)
pnb_l2_kernel(const uint16_t* __restrict__ a1, const uint8_t* __restrict__ valid, long long n,
              long long p, const float* __restrict__ prm, const float* __restrict__ stats,
              uint16_t* __restrict__ a2, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* w2t = reinterpret_cast<uint16_t*>(smem_raw);  // [128][kLdB64]: W2^T
  uint16_t* h1s = w2t + kC2 * kLdB64;                     // [64][kLdB64]
  float* a2s = reinterpret_cast<float*>(h1s + kTileP * kLdB64);  // [64][kLdA2]
  float* bn1 = a2s + kTileP * kLdA2;                      // [3][64]: mu, mul, beta
  float* b2s = bn1 + 3 * kC1;                             // [128]
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane >> 2, tq = lane & 3;
  for (int i = t; i < kC1 * kC2; i += kThreads)
    w2t[(i % kC2) * kLdB64 + i / kC2] = bf_bits(prm[off_w2() + i]);
  for (int i = t; i < kC1; i += kThreads) {
    bn1[i] = stats[kStats1 + i];
    bn1[kC1 + i] = bn_mul_bf16(stats[kStats1 + kC1 + i], prm[off_l1() + kC1 + i]);
    bn1[2 * kC1 + i] = prm[off_l1() + 2 * kC1 + i];
  }
  for (int i = t; i < kC2; i += kThreads) b2s[i] = bf_round(prm[off_l2() + i]);
  const int c = t % kC2, half = t / kC2;  // the statistics: a column, 32 points
  float s = 0.0f, q = 0.0f, cs = 0.0f, cq = 0.0f;
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();  // the weights stored; the previous tile read
    load_h<kC1>(h1s, kLdB64, nullptr, a1, tl, bn1);
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kC1 / 16; ++ks) {
      uint32_t a[4];
      load_a(a, h1s, kLdB64, 16 * (warp & 3), 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, w2t, kLdB64, 64 * (warp >> 2) + 8 * j, 16 * ks, lane);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * (warp >> 2) + 8 * j + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (warp & 3) + g + 8 * h;
        const float v0 = dense_bf16(acc[j][2 * h], b2s[col]);
        const float v1 = dense_bf16(acc[j][2 * h + 1], b2s[col + 1]);
        a2s[row * kLdA2 + col] = v0;
        a2s[row * kLdA2 + col + 1] = v1;
        if (row < tl.np)
          *reinterpret_cast<uint32_t*>(a2 + (tl.row0 + row) * kC2 + col) = pack_bf16(v0, v1);
      }
    }
    __syncthreads();
    if (!tl.valid) continue;
    float ts = 0.0f, tsq = 0.0f;
    for (int pp = 32 * half; pp < 32 * half + 32 && pp < tl.np; ++pp) {
      const float a = a2s[pp * kLdA2 + c];
      ts += a;
      tsq = fmaf(a, a, tsq);
    }
    add_c(s, cs, ts);
    add_c(q, cq, tsq);
  }
  __syncthreads();
  stats_to_shared(a2s, 2, kC2, half, c, s, cs, q, cq);
  stats_partial(a2s, 2, kC2, partial + blockIdx.x * 4 * kC2, kC2);
}

// ------------------------------------------- the D-wide passes on Hopper's wgmma
//
// Layer 3 (K 128, D columns) runs on the asynchronous warpgroup products:
// a block of two warpgroups takes 128-point tiles (warpgroup w rows 64 w..)
// across a group of 256 columns of W3, held in shared memory (64 KB of
// bf16) for the block's life. Operands sit in shared memory in the
// 128-byte swizzle that wgmma's descriptors name: a tile of R rows is
// stored as column blocks of 64 bf16 (128 bytes a row), R * 128 bytes each,
// 16-byte chunk c of row r at chunk c ^ (r % 8) (sw_off). Read along its
// rows it is a K-major operand; read down its columns (wgmma's transpose
// bit for 16-bit types) an MN-major one, the column blocks R * 128 bytes
// apart (the descriptor's leading byte offset) and 8-row groups 1024 bytes
// apart (its stride byte offset).

constexpr int kTileW = 128;                  // points a D-wide tile
constexpr int kGroupW = 256;                 // W3's columns a D-wide block holds
constexpr int kWarps = kThreads / 32;        // 8: warps w / 4 = warpgroup, w % 4 its 16 rows
constexpr int kW3Bytes = 2 * kGroupW * 128;  // W3's group [k block][column][64 k], 64 KB
constexpr int kH2Bytes = 2 * kTileW * 128;   // h2 [k block][point][64 k], 32 KB
constexpr int kRawBytes = kTileW * kC2 * 2;  // a2's tile as stored, [point][128], 32 KB
constexpr int kDa3Bytes = 4 * kTileW * 128;  // da3 [column block][point][64 columns], 64 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// byte offset of element (r, c) of a swizzled tile of R rows
__device__ __forceinline__ int sw_off(int r, int c, int R) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}
// a wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart, column blocks `lbo` bytes apart (MN-major operands)
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) | (64ull << 32) | (1ull << 62);
}
// k-step s (16 k) of a K-major operand: rows row0.. of a tile of R rows
__device__ __forceinline__ uint64_t k_major(uint32_t base, int R, int row0, int s) {
  return sw_desc(base + (s >> 2) * (R * 128) + row0 * 128 + (s & 3) * 32, 16);
}
// k-step s (16 rows) of an MN-major operand from column block `blk` of a
// tile of R rows
__device__ __forceinline__ uint64_t mn_major(uint32_t base, int R, int blk, int s) {
  return sw_desc(base + blk * (R * 128) + s * 2048, R * 128);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the generic proxy's shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the accumulators' reads and writes across
// the asynchronous products' issue and wait
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// D (64 x N, f32) (+)= A (64 x 16) B (16 x N), bf16 from shared memory;
// scale_d 0 starts the sum. _tb: B read MN-major; _tt: A and B both. The
// accumulators: warp w % 4 of the warpgroup holds rows 16 (w % 4) + lane / 4
// (+ 8: h = 1), d[4 j + 2 h + e] column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128_tb(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256_tt(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// a3's accumulators (before the bias) of the tile's rows 64 wg.. and the
// group's columns 128 half..: the one computation of a3, in every pass that
// needs it (the same instruction, operands and k order, so a3 and y3 are
// the same bits in the statistics, the max and the backward). Issues the
// eight k-steps as one product group; the caller waits for it.
__device__ __forceinline__ void layer3_issue(float (&acc)[64], uint32_t h2s, uint32_t w3s, int wg,
                                             int half) {
  zero_acc<64>(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kC2 / 16; ++s)
    wgmma_n128(acc, k_major(h2s, kTileW, 64 * wg, s), k_major(w3s, kGroupW, 128 * half, s), s);
  wgmma_commit();
}

// W3's columns g0.. (kGroupW of them, 0 past d) in bf16 into w3s: row =
// column, k = channel (layer 3's K-major B)
__device__ __forceinline__ void stage_w3(unsigned char* w3s, const float* prm, long long d,
                                         long long g0) {
  for (int i = threadIdx.x; i < kC2 * kGroupW; i += kThreads) {
    const int k = i / kGroupW, c = i % kGroupW;
    const float w = g0 + c < d ? prm[off_w3() + k * d + g0 + c] : 0.0f;
    *reinterpret_cast<uint16_t*>(w3s + sw_off(c, k, kGroupW)) = bf_bits(w);
  }
}

// Rounding to bf16 is a conversion, and the conversion unit's rate, not the
// FP32 one, bounds the epilogues: the D-wide passes round two values an
// instruction (cvt.rn.bf16x2.f32, the same round-to-nearest-even as
// bf_round) and pack rounded values by a byte permute.
// bf16(lo) in the low half, bf16(hi) in the high half
__device__ __forceinline__ uint32_t bf2_bits(float lo, float hi) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(hi), "f"(lo));
  return w;
}
__device__ __forceinline__ float lo_val(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_val(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// two values that are bf16 already, as one word (lo in the low half)
__device__ __forceinline__ uint32_t pack_rounded(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// bf_round of a pair
__device__ __forceinline__ void bf_round2(float& lo, float& hi) {
  const uint32_t w = bf2_bits(lo, hi);
  lo = lo_val(w);
  hi = hi_val(w);
}
// dense_bf16 of a pair: a_e = bf16(bf16(acc_e) + b_e)
__device__ __forceinline__ void dense2(float& a0, float& a1, float b0, float b1) {
  bf_round2(a0, a1);
  a0 = __fadd_rn(a0, b0);
  a1 = __fadd_rn(a1, b1);
  bf_round2(a0, a1);
}
// bn_bf16 before its rounding
__device__ __forceinline__ float bn_f32(float a, float mu, float mul, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(a, mu), mul), beta);
}

// BatchNorm 2's (mu, mul, beta) into shared memory, one 16-byte read a
// channel: channel k at bn2_at(k), 16 bytes of padding after every 8
// channels, so that the 8 lanes of a quarter-warp reading channels 8 apart
// (norm_h2) fall in different banks
constexpr int kBn2Floats = 4 * kC2 + 4 * (kC2 / 8);
__device__ __forceinline__ int bn2_at(int k) { return 4 * k + 4 * (k >> 3); }
__device__ __forceinline__ void load_bn2(float* bn2s, const float* prm, const float* stats) {
  for (int i = threadIdx.x; i < kC2; i += kThreads) {
    float* b = bn2s + bn2_at(i);
    b[0] = stats[kStats2 + i];
    b[1] = bn_mul_bf16(stats[kStats2 + kC2 + i], prm[off_l2() + kC2 + i]);
    b[2] = prm[off_l2() + 2 * kC2 + i];
    b[3] = 0.0f;
  }
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// a2's rows of a tile into raw ([point][128] bf16 as stored) by cp.async,
// 16 bytes a copy, rows past the tile's end zero-filled; one commit group
__device__ __forceinline__ void issue_a2(uint32_t raw, const uint16_t* a2, const Tile& tl) {
#pragma unroll
  for (int i = 0; i < kRawBytes / 16 / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads, row = v >> 4;
    const bool in = row < tl.np;
    cp_async16(raw + 16 * v, a2 + (in ? (tl.row0 + row) * kC2 + 8 * (v & 15) : 0), in ? 16 : 0);
  }
  cp_async_commit();
}

// h2 = relu(bn2(a2)) of the tile in raw into h2s (swizzled), rows past np
// 0 (bn2s: load_bn2's): thread t the channels 8 (t % 16).. of rows t / 16 +
// 16 i, 16 bytes a read and a write
__device__ __forceinline__ void norm_h2(unsigned char* h2s, const unsigned char* raw,
                                        const float* bn2s, int np) {
  const int c8 = threadIdx.x & 15;
  float4 bn[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bn[e] = ld4(bn2s + bn2_at(8 * c8 + e));
#pragma unroll
  for (int i = 0; i < kTileW / (kThreads / 16); ++i) {
    const int row = (threadIdx.x >> 4) + (kThreads / 16) * i;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + row * 2 * kC2 + 16 * c8);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b0 = bn[2 * q], b1 = bn[2 * q + 1];
      // relu on the pair: a bf16's sign is its 16-bit integer's
      w[q] = row < np ? __vmaxs2(bf2_bits(bn_f32(half_of(v, 2 * q), b0.x, b0.y, b0.z),
                                          bn_f32(half_of(v, 2 * q + 1), b1.x, b1.y, b1.z)),
                                 0u)
                      : 0u;
    }
    *reinterpret_cast<uint4*>(h2s + sw_off(row, 8 * c8, kTileW)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Sums over the 8 lanes of a fragment column (lane bits 2-4, the rows
// lane / 4): v[0..8) -> v[0], the sum for value 4 b2 + 2 b3 + b4 (b the
// lane's bits), each step sending half the values and keeping the other
// half (a fixed tree: the same bits every run)
template <int H>
__device__ __forceinline__ void fold_sum_step(float (&v)[8], int lane, int m) {
  const bool up = lane & m;
#pragma unroll
  for (int i = 0; i < H; ++i)
    v[i] = (up ? v[i + H] : v[i]) + __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + H], m);
}
__device__ __forceinline__ void fold_sum(float (&v)[8], int lane) {
  fold_sum_step<4>(v, lane, 4);
  fold_sum_step<2>(v, lane, 8);
  fold_sum_step<1>(v, lane, 16);
}
__device__ __forceinline__ int fold_index(int lane) {
  return 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 4) & 1);
}

// the max's merge of two partial results (the warps' of a tile, in row
// order): a larger maximum restarts the count and the tied points' sum of
// a3 - mu3, an equal one adds to them
__device__ __forceinline__ void merge_max(float& best, int& cnt, float& sum, float b2, int c2,
                                          float s2) {
  if (c2 == 0) return;
  if (cnt == 0 || b2 > best) {
    best = b2;
    cnt = c2;
    sum = s2;
  } else if (b2 == best) {
    cnt += c2;
    sum = __fadd_rn(sum, s2);
  }
}
// fold_sum's tree with the maximum in place of the sum
template <int H>
__device__ __forceinline__ void fold_fmax_step(float (&v)[8], int lane, int m) {
  const bool up = lane & m;
#pragma unroll
  for (int i = 0; i < H; ++i)
    v[i] = fmaxf(up ? v[i + H] : v[i], __shfl_xor_sync(0xffffffffu, up ? v[i] : v[i + H], m));
}
__device__ __forceinline__ void fold_fmax(float (&v)[8], int lane) {
  fold_fmax_step<4>(v, lane, 4);
  fold_fmax_step<2>(v, lane, 8);
  fold_fmax_step<1>(v, lane, 16);
}

// the next tile from `from` that a D-wide pass takes: every tile, or with
// `valid_only` the valid clouds' only (the same for every thread)
__device__ __forceinline__ long long next_tile(long long from, long long tiles, long long p,
                                               const uint8_t* valid, bool valid_only) {
  while (valid_only && from < tiles && !tile_of<kTileW>(from, p, valid).valid) from += gridDim.x;
  return from;
}

__host__ __device__ constexpr int l3_smem_bytes() {
  return 1024 + kW3Bytes + kH2Bytes + kRawBytes +
         4 * (4 * kGroupW + kBn2Floats + 3 * kWarps * kGroupW);
}

// grid (segments, column groups): layer 3 on the group of columns g0 = 256
// blockIdx.y.. for the 128-point tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...: a3 = bf16(bf16(h2 W3) + b3) (layer3_issue, two products of 128
// columns in flight, the first one's epilogue running while the second
// one's products do) and then, on the accumulators,
//   kMax false: the sums of a3 and a3^2 over the valid clouds' points ->
//               partial[segment][4][d] (sums and their errors);
//   kMax true:  y3 = bn3(a3) and, per tile and column, the largest y3, the
//               number of points that take it and the sum of their a3 -
//               mu3 -> pmax, pcnt, psum [tile][d]
// a thread's two rows, then the 8 lanes of its column by shuffles
// (fold_sum; the maximum by fold_fmax, its ties then counted and summed by
// fold_sum), then the 8 warps in row order through shared
// memory (thread t: column t). a2's next tile lands by cp.async while this
// one's products and epilogue run.
template <bool kMax>
__global__ void __launch_bounds__(kThreads, 1)
pnb_l3_kernel(const uint16_t* __restrict__ a2, const uint8_t* __restrict__ valid, long long n,
              long long p, long long d, const float* __restrict__ prm,
              const float* __restrict__ stats, float* __restrict__ partial,
              float* __restrict__ pmax, int* __restrict__ pcnt, float* __restrict__ psum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* w3s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* h2s = w3s + kW3Bytes;
  unsigned char* raw = h2s + kH2Bytes;
  float* col3 = reinterpret_cast<float*>(raw + kRawBytes);  // [256][4]: b3, mu3, mul3, beta3
  float* bn2s = col3 + 4 * kGroupW;  // mu2, mul2, beta2 (bn2_at)
  float* red = bn2s + kBn2Floats;    // [3][8 warps][256]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, wg = warp >> 2, tq = lane & 3;
  const long long g0 = static_cast<long long>(blockIdx.y) * kGroupW, c3 = g0 + t;
  stage_w3(w3s, prm, d, g0);
  const bool cin = c3 < d;
  col3[4 * t] = cin ? bf_round(prm[off_l3(d) + c3]) : 0.0f;
  col3[4 * t + 1] = cin && kMax ? stats[kStats3 + c3] : 0.0f;
  col3[4 * t + 2] =
      cin && kMax ? bn_mul_bf16(stats[kStats3 + d + c3], prm[off_l3(d) + d + c3]) : 0.0f;
  col3[4 * t + 3] = cin && kMax ? prm[off_l3(d) + 2 * d + c3] : 0.0f;
  load_bn2(bn2s, prm, stats);
  fence_proxy_async();  // W3 for the products (the loop's first barrier orders it)
  const uint32_t h2a = smem_addr(h2s), w3a = smem_addr(w3s), rawa = smem_addr(raw);
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's rows r0, r0 + 8
  const int fi = fold_index(lane);
  float s = 0.0f, q = 0.0f, cs = 0.0f, cq = 0.0f;  // column t's sums (kMax false)
  const long long tiles = n * ((p + kTileW - 1) / kTileW);
  long long tile = next_tile(blockIdx.x, tiles, p, valid, !kMax);
  if (tile < tiles) issue_a2(rawa, a2, tile_of<kTileW>(tile, p, valid));
  while (tile < tiles) {
    const Tile tl = tile_of<kTileW>(tile, p, valid);
    cp_async_wait_all();
    __syncthreads();  // a2 landed; the previous tile's products and merge done
    norm_h2(h2s, raw, bn2s, tl.np);
    fence_proxy_async();
    __syncthreads();
    const long long next = next_tile(tile + gridDim.x, tiles, p, valid, !kMax);
    if (next < tiles) issue_a2(rawa, a2, tile_of<kTileW>(next, p, valid));
    float acc[2][64];
    layer3_issue(acc[0], h2a, w3a, wg, 0);
    layer3_issue(acc[1], h2a, w3a, wg, 1);
    const bool lo_in = r0 < tl.np, hi_in = r0 + 8 < tl.np;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 0) {
        wgmma_wait<1>();
        fence_acc<64>(acc[0]);
      } else {
        wgmma_wait<0>();
        fence_acc<64>(acc[1]);
      }
#pragma unroll
      for (int jc = 0; jc < 4; ++jc) {  // four column octets a round: 8 columns of the thread
        float v0[8], v1[8], yl[8], yh[8], xl[8], xh[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * jc + jj, c = 128 * half + 8 * j + 2 * tq, i = 2 * jj;
          // columns c, c + 1 (b3, mu3, mul3, beta3), rows r0 and r0 + 8
          const float4 p0 = ld4(col3 + 4 * c), p1 = ld4(col3 + 4 * (c + 1));
          float lo0 = acc[half][4 * j], lo1 = acc[half][4 * j + 1];
          float hi0 = acc[half][4 * j + 2], hi1 = acc[half][4 * j + 3];
          dense2(lo0, lo1, p0.x, p1.x);
          dense2(hi0, hi1, p0.x, p1.x);
          if (!kMax) {
            const float x0 = lo_in ? lo0 : 0.0f, y0 = hi_in ? hi0 : 0.0f;
            const float x1 = lo_in ? lo1 : 0.0f, y1 = hi_in ? hi1 : 0.0f;
            v0[i] = x0 + y0;
            v1[i] = fmaf(y0, y0, x0 * x0);
            v0[i + 1] = x1 + y1;
            v1[i + 1] = fmaf(y1, y1, x1 * x1);
          } else {
            yl[i] = bn_f32(lo0, p0.y, p0.z, p0.w);
            yl[i + 1] = bn_f32(lo1, p1.y, p1.z, p1.w);
            yh[i] = bn_f32(hi0, p0.y, p0.z, p0.w);
            yh[i + 1] = bn_f32(hi1, p1.y, p1.z, p1.w);
            bf_round2(yl[i], yl[i + 1]);
            bf_round2(yh[i], yh[i + 1]);
            xl[i] = __fsub_rn(lo0, p0.y);
            xl[i + 1] = __fsub_rn(lo1, p1.y);
            xh[i] = __fsub_rn(hi0, p0.y);
            xh[i + 1] = __fsub_rn(hi1, p1.y);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v0[i + e] = fmaxf(lo_in ? yl[i + e] : -CUDART_INF_F,
                                hi_in ? yh[i + e] : -CUDART_INF_F);
          }
        }
        const int col = 128 * half + 8 * (4 * jc + (fi >> 1)) + 2 * tq + (fi & 1);
        if (!kMax) {
          fold_sum(v0, lane);
          fold_sum(v1, lane);
          red[warp * kGroupW + col] = v0[0];
          red[(kWarps + warp) * kGroupW + col] = v1[0];
        } else {
          // the warp's maximum of each column, back to the lanes that hold
          // the column; then the rows that reach it, counted and their a3 -
          // mu3 summed
          fold_fmax(v0, lane);
          float cnt[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float m = __shfl_sync(0xffffffffu, v0[0], (lane & 3) | ((i & 4) << 0) |
                                                                ((i & 2) << 2) | ((i & 1) << 4));
            const bool tl = lo_in && yl[i] == m, th = hi_in && yh[i] == m;
            cnt[i] = (tl ? 1.0f : 0.0f) + (th ? 1.0f : 0.0f);
            v1[i] = (tl ? xl[i] : 0.0f) + (th ? xh[i] : 0.0f);
          }
          fold_sum(cnt, lane);
          fold_sum(v1, lane);
          red[warp * kGroupW + col] = v0[0];
          reinterpret_cast<int*>(red)[(kWarps + warp) * kGroupW + col] = static_cast<int>(cnt[0]);
          red[(2 * kWarps + warp) * kGroupW + col] = v1[0];
        }
      }
    }
    __syncthreads();
    // thread t: column t's tile result, the warps in row order
    if (!kMax) {
      if (tl.valid) {
        float ts = red[t], tsq = red[kWarps * kGroupW + t];
        for (int w = 1; w < kWarps; ++w) {
          ts += red[w * kGroupW + t];
          tsq += red[(kWarps + w) * kGroupW + t];
        }
        add_c(s, cs, ts);
        add_c(q, cq, tsq);
      }
    } else if (cin) {
      float best = red[t], sum = red[2 * kWarps * kGroupW + t];
      int cnt = reinterpret_cast<const int*>(red)[kWarps * kGroupW + t];
      for (int w = 1; w < kWarps; ++w)
        merge_max(best, cnt, sum, red[w * kGroupW + t],
                  reinterpret_cast<const int*>(red)[(kWarps + w) * kGroupW + t],
                  red[(2 * kWarps + w) * kGroupW + t]);
      pmax[tile * d + c3] = best;
      pcnt[tile * d + c3] = cnt;
      psum[tile * d + c3] = sum;
    }
    tile = next;
  }
  if (!kMax && cin) {
    float* part = partial + static_cast<long long>(blockIdx.x) * 4 * d + c3;
    part[0] = s;
    part[d] = q;
    part[2 * d] = cs;
    part[3 * d] = cq;
  }
}

// out[n, c] (bf16), count[n, c] and tsum[n, c]: the cloud's tiles merged
// in order by pnb_l3_kernel<true>'s rule
__global__ void __launch_bounds__(kThreads)
pnb_max_reduce_kernel(const float* __restrict__ pmax, const int* __restrict__ pcnt,
                      const float* __restrict__ psum, long long n, long long tpc, long long d,
                      uint16_t* __restrict__ out, int* __restrict__ count,
                      float* __restrict__ tsum) {
  const long long total = n * d;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long base = (i / d) * tpc * d + i % d;
    float best = pmax[base], sum = psum[base];
    int cnt = pcnt[base];
    for (long long tt = 1; tt < tpc; ++tt) {
      const float v = pmax[base + tt * d];
      if (v > best) {
        best = v;
        cnt = pcnt[base + tt * d];
        sum = psum[base + tt * d];
      } else if (v == best) {
        cnt += pcnt[base + tt * d];
        sum = __fadd_rn(sum, psum[base + tt * d]);
      }
    }
    out[i] = bf_bits(best);
    count[i] = cnt;
    tsum[i] = sum;
  }
}

// BatchNorm's backward coefficients from sdy = sum dy and sdyx = sum dy (a
// - mu) over every point (f64): the gradient of the input a at a valid
// cloud's point is bf16(dy mul) + bf16(A + B a) (two bf16 cotangents, as
// JAX's two widenings of a give them), at a padded cloud's bf16(dy mul);
// dgamma = sdyx r, dbeta = sdy
__device__ __forceinline__ void bn_back_coef(double sdy, double sdyx, float mu, float var,
                                             float gamma, double m, float* coef, long long c,
                                             long long ch, float* dgamma_beta) {
  const double r = 1.0 / sqrt(static_cast<double>(var) + kEps);
  const double dvar = var > 0.0f ? -0.5 * sdyx * static_cast<double>(gamma) * r * r * r : 0.0;
  const float mul = bn_mul_bf16(var, gamma);
  coef[c] = mul;
  coef[ch + c] = static_cast<float>((-sdy * mul - 2.0 * static_cast<double>(mu) * dvar) / m);
  coef[2 * ch + c] = static_cast<float>(2.0 * dvar / m);
  dgamma_beta[c] = static_cast<float>(sdyx * r);
  dgamma_beta[ch + c] = static_cast<float>(sdy);
}

// the gradient of a BatchNorm input at one point: dy the output's (f32 of
// a bf16 cotangent), a the input, coef (mul, A, B) at column c of ch
__device__ __forceinline__ float bn_back_bf16(float dy, float a, bool in_stats, const float* coef,
                                              int c, int ch) {
  const float t1 = bf_round(__fmul_rn(dy, coef[c]));
  const float t2 = in_stats ? bf_round(fmaf(coef[2 * ch + c], a, coef[ch + c])) : 0.0f;
  return bf_round(__fadd_rn(t1, t2));
}

// per channel c of layer 3: gk[n][c] = bf16(g / count), JAX's even split
// of a tied maximum; sdy = sum_n count gk and sdyx = sum_n gk tsum (every
// cloud) -> dgamma3, dbeta3 and the coefficients (mul, A, B) [3][d]; and
// W3 in bf16, (128, d), for dh2
__global__ void __launch_bounds__(kThreads)
pnb_bn3_kernel(const uint16_t* __restrict__ g, const int* __restrict__ count,
               const float* __restrict__ tsum, const uint8_t* __restrict__ valid, long long n,
               long long p, long long d, const float* __restrict__ prm,
               const float* __restrict__ stats, float* __restrict__ grads, float* __restrict__ gk,
               float* __restrict__ coef, uint16_t* __restrict__ w3b) {
  __shared__ long long m_s;
  if (threadIdx.x == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; c < d;
       c += static_cast<long long>(gridDim.x) * kThreads) {
    double sdy = 0.0, sdyx = 0.0;
    for (long long i = 0; i < n; ++i) {
      const int k = count[i * d + c];
      const float gv = bf_round(__fdiv_rn(bf_val(g[i * d + c]), static_cast<float>(k)));
      gk[i * d + c] = gv;
      sdy += static_cast<double>(k) * gv;
      sdyx += static_cast<double>(gv) * tsum[i * d + c];
    }
    bn_back_coef(sdy, sdyx, stats[kStats3 + c], stats[kStats3 + d + c], prm[off_l3(d) + d + c],
                 static_cast<double>(m_s), coef, c, d, grads + off_l3(d) + d);
    if (w3b != nullptr)
      for (int k = 0; k < kC2; ++k) w3b[k * d + c] = bf_bits(prm[off_w3() + k * d + c]);
  }
}

__host__ __device__ constexpr int l3back_smem_bytes() {
  return 1024 + kW3Bytes + kH2Bytes + kRawBytes + kDa3Bytes +
         4 * (8 * kGroupW + kBn2Floats + 2 * kWarps * kGroupW);
}

// grid (segments, column groups), every tile (padded clouds' too): a3 and
// y3 recomputed by layer3_issue, one 128-column product at a time; on the
// accumulators dy = gk at each point whose y3 equals the cloud's maximum
// (out), 0 elsewhere, and da3 = BN3's backward (bf16) into shared memory
// (swizzled, the next products' operand); db3 by fold_sum; then
// dW3 += h2^T da3 (wgmma m64n256k16, both operands read down their columns:
// warpgroup w channels 64 w.., all 256 columns, 128 accumulators a thread
// held over the block's tiles). kFused (one column group, D <= 256): dh2 =
// da3 W3^T in the same block (wgmma m64n128k16 over the 256 columns, W3
// read down its columns), rounded to bf16; dy2 = dh2 where h2 > 0 (a2 read
// again, from L2), stored; BN2's sums of dy2 and dy2 (a2 - mu2) ->
// partial2[segment][2][128]: da3 never reaches device memory. Otherwise
// da3 is stored (n * p, d) for pnb_dh2_kernel. dW3, db3 ->
// partial[segment][129][d].
template <bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
pnb_l3_back_kernel(const uint16_t* __restrict__ a2, const uint8_t* __restrict__ valid,
                   long long n, long long p, long long d, const float* __restrict__ prm,
                   const float* __restrict__ stats, const uint16_t* __restrict__ out,
                   const float* __restrict__ gk, const float* __restrict__ coef,
                   uint16_t* __restrict__ da3, uint16_t* __restrict__ dy2,
                   float* __restrict__ partial, float* __restrict__ partial2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* w3s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* h2s = w3s + kW3Bytes;
  unsigned char* raw = h2s + kH2Bytes;
  unsigned char* das = raw + kRawBytes;
  // [256][8]: b3, mu3, mul3, beta3, A3, B3 (BN3's backward), the tile's
  // cloud's out and bf16(gk mul3); then BN2's (mu, mul, beta) (bn2_at); then the
  // warps' sums [2][8][256]: db3, BN2's (dy2, dy2 (a2 - mu2))
  float* col3 = reinterpret_cast<float*>(das + kDa3Bytes);
  float* bn2s = col3 + 8 * kGroupW;
  float* red = bn2s + kBn2Floats;
  float* red2 = red + kWarps * kGroupW;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, wg = warp >> 2, tq = lane & 3;
  const long long g0 = static_cast<long long>(blockIdx.y) * kGroupW, c3 = g0 + t;
  stage_w3(w3s, prm, d, g0);
  const bool cin = c3 < d;
  const int dlim = static_cast<int>(d - g0 < kGroupW ? d - g0 : kGroupW);  // the group's columns
  col3[8 * t] = cin ? bf_round(prm[off_l3(d) + c3]) : 0.0f;
  col3[8 * t + 1] = cin ? stats[kStats3 + c3] : 0.0f;
  col3[8 * t + 2] = cin ? coef[c3] : 0.0f;
  col3[8 * t + 3] = cin ? prm[off_l3(d) + 2 * d + c3] : 0.0f;
  col3[8 * t + 4] = cin ? coef[d + c3] : 0.0f;
  col3[8 * t + 5] = cin ? coef[2 * d + c3] : 0.0f;
  load_bn2(bn2s, prm, stats);
  fence_proxy_async();
  const uint32_t h2a = smem_addr(h2s), w3a = smem_addr(w3s), rawa = smem_addr(raw),
                 daa = smem_addr(das);
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's rows r0, r0 + 8
  const int fi = fold_index(lane);
  float dw[128];  // dW3: channel 64 wg + 16 (warp % 4) + lane / 4 (+ 8), column 8 j + 2 tq + e
  zero_acc<128>(dw);
  float db = 0.0f, sbn = 0.0f;  // thread t: db3 of column t; BN2's sum t of [2][128]
  const long long tiles = n * ((p + kTileW - 1) / kTileW);
  // the next tile's a2 by cp.async and its cloud's out and gk (column t) into registers
  float out_next = 0.0f, gk_next = 0.0f;
  auto prefetch = [&](long long tile) {
    const Tile tn = tile_of<kTileW>(tile, p, valid);
    issue_a2(rawa, a2, tn);
    out_next = cin ? bf_val(out[tn.cloud * d + c3]) : 0.0f;
    gk_next = cin ? gk[tn.cloud * d + c3] : 0.0f;
  };
  if (blockIdx.x < tiles) prefetch(blockIdx.x);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of<kTileW>(tile, p, valid);
    cp_async_wait_all();
    __syncthreads();  // a2 landed; the previous tile's products and sums done
    if (kFused && tile != blockIdx.x) {  // the previous tile's BN2 sums
      float v = red2[t];
      for (int w = 1; w < kWarps; ++w) v += red2[w * 2 * kC2 + t];
      sbn += v;
    }
    norm_h2(h2s, raw, bn2s, tl.np);
    col3[8 * t + 6] = out_next;
    col3[8 * t + 7] = bf_round(__fmul_rn(gk_next, col3[8 * t + 2]));
    fence_proxy_async();
    __syncthreads();
    if (tile + gridDim.x < tiles) prefetch(tile + gridDim.x);
    const bool lo_in = r0 < tl.np, hi_in = r0 + 8 < tl.np;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float acc[64];
      layer3_issue(acc, h2a, w3a, wg, half);
      wgmma_wait<0>();
      fence_acc<64>(acc);
#pragma unroll
      for (int jc = 0; jc < 4; ++jc) {
        float sd[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * jc + jj, c = 128 * half + 8 * j + 2 * tq;
          // columns c, c + 1: b3, mu3, mul3, beta3 | A3, B3, out, bf16(gk mul3)
          float4 p[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e][0] = ld4(col3 + 8 * (c + e));
            p[e][1] = ld4(col3 + 8 * (c + e) + 4);
          }
          float da[2][2];  // [row h][column e]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float a[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]}, y[2], t2[2], v[2];
            dense2(a[0], a[1], p[0][0].x, p[1][0].x);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              y[e] = bn_f32(a[e], p[e][0].y, p[e][0].z, p[e][0].w);
              t2[e] = fmaf(p[e][1].y, a[e], p[e][1].x);
            }
            bf_round2(y[0], y[1]);
            bf_round2(t2[0], t2[1]);
            // bf16(dy mul) + bf16(A + B a), dy = gk where y3 reaches the
            // maximum, else 0: bf16(dy mul) is bf16(gk mul) or 0 mul, per
            // column
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = __fadd_rn(y[e] == p[e][1].z ? p[e][1].w : __fmul_rn(0.0f, p[e][0].z),
                               tl.valid ? t2[e] : 0.0f);
            uint32_t w = bf2_bits(v[0], v[1]);
            const int row = r0 + 8 * h;
            if (!(h ? hi_in : lo_in)) w = 0u;
            if (c + 1 >= dlim) w = c < dlim ? w & 0xffffu : 0u;
            *reinterpret_cast<uint32_t*>(das + sw_off(row, c, kTileW)) = w;
            if (!kFused && row < tl.np && c < dlim)
              *reinterpret_cast<uint32_t*>(da3 + (tl.row0 + row) * d + g0 + c) = w;
            da[h][0] = lo_val(w);
            da[h][1] = hi_val(w);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) sd[2 * jj + e] = da[0][e] + da[1][e];
        }
        fold_sum(sd, lane);
        red[warp * kGroupW + 128 * half + 8 * (4 * jc + (fi >> 1)) + 2 * tq + (fi & 1)] = sd[0];
      }
    }
    fence_proxy_async();
    __syncthreads();  // da3's tile and the warps' db3 sums complete
    {
      float v = red[t];
      for (int w = 1; w < kWarps; ++w) v += red[w * kGroupW + t];
      db += v;
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTileW / 16; ++s)
      wgmma_n256_tt(dw, mn_major(h2a, kTileW, wg, s), mn_major(daa, kTileW, 0, s), 1);
    wgmma_commit();
    if (!kFused) {
      wgmma_wait<0>();
      fence_acc<128>(dw);
      continue;
    }
    float dh[64];
    zero_acc<64>(dh);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kGroupW / 16; ++s)
      wgmma_n128_tb(dh, k_major(daa, kTileW, 64 * wg, s), mn_major(w3a, kGroupW, 0, s), s);
    wgmma_commit();
    // a2 at the thread's rows and channels read again (from L2), four
    // column octets ahead of their use: the first ones while the products run
    uint32_t aw_next[4][2];
    auto a2_words = [&](int jc) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          aw_next[jj][h] = (h ? hi_in : lo_in) ? *reinterpret_cast<const uint32_t*>(
                                                     a2 + (tl.row0 + r0 + 8 * h) * kC2 +
                                                     8 * (4 * jc + jj) + 2 * tq)
                                               : 0u;
    };
    a2_words(0);
    wgmma_wait<0>();
    fence_acc<128>(dw);
    fence_acc<64>(dh);
    // dy2 and BN2's sums: channel 8 j + 2 tq + e of rows r0, r0 + 8
#pragma unroll
    for (int jc = 0; jc < 4; ++jc) {
      float u[8], v[8];
      uint32_t aws[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) aws[jj][0] = aw_next[jj][0], aws[jj][1] = aw_next[jj][1];
      if (jc < 3) a2_words(jc + 1);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jc + jj, c = 8 * j + 2 * tq;
        const uint32_t(&aw)[2] = aws[jj];
        const float4 b0 = ld4(bn2s + bn2_at(c)), b1 = ld4(bn2s + bn2_at(c + 1));  // mu, mul, beta
        float dy[2][2], x[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a0 = lo_val(aw[h]), a1 = hi_val(aw[h]);
          // dy2 = bf16(dh2) where y2 > 0: a bf16 is positive where its
          // 16-bit integer is
          const uint32_t y = bf2_bits(bn_f32(a0, b0.x, b0.y, b0.z), bn_f32(a1, b1.x, b1.y, b1.z));
          uint32_t w = bf2_bits(dh[4 * j + 2 * h], dh[4 * j + 2 * h + 1]) & __vcmpgts2(y, 0u);
          if (!(h ? hi_in : lo_in)) w = 0u;
          else
            *reinterpret_cast<uint32_t*>(dy2 + (tl.row0 + r0 + 8 * h) * kC2 + c) = w;
          dy[h][0] = lo_val(w);
          dy[h][1] = hi_val(w);
          x[h][0] = __fsub_rn(a0, b0.x);
          x[h][1] = __fsub_rn(a1, b1.x);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          u[2 * jj + e] = dy[0][e] + dy[1][e];
          v[2 * jj + e] = fmaf(dy[1][e], x[1][e], dy[0][e] * x[0][e]);
        }
      }
      fold_sum(u, lane);
      fold_sum(v, lane);
      const int ch = 8 * (4 * jc + (fi >> 1)) + 2 * tq + (fi & 1);
      red2[warp * 2 * kC2 + ch] = u[0];
      red2[warp * 2 * kC2 + kC2 + ch] = v[0];
    }
  }
  if (kFused) {
    __syncthreads();
    if (blockIdx.x < tiles) {
      float v = red2[t];
      for (int w = 1; w < kWarps; ++w) v += red2[w * 2 * kC2 + t];
      sbn += v;
    }
    partial2[static_cast<long long>(blockIdx.x) * 2 * kC2 + t] = sbn;
  }
  float* part = partial + static_cast<long long>(blockIdx.x) * kL3Rows * d;
#pragma unroll
  for (int j = 0; j < kGroupW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long c = g0 + 8 * j + 2 * tq + (e & 1);
      if (c < d) part[(r0 + 8 * (e >> 1)) * d + c] = dw[4 * j + e];
    }
  if (cin) part[kC2 * d + c3] = db;
}

// dh2 = da3 W3^T on the tensor cores (K = d; warp w: points 16 (w % 4)..,
// channels 64 (w / 4) + 8 j..), rounded to bf16; dy2 = dh2 where h2 > 0,
// stored; sums of dy2 and dy2 (a2 - mu2) over every point ->
// partial[block][2][128]
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
pnb_dh2_kernel(const uint16_t* __restrict__ da3, const uint16_t* __restrict__ w3b,
               const uint16_t* __restrict__ a2, long long n, long long p, long long d,
               const float* __restrict__ prm, const float* __restrict__ stats,
               uint16_t* __restrict__ dy2, float* __restrict__ partial) {
  __shared__ float bn2[3 * kC2];
  __shared__ float red[4][2][kC2];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane >> 2, tq = lane & 3;
  // kStaged: W3 (bf16, [c][k]) held in shared memory, rows d + 8 apart (the
  // 8 rows a b-fragment reads then fall in different banks); else read
  // from L2 for each tile
  const uint16_t* w3 = w3b;
  long long ldw = d;
  if (kStaged) {
    uint16_t* w3s = reinterpret_cast<uint16_t*>(smem_raw);
    for (long long i = t; i < kC2 * d / 8; i += kThreads) {
      const long long row = i / (d / 8), col = 8 * (i % (d / 8));
      *reinterpret_cast<uint4*>(w3s + row * (d + 8) + col) =
          *reinterpret_cast<const uint4*>(w3b + row * d + col);
    }
    w3 = w3s;
    ldw = d + 8;
  }
  for (int i = t; i < kC2; i += kThreads) {
    bn2[i] = stats[kStats2 + i];
    bn2[kC2 + i] = bn_mul_bf16(stats[kStats2 + kC2 + i], prm[off_l2() + kC2 + i]);
    bn2[2 * kC2 + i] = prm[off_l2() + 2 * kC2 + i];
  }
  __syncthreads();
  float sdy[8][2], sdyx[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) sdy[j][0] = sdy[j][1] = sdyx[j][0] = sdyx[j][1] = 0.0f;
  const int r0 = 16 * (warp & 3) + g;  // the thread's rows r0 and r0 + 8
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, nullptr);
    const bool lo = r0 < tl.np, hi = r0 + 8 < tl.np;
    const uint16_t* rlo = da3 + (tl.row0 + r0) * d + 2 * tq;
    const uint16_t* rhi = rlo + 8 * d;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (long long k1 = 0; k1 < d; k1 += 64) {  // four k-steps, their loads first
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const long long k0 = k1 + 16 * s;
        a[s][0] = lo ? word(rlo + k0) : 0u;
        a[s][1] = hi ? word(rhi + k0) : 0u;
        a[s][2] = lo ? word(rlo + k0 + 8) : 0u;
        a[s][3] = hi ? word(rhi + k0 + 8) : 0u;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t b[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          load_b(b[j][0], b[j][1], w3, ldw, 64 * (warp >> 2) + 8 * j,
                 static_cast<int>(k1) + 16 * s, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a[s], b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= tl.np) continue;
        const int col = 64 * (warp >> 2) + 8 * j + 2 * tq;
        const uint32_t aw = word(a2 + (tl.row0 + row) * kC2 + col);
        float dy[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          const float a = bf_val(static_cast<uint16_t>(aw >> (16 * e)));
          const float y = bn_bf16(a, bn2[c], bn2[kC2 + c], bn2[2 * kC2 + c]);
          dy[e] = y > 0.0f ? bf_round(acc[j][2 * h + e]) : 0.0f;
          sdy[j][e] += dy[e];
          sdyx[j][e] = fmaf(dy[e], __fsub_rn(a, bn2[c]), sdyx[j][e]);
        }
        *reinterpret_cast<uint32_t*>(dy2 + (tl.row0 + row) * kC2 + col) = pack_bf16(dy[0], dy[1]);
      }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float u = sdy[j][e], v = sdyx[j][e];
      for (int o = 4; o < 32; o <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (g == 0) {
        red[warp & 3][0][64 * (warp >> 2) + 8 * j + 2 * tq + e] = u;
        red[warp & 3][1][64 * (warp >> 2) + 8 * j + 2 * tq + e] = v;
      }
    }
  __syncthreads();
  const int which = t / kC2, c = t % kC2;
  partial[blockIdx.x * 2 * kC2 + t] =
      red[0][which][c] + red[1][which][c] + red[2][which][c] + red[3][which][c];
}

// per channel of a BatchNorm of width ch: the blocks' sums of dy and dy (a
// - mu) (partial[b * stride + offset + ...], [2][ch]) in block order ->
// dgamma, dbeta (at dgb) and the coefficients (mul, A, B) [3][ch]
__global__ void __launch_bounds__(kThreads)
pnb_bn_back_kernel(const float* __restrict__ partial, int blocks, long long stride,
                   long long offset, long long ch, const float* __restrict__ mu_var,
                   const float* __restrict__ gamma, const uint8_t* __restrict__ valid, long long n,
                   long long p, float* __restrict__ dgb, float* __restrict__ coef) {
  __shared__ long long m_s;
  if (threadIdx.x == 0) m_s = valid_points(valid, n, p);
  __syncthreads();
  for (long long c = threadIdx.x; c < ch; c += kThreads) {
    double sdy = 0.0, sdyx = 0.0;
    for (int b = 0; b < blocks; ++b) {
      sdy += partial[b * stride + offset + c];
      sdyx += partial[b * stride + offset + ch + c];
    }
    bn_back_coef(sdy, sdyx, mu_var[c], mu_var[ch + c], gamma[c], static_cast<double>(m_s), coef, c,
                 ch, dgb);
  }
}

__host__ __device__ constexpr int l2back_smem_bytes() {
  return 2 * (kC1 * kLdB + kC1 * kLdB64 + kTileP * kLdB + kC2 * kLdB64) +
         4 * (3 * kC2 + 3 * kC1 + 2 * 4 * kC1);
}

// BN2's backward: da2 (bf16) from dy2 and coef2; dW2 += h1^T da2 (warp w:
// channels 16 (w % 4).. of h1, 64 (w / 4) + 8 j.. of a2) and db2 += sum da2;
// dh1 = da2 W2^T (warp w: points 16 (w % 4).., channels 32 (w / 4) + 8 j..),
// rounded; dy1 = dh1 where h1 > 0, stored; the sums of dy1 and dy1 (a1 -
// mu1) over every point -> partial[block][kB2Partial]
__global__ void __launch_bounds__(kThreads)
pnb_l2_back_kernel(const uint16_t* __restrict__ a1, const uint16_t* __restrict__ a2,
                   const uint16_t* __restrict__ dy2, const uint8_t* __restrict__ valid,
                   long long n, long long p, const float* __restrict__ prm,
                   const float* __restrict__ stats, const float* __restrict__ coef2,
                   uint16_t* __restrict__ dy1, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem_raw);  // [64][kLdB]: W2 [in][out]
  uint16_t* h1t = w2s + kC1 * kLdB;                       // [64][kLdB64]: h1 [k][p]
  uint16_t* das = h1t + kC1 * kLdB64;                     // [64][kLdB]: da2 [p][c]
  uint16_t* dat = das + kTileP * kLdB;                    // [128][kLdB64]: da2 [c][p]
  float* cf2 = reinterpret_cast<float*>(dat + kC2 * kLdB64);  // [3][128]: mul, A, B
  float* bn1 = cf2 + 3 * kC2;                             // [3][64]: mu, mul, beta
  float* red = bn1 + 3 * kC1;                             // [4][2][64]
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane >> 2, tq = lane & 3;
  for (int i = t; i < kC1 * kC2; i += kThreads)
    w2s[(i / kC2) * kLdB + i % kC2] = bf_bits(prm[off_w2() + i]);
  for (int i = t; i < 3 * kC2; i += kThreads) cf2[i] = coef2[i];
  for (int i = t; i < kC1; i += kThreads) {
    bn1[i] = stats[kStats1 + i];
    bn1[kC1 + i] = bn_mul_bf16(stats[kStats1 + kC1 + i], prm[off_l1() + kC1 + i]);
    bn1[2 * kC1 + i] = prm[off_l1() + 2 * kC1 + i];
  }
  float dw[8][4], s1[4][2], s1x[4][2], db = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) s1[j][0] = s1[j][1] = s1x[j][0] = s1x[j][1] = 0.0f;
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();  // the operands stored; the previous tile read
    {
      constexpr int kPer = kTileP * kC2 / 8 / kThreads;
      uint4 rdy[kPer], ra[kPer];
      load_rows<kC2, false>(rdy, dy2, tl);
      load_rows<kC2, false>(ra, a2, tl);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int pp, c0;
        vector_of<kC2, false>(j, pp, c0);
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float da[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            da[e] = pp < tl.np ? bn_back_bf16(half_of(rdy[j], 2 * q + e), half_of(ra[j], 2 * q + e),
                                              tl.valid, cf2, c0 + 2 * q + e, kC2)
                               : 0.0f;
          w[q] = pack_bf16(da[0], da[1]);
        }
        *reinterpret_cast<uint4*>(das + pp * kLdB + c0) = make_uint4(w[0], w[1], w[2], w[3]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dat[(c0 + e) * kLdB64 + pp] = static_cast<uint16_t>(w[e / 2] >> (16 * (e & 1)));
      }
    }
    load_h<kC1>(nullptr, 0, h1t, a1, tl, bn1);
    __syncthreads();
    if (t < kC2) {
      float ts = 0.0f;
      for (int pp = 0; pp < kTileP; ++pp) ts += bf_val(dat[t * kLdB64 + pp]);
      db += ts;
    }
#pragma unroll
    for (int ks = 0; ks < kTileP / 16; ++ks) {
      uint32_t a[4];
      load_a(a, h1t, kLdB64, 16 * (warp & 3), 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, dat, kLdB64, 64 * (warp >> 2) + 8 * j, 16 * ks, lane);
        mma_bf16(dw[j], a, b0, b1);
      }
    }
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kC2 / 16; ++ks) {
      uint32_t a[4];
      load_a(a, das, kLdB, 16 * (warp & 3), 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, w2s, kLdB, 32 * (warp >> 2) + 8 * j, 16 * ks, lane);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (warp & 3) + g + 8 * h;
        if (row >= tl.np) continue;
        const int col = 32 * (warp >> 2) + 8 * j + 2 * tq;
        float dy[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = col + e;
          dy[e] = bf_val(h1t[k * kLdB64 + row]) > 0.0f ? bf_round(acc[j][2 * h + e]) : 0.0f;
          const float a = bf_val(a1[(tl.row0 + row) * kC1 + k]);
          s1[j][e] += dy[e];
          s1x[j][e] = fmaf(dy[e], __fsub_rn(a, bn1[k]), s1x[j][e]);
        }
        *reinterpret_cast<uint32_t*>(dy1 + (tl.row0 + row) * kC1 + col) = pack_bf16(dy[0], dy[1]);
      }
  }
  float* part = partial + static_cast<long long>(blockIdx.x) * kB2Partial;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(16 * (warp & 3) + g + 8 * (e >> 1)) * kC2 + 64 * (warp >> 2) + 8 * j + 2 * tq +
           (e & 1)] = dw[j][e];
  if (t < kC2) part[kC1 * kC2 + t] = db;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float u = s1[j][e], v = s1x[j][e];
      for (int o = 4; o < 32; o <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (g == 0) {
        const int k = 32 * (warp >> 2) + 8 * j + 2 * tq + e;
        red[((warp & 3) * 2) * kC1 + k] = u;
        red[((warp & 3) * 2 + 1) * kC1 + k] = v;
      }
    }
  __syncthreads();
  if (t < 2 * kC1) {
    const int which = t / kC1, k = t % kC1;
    part[kC1 * kC2 + kC2 + t] = red[which * kC1 + k] + red[(2 + which) * kC1 + k] +
                                red[(4 + which) * kC1 + k] + red[(6 + which) * kC1 + k];
  }
}

// BN1's backward: da1 (bf16) from dy1 and coef1; dW1 = x^T da1 and db1 =
// sum da1 -> partial[block][4][64], as pnt_b3_kernel's
__global__ void __launch_bounds__(kThreads)
pnb_l1_back_kernel(const uint16_t* __restrict__ points, const uint16_t* __restrict__ a1,
                   const uint16_t* __restrict__ dy1, const uint8_t* __restrict__ valid,
                   long long n, long long p, const float* __restrict__ coef1,
                   float* __restrict__ partial) {
  __shared__ float xs[3 * kTileP];
  __shared__ float red[4][4][kC1];
  __shared__ float cf1[3 * kC1];
  const int t = threadIdx.x, k = t % kC1, pg = t / kC1;
  if (t < 3 * kC1) cf1[t] = coef1[t];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();
    if (t < 3 * kTileP) xs[t] = t < 3 * tl.np ? bf_val(points[3 * tl.row0 + t]) : 0.0f;
    __syncthreads();
    for (int i = 0; i < 16; ++i) {
      const int pp = 16 * pg + i;
      if (pp >= tl.np) break;
      const long long at = (tl.row0 + pp) * kC1 + k;
      const float da = bn_back_bf16(bf_val(dy1[at]), bf_val(a1[at]), tl.valid, cf1, k, kC1);
      const float* x = xs + 3 * pp;
      acc[0] = fmaf(x[0], da, acc[0]);
      acc[1] = fmaf(x[1], da, acc[1]);
      acc[2] = fmaf(x[2], da, acc[2]);
      acc[3] += da;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[j][pg][k] = acc[j];
  __syncthreads();
  partial[blockIdx.x * 4 * kC1 + t] = sum_groups(&red[t / kC1][0][0], 4, kC1, t % kC1);
}

// out[e] = bf16(sum over blocks b, in order, of partial[b * stride + e]):
// a cast parameter's gradient, a bf16 value as JAX's is
__global__ void __launch_bounds__(kThreads)
pnb_sum_round_kernel(const float* __restrict__ partial, int blocks, long long stride,
                     long long count, float* __restrict__ out) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < count;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += partial[b * stride + e];
    out[e] = bf_round(s);
  }
}

// ------------------------------------------------------------- host side

long long tiles_of(long long n, long long p) { return n * ((p + kTileP - 1) / kTileP); }

// narrow passes: two blocks per SM, or one per tile
int narrow_blocks(long long tiles, int sms) {
  return static_cast<int>(tiles < 2LL * sms ? tiles : 2LL * sms);
}

// the max pass: segments x chunks about two blocks per SM
int max_segments(long long tiles, long long d, int sms) {
  long long s = (2LL * sms + d / kChunk - 1) / (d / kChunk);
  if (s > tiles) s = tiles;
  return static_cast<int>(s < 1 ? 1 : s);
}

long long max3(long long a, long long b, long long c) {
  const long long m = a > b ? a : b;
  return m > c ? m : c;
}

// workspace sizes: 0, forward T elements (partials, then the per-tile
// maxima); 1, forward ints (the per-tile argmaxima); 2, backward T elements
// (dy2, dy1, partials, then M and k0, W3^T, gamma r); 3, backward doubles
// (coef)
long long workspace(long long n, long long p, long long d, int sms, int which) {
  const long long tiles = tiles_of(n, p);
  const long long b = narrow_blocks(tiles, sms);
  if (which == 0) return max3(b * kGramPartial, b * 4 * kC2, 0) + tiles * d;
  if (which == 1) return tiles * d;
  if (which == 2)
    return n * p * (kC1 + kC2) + max3(b * kB2Partial, n * d, b * 2 * kC2) + kC2 * kC2 + kC2 +
           kC2 * d + d;
  return 4 * d;
}

unsigned grid_for(long long count) {
  const long long g = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(g < 1 ? 1 : (g > 132 * 32 ? 132 * 32 : g));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define CHECK(expr)                                   \
  do {                                                \
    cudaError_t e_ = (expr);                          \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)
#define LAUNCHED() CHECK(cudaGetLastError())

template <typename T>
int forward(const T* points, const uint8_t* valid, long long n, long long p, long long d,
            const T* prm, T* stats, T* out, int* idx, T* h1, T* h2, double* gram, T* ws, int* iws,
            int sms, void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || d % kChunk || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n, p);
  const int b = narrow_blocks(tiles, sms), s = max_segments(tiles, d, sms);
  T* partial = ws;
  T* pmax = ws + max3(static_cast<long long>(b) * kGramPartial, static_cast<long long>(b) * 4 * kC2,
                      0);
  const size_t l2s = sizeof(T) * (kC1 * kC2 + kC1 * kLd + 3 * kTileP);
  const size_t l2f = sizeof(T) * (kC1 * kC2 + kTileP * kLdH + kGramSlots);
  const size_t mx = sizeof(T) * max_smem_t() + sizeof(int) * max_smem_i();
  CHECK(allow_smem(pnt_l2_stats_kernel<T>, l2s));
  CHECK(allow_smem(pnt_l2_forward_kernel<T>, l2f));
  CHECK(allow_smem(pnt_max_kernel<T>, mx));
  const dim3 wgrid(static_cast<unsigned>(s), static_cast<unsigned>(d / kChunk));

  pnt_l1_stats_kernel<T><<<b, kThreads, 0, st>>>(points, valid, n, p, prm, partial);
  LAUNCHED();
  pnt_stats_kernel<T><<<1, kThreads, 0, st>>>(partial, b, kC1, valid, n, p, stats + kStats1);
  LAUNCHED();
  pnt_l2_stats_kernel<T><<<b, kThreads, l2s, st>>>(points, valid, n, p, prm, stats, h1, partial);
  LAUNCHED();
  pnt_stats_kernel<T><<<1, kThreads, 0, st>>>(partial, b, kC2, valid, n, p, stats + kStats2);
  LAUNCHED();
  pnt_l2_forward_kernel<T><<<b, kThreads, l2f, st>>>(h1, valid, n, p, prm, stats, h2, partial);
  LAUNCHED();
  pnt_gram_kernel<T><<<grid_for(kGramSlots + kC2), kThreads, 0, st>>>(partial, b, gram);
  LAUNCHED();
  const unsigned s3 = static_cast<unsigned>(d < 132 * 8 ? d : 132 * 8);
  pnt_stats3_kernel<T><<<s3, kC2, 0, st>>>(gram, valid, n, p, d, prm, stats);
  LAUNCHED();
  pnt_max_kernel<T><<<wgrid, kThreads, mx, st>>>(h2, n, p, d, prm, stats, pmax, iws);
  LAUNCHED();
  pnt_max_reduce_kernel<T><<<grid_for(n * d), kThreads, 0, st>>>(
      pmax, iws, n, (p + kTileP - 1) / kTileP, d, out, idx);
  LAUNCHED();
  return 0;
}

template <typename T>
int backward(const T* points, const uint8_t* valid, long long n, long long p, long long d,
             const T* prm, const T* stats, const double* gram, const int* idx, const T* h1,
             const T* h2, const T* g, T* grads, T* ws, double* dws, int sms, void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || d % kChunk || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n, p);
  const int b = narrow_blocks(tiles, sms);
  T* dy2 = ws;
  T* dy1 = dy2 + n * p * kC2;
  T* partial = dy1 + n * p * kC1;
  T* mk = partial + max3(static_cast<long long>(b) * kB2Partial, n * d,
                         static_cast<long long>(b) * 2 * kC2);
  T* wt = mk + kC2 * kC2 + kC2;
  T* gr = wt + kC2 * d;
  const size_t dh2s = sizeof(T) * dh2_smem_t() + sizeof(int) * dh2_smem_i();
  const size_t b2s = sizeof(T) * b2_smem_t();
  CHECK(allow_smem(pnt_dh2_kernel<T>, dh2s));
  CHECK(allow_smem(pnt_b2_kernel<T>, b2s));

  pnt_bn3_terms_kernel<T><<<grid_for(n * d), kThreads, 0, st>>>(h2, g, idx, n, p, d, prm, stats,
                                                                 partial);
  LAUNCHED();
  pnt_bn3_sum_kernel<T><<<grid_for(d), kThreads, 0, st>>>(partial, g, valid, n, p, d, prm, stats,
                                                          grads, dws);
  LAUNCHED();
  pnt_l3_grad_kernel<T><<<grid_for((kC2 + 1) * d), kThreads, 0, st>>>(
      gram, dws, h2, idx, g, valid, n, p, d, prm, grads, mk, wt, gr);
  LAUNCHED();
  pnt_dh2_kernel<T><<<b, kThreads, dh2s, st>>>(h1, h2, valid, n, p, d, prm, stats, g, idx, mk, wt,
                                               gr, dy2, partial);
  LAUNCHED();
  pnt_sum_kernel<T><<<1, kThreads, 0, st>>>(partial, b, 2 * kC2, 0, 2 * kC2,
                                            grads + off_l2() + kC2);
  LAUNCHED();
  pnt_b2_kernel<T><<<b, kThreads, b2s, st>>>(points, h1, dy2, valid, n, p, prm, stats, grads, dy1,
                                             partial);
  LAUNCHED();
  pnt_sum_kernel<T><<<grid_for(kC1 * kC2 + kC2), kThreads, 0, st>>>(
      partial, b, kB2Partial, 0, kC1 * kC2 + kC2, grads + off_w2());
  LAUNCHED();
  pnt_sum_kernel<T><<<1, kThreads, 0, st>>>(partial, b, kB2Partial, kC1 * kC2 + kC2, 2 * kC1,
                                            grads + off_l1() + kC1);
  LAUNCHED();
  pnt_b3_kernel<T><<<b, kThreads, 0, st>>>(points, dy1, valid, n, p, prm, stats, grads, partial);
  LAUNCHED();
  pnt_sum_kernel<T><<<1, kThreads, 0, st>>>(partial, b, 4 * kC1, 0, 4 * kC1, grads + off_w1());
  LAUNCHED();
  return 0;
}


// the D-wide passes' column groups and segments: one block an SM, each
// group's segments walking the 128-point tiles
long long wide_tiles(long long n, long long p) { return n * ((p + kTileW - 1) / kTileW); }
long long groups_of(long long d) { return (d + kGroupW - 1) / kGroupW; }
int wide_segments(long long n, long long p, long long d, int sms) {
  long long s = sms / groups_of(d);
  const long long tiles = wide_tiles(n, p);
  if (s > tiles) s = tiles;
  return static_cast<int>(s < 1 ? 1 : s);
}
// the backward fuses dh2 into layer 3's pass where W3 is one column group
bool fused_dh2(long long d) { return d <= kGroupW; }

// the bf16 instance's workspaces: 0, forward f32 (partials, then the
// per-tile maxima and tie sums); 1, forward int32 (the per-tile tie
// counts); 2, backward f32 (gk, the three layers' coefficients, BN2's
// partial sums, the other partials); 3, backward bf16 (dy2, dy1 and, above
// one column group, da3 and W3)
long long workspace_bf16(long long n, long long p, long long d, int sms, int which) {
  const long long tiles = tiles_of(n, p), wt = wide_tiles(n, p);
  const long long b = narrow_blocks(tiles, sms), s = wide_segments(n, p, d, sms);
  if (which == 0) return max3(b * 4 * kC2, s * 4 * d, 0) + 2 * wt * d;
  if (which == 1) return wt * d;
  if (which == 2)
    return n * d + 3 * (d + kC2 + kC1) + (s > b ? s : b) * 2 * kC2 +
           max3(s * kL3Rows * d, b * kB2Partial, 0);
  return n * p * (kC2 + kC1) + (fused_dh2(d) ? 0 : n * p * d + kC2 * d);
}

int forward_bf16(const uint16_t* points, const uint8_t* valid, long long n, long long p,
                 long long d, const float* prm, float* stats, uint16_t* out, int* count,
                 float* tsum, uint16_t* a1, uint16_t* a2, float* ws, int* iws, int sms,
                 void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || d % kChunk || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n, p), wt = wide_tiles(n, p);
  const int b = narrow_blocks(tiles, sms), s = wide_segments(n, p, d, sms);
  float* partial = ws;
  float* pmax = ws + max3(static_cast<long long>(b) * 4 * kC2, static_cast<long long>(s) * 4 * d,
                          0);
  float* psum = pmax + wt * d;
  CHECK(allow_smem(pnb_l2_kernel, l2b_smem_bytes()));
  CHECK(allow_smem(pnb_l3_kernel<false>, l3_smem_bytes()));
  CHECK(allow_smem(pnb_l3_kernel<true>, l3_smem_bytes()));
  const dim3 wgrid(static_cast<unsigned>(s), static_cast<unsigned>(groups_of(d)));

  pnb_l1_stats_kernel<<<b, kThreads, 0, st>>>(points, valid, n, p, prm, a1, partial);
  LAUNCHED();
  pnb_stats_kernel<<<1, kThreads, 0, st>>>(partial, b, kC1, valid, n, p, stats + kStats1);
  LAUNCHED();
  pnb_l2_kernel<<<b, kThreads, l2b_smem_bytes(), st>>>(a1, valid, n, p, prm, stats, a2, partial);
  LAUNCHED();
  pnb_stats_kernel<<<1, kThreads, 0, st>>>(partial, b, kC2, valid, n, p, stats + kStats2);
  LAUNCHED();
  pnb_l3_kernel<false><<<wgrid, kThreads, l3_smem_bytes(), st>>>(
      a2, valid, n, p, d, prm, stats, partial, nullptr, nullptr, nullptr);
  LAUNCHED();
  pnb_stats_kernel<<<grid_for(d), kThreads, 0, st>>>(partial, s, d, valid, n, p, stats + kStats3);
  LAUNCHED();
  pnb_l3_kernel<true><<<wgrid, kThreads, l3_smem_bytes(), st>>>(
      a2, valid, n, p, d, prm, stats, nullptr, pmax, iws, psum);
  LAUNCHED();
  pnb_max_reduce_kernel<<<grid_for(n * d), kThreads, 0, st>>>(
      pmax, iws, psum, n, (p + kTileW - 1) / kTileW, d, out, count, tsum);
  LAUNCHED();
  return 0;
}

int backward_bf16(const uint16_t* points, const uint8_t* valid, long long n, long long p,
                  long long d, const float* prm, const float* stats, const uint16_t* out,
                  const int* count, const float* tsum, const uint16_t* a1, const uint16_t* a2,
                  const uint16_t* g, float* grads, float* ws, uint16_t* hws, int sms,
                  void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || d % kChunk || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n, p);
  const int b = narrow_blocks(tiles, sms), s = wide_segments(n, p, d, sms);
  const bool fused = fused_dh2(d);
  float* gk = ws;
  float* coef3 = gk + n * d;
  float* coef2 = coef3 + 3 * d;
  float* coef1 = coef2 + 3 * kC2;
  float* partial2 = coef1 + 3 * kC1;  // BN2's sums, [segment or block][2][128]
  float* partial = partial2 + static_cast<long long>(s > b ? s : b) * 2 * kC2;
  uint16_t* dy2 = hws;
  uint16_t* dy1 = dy2 + n * p * kC2;
  uint16_t* da3 = fused ? nullptr : dy1 + n * p * kC1;
  uint16_t* w3b = fused ? nullptr : da3 + n * p * d;
  CHECK(allow_smem(pnb_l3_back_kernel<true>, l3back_smem_bytes()));
  CHECK(allow_smem(pnb_l3_back_kernel<false>, l3back_smem_bytes()));
  CHECK(allow_smem(pnb_l2_back_kernel, l2back_smem_bytes()));
  const dim3 wgrid(static_cast<unsigned>(s), static_cast<unsigned>(groups_of(d)));

  pnb_bn3_kernel<<<grid_for(d), kThreads, 0, st>>>(g, count, tsum, valid, n, p, d, prm, stats,
                                                   grads, gk, coef3, w3b);
  LAUNCHED();
  if (fused)
    pnb_l3_back_kernel<true><<<wgrid, kThreads, l3back_smem_bytes(), st>>>(
        a2, valid, n, p, d, prm, stats, out, gk, coef3, nullptr, dy2, partial, partial2);
  else
    pnb_l3_back_kernel<false><<<wgrid, kThreads, l3back_smem_bytes(), st>>>(
        a2, valid, n, p, d, prm, stats, out, gk, coef3, da3, nullptr, partial, nullptr);
  LAUNCHED();
  pnb_sum_round_kernel<<<grid_for(kL3Rows * d), kThreads, 0, st>>>(
      partial, s, kL3Rows * d, kL3Rows * d, grads + off_w3());
  LAUNCHED();
  if (!fused) {
    const size_t w3s = sizeof(uint16_t) * kC2 * (d + 8);
    if (w3s <= kDh2StagedBytes) {
      CHECK(allow_smem(pnb_dh2_kernel<true>, w3s));
      pnb_dh2_kernel<true><<<b, kThreads, w3s, st>>>(da3, w3b, a2, n, p, d, prm, stats, dy2,
                                                     partial2);
    } else {
      pnb_dh2_kernel<false><<<b, kThreads, 0, st>>>(da3, w3b, a2, n, p, d, prm, stats, dy2,
                                                    partial2);
    }
    LAUNCHED();
  }
  pnb_bn_back_kernel<<<1, kThreads, 0, st>>>(partial2, fused ? s : b, 2 * kC2, 0, kC2,
                                             stats + kStats2, prm + off_l2() + kC2, valid, n, p,
                                             grads + off_l2() + kC2, coef2);
  LAUNCHED();
  pnb_l2_back_kernel<<<b, kThreads, l2back_smem_bytes(), st>>>(a1, a2, dy2, valid, n, p, prm,
                                                                stats, coef2, dy1, partial);
  LAUNCHED();
  pnb_sum_round_kernel<<<grid_for(kC1 * kC2 + kC2), kThreads, 0, st>>>(
      partial, b, kB2Partial, kC1 * kC2 + kC2, grads + off_w2());
  LAUNCHED();
  pnb_bn_back_kernel<<<1, kThreads, 0, st>>>(partial, b, kB2Partial, kC1 * kC2 + kC2, kC1,
                                             stats + kStats1, prm + off_l1() + kC1, valid, n, p,
                                             grads + off_l1() + kC1, coef1);
  LAUNCHED();
  pnb_l1_back_kernel<<<b, kThreads, 0, st>>>(points, a1, dy1, valid, n, p, coef1, partial);
  LAUNCHED();
  pnb_sum_round_kernel<<<1, kThreads, 0, st>>>(partial, b, 4 * kC1, 4 * kC1, grads + off_w1());
  LAUNCHED();
  return 0;
}

}  // namespace

// The kernels' launches a call: 0 forward and 1 backward of the f32 and
// f64 instances, 2 forward and 3 backward of the bf16 one at D <= 256 (dh2
// fused into layer 3's backward), 4 and 5 the bf16 one above.
extern "C" int pointnet_train_launches(int which) {
  constexpr int kLaunches[6] = {9, 10, 8, 9, 8, 10};
  return which >= 0 && which < 6 ? kLaunches[which] : 0;
}

// The workspace a call takes, in elements: which 0 the forward's (of the
// call's type), 1 the forward's int32 one, 2 the backward's (of the type),
// 3 the backward's float64 one. sms: the card's SM count, as the call is
// given it.
extern "C" long long pointnet_train_workspace(long long n, long long p, long long d, int sms,
                                              int which) {
  return workspace(n, p, d, sms, which);
}

// The dynamic shared memory of the largest block (l2_forward), in bytes.
extern "C" int pointnet_train_smem_bytes(int dbl) {
  return static_cast<int>((dbl ? sizeof(double) : sizeof(float)) *
                          (kC1 * kC2 + kTileP * kLdH + kGramSlots));
}

// points (n, p, 3); valid (n,) bytes or null (every cloud counts); prm the
// packed parameters: W1 (3, 64), b1, gamma1, beta1 (64 each), W2 (64, 128),
// b2, gamma2, beta2, W3 (128, d), b3, gamma3, beta3; all contiguous on the
// current device, d a multiple of 64. Writes stats (mu1, var1, mu2, var2,
// mu3, var3), out (n, d), idx (n, d) int32 point indices, and for the
// backward h1 (n, p, 64), h2 (n, p, 128) and gram (128 * 128 + 128
// float64: G = sum h2 h2^T and s = sum h2 over the valid clouds); ws and
// iws are workspaces of pointnet_train_workspace(.., 0) and (.., 1)
// elements. Launches on `stream` and returns the first cudaError_t (0 on
// success); it neither synchronises nor allocates.
extern "C" int pointnet_train_forward_f32(const float* points, const uint8_t* valid,
                                          long long n, long long p, long long d,
                                          const float* prm, float* stats, float* out, int* idx,
                                          float* h1, float* h2, double* gram, float* ws, int* iws,
                                          int sms, void* stream) {
  return forward<float>(points, valid, n, p, d, prm, stats, out, idx, h1, h2, gram, ws, iws, sms,
                        stream);
}

extern "C" int pointnet_train_forward_f64(const double* points, const uint8_t* valid,
                                          long long n, long long p, long long d,
                                          const double* prm, double* stats, double* out,
                                          int* idx, double* h1, double* h2, double* gram,
                                          double* ws, int* iws, int sms, void* stream) {
  return forward<double>(points, valid, n, p, d, prm, stats, out, idx, h1, h2, gram, ws, iws, sms,
                         stream);
}

// The gradient of sum(out * g) with respect to the packed parameters, into
// grads (prm's layout), from what the forward wrote; ws and dws workspaces
// of pointnet_train_workspace(.., 2) and (.., 3) elements.
extern "C" int pointnet_train_backward_f32(const float* points, const uint8_t* valid,
                                           long long n, long long p, long long d,
                                           const float* prm, const float* stats,
                                           const double* gram, const int* idx, const float* h1,
                                           const float* h2, const float* g, float* grads,
                                           float* ws, double* dws, int sms, void* stream) {
  return backward<float>(points, valid, n, p, d, prm, stats, gram, idx, h1, h2, g, grads, ws, dws,
                         sms, stream);
}

extern "C" int pointnet_train_backward_f64(const double* points, const uint8_t* valid,
                                           long long n, long long p, long long d,
                                           const double* prm, const double* stats,
                                           const double* gram, const int* idx, const double* h1,
                                           const double* h2, const double* g, double* grads,
                                           double* ws, double* dws, int sms, void* stream) {
  return backward<double>(points, valid, n, p, d, prm, stats, gram, idx, h1, h2, g, grads, ws,
                          dws, sms, stream);
}

// The bf16 instance's workspace, in elements: which 0 the forward's
// float32 one, 1 its int32 one, 2 the backward's float32 one, 3 its bf16
// one.
extern "C" long long pointnet_train_bf16_workspace(long long n, long long p, long long d, int sms,
                                                   int which) {
  return workspace_bf16(n, p, d, sms, which);
}

// The bf16 instance. points (n, p, 3) bf16; prm the packed float32
// parameters of the f32 instance (W and b are rounded to bf16 where they
// are used, gamma and beta stay float32); valid as above. Writes stats
// (float32, the layout above), out (n, d) bf16, count (n, d) int32 (the
// points of each cloud whose y3 equals its maximum), tsum (n, d) float32
// (the sum of their a3 - mu3), a1 (n, p, 64) and a2 (n, p, 128) bf16 (the
// dense layers' rounded outputs); ws and iws of
// pointnet_train_bf16_workspace(.., 0) and (.., 1) elements.
extern "C" int pointnet_train_forward_bf16(const void* points, const uint8_t* valid, long long n,
                                           long long p, long long d, const float* prm,
                                           float* stats, void* out, int* count, float* tsum,
                                           void* a1, void* a2, float* ws, int* iws, int sms,
                                           void* stream) {
  return forward_bf16(static_cast<const uint16_t*>(points), valid, n, p, d, prm, stats,
                      static_cast<uint16_t*>(out), count, tsum, static_cast<uint16_t*>(a1),
                      static_cast<uint16_t*>(a2), ws, iws, sms, stream);
}

// The gradient of sum(out * g), g (n, d) bf16, with respect to the packed
// parameters, into grads (float32, prm's layout; W's and b's entries bf16
// values), from what the forward wrote; ws and hws of
// pointnet_train_bf16_workspace(.., 2) and (.., 3) elements.
extern "C" int pointnet_train_backward_bf16(const void* points, const uint8_t* valid, long long n,
                                            long long p, long long d, const float* prm,
                                            const float* stats, const void* out,
                                            const int* count, const float* tsum, const void* a1,
                                            const void* a2, const void* g, float* grads,
                                            float* ws, void* hws, int sms, void* stream) {
  return backward_bf16(static_cast<const uint16_t*>(points), valid, n, p, d, prm, stats,
                       static_cast<const uint16_t*>(out), count, tsum,
                       static_cast<const uint16_t*>(a1), static_cast<const uint16_t*>(a2),
                       static_cast<const uint16_t*>(g), grads, ws, static_cast<uint16_t*>(hws),
                       sms, stream);
}
