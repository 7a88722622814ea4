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
// max, the backward), each recomputing a_3 on the tensor cores by the same
// code (layer3_tile: the same fragments, the same k order), so that a_3 and
// y_3 are the same bits in every pass. Ties at the max are common in bf16
// (2-14 % of the (cloud, channel) maxima at 2,500 points), and JAX's VJP of
// jnp.max splits them evenly: the max pass keeps, per cloud and channel,
// the maximum, the number of points that reach it and the sum of their
// a_3 - mu_3 (dgamma3 needs each tied point's own a_3: points with equal
// y_3 can differ in a_3), merged over tiles in a fixed order (an equal
// maximum adds its count and sum, a larger one restarts them); the
// backward gives bf16(g / count) to each point whose recomputed y_3 equals
// the stored maximum, an equality of two results of the same computation.
// The f32 and f64 instances keep their first-argmax rule (ties there are
// rare, and each tie is one gradient-equivalent point in practice).
// The backward rounds where JAX's autodiff of those layers does: the
// gradient of a BatchNorm's input is bf16(dy mul) + bf16(A + B a) summed in
// bf16 (the cotangents of JAX's two widenings of a: the normalisation and
// the statistics, the latter over the valid clouds' points only), the
// products' dW = bf16(h^T da), dh = bf16(da W^T), db = bf16(sum da), the
// BatchNorm parameters' gradients in f32.
// Passes (pnb_<pass>_kernel; layers 2 and 3 forward and backward by
// mma.sync m16n8k16 bf16 with f32 accumulators, layer 1 (K 3) on the CUDA
// cores; 64-point tiles, the D-wide passes a 64-column chunk of W3 a block):
//   forward   l1_stats    points -> a1 stored, sums of a1, a1^2   (+ stats)
//             l2          a1 -> h1 -> a2 stored, sums of a2, a2^2 (+ stats)
//             l3<false>   a2 -> h2 -> a3: sums of a3, a3^2       (+ stats)
//             l3<true>    a3 -> y3: each tile's max, count, sum
//             max_reduce  -> out, count, tsum
//   backward  bn3         g, count, tsum -> bf16(g / count), dgamma3,
//                         dbeta3, BN3's coefficients; W3 in bf16
//             l3_back     a3, y3 again -> da3 stored; dW3 (h2^T da3), db3
//             sum_round   -> dW3, db3 rounded to bf16
//             dh2         da3 W3^T (W3 in shared memory up to D 768) ->
//                         dy2 stored; BN2's sums
//             bn_back     -> dgamma2, dbeta2, BN2's coefficients
//             l2_back     -> da2; dW2 (h1^T da2), db2; da2 W2^T -> dy1
//                         stored; BN1's sums
//             sum_round   -> dW2, db2;  bn_back -> dgamma1, dbeta1, BN1's
//             l1_back     -> da1; dW1, db1;  sum_round -> dW1, db1
// 8 launches forward, 10 backward. a1 and a2 (the dense layers' rounded
// outputs, 384 bytes a point) are stored and h1, h2 recomputed from them
// where a pass reads them: h = relu(bn(a)) is a few exact operations a
// value, and the backward's BatchNorm needs a itself; recomputing a2 would
// redo layer 2's product in every pass that reads h2. da3, dy2 and dy1 are
// stored for the passes after them, as the TPU kernels store d_y2 and d_y1.
// A pass reads a tile of a stored tensor 16 bytes a thread at a time, every
// load of the tile issued before the values are used; the D-wide passes
// read the next tile's a2 while this tile's products run. Every bf16 kernel
// declares __launch_bounds__(kThreads) and is launched with kThreads
// threads.

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

__device__ __forceinline__ Tile tile_of(long long tile, long long p, const uint8_t* valid) {
  const long long tpc = (p + kTileP - 1) / kTileP;
  Tile t;
  t.cloud = tile / tpc;
  const long long p0 = (tile % tpc) * kTileP;
  t.row0 = t.cloud * p + p0;
  t.np = static_cast<int>(min(static_cast<long long>(kTileP), p - p0));
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
// the bf16 tensor cores (mma.sync m16n8k16, f32 accumulators), except
// layer 1's (K 3) on the CUDA cores. The a-fragments of a row-major tile
// [row][k] and the b-fragments of a tile stored [n][k] are single 32-bit
// loads from shared memory (two bf16 each), so each product whose operand
// is the transpose of a stored tile has that tile staged in both layouts.

constexpr int kLdB = kC2 + 8;        // row stride (bf16) of a tile 128 wide
constexpr int kLdB64 = kTileP + 8;   // row stride (bf16) of a tile 64 wide
constexpr int kLdA2 = kC2 + 4;       // row stride (f32) of layer 2's tile
constexpr int kLdA3 = kChunk + 1;    // row stride (f32) of layer 3's tile
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

// a tile's a3 accumulators: warp w takes points 16 (w % 4).. and columns
// 32 (w / 4) + 8 j.. of the 64-column chunk, k-steps in order from 0. Every
// pass that needs a3 calls this on the same operands, so a3 is the same
// bits in every pass (no float computed two ways is ever compared).
__device__ __forceinline__ void layer3_tile(float (&acc)[4][4], const uint16_t* h2s,
                                            const uint16_t* w3t, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kC2 / 16; ++ks) {
    uint32_t a[4];
    load_a(a, h2s, kLdB, 16 * (warp & 3), 16 * ks, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b0, b1;
      load_b(b0, b1, w3t, kLdB, 32 * (warp >> 2) + 8 * j, 16 * ks, lane);
      mma_bf16(acc[j], a, b0, b1);
    }
  }
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

constexpr int kH2Vectors = kTileP * kC2 / 8 / kThreads;  // a thread's 16-byte vectors of a2

// the next tile from `from` that a D-wide pass takes: every tile, or with
// `valid_only` the valid clouds' only (the same for every thread)
__device__ __forceinline__ long long next_tile(long long from, long long tiles, long long p,
                                               const uint8_t* valid, bool valid_only) {
  while (valid_only && from < tiles && !tile_of(from, p, valid).valid) from += gridDim.x;
  return from;
}

// layer 2's BatchNorm (mu, mul, beta) and W3's chunk d0.. (bf16, [c][k])
// into shared memory
__device__ __forceinline__ void load_l3_operands(float* bn2, uint16_t* w3t, const float* prm,
                                                 const float* stats, long long d, long long d0) {
  for (int i = threadIdx.x; i < kC2; i += kThreads) {
    bn2[i] = stats[kStats2 + i];
    bn2[kC2 + i] = bn_mul_bf16(stats[kStats2 + kC2 + i], prm[off_l2() + kC2 + i]);
    bn2[2 * kC2 + i] = prm[off_l2() + 2 * kC2 + i];
  }
  for (int i = threadIdx.x; i < kC2 * kChunk; i += kThreads) {
    const int k = i / kChunk, c = i % kChunk;
    w3t[c * kLdB + k] = bf_bits(prm[off_w3() + k * d + d0 + c]);
  }
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

__host__ __device__ constexpr int l3b_smem_bytes() {
  return 2 * (2 * kChunk * kLdB) + 4 * (kTileP * kLdA3 + 3 * kC2 + 4 * kChunk + 3 * 4 * kChunk);
}

// grid (segments, d / 64): layer 3 on the chunk of columns d0 = 64
// blockIdx.y.. for the tiles blockIdx.x, blockIdx.x + gridDim.x, ...:
// a3 = bf16(bf16(h2 W3) + b3) (layer3_tile) and then
//   kMax false: the sums of a3 and a3^2 over the valid clouds' points ->
//               partial[segment][4][d] (the columns of the chunk);
//   kMax true:  y3 = bn3(a3) and, per tile and column, the largest y3 over
//               every point, the number of points that take it and the
//               sum of their a3 - mu3 -> pmax, pcnt, psum [tile][d]
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
pnb_l3_kernel(const uint16_t* __restrict__ a2, const uint8_t* __restrict__ valid, long long n,
              long long p, long long d, const float* __restrict__ prm,
              const float* __restrict__ stats, float* __restrict__ partial,
              float* __restrict__ pmax, int* __restrict__ pcnt, float* __restrict__ psum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* w3t = reinterpret_cast<uint16_t*>(smem_raw);  // [64][kLdB]: W3's chunk, [c][k]
  uint16_t* h2s = w3t + kChunk * kLdB;                    // [64][kLdB]
  float* a3s = reinterpret_cast<float*>(h2s + kTileP * kLdB);  // [64][kLdA3]
  float* bn2 = a3s + kTileP * kLdA3;                      // [3][128]
  float* col3 = bn2 + 3 * kC2;                            // [4][64]: b3, mu3, mul3, beta3
  float* redv = col3 + 4 * kChunk;                        // [4][64] each: max, count, sum
  int* redc = reinterpret_cast<int*>(redv + 4 * kChunk);
  float* reds = redv + 8 * kChunk;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane >> 2, tq = lane & 3;
  const long long d0 = static_cast<long long>(blockIdx.y) * kChunk;
  load_l3_operands(bn2, w3t, prm, stats, d, d0);
  if (t < kChunk) {
    col3[t] = bf_round(prm[off_l3(d) + d0 + t]);
    if (kMax) {
      col3[kChunk + t] = stats[kStats3 + d0 + t];
      col3[2 * kChunk + t] = bn_mul_bf16(stats[kStats3 + d + d0 + t], prm[off_l3(d) + d + d0 + t]);
      col3[3 * kChunk + t] = prm[off_l3(d) + 2 * d + d0 + t];
    }
  }
  const int c = t % kChunk, quarter = t / kChunk;  // the tile's column c, 16 points
  float s = 0.0f, q = 0.0f, cs = 0.0f, cq = 0.0f;
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  // a2 of the next tile is read while this one's products run
  uint4 raw[kH2Vectors];
  long long next = next_tile(blockIdx.x, tiles, p, valid, !kMax);
  if (next < tiles) load_rows<kC2, true>(raw, a2, tile_of(next, p, valid));
  for (long long tile = next; tile < tiles; tile = next) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();  // the operands stored; the previous tile read
    store_h<kC2>(raw, h2s, kLdB, nullptr, tl, bn2);
    next = next_tile(tile + gridDim.x, tiles, p, valid, !kMax);
    if (next < tiles) load_rows<kC2, true>(raw, a2, tile_of(next, p, valid));
    __syncthreads();
    float acc[4][4];
    layer3_tile(acc, h2s, w3t, warp, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * (warp & 3) + g + 8 * (e >> 1);
        const int col = 32 * (warp >> 2) + 8 * j + 2 * tq + (e & 1);
        a3s[row * kLdA3 + col] = dense_bf16(acc[j][e], col3[col]);
      }
    __syncthreads();
    if (!kMax) {
      float ts = 0.0f, tsq = 0.0f;
      for (int pp = 16 * quarter; pp < 16 * quarter + 16 && pp < tl.np; ++pp) {
        const float a = a3s[pp * kLdA3 + c];
        ts += a;
        tsq = fmaf(a, a, tsq);
      }
      add_c(s, cs, ts);
      add_c(q, cq, tsq);
      continue;
    }
    // the quarter's points in order, then the quarters in order: a larger
    // y3 restarts the count and the sum, an equal one adds to them
    const float mu = col3[kChunk + c], mul = col3[2 * kChunk + c], be = col3[3 * kChunk + c];
    float best = 0.0f, sum = 0.0f;
    int cnt = 0;
    for (int pp = 16 * quarter; pp < 16 * quarter + 16 && pp < tl.np; ++pp) {
      const float a = a3s[pp * kLdA3 + c];
      const float y = bn_bf16(a, mu, mul, be);
      if (cnt == 0 || y > best) {
        best = y;
        cnt = 1;
        sum = __fsub_rn(a, mu);
      } else if (y == best) {
        ++cnt;
        sum = __fadd_rn(sum, __fsub_rn(a, mu));
      }
    }
    redv[quarter * kChunk + c] = best;
    redc[quarter * kChunk + c] = cnt;
    reds[quarter * kChunk + c] = sum;
    __syncthreads();
    if (t < kChunk) {
      best = redv[t];
      cnt = redc[t];
      sum = reds[t];
      for (int r = 1; r < 4; ++r) {
        const int rc = redc[r * kChunk + t];
        const float rv = redv[r * kChunk + t];
        if (rc == 0) continue;
        if (cnt == 0 || rv > best) {
          best = rv;
          cnt = rc;
          sum = reds[r * kChunk + t];
        } else if (rv == best) {
          cnt += rc;
          sum = __fadd_rn(sum, reds[r * kChunk + t]);
        }
      }
      pmax[tile * d + d0 + t] = best;
      pcnt[tile * d + d0 + t] = cnt;
      psum[tile * d + d0 + t] = sum;
    }
  }
  if (kMax) return;
  __syncthreads();
  stats_to_shared(a3s, 4, kChunk, quarter, c, s, cs, q, cq);
  stats_partial(a3s, 4, kChunk, partial + blockIdx.x * 4 * d + d0, d);
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
    for (int k = 0; k < kC2; ++k) w3b[k * d + c] = bf_bits(prm[off_w3() + k * d + c]);
  }
}

__host__ __device__ constexpr int l3back_smem_bytes() {
  return 2 * (2 * kChunk * kLdB + kC2 * kLdB64 + kChunk * kLdB64) +
         4 * (3 * kC2 + 6 * kChunk + 4 * kChunk);
}

// grid (segments, d / 64), the tiles and chunks of pnb_l3_kernel: a3 and y3
// recomputed by the same code; dy = gk at each point whose y3 equals the
// cloud's maximum (out), 0 elsewhere; da3 = BN3's backward (bf16), stored
// (n * p, d); dW3 += h2^T da3 on the tensor cores (warp w: channels 16 w..,
// the chunk's 64 columns), db3 += sum da3 -> partial[segment][129][d]
__global__ void __launch_bounds__(kThreads)
pnb_l3_back_kernel(const uint16_t* __restrict__ a2, const uint8_t* __restrict__ valid,
                   long long n, long long p, long long d, const float* __restrict__ prm,
                   const float* __restrict__ stats, const uint16_t* __restrict__ out,
                   const float* __restrict__ gk, const float* __restrict__ coef,
                   uint16_t* __restrict__ da3, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* w3t = reinterpret_cast<uint16_t*>(smem_raw);  // [64][kLdB]: W3's chunk, [c][k]
  uint16_t* h2s = w3t + kChunk * kLdB;                    // [64][kLdB]: h2 [p][k]
  uint16_t* h2t = h2s + kTileP * kLdB;                    // [128][kLdB64]: h2 [k][p]
  uint16_t* dat = h2t + kC2 * kLdB64;                     // [64][kLdB64]: da3 [c][p]
  float* bn2 = reinterpret_cast<float*>(dat + kChunk * kLdB64);  // [3][128]
  float* col3 = bn2 + 3 * kC2;  // [6][64]: b3, mu3, mul3, beta3, A3, B3
  float* red = col3 + 6 * kChunk;                         // [4][64]
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane >> 2, tq = lane & 3;
  const long long d0 = static_cast<long long>(blockIdx.y) * kChunk;
  load_l3_operands(bn2, w3t, prm, stats, d, d0);
  if (t < kChunk) {
    col3[t] = bf_round(prm[off_l3(d) + d0 + t]);
    col3[kChunk + t] = stats[kStats3 + d0 + t];
    col3[2 * kChunk + t] = bn_mul_bf16(stats[kStats3 + d + d0 + t], prm[off_l3(d) + d + d0 + t]);
    col3[3 * kChunk + t] = prm[off_l3(d) + 2 * d + d0 + t];
  }
  float dw[8][4], db[4][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) db[j][0] = db[j][1] = 0.0f;
  const long long tiles = n * ((p + kTileP - 1) / kTileP);
  // a2 of the next tile is read while this one's products run
  uint4 raw[kH2Vectors];
  if (blockIdx.x < tiles) load_rows<kC2, false>(raw, a2, tile_of(blockIdx.x, p, valid));
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_of(tile, p, valid);
    __syncthreads();  // the operands stored; the previous tile read
    store_h<kC2>(raw, h2s, kLdB, h2t, tl, bn2);
    if (tile + gridDim.x < tiles)
      load_rows<kC2, false>(raw, a2, tile_of(tile + gridDim.x, p, valid));
    __syncthreads();
    float acc[4][4];
    layer3_tile(acc, h2s, w3t, warp, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (warp & 3) + g + 8 * h;
        const int col = 32 * (warp >> 2) + 8 * j + 2 * tq;
        float da[2] = {0.0f, 0.0f};
        if (row < tl.np) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + e;
            const float a = dense_bf16(acc[j][2 * h + e], col3[cc]);
            const float y = bn_bf16(a, col3[kChunk + cc], col3[2 * kChunk + cc],
                                    col3[3 * kChunk + cc]);
            const long long at = tl.cloud * d + d0 + cc;
            const float dy = y == bf_val(out[at]) ? gk[at] : 0.0f;
            const float t1 = bf_round(__fmul_rn(dy, col3[2 * kChunk + cc]));
            const float t2 =
                tl.valid ? bf_round(fmaf(coef[2 * d + d0 + cc], a, coef[d + d0 + cc])) : 0.0f;
            da[e] = bf_round(__fadd_rn(t1, t2));
            db[j][e] += da[e];
          }
          *reinterpret_cast<uint32_t*>(da3 + (tl.row0 + row) * d + d0 + col) =
              pack_bf16(da[0], da[1]);
        }
        dat[col * kLdB64 + row] = bf_bits(da[0]);
        dat[(col + 1) * kLdB64 + row] = bf_bits(da[1]);
      }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTileP / 16; ++ks) {
      uint32_t a[4];
      load_a(a, h2t, kLdB64, 16 * warp, 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, dat, kLdB64, 8 * j, 16 * ks, lane);
        mma_bf16(dw[j], a, b0, b1);
      }
    }
  }
  float* part = partial + static_cast<long long>(blockIdx.x) * kL3Rows * d;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(16 * warp + g + 8 * (e >> 1)) * d + d0 + 8 * j + 2 * tq + (e & 1)] = dw[j][e];
  // db3: the lanes of one column (same tq) in a fixed tree, then the warps
  // of the four point ranges in order
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = db[j][e];
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (g == 0) red[(warp & 3) * kChunk + 32 * (warp >> 2) + 8 * j + 2 * tq + e] = v;
    }
  __syncthreads();
  if (t < kChunk)
    part[kC2 * d + d0 + t] = red[t] + red[kChunk + t] + red[2 * kChunk + t] + red[3 * kChunk + t];
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


// the bf16 instance's workspaces: 0, forward f32 (partials, then the
// per-tile maxima and tie sums); 1, forward int32 (the per-tile tie
// counts); 2, backward f32 (gk, the three layers' coefficients, partials);
// 3, backward bf16 (da3, dy2, dy1, W3)
long long workspace_bf16(long long n, long long p, long long d, int sms, int which) {
  const long long tiles = tiles_of(n, p);
  const long long b = narrow_blocks(tiles, sms), s = max_segments(tiles, d, sms);
  if (which == 0) return max3(b * 4 * kC2, s * 4 * d, 0) + 2 * tiles * d;
  if (which == 1) return tiles * d;
  if (which == 2)
    return n * d + 3 * (d + kC2 + kC1) + max3(s * kL3Rows * d, b * kB2Partial, b * 2 * kC2);
  return n * p * (d + kC2 + kC1) + kC2 * d;
}

int forward_bf16(const uint16_t* points, const uint8_t* valid, long long n, long long p,
                 long long d, const float* prm, float* stats, uint16_t* out, int* count,
                 float* tsum, uint16_t* a1, uint16_t* a2, float* ws, int* iws, int sms,
                 void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || d % kChunk || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n, p);
  const int b = narrow_blocks(tiles, sms), s = max_segments(tiles, d, sms);
  float* partial = ws;
  float* pmax = ws + max3(static_cast<long long>(b) * 4 * kC2, static_cast<long long>(s) * 4 * d,
                          0);
  float* psum = pmax + tiles * d;
  CHECK(allow_smem(pnb_l2_kernel, l2b_smem_bytes()));
  CHECK(allow_smem(pnb_l3_kernel<false>, l3b_smem_bytes()));
  CHECK(allow_smem(pnb_l3_kernel<true>, l3b_smem_bytes()));
  const dim3 wgrid(static_cast<unsigned>(s), static_cast<unsigned>(d / kChunk));

  pnb_l1_stats_kernel<<<b, kThreads, 0, st>>>(points, valid, n, p, prm, a1, partial);
  LAUNCHED();
  pnt_stats_kernel<float><<<1, kThreads, 0, st>>>(partial, b, kC1, valid, n, p, stats + kStats1);
  LAUNCHED();
  pnb_l2_kernel<<<b, kThreads, l2b_smem_bytes(), st>>>(a1, valid, n, p, prm, stats, a2, partial);
  LAUNCHED();
  pnt_stats_kernel<float><<<1, kThreads, 0, st>>>(partial, b, kC2, valid, n, p, stats + kStats2);
  LAUNCHED();
  pnb_l3_kernel<false><<<wgrid, kThreads, l3b_smem_bytes(), st>>>(
      a2, valid, n, p, d, prm, stats, partial, nullptr, nullptr, nullptr);
  LAUNCHED();
  pnt_stats_kernel<float><<<grid_for(d), kThreads, 0, st>>>(partial, s, d, valid, n, p,
                                                            stats + kStats3);
  LAUNCHED();
  pnb_l3_kernel<true><<<wgrid, kThreads, l3b_smem_bytes(), st>>>(
      a2, valid, n, p, d, prm, stats, nullptr, pmax, iws, psum);
  LAUNCHED();
  pnb_max_reduce_kernel<<<grid_for(n * d), kThreads, 0, st>>>(
      pmax, iws, psum, n, (p + kTileP - 1) / kTileP, d, out, count, tsum);
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
  const int b = narrow_blocks(tiles, sms), s = max_segments(tiles, d, sms);
  float* gk = ws;
  float* coef3 = gk + n * d;
  float* coef2 = coef3 + 3 * d;
  float* coef1 = coef2 + 3 * kC2;
  float* partial = coef1 + 3 * kC1;
  uint16_t* da3 = hws;
  uint16_t* dy2 = da3 + n * p * d;
  uint16_t* dy1 = dy2 + n * p * kC2;
  uint16_t* w3b = dy1 + n * p * kC1;
  CHECK(allow_smem(pnb_l3_back_kernel, l3back_smem_bytes()));
  CHECK(allow_smem(pnb_l2_back_kernel, l2back_smem_bytes()));
  const dim3 wgrid(static_cast<unsigned>(s), static_cast<unsigned>(d / kChunk));

  pnb_bn3_kernel<<<grid_for(d), kThreads, 0, st>>>(g, count, tsum, valid, n, p, d, prm, stats,
                                                   grads, gk, coef3, w3b);
  LAUNCHED();
  pnb_l3_back_kernel<<<wgrid, kThreads, l3back_smem_bytes(), st>>>(
      a2, valid, n, p, d, prm, stats, out, gk, coef3, da3, partial);
  LAUNCHED();
  pnb_sum_round_kernel<<<grid_for(kL3Rows * d), kThreads, 0, st>>>(
      partial, s, kL3Rows * d, kL3Rows * d, grads + off_w3());
  LAUNCHED();
  const size_t w3s = sizeof(uint16_t) * kC2 * (d + 8);
  if (w3s <= kDh2StagedBytes) {
    CHECK(allow_smem(pnb_dh2_kernel<true>, w3s));
    pnb_dh2_kernel<true><<<b, kThreads, w3s, st>>>(da3, w3b, a2, n, p, d, prm, stats, dy2,
                                                   partial);
  } else {
    pnb_dh2_kernel<false><<<b, kThreads, 0, st>>>(da3, w3b, a2, n, p, d, prm, stats, dy2,
                                                  partial);
  }
  LAUNCHED();
  pnb_bn_back_kernel<<<1, kThreads, 0, st>>>(partial, b, 2 * kC2, 0, kC2, stats + kStats2,
                                             prm + off_l2() + kC2, valid, n, p,
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
// f64 instances, 2 forward and 3 backward of the bf16 one.
extern "C" int pointnet_train_launches(int which) {
  constexpr int kLaunches[4] = {9, 10, 8, 10};
  return which >= 0 && which < 4 ? kLaunches[which] : 0;
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
