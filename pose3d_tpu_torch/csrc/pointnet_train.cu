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
// this kernel read wrong values on the H100, and without it right ones)
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

}  // namespace

// The kernels' launches a call: forward, backward.
extern "C" int pointnet_train_launches(int which) { return which == 0 ? 9 : 10; }

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
