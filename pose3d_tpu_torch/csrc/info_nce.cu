// In-batch infoNCE-KD loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels pose3d_tpu/ops/nce_fused.py fused_info_nce
// (_fwd_call :109, _bwd_call :134) and pose3d_tpu/ops/nce_blocked.py
// _blocked_rect_sum (_fwd_call :191, _bwd_call :224). One rectangular,
// masked core serves both; pose3d_tpu_torch/ops/nce.py wraps it as
// fused_info_nce, blocked_info_nce and blocked_info_nce_partial, and
// info_nce_plain there is the same function in plain PyTorch:
//
//   s_n = s / max(|s|, 1e-12), t_n = t / max(|t|, 1e-12)   (rows, L2)
//   z_rc = s_n[r] . t_n[c] / tau, or -1e30 where column c is invalid
//   m_r = max_c z_rc,  se_r = sum_c exp(z_rc - m_r),  pos_r = z_{r, off + r}
//   denom_r = exp(pos_r - m_r) + se_r   (the positive counts twice, as in
//                                        the reference)
//   loss = sum over valid rows of -(pos_r - m_r) + log(denom_r), divided by
//          max(number of valid rows, 1) when `divide` is set
//
// and the analytic backward, z recomputed tile by tile:
//   dz_rc = (exp(z_rc - m_r) / denom_r + [c == off + r] (exp(pos_r - m_r) /
//            denom_r - 1)) g_eff, zero on invalid rows
//   ds_n = dz t_n / tau,  dt_n = dz^T s_n / tau,
//   ds = (ds_n - (ds_n . s_n) s_n) / |s|,  dt likewise.
//
// What bounds it. The forward's products are 2 Nr Nc D operations, the
// backward's 6 Nr Nc D (z again, dz t_n and dz^T s_n; counted as 4 Nr Nc D
// of new products, z's recompute aside, in chip_smoke.py's bound). At the
// teacher step's N 160, D 200 the forward is 10.2 MFLOP against 256 KB of
// rows in and out: 0.15 us on the CUDA cores (67 TFLOP/s f32), 0.08 us of
// bytes, so launch latency and the few microseconds a block needs to load
// its rows bound it. At N 4096 the forward's 6.7 GFLOP take 0.100 ms on the
// CUDA cores, the backward's 13.4 GFLOP 0.200 ms; as split TF32 on the
// tensor cores (three TF32 products per f32 product, 3 x 2 N^2 D and
// 3 x 4 N^2 D at 495 TFLOP/s) 0.041 and 0.081 ms; the rows' 13 MB take
// 4 us. So the products go to the tensor cores.
//
// Products: mma.sync.m16n8k8 TF32 in split form. Each f32 operand v is
// big = rna(v) plus small = rna(v - big), both TF32 (cvt.rna), and each
// product is small.big + big.small + big.big in f32 accumulators (as
// csrc/vgg_stem.cu's forward): about 2^-21 of each product is lost where
// one TF32 product loses 2^-11. One product would keep the loss within its
// 1e-5 (2e-6 at N 160, tau 0.1) but miss the gradients' 1e-4 of max|ref|
// by 5x (random keys) to 24x (trained ones), which is what the threefold
// cost buys (tests/test_torch_nce.py, in numpy). The Gram tiles
// z = s_n t_n^T and the backward's dz t_n and dz^T s_n all run so, dz
// split too. The forward's resident rows of s are split once, as they are
// loaded, into fragment order: a lane's A fragment is two 16-byte loads
// (big and small parts) at every k-step of every column tile. Every other
// operand is held as f32 rows at a stride of 4 mod 8 words, so the scalar
// loads of a fragment (lanes 4g + t at rows g, columns t) hit 32 banks, and
// is split in registers as a fragment is loaded (three ALU operations a
// value): the streamed column tiles (their parts would double a tile, and
// the backward reads each tile in two orientations), and the backward's
// resident operand, whose parts do not fit at D 512 beside the streamed
// tiles and the (tile x D) accumulator (the row pass would take 233,216
// bytes of the 232,448 a block may have, the column pass 265,728).
//
// Design. The TPU kernels carry the running (m, se, pos) and the ds and dt
// sums across a sequential grid axis; Hopper's blocks run in parallel and
// in no order, so:
//   * Forward, one launch: a grid of row tiles (16 rows up to Nr 512, so
//     that small batches spread; 32 above) x column splits. The
//     splits of a row tile form a thread block cluster (up to 8 blocks);
//     each block loads its rows of s by cp.async (into the buffer of its
//     second column tile, which is free until then), normalises them and
//     splits them into fragment order, then walks its columns in tiles of
//     32, double-buffered
//     by cp.async, normalising each tile as it lands; the Gram tile goes
//     through shared memory to a per-row online max and sum of exp (m, se,
//     pos). Split 0 writes the normalised rows of s and their norms, row
//     tile 0 those of t: each is written once, by its owner. The cluster's
//     block 0 then reads the other blocks' partials from their shared
//     memory (distributed shared memory), merges them in split order by
//     se exp(m_old - m_new), and writes m, denom, pos and the row losses; the
//     last row tile to finish (an atomic ticket; the sums are not atomics)
//     sums the row losses and the valid rows in row order into loss and
//     count. The ticket is the call's own: the count's word in the call's
//     workspace, zeroed by the entry point on the call's stream before the
//     launch and overwritten by the count at the end, so calls on several
//     streams may overlap.
//   * Backward, one launch: blocks [0, R) own row tiles of ds, blocks
//     [R, R + C) tiles of 32 columns of dt. Each recomputes its z tiles with
//     the forward's fragments in the forward's k order, forms dz in shared
//     memory and adds dz t_n (rows) or dz^T s_n (columns, dz read transposed
//     from the same row-oriented tile) into a (tile x D) accumulator in
//     shared memory; the pullback through the normalisation is the epilogue,
//     since a block holds whole D-wide rows.
// Every z element is the same chain of mma over the same k steps with the
// same operands (a split is a function of its value, wherever it is made)
// at the same fragment position (rows at multiples of 16,
// columns of 8, in every pass), so the backward's z equals the forward's bit
// for bit and exp(z - m) <= 1 holds exactly. No atomics in any sum: the loss
// and both gradients are the same bits on every run.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                 // columns of a tile (4 n-tiles of 8)
constexpr int kZld = kCols + 8;           // row stride of the z / dz tile
constexpr int kMaxSplits = 8;             // a portable cluster
constexpr float kNeg = -1e30f;            // JAX's _NEG, not -inf
constexpr float kEps = 1e-12f;
constexpr int kMaxD = 512;
constexpr int kSmemAllow = 232448;       // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;

// the tiles' geometry and the function's scalars
struct Shape {
  long long nr, nc, off;
  int d, kd8, ld;      // width, padded to 8, row stride in shared memory
  int splits, width;   // forward: column splits (the cluster), columns each
  int row_tiles;       // row tiles (forward and backward)
  int vec_a, vec_b;    // the first and second operand rows load 16 bytes at a time
  float tau;
};

__device__ __forceinline__ bool is_valid(const float* mask, long long i) {
  return mask == nullptr || mask[i] > 0.0f;
}

// ---------------------------------------------------------------------------
// Asynchronous copies, global -> shared; `valid` false zero-fills (nothing is
// read, but the source stays a valid address)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Thread block clusters: a barrier over the cluster's threads, and a load
// from another block's shared memory

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// *p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float cluster_load(const float* p, unsigned rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)),
               "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// Split TF32 on the tensor cores (the helpers of csrc/vgg_stem.cu)

// cvt.rna: f32 to TF32, to nearest with ties away from zero (the low 13 bits 0)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
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

// v = big + small, both TF32: small is the remainder, rounded
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

// A (m16 x k8) at rows m0, columns k0 of x: element (m, k) at x[m ld + k],
// or at x[k ld + m] when TRANS
template <bool TRANS>
__device__ __forceinline__ FragA load_a(const float* x, int ld, int m0, int k0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int ms[4] = {g, g + 8, g, g + 8}, ks[4] = {t, t, t + 4, t + 4};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ms[i], k = k0 + ks[i];
    split_tf32(TRANS ? x[k * ld + m] : x[m * ld + k], f.big[i], f.small[i]);
  }
  return f;
}

// B (k8 x n8) at rows k0, columns n0: element (k, n) at y[k ld + n], or at
// y[n ld + k] when TRANS
template <bool TRANS>
__device__ __forceinline__ FragB load_b(const float* y, int ld, int k0, int n0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + t + 4 * i, n = n0 + g;
    split_tf32(TRANS ? y[n * ld + k] : y[k * ld + n], f.big[i], f.small[i]);
  }
  return f;
}

// A from parts split once in fragment order: tile i's big parts, lane l's
// four at [256 i + 4 l], then its small parts 128 words on
__device__ __forceinline__ FragA load_a_split(const uint32_t* parts, int i) {
  const uint32_t* p = parts + 256 * i + 4 * (threadIdx.x % 32);
  const uint4 big = *reinterpret_cast<const uint4*>(p);
  const uint4 small = *reinterpret_cast<const uint4*>(p + 128);
  return {{big.x, big.y, big.z, big.w}, {small.x, small.y, small.z, small.w}};
}

// c += a . b in split TF32: small.big, big.small, big.big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// ---------------------------------------------------------------------------
// Tiles in shared memory: `rows` rows of x from row0 (zero past n), each
// padded with zeros to kd8 columns, at stride ld

__device__ __forceinline__ void stage_rows(float* buf, const float* __restrict__ x,
                                           long long row0, int rows, long long n,
                                           const Shape& sh, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (vec) {  // d a multiple of 4, x 16-byte aligned
    const int chunks = sh.kd8 / 4;
    for (int r = warp; r < rows; r += kWarps) {
      const long long row = row0 + r;
      for (int q = lane; q < chunks; q += 32) {
        const bool in = row < n && 4 * q < sh.d;
        cp_async16(buf + r * sh.ld + 4 * q, in ? x + row * sh.d + 4 * q : x, in);
      }
    }
  } else {
    for (int r = warp; r < rows; r += kWarps) {
      const long long row = row0 + r;
      for (int k = lane; k < sh.kd8; k += 32) {
        const bool in = row < n && k < sh.d;
        cp_async4(buf + r * sh.ld + k, in ? x + row * sh.d + k : x, in);
      }
    }
  }
}

// Four threads a row: thread p of row r sums columns p, p + 4, ... in order
// and the four partial sums meet in a butterfly, so every row's sum is the
// same bits whichever block computes it.
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Normalise `rows` staged rows in place (x times 1 / max(|x|, eps), within
// an ulp of the quotient); with `out`,
// also write the normalised rows (n, d) and their norms from row0.
__device__ __forceinline__ void normalize_rows(float* buf, long long row0, int rows,
                                               long long n, const Shape& sh,
                                               float* __restrict__ out,
                                               float* __restrict__ norm_out) {
  const int p = threadIdx.x % 4;
  for (int r = threadIdx.x / 4; r < rows; r += kThreads / 4) {
    float* xr = buf + r * sh.ld;
    float ss = 0.0f;
    for (int k = p; k < sh.kd8; k += 4) ss = fmaf(xr[k], xr[k], ss);
    const float nrm = fmaxf(sqrtf(row_sum4(ss)), kEps), inv = 1.0f / nrm;
    const long long row = row0 + r;
    const bool own = out != nullptr && row < n;
    for (int k = p; k < sh.kd8; k += 4) {
      const float v = xr[k] * inv;
      xr[k] = v;
      if (own && k < sh.d) out[row * sh.d + k] = v;
    }
    if (own && p == 0) norm_out[row] = nrm;
  }
}

// The tensor cores' f32 accumulation truncates, and a long chain of mma on
// one accumulator adds a bias of up to an ulp of the sum at each step: each
// k-step's three products go into a fresh accumulator, which an FADD (round
// to nearest) adds to the running sum. That also makes the k-steps' chains
// independent, three mma long.
__device__ __forceinline__ void add_step(float (&acc)[4], const FragA& a, const FragB& b) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(part, a, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += part[j];
}

// The z tile (16 RM rows of A, 32 columns of b) into z (raw sums, before
// 1 / tau), k in steps of 8 from 0: warp w takes m-tile w % RM and the RM
// n-tiles from RM (w / RM), so that one A fragment serves RM products;
// a_at(m0, k0) is A's fragment at rows m0, columns k0.
template <int RM, class LoadA>
__device__ __forceinline__ void gram_tile(LoadA a_at, const float* b, float* z,
                                          const Shape& sh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % RM), n0 = 8 * RM * (warp / RM);
  float acc[RM][4];
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.0f;
  for (int k0 = 0; k0 < sh.kd8; k0 += 8) {
    const FragA fa = a_at(m0, k0);
#pragma unroll
    for (int q = 0; q < RM; ++q) add_step(acc[q], fa, load_b<true>(b, sh.ld, k0, n0 + 8 * q));
  }
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    float* zr = z + (m0 + g) * kZld + n0 + 8 * q + 2 * t;
    *reinterpret_cast<float2*>(zr) = make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(zr + 8 * kZld) = make_float2(acc[q][2], acc[q][3]);
  }
}

// acc (M x kd8, C-fragment order rows at stride sh.ld) += A . B over KS
// k-steps: A (M x 8 KS) from a (TRANS_A: read transposed), B (8 KS x kd8)
// from b's rows. Warp w takes the n-tiles w, w + 4, ...
template <int MT, int KS, bool TRANS_A>
__device__ __forceinline__ void add_product(float* acc, const float* a, int lda, const float* b,
                                            const Shape& sh) {
  constexpr int kChunk = KS < 4 ? KS : 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int ntiles = sh.kd8 / 8;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int kc = 0; kc < KS; kc += kChunk) {
      FragA fa[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) fa[q] = load_a<TRANS_A>(a, lda, 16 * i, 8 * (kc + q));
      for (int j = warp; j < ntiles; j += kWarps) {
        float* cr = acc + (16 * i + g) * sh.ld + 8 * j + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(cr);
        const float2 hi = *reinterpret_cast<const float2*>(cr + 8 * sh.ld);
        float c[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          add_step(c, fa[q], load_b<false>(b, sh.ld, 8 * (kc + q), 8 * j));
        *reinterpret_cast<float2*>(cr) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(cr + 8 * sh.ld) = make_float2(c[2], c[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward

// the row tile's dynamic shared memory, in floats: the split parts of its
// rows of s, two column tiles of t (the second first holds the rows of s),
// the z tile (which the last row tile's final sums reuse) and the per-row
// partials (m, se, pos)
int forward_floats(int rm, int kd8, int ld) {
  const int rows = 16 * rm;
  return 2 * rows * kd8 + 2 * kCols * ld + rows * kZld + 3 * rows;
}

// The row tile's normalised rows (f32 at stride ld, zeros past nr and d)
// split into parts in fragment order: load_a_split's tile i is m-tile
// i / (kd8 / 8), k-step i % (kd8 / 8).
template <int RM>
__device__ __forceinline__ void split_rows(uint32_t* parts, const float* rows, const Shape& sh) {
  const int ksteps = sh.kd8 / 8;
  for (int i = threadIdx.x; i < RM * ksteps * 128; i += kThreads) {
    // tile, lane 4g + t and its value q: row g (+ 8 if q odd), column t (+ 4
    // if q > 1), as load_a
    const int tile = i / 128, lane = (i / 4) % 32, q = i % 4;
    const int m = 16 * (tile / ksteps) + lane / 4 + 8 * (q & 1);
    const int k = 8 * (tile % ksteps) + lane % 4 + 4 * (q >> 1);
    split_tf32(rows[m * sh.ld + k], parts[256 * tile + 4 * lane + q],
               parts[256 * tile + 128 + 4 * lane + q]);
  }
}

// the per-row partials of one z tile, columns [c0, c0 + 32) of which those
// below hi count: tpr threads a row, each over 32 / tpr columns in order;
// the row's threads agree after each butterfly
template <int RM>
__device__ __forceinline__ void online_lse(const float* z, long long r0, long long c0,
                                           long long hi, const float* __restrict__ vcol,
                                           const Shape& sh, float& m, float& se, float& pos) {
  constexpr int kRows = 16 * RM, kTpr = kThreads / kRows, kCpt = kCols / kTpr;
  const int r = threadIdx.x / kTpr, p = threadIdx.x % kTpr;
  const long long row = r0 + r;
  float zv[kCpt];
  float tile_max = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kCpt; ++j) {
    const long long c = c0 + p * kCpt + j;
    zv[j] = c < hi && is_valid(vcol, c) ? z[r * kZld + p * kCpt + j] / sh.tau : kNeg;
    if (c < hi) tile_max = fmaxf(tile_max, zv[j]);
  }
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1)
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
  const float m_new = fmaxf(m, tile_max);
  float e = 0.0f, pp = 0.0f;
#pragma unroll
  for (int j = 0; j < kCpt; ++j) {
    const long long c = c0 + p * kCpt + j;
    if (c < hi) e += expf(zv[j] - m_new);
    if (c < hi && c == sh.off + row) pp += zv[j];
  }
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1) {
    e += __shfl_xor_sync(0xffffffffu, e, o);
    pp += __shfl_xor_sync(0xffffffffu, pp, o);
  }
  se = se * expf(m - m_new) + e;
  m = m_new;
  pos += pp;
}

// Grid: row_tiles x splits blocks, x = row tile * splits + split, clusters of
// `splits` blocks along x (one row tile each).
template <int RM>
__global__ void __launch_bounds__(kThreads)
nce_forward_kernel(const float* __restrict__ s, const float* __restrict__ t,
                   const float* __restrict__ vrow, const float* __restrict__ vcol, Shape sh,
                   int divide, float* __restrict__ sn, float* __restrict__ tn,
                   float* __restrict__ s_norm, float* __restrict__ t_norm,
                   float* __restrict__ m_out, float* __restrict__ denom_out,
                   float* __restrict__ pos_out, float* __restrict__ row_loss,
                   float* __restrict__ loss, float* __restrict__ count) {
  constexpr int kRows = 16 * RM, kTpr = kThreads / kRows;
  extern __shared__ __align__(16) float smem[];
  uint32_t* s_parts = reinterpret_cast<uint32_t*>(smem);  // [RM][kd8 / 8][2][32][4]
  float* t_sh = smem + 2 * kRows * sh.kd8;   // [2][kCols][ld]
  float* z_sh = t_sh + 2 * kCols * sh.ld;    // [kRows][kZld]
  float* part = z_sh + kRows * kZld;         // [3][kRows]: m, se, pos
  const int split = blockIdx.x % sh.splits;
  const long long rt = blockIdx.x / sh.splits;
  const long long r0 = rt * kRows;
  const long long lo = static_cast<long long>(split) * sh.width;
  const long long hi = lo + sh.width < sh.nc ? lo + sh.width : sh.nc;
  const int tiles = static_cast<int>((hi - lo + kCols - 1) / kCols);

  float* s_rows = t_sh + kCols * sh.ld;      // the second tile's buffer, free until then
  stage_rows(s_rows, s, r0, kRows, sh.nr, sh, sh.vec_a);
  stage_rows(t_sh, t, lo, kCols, hi, sh, sh.vec_b);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  normalize_rows(s_rows, r0, kRows, sh.nr, sh, split == 0 ? sn : nullptr, s_norm);
  __syncthreads();
  split_rows<RM>(s_parts, s_rows, sh);  // the loop's first barrier: before tile 1 lands there
  const int ksteps = sh.kd8 / 8;
  const auto a_at = [&](int m0, int k0) {
    return load_a_split(s_parts, (m0 / 16) * ksteps + k0 / 8);
  };
  float m = -CUDART_INF_F, se = 0.0f, pos = 0.0f;
  for (int i = 0; i < tiles; ++i) {
    float* cur = t_sh + (i & 1) * kCols * sh.ld;
    const long long c0 = lo + static_cast<long long>(i) * kCols;
    cp_async_wait_all();
    __syncthreads();  // tile i landed; tile i - 1 and its z are read
    if (i + 1 < tiles)  // under this tile's normalisation and products
      stage_rows(t_sh + ((i + 1) & 1) * kCols * sh.ld, t, c0 + kCols, kCols, hi, sh, sh.vec_b);
    cp_async_commit();
    normalize_rows(cur, c0, kCols, hi, sh, rt == 0 ? tn : nullptr, t_norm);
    __syncthreads();
    gram_tile<RM>(a_at, cur, z_sh, sh);
    __syncthreads();
    online_lse<RM>(z_sh, r0, c0, hi, vcol, sh, m, se, pos);
  }
  const int r = threadIdx.x / kTpr;
  if (threadIdx.x % kTpr == 0) {
    part[r] = m;
    part[kRows + r] = se;
    part[2 * kRows + r] = pos;
  }
  cluster_sync();  // every split's partials are written
  if (split == 0) {
    if (threadIdx.x < kRows && r0 + threadIdx.x < sh.nr) {
      const int lr = threadIdx.x;
      float mm = -CUDART_INF_F, ss = 0.0f, pp = 0.0f;
      for (int k = 0; k < sh.splits; ++k) {  // in split order
        const float mk = cluster_load(part + lr, k);
        const float m_new = fmaxf(mm, mk);
        ss = ss * expf(mm - m_new) + cluster_load(part + kRows + lr, k) * expf(mk - m_new);
        mm = m_new;
        pp += cluster_load(part + 2 * kRows + lr, k);
      }
      const long long row = r0 + lr;
      const float denom = expf(pp - mm) + ss;
      m_out[row] = mm;
      denom_out[row] = denom;
      pos_out[row] = pp;
      row_loss[row] = is_valid(vrow, row) ? -(pp - mm) + logf(denom) : 0.0f;
    }
  }
  cluster_sync();  // the other blocks' shared memory is read
  if (split != 0) return;
  float* sums = z_sh;  // [2][kThreads], free now
  unsigned* last = reinterpret_cast<unsigned*>(z_sh + 2 * kThreads);
  __threadfence();  // this tile's row losses before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(reinterpret_cast<unsigned*>(count), 1u) ==
            static_cast<unsigned>(sh.row_tiles - 1);
  __syncthreads();
  if (*last == 0) return;
  __threadfence();
  // the last row tile: the loss and the valid count, each thread over rows
  // i, i + 128, ... in order, then a fixed tree
  float l = 0.0f, c = 0.0f;
  for (long long i = threadIdx.x; i < sh.nr; i += kThreads) {
    l += __ldcg(row_loss + i);
    c += is_valid(vrow, i) ? 1.0f : 0.0f;
  }
  sums[threadIdx.x] = l;
  sums[kThreads + threadIdx.x] = c;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      sums[threadIdx.x] += sums[threadIdx.x + h];
      sums[kThreads + threadIdx.x] += sums[kThreads + threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    count[0] = sums[kThreads];  // the ticket's word: every tile has taken its ticket
    loss[0] = divide ? sums[0] / fmaxf(sums[kThreads], 1.0f) : sums[0];
  }
}

// ---------------------------------------------------------------------------
// Backward

// dynamic shared memory in floats: the row pass holds its rows of s_n, two
// column tiles of t_n, the dz tile and the (rows x kd8) accumulator; the
// column pass its 32 columns of t_n, two row tiles of s_n, the dz tile and
// the (32 x kd8) accumulator
int backward_floats(int rm, int ld) {
  const int rows = 16 * rm;
  const int row_pass = rows * ld + 2 * kCols * ld + rows * kZld + rows * ld;
  const int col_pass = kCols * ld + 2 * rows * ld + rows * kZld + kCols * ld;
  return row_pass > col_pass ? row_pass : col_pass;
}

// d(loss)/d(row-loss sum): the upstream gradient, over the valid count
// when the loss is a mean
__device__ __forceinline__ float effective_grad(const float* g, const float* count,
                                                int divide) {
  return divide ? g[0] / fmaxf(count[0], 1.0f) : g[0];
}

// the z tile (rows r0.., columns c0..) into dz in place: zero on invalid
// rows and past nc
template <int RM>
__device__ __forceinline__ void dz_tile(float* z, long long r0, long long c0,
                                        const float* __restrict__ vrow,
                                        const float* __restrict__ vcol,
                                        const float* __restrict__ m_in,
                                        const float* __restrict__ denom_in,
                                        const float* __restrict__ pos_in, float g_eff,
                                        const Shape& sh) {
  constexpr int kRows = 16 * RM, kTpr = kThreads / kRows, kCpt = kCols / kTpr;
  const int r = threadIdx.x / kTpr, p = threadIdx.x % kTpr;
  const long long row = r0 + r;
  const bool row_ok = row < sh.nr && is_valid(vrow, row);
  const float m = row_ok ? m_in[row] : 0.0f;
  const float denom = row_ok ? denom_in[row] : 1.0f;
  const float q_pos = row_ok ? expf(pos_in[row] - m) / denom : 0.0f;
#pragma unroll
  for (int j = 0; j < kCpt; ++j) {
    const int lc = p * kCpt + j;
    const long long c = c0 + lc;
    float dz = 0.0f;
    if (row_ok && c < sh.nc) {
      const float zz = is_valid(vcol, c) ? z[r * kZld + lc] / sh.tau : kNeg;
      dz = expf(zz - m) / denom * g_eff;
      if (c == sh.off + row) dz += (q_pos - 1.0f) * g_eff;
    }
    z[r * kZld + lc] = dz;
  }
}

// the pullback of `rows` accumulated rows (acc, before the 1 / tau) through
// x_n = x / |x|, four threads a row as normalize_rows: out = (acc / tau -
// (acc / tau . x_n) x_n) / |x|
__device__ __forceinline__ void normalize_pullback(const float* acc, const float* xn,
                                                   long long row0, int rows, long long n,
                                                   const float* __restrict__ norm,
                                                   const Shape& sh, float* __restrict__ out) {
  const int p = threadIdx.x % 4;
  for (int r = threadIdx.x / 4; r < rows; r += kThreads / 4) {
    const long long row = row0 + r;
    const float* ar = acc + r * sh.ld;
    const float* xr = xn + r * sh.ld;
    float dot = 0.0f;
    for (int k = p; k < sh.kd8; k += 4) dot = fmaf(ar[k] / sh.tau, xr[k], dot);
    dot = row_sum4(dot);
    if (row >= n) continue;
    const float nrm = norm[row];
    for (int k = p; k < sh.d; k += 4) out[row * sh.d + k] = (ar[k] / sh.tau - dot * xr[k]) / nrm;
  }
}

// Grid: row_tiles + ceil(nc / 32) blocks
template <int RM>
__global__ void __launch_bounds__(kThreads)
nce_backward_kernel(const float* __restrict__ sn, const float* __restrict__ tn,
                    const float* __restrict__ s_norm, const float* __restrict__ t_norm,
                    const float* __restrict__ vrow, const float* __restrict__ vcol,
                    const float* __restrict__ m_in, const float* __restrict__ denom_in,
                    const float* __restrict__ pos_in, const float* __restrict__ count,
                    const float* __restrict__ g, Shape sh, int divide, float* __restrict__ ds,
                    float* __restrict__ dt) {
  constexpr int kRows = 16 * RM;
  extern __shared__ __align__(16) float smem[];
  const float g_eff = effective_grad(g, count, divide);
  const int ld = sh.ld;
  if (blockIdx.x < static_cast<unsigned>(sh.row_tiles)) {
    // rows: ds for rows r0 .. r0 + kRows against every column tile
    float* s_sh = smem;                      // [kRows][ld]
    float* t_sh = s_sh + kRows * ld;         // [2][kCols][ld]
    float* z_sh = t_sh + 2 * kCols * ld;     // [kRows][kZld]
    float* acc = z_sh + kRows * kZld;        // [kRows][ld]
    const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
    const int tiles = static_cast<int>((sh.nc + kCols - 1) / kCols);
    stage_rows(s_sh, sn, r0, kRows, sh.nr, sh, sh.vec_a);
    stage_rows(t_sh, tn, 0, kCols, sh.nc, sh, sh.vec_b);
    cp_async_commit();
    for (int i = threadIdx.x; i < kRows * ld; i += kThreads) acc[i] = 0.0f;
    for (int i = 0; i < tiles; ++i) {
      const float* cur = t_sh + (i & 1) * kCols * ld;
      const long long c0 = static_cast<long long>(i) * kCols;
      cp_async_wait_all();
      __syncthreads();  // tile i landed; tile i - 1 is read
      if (i + 1 < tiles)
        stage_rows(t_sh + ((i + 1) & 1) * kCols * ld, tn, c0 + kCols, kCols, sh.nc, sh,
                   sh.vec_b);
      cp_async_commit();
      gram_tile<RM>([&](int m0, int k0) { return load_a<false>(s_sh, ld, m0, k0); }, cur, z_sh,
                    sh);
      __syncthreads();
      dz_tile<RM>(z_sh, r0, c0, vrow, vcol, m_in, denom_in, pos_in, g_eff, sh);
      __syncthreads();
      add_product<RM, kCols / 8, false>(acc, z_sh, kZld, cur, sh);
    }
    __syncthreads();
    normalize_pullback(acc, s_sh, r0, kRows, sh.nr, s_norm, sh, ds);
  } else {
    // columns: dt for columns c0 .. c0 + 32 against every row tile
    float* t_sh = smem;                      // [kCols][ld]
    float* s_sh = t_sh + kCols * ld;         // [2][kRows][ld]
    float* z_sh = s_sh + 2 * kRows * ld;     // [kRows][kZld]
    float* acc = z_sh + kRows * kZld;        // [kCols][ld]
    const long long c0 = static_cast<long long>(blockIdx.x - sh.row_tiles) * kCols;
    const int tiles = sh.row_tiles;
    stage_rows(t_sh, tn, c0, kCols, sh.nc, sh, sh.vec_b);
    stage_rows(s_sh, sn, 0, kRows, sh.nr, sh, sh.vec_a);
    cp_async_commit();
    for (int i = threadIdx.x; i < kCols * ld; i += kThreads) acc[i] = 0.0f;
    for (int i = 0; i < tiles; ++i) {
      const float* cur = s_sh + (i & 1) * kRows * ld;
      const long long r0 = static_cast<long long>(i) * kRows;
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < tiles)
        stage_rows(s_sh + ((i + 1) & 1) * kRows * ld, sn, r0 + kRows, kRows, sh.nr, sh,
                   sh.vec_a);
      cp_async_commit();
      gram_tile<RM>([&](int m0, int k0) { return load_a<false>(cur, ld, m0, k0); }, t_sh, z_sh,
                    sh);
      __syncthreads();
      dz_tile<RM>(z_sh, r0, c0, vrow, vcol, m_in, denom_in, pos_in, g_eff, sh);
      __syncthreads();
      add_product<kCols / 16, 2 * RM, true>(acc, z_sh, kZld, cur, sh);
    }
    __syncthreads();
    normalize_pullback(acc, t_sh, c0, kCols, sh.nc, t_norm, sh, dt);
  }
}

// ---------------------------------------------------------------------------
// Host side

int padded(long long d) { return static_cast<int>((d + 7) / 8 * 8); }

// 4 mod 8 words: a fragment's scalar loads (lanes 4g + t at row g, column t)
// fall in 32 banks
int row_stride(long long d) { return padded(d) + 4; }

// m-tiles a row tile: 16 rows up to 512 rows, so that small batches spread
// over the card; above, 32 rows where two blocks of either kernel fit a
// multiprocessor (D up to 208), so that the backward's row and column blocks
// carry the same work (16-row tiles took 1.4x the forward's and 1.8x the
// backward's time at Nr 4096, D 200 on an H100)
int tile_mtiles(long long nr, long long d) {
  const int kd8 = padded(d), ld = row_stride(d);
  const int most = std::max(forward_floats(2, kd8, ld), backward_floats(2, ld));
  return nr > 512 && 2 * (sizeof(float) * most + 1024) <= 233472 ? 2 : 1;
}

struct Device {
  int sms = 0;
  bool ready = false;
};

// Once a device: its multiprocessor count, and every kernel's dynamic shared
// memory allowance raised to the most a block may take.
cudaError_t prepare(int& sms) {
  static std::mutex mu;
  static Device devices[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Device& dv = devices[dev];
  if (!dv.ready) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(nce_forward_kernel<1>),
        reinterpret_cast<const void*>(nce_forward_kernel<2>),
        reinterpret_cast<const void*>(nce_backward_kernel<1>),
        reinterpret_cast<const void*>(nce_backward_kernel<2>)};
    for (const void* k : kernels) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemAllow);
      if (err != cudaSuccess) return err;
    }
    if ((err = cudaDeviceGetAttribute(&dv.sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    dv.ready = true;
  }
  sms = dv.sms;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

Shape shape_of(long long nr, long long nc, long long d, long long off, float tau,
               const void* a, const void* b) {
  Shape sh{};
  sh.nr = nr;
  sh.nc = nc;
  sh.off = off;
  sh.d = static_cast<int>(d);
  sh.kd8 = padded(d);
  sh.ld = row_stride(d);
  sh.row_tiles = static_cast<int>((nr + 16 * tile_mtiles(nr, d) - 1) / (16 * tile_mtiles(nr, d)));
  sh.vec_a = d % 4 == 0 && aligned16(a);
  sh.vec_b = d % 4 == 0 && aligned16(b);
  sh.tau = tau;
  return sh;
}

template <int RM>
cudaError_t launch_forward(const float* s, const float* t, const float* vrow, const float* vcol,
                           const Shape& sh, int divide, float* sn, float* tn, float* s_norm,
                           float* t_norm, float* m, float* denom, float* pos, float* row_loss,
                           float* loss, float* count, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(sh.row_tiles * sh.splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * forward_floats(RM, sh.kd8, sh.ld);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(sh.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nce_forward_kernel<RM>, s, t, vrow, vcol, sh, divide, sn, tn,
                            s_norm, t_norm, m, denom, pos, row_loss, loss, count);
}

template <int RM>
cudaError_t launch_backward(const float* sn, const float* tn, const float* s_norm,
                            const float* t_norm, const float* vrow, const float* vcol,
                            const float* m, const float* denom, const float* pos,
                            const float* count, const float* g, const Shape& sh, int divide,
                            float* ds, float* dt, cudaStream_t st) {
  const long long col_tiles = (sh.nc + kCols - 1) / kCols;
  nce_backward_kernel<RM><<<static_cast<unsigned>(sh.row_tiles + col_tiles), kThreads,
                            sizeof(float) * backward_floats(RM, sh.ld), st>>>(
      sn, tn, s_norm, t_norm, vrow, vcol, m, denom, pos, count, g, sh, divide, ds, dt);
  return cudaGetLastError();
}

bool shape_ok(long long nr, long long nc, long long d) {
  return nr > 0 && nc > 0 && d > 0 && d <= kMaxD && nr < (1LL << 31) && nc < (1LL << 31);
}

}  // namespace

// The dynamic shared memory a block takes at width d and 16-row tiles (any
// Nr up to 512): forward (which 0) or backward (which 1), in bytes.
extern "C" int info_nce_smem_bytes(long long d, int which) {
  const int rm = tile_mtiles(160, d), ld = row_stride(d);
  return static_cast<int>(sizeof(float) * (which == 0 ? forward_floats(rm, padded(d), ld)
                                                      : backward_floats(rm, ld)));
}

// CUDA launches a call makes: forward (which 0) or backward (which 1).
extern "C" int info_nce_launches(int which) {
  (void)which;
  return 1;  // one kernel each way
}

// s (nr, d) and t (nc, d) float32; vrow (nr) and vcol (nc) float32 masks
// (> 0 is valid) or null for all valid; off: the column of row 0's positive.
// Writes the workspace sn (nr, d), tn (nc, d), s_norm (nr), t_norm (nc), the
// residuals m, denom, pos and row_loss (nr), then loss (one float) and
// count (one float, the valid rows). All contiguous on the current device.
// Launches on `stream` and returns the first cudaError_t (0 on success); it
// neither synchronises nor allocates. The caller keeps 1 <= nr, nc < 2^31
// and 1 <= d <= 512. `count` is the row tiles' ticket until the last one
// writes the count into it: it is zeroed here on `stream`, so calls on
// other streams, each with its own workspace, may run at once.
extern "C" int info_nce_forward(const float* s, const float* t, const float* vrow,
                                const float* vcol, long long nr, long long nc, long long d,
                                long long off, float tau, int divide, float* sn, float* tn,
                                float* s_norm, float* t_norm, float* m, float* denom,
                                float* pos, float* row_loss, float* loss, float* count,
                                void* stream) {
  if (!shape_ok(nr, nc, d)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = prepare(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape sh = shape_of(nr, nc, d, off, tau, s, t);
  // column splits: up to a cluster of 8, at most two blocks a
  // multiprocessor (one wave), each split a whole number of 8-column n-tiles
  const long long ntiles = (nc + 7) / 8;
  long long splits = 2LL * sms / sh.row_tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits > ntiles) splits = ntiles;
  if (splits < 1) splits = 1;
  const long long per = (ntiles + splits - 1) / splits;
  sh.width = static_cast<int>(8 * per);
  sh.splits = static_cast<int>((ntiles + per - 1) / per);  // every split holds a column
  const int rm = tile_mtiles(nr, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned), st);  // the call's ticket
  if (err != cudaSuccess) return static_cast<int>(err);
  err = rm == 2 ? launch_forward<2>(s, t, vrow, vcol, sh, divide, sn, tn, s_norm, t_norm, m,
                                    denom, pos, row_loss, loss, count, st)
                : launch_forward<1>(s, t, vrow, vcol, sh, divide, sn, tn, s_norm, t_norm, m,
                                    denom, pos, row_loss, loss, count, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The backward of info_nce_forward: sn, tn, s_norm, t_norm, m, denom, pos
// and count are its outputs; g is the upstream gradient of loss (one
// float). Writes ds (nr, d) and dt (nc, d). Same launch contract.
extern "C" int info_nce_backward(const float* sn, const float* tn, const float* s_norm,
                                 const float* t_norm, const float* vrow, const float* vcol,
                                 const float* m, const float* denom, const float* pos,
                                 const float* count, const float* g, long long nr,
                                 long long nc, long long d, long long off, float tau,
                                 int divide, float* ds, float* dt, void* stream) {
  if (!shape_ok(nr, nc, d)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = prepare(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape sh = shape_of(nr, nc, d, off, tau, sn, tn);
  const int rm = tile_mtiles(nr, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = rm == 2 ? launch_backward<2>(sn, tn, s_norm, t_norm, vrow, vcol, m, denom, pos, count, g,
                                     sh, divide, ds, dt, st)
                : launch_backward<1>(sn, tn, s_norm, t_norm, vrow, vcol, m, denom, pos, count, g,
                                     sh, divide, ds, dt, st);
  return static_cast<int>(err);
}
