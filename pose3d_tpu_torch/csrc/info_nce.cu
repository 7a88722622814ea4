// In-batch infoNCE-KD loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels pose3d_tpu/ops/nce_fused.py fused_info_nce
// (_fwd_kernel, _bwd_kernel) and pose3d_tpu/ops/nce_blocked.py
// _blocked_rect_sum (_fwd_kernel, _bwd_ds_kernel, _bwd_dt_kernel). One
// rectangular, masked core serves both; pose3d_tpu_torch/ops/nce.py wraps it
// as fused_info_nce, blocked_info_nce and blocked_info_nce_partial, and
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
// What bounds it: at the training recipe's N 160, D 200 the forward is
// 2 N^2 D = 10 MFLOP and reads 256 KB, so it is bound by launch latency;
// at N 4096 it is 6.7 GFLOP (the backward twice that) against 6.6 MB, so
// compute-bound, 0.1 ms at the H100's 67 TFLOP/s float32 rate outside the
// tensor cores. It uses f32 FMA on the CUDA cores (no TF32, no wgmma), so
// that it agrees with the plain version at float32 tolerance.
//
// Design. The TPU kernels carry the running (m, se, pos) and the ds and dt
// sums across a sequential grid axis in their output blocks; Hopper's
// blocks run in parallel and in no order, so each block owns whole outputs:
//   * normalisation: one warp per row, the normalised rows and their norms
//     go to a workspace the backward reuses;
//   * forward: a block per tile of 32 rows, its rows of s_n in shared
//     memory, walking the columns in tiles of 32 (t_n staged in shared
//     memory). Warp w holds rows w, w+8, w+16, w+24 and lane l column l, so
//     each row's online max and sum-exp are warp reductions;
//   * a one-block reduction sums the per-row losses in a fixed order;
//   * backward: a row pass (a block per 32 rows of ds) and a column pass (a
//     block per 32 rows of dt) recompute z, write the 32 x 32 tile of dz to
//     shared memory and accumulate dz t_n or dz^T s_n into a (32, D)
//     accumulator in shared memory; the pullback through the normalisation
//     is each pass's epilogue, since a block holds whole D-wide rows.
// No atomics anywhere, so the loss and both gradients are deterministic.
// Every z is the same sequential chain of fmaf over d, whichever pass
// computes it, so the backward's z equals the forward's bit for bit and
// exp(z - m) <= 1 holds exactly.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // rows and columns per tile
constexpr int kPerWarp = kTile / kWarps;  // rows (or columns) a warp holds
constexpr int kLdDz = kTile + 1;          // row stride of the dz tile
constexpr float kNeg = -1e30f;            // JAX's _NEG, not -inf
constexpr float kEps = 1e-12f;
constexpr int kMaxD = 512;                // keeps the backward under 227 KB

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane adds the same pairs, so all lanes agree exactly
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool is_valid(const float* mask, long long i) {
  return mask == nullptr || mask[i] > 0.0f;
}

// rows [row0, row0 + kTile) of x (n, d) into sh with row stride ld; rows
// past n are zero
__device__ __forceinline__ void load_tile(float* sh, const float* __restrict__ x,
                                          long long row0, long long n, int d, int ld) {
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
    const int r = i / d, k = i % d;
    const long long row = row0 + r;
    sh[r * ld + k] = row < n ? x[row * d + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
nce_normalize_kernel(const float* __restrict__ x, long long n, int d,
                     float* __restrict__ xn, float* __restrict__ norm) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const float* src = x + row * d;
  float ss = 0.0f;
  for (int k = lane; k < d; k += 32) ss = fmaf(src[k], src[k], ss);
  const float nrm = fmaxf(sqrtf(warp_sum(ss)), kEps);
  for (int k = lane; k < d; k += 32) xn[row * d + k] = src[k] / nrm;
  if (lane == 0) norm[row] = nrm;
}

__global__ void __launch_bounds__(kThreads)
nce_forward_kernel(const float* __restrict__ sn, const float* __restrict__ tn,
                   const float* __restrict__ vrow, const float* __restrict__ vcol,
                   long long nr, long long nc, int d, int ld, long long off, float tau,
                   float* __restrict__ m_out, float* __restrict__ denom_out,
                   float* __restrict__ pos_out, float* __restrict__ row_loss) {
  extern __shared__ float smem[];
  float* s_sh = smem;               // [kTile][ld]
  float* t_sh = smem + kTile * ld;  // [kTile][ld]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  load_tile(s_sh, sn, r0, nr, d, ld);

  float m[kPerWarp], se[kPerWarp], pos[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    m[i] = -CUDART_INF_F;
    se[i] = 0.0f;
    pos[i] = 0.0f;
  }
  for (long long c0 = 0; c0 < nc; c0 += kTile) {
    __syncthreads();  // the previous column tile is read (and s_sh stored)
    load_tile(t_sh, tn, c0, nc, d, ld);
    __syncthreads();
    const long long c = c0 + lane;
    const bool in = c < nc;
    const bool col_ok = in && is_valid(vcol, c);
    float acc[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) acc[i] = 0.0f;
    const float* tb = t_sh + lane * ld;
    for (int k = 0; k < d; ++k) {
      const float tk = tb[k];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i)
        acc[i] = fmaf(s_sh[(warp + kWarps * i) * ld + k], tk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const long long row = r0 + warp + kWarps * i;
      const float z = col_ok ? acc[i] / tau : kNeg;
      const float m_new = fmaxf(m[i], warp_max(in ? z : -CUDART_INF_F));
      const float e = warp_sum(in ? expf(z - m_new) : 0.0f);
      se[i] = se[i] * expf(m[i] - m_new) + e;
      m[i] = m_new;
      pos[i] += warp_sum(in && c == off + row ? z : 0.0f);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const long long row = r0 + warp + kWarps * i;
      if (row < nr) {
        const float denom = expf(pos[i] - m[i]) + se[i];
        const float per_row = -(pos[i] - m[i]) + logf(denom);
        m_out[row] = m[i];
        denom_out[row] = denom;
        pos_out[row] = pos[i];
        row_loss[row] = is_valid(vrow, row) ? per_row : 0.0f;
      }
    }
  }
}

// loss = sum(row_loss) (/ max(count, 1) with divide); count = valid rows
__global__ void __launch_bounds__(kThreads)
nce_reduce_kernel(const float* __restrict__ row_loss, const float* __restrict__ vrow,
                  long long nr, int divide, float* __restrict__ loss,
                  float* __restrict__ count) {
  __shared__ float ls[kThreads], cs[kThreads];
  float l = 0.0f, n = 0.0f;
  for (long long i = threadIdx.x; i < nr; i += kThreads) {
    l += row_loss[i];
    n += is_valid(vrow, i) ? 1.0f : 0.0f;
  }
  ls[threadIdx.x] = l;
  cs[threadIdx.x] = n;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      ls[threadIdx.x] += ls[threadIdx.x + s];
      cs[threadIdx.x] += cs[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    count[0] = cs[0];
    loss[0] = divide ? ls[0] / fmaxf(cs[0], 1.0f) : ls[0];
  }
}

// d(loss)/d(row-loss sum): the upstream gradient, over the valid count
// when the loss is a mean
__device__ __forceinline__ float effective_grad(const float* g, const float* count,
                                                int divide) {
  return divide ? g[0] / fmaxf(count[0], 1.0f) : g[0];
}

__device__ __forceinline__ float dz_of(float acc, bool col_ok, long long r, long long c,
                                       long long off, float tau, float m, float denom,
                                       float q_pos, float g_eff) {
  const float z = col_ok ? acc / tau : kNeg;
  float dz = expf(z - m) / denom * g_eff;
  if (c == off + r) dz += (q_pos - 1.0f) * g_eff;
  return dz;
}

// the pullback of a (kTile, d) block of gradients w.r.t. normalised rows
// (acc, in shared memory, before the 1 / tau) through x_n = x / |x|; the
// rows are warp w's rows w + 8 i
__device__ __forceinline__ void normalize_pullback(
    const float* acc, const float* xn_sh, int ld, int d, long long row0, long long n,
    float tau, const float* __restrict__ norm, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int lr = warp + kWarps * i;
    const long long row = row0 + lr;
    if (row >= n) continue;
    float dot = 0.0f;
    for (int k = lane; k < d; k += 32) dot = fmaf(acc[lr * d + k] / tau, xn_sh[lr * ld + k], dot);
    dot = warp_sum(dot);
    const float nrm = norm[row];
    for (int k = lane; k < d; k += 32)
      out[row * d + k] = (acc[lr * d + k] / tau - dot * xn_sh[lr * ld + k]) / nrm;
  }
}

__global__ void __launch_bounds__(kThreads)
nce_backward_rows_kernel(const float* __restrict__ sn, const float* __restrict__ tn,
                         const float* __restrict__ s_norm, const float* __restrict__ vrow,
                         const float* __restrict__ vcol, const float* __restrict__ m_in,
                         const float* __restrict__ denom_in, const float* __restrict__ pos_in,
                         const float* __restrict__ count, const float* __restrict__ g,
                         int divide, long long nr, long long nc, int d, int ld, long long off,
                         float tau, float* __restrict__ ds) {
  extern __shared__ float smem[];
  float* s_sh = smem;                 // [kTile][ld]
  float* t_sh = s_sh + kTile * ld;    // [kTile][ld]
  float* dz_sh = t_sh + kTile * ld;   // [kTile][kLdDz]
  float* acc_sh = dz_sh + kTile * kLdDz;  // [kTile][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  load_tile(s_sh, sn, r0, nr, d, ld);
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) acc_sh[i] = 0.0f;

  const float g_eff = effective_grad(g, count, divide);
  bool row_ok[kPerWarp];
  float m[kPerWarp], denom[kPerWarp], q_pos[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const long long row = r0 + warp + kWarps * i;
    row_ok[i] = row < nr && is_valid(vrow, row);
    m[i] = row_ok[i] ? m_in[row] : 0.0f;
    denom[i] = row_ok[i] ? denom_in[row] : 1.0f;
    q_pos[i] = row_ok[i] ? expf(pos_in[row] - m[i]) / denom[i] : 0.0f;
  }
  for (long long c0 = 0; c0 < nc; c0 += kTile) {
    __syncthreads();  // the previous tiles are read
    load_tile(t_sh, tn, c0, nc, d, ld);
    __syncthreads();
    const long long c = c0 + lane;
    const bool in = c < nc;
    const bool col_ok = in && is_valid(vcol, c);
    float acc[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) acc[i] = 0.0f;
    const float* tb = t_sh + lane * ld;
    for (int k = 0; k < d; ++k) {
      const float tk = tb[k];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i)
        acc[i] = fmaf(s_sh[(warp + kWarps * i) * ld + k], tk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int lr = warp + kWarps * i;
      dz_sh[lr * kLdDz + lane] =
          row_ok[i] && in ? dz_of(acc[i], col_ok, r0 + lr, c, off, tau, m[i], denom[i],
                                  q_pos[i], g_eff)
                          : 0.0f;
    }
    __syncthreads();
    // acc_sh[r][k] += sum_c dz[r][c] t_n[c][k]; each (r, k) has one owner
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int lr = warp + kWarps * i;
      for (int k = lane; k < d; k += 32) {
        float a = acc_sh[lr * d + k];
#pragma unroll 8
        for (int cc = 0; cc < kTile; ++cc) a = fmaf(dz_sh[lr * kLdDz + cc], t_sh[cc * ld + k], a);
        acc_sh[lr * d + k] = a;
      }
    }
  }
  normalize_pullback(acc_sh, s_sh, ld, d, r0, nr, tau, s_norm, ds);
}

__global__ void __launch_bounds__(kThreads)
nce_backward_cols_kernel(const float* __restrict__ sn, const float* __restrict__ tn,
                         const float* __restrict__ t_norm, const float* __restrict__ vrow,
                         const float* __restrict__ vcol, const float* __restrict__ m_in,
                         const float* __restrict__ denom_in, const float* __restrict__ pos_in,
                         const float* __restrict__ count, const float* __restrict__ g,
                         int divide, long long nr, long long nc, int d, int ld, long long off,
                         float tau, float* __restrict__ dt) {
  extern __shared__ float smem[];
  float* t_sh = smem;                 // [kTile][ld], this block's columns
  float* s_sh = t_sh + kTile * ld;    // [kTile][ld], the current rows
  float* dz_sh = s_sh + kTile * ld;   // [kTile rows][kLdDz]
  float* acc_sh = dz_sh + kTile * kLdDz;  // [kTile columns][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  load_tile(t_sh, tn, c0, nc, d, ld);
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) acc_sh[i] = 0.0f;

  const float g_eff = effective_grad(g, count, divide);
  bool col_in[kPerWarp], col_ok[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const long long c = c0 + warp + kWarps * i;
    col_in[i] = c < nc;
    col_ok[i] = col_in[i] && is_valid(vcol, c);
  }
  for (long long r0 = 0; r0 < nr; r0 += kTile) {
    __syncthreads();  // the previous tiles are read (and t_sh stored)
    load_tile(s_sh, sn, r0, nr, d, ld);
    __syncthreads();
    // lane l holds row r0 + l; warp w columns w + 8 i
    const long long row = r0 + lane;
    const bool row_ok = row < nr && is_valid(vrow, row);
    const float m = row_ok ? m_in[row] : 0.0f;
    const float denom = row_ok ? denom_in[row] : 1.0f;
    const float q_pos = row_ok ? expf(pos_in[row] - m) / denom : 0.0f;
    float acc[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) acc[i] = 0.0f;
    const float* sb = s_sh + lane * ld;
    for (int k = 0; k < d; ++k) {
      const float sk = sb[k];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i)
        acc[i] = fmaf(sk, t_sh[(warp + kWarps * i) * ld + k], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int lc = warp + kWarps * i;
      dz_sh[lane * kLdDz + lc] =
          row_ok && col_in[i] ? dz_of(acc[i], col_ok[i], row, c0 + lc, off, tau, m, denom,
                                      q_pos, g_eff)
                              : 0.0f;
    }
    __syncthreads();
    // acc_sh[c][k] += sum_r dz[r][c] s_n[r][k]; each (c, k) has one owner
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int lc = warp + kWarps * i;
      for (int k = lane; k < d; k += 32) {
        float a = acc_sh[lc * d + k];
#pragma unroll 8
        for (int rr = 0; rr < kTile; ++rr) a = fmaf(dz_sh[rr * kLdDz + lc], s_sh[rr * ld + k], a);
        acc_sh[lc * d + k] = a;
      }
    }
  }
  normalize_pullback(acc_sh, t_sh, ld, d, c0, nc, tau, t_norm, dt);
}

// an odd row stride: lanes reading 32 rows at one column hit 32 banks
int row_stride(long long d) { return static_cast<int>(d | 1); }

size_t forward_smem_bytes(long long d) {
  return sizeof(float) * 2 * kTile * row_stride(d);
}

size_t backward_smem_bytes(long long d) {
  return sizeof(float) * (2 * kTile * row_stride(d) + kTile * kLdDz + kTile * d);
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kTile - 1) / kTile); }

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// The dynamic shared memory a block takes at width d: forward (which 0)
// and either backward pass (which 1), in bytes.
extern "C" int info_nce_smem_bytes(long long d, int which) {
  return static_cast<int>(which == 0 ? forward_smem_bytes(d) : backward_smem_bytes(d));
}

// s (nr, d) and t (nc, d) float32; vrow (nr) and vcol (nc) float32 masks
// (> 0 is valid) or null for all valid; off: the column of row 0's positive.
// Writes the workspace sn (nr, d), tn (nc, d), s_norm (nr), t_norm (nc), the
// residuals m, denom, pos and row_loss (nr), then loss (one float) and
// count (one float, the valid rows). All contiguous on the current device.
// Launches on `stream` and returns the first cudaError_t (0 on success); it
// neither synchronises nor allocates. The caller keeps 1 <= nr, nc < 2^31
// and 1 <= d <= 512.
extern "C" int info_nce_forward(const float* s, const float* t, const float* vrow,
                                const float* vcol, long long nr, long long nc, long long d,
                                long long off, float tau, int divide, float* sn, float* tn,
                                float* s_norm, float* t_norm, float* m, float* denom,
                                float* pos, float* row_loss, float* loss, float* count,
                                void* stream) {
  if (nr <= 0 || nc <= 0 || d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = forward_smem_bytes(d);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(nce_forward_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nce_normalize_kernel<<<static_cast<unsigned>((nr + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      s, nr, static_cast<int>(d), sn, s_norm);
  nce_normalize_kernel<<<static_cast<unsigned>((nc + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      t, nc, static_cast<int>(d), tn, t_norm);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  nce_forward_kernel<<<blocks_for(nr), kThreads, smem, st>>>(
      sn, tn, vrow, vcol, nr, nc, static_cast<int>(d), row_stride(d), off, tau, m, denom, pos,
      row_loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  nce_reduce_kernel<<<1, kThreads, 0, st>>>(row_loss, vrow, nr, divide, loss, count);
  return static_cast<int>(cudaGetLastError());
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
  if (nr <= 0 || nc <= 0 || d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = backward_smem_bytes(d);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(nce_backward_rows_kernel), smem);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(nce_backward_cols_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int di = static_cast<int>(d), ld = row_stride(d);
  nce_backward_rows_kernel<<<blocks_for(nr), kThreads, smem, st>>>(
      sn, tn, s_norm, vrow, vcol, m, denom, pos, count, g, divide, nr, nc, di, ld, off, tau, ds);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  nce_backward_cols_kernel<<<blocks_for(nc), kThreads, smem, st>>>(
      sn, tn, t_norm, vrow, vcol, m, denom, pos, count, g, divide, nr, nc, di, ld, off, tau, dt);
  return static_cast<int>(cudaGetLastError());
}
