// int8 post-training-quantized convolution for Hopper (sm_90a): an implicit
// GEMM with s8 x s8 -> s32 products on the tensor cores.
//
// Replaces no TPU kernel. The JAX package's int8 serving path
// (pose3d_tpu/serving/quant_student.py, quant_teacher.py) computes its
// products with XLA's convolution (`jax.lax.conv_general_dilated(...,
// preferred_element_type=int32)`), not with Pallas. PyTorch on CUDA has no
// int8 convolution, and cuDNN's is not reachable from it; im2col with
// `torch._int_mm` would materialise the patches (1.85 GB of s8 for one VGG
// conv at batch 256) and refuses M <= 16, so batch-1 serving could not take
// it. This kernel is the port's int8 product for every int8 conv and dense
// layer of the student (VGG-11) and the teachers (ResNet-50, ResNet-18).
//
// Function, per output pixel m = (n, oy, ox) and channel c:
//   q(v) = clamp(rint(float(v) / a), -127, 127)     (IEEE division, round
//                                                     half to even; never -128)
//   z[m, c] = sum over (ky, kx, ci) of q(x[n, oy*s - p + ky, ox*s - p + kx, ci])
//             * w[ky, kx, ci, c]                      (s32; 0 outside the image)
//   y[m, c] = float(z) * (a * ws[c]) + shift[c]       (two rounded operations,
//                                                     __fmul_rn then __fadd_rn:
//                                                     no FMA), then the ReLU
//                                                     if asked, stored in the
//                                                     input's dtype (f32 or bf16)
// with x NHWC (f32 or bf16), w HWIO s8 (JAX's layout: the GEMM's K x N
// matrix, K = (ky, kx, ci)), a the per-tensor activation scale (a device
// scalar), ws the per-channel weight scale (the student's w_scale, or
// ResNet's w_scale * BN gain) and shift the per-channel shift (the bias, or
// the folded BN shift). `a * ws[c]` is one f32 product, formed before it
// meets z, as JAX forms `c["a"] * c["ws"]`. A dense layer is a 1x1 conv on a
// 1x1 image. Stride 1 or 2, any padding, any window.
//
// What bounds it: at the main path's shapes the operations (2 M N K at
// 1,979 TOPS dense int8 on an H100 SXM) and the bytes (x read once in its
// dtype, w once, y written once, at 3.35 TB/s) are close for the 3x3 convs
// and the dense layers at batch 256; the dense layers at batch 1 are bound
// by the weight bytes. The design, simple and right first:
//   * a first pass quantizes x once, each element one IEEE division, into
//     an s8 NHWC copy (a quarter of an f32 input's bytes). Quantizing on
//     the conv's own load would divide each input element 9 x CO / 64 times
//     over for a 3x3 conv: measured on an H100 at 4 % of the int8 rate;
//   * tiles of 128 pixels x 64 channels x 64 k, 128 threads (4 warps, each
//     a 64 x 32 sub-tile of 4 x 4 mma.sync.m16n8k32 s8 products, two k-steps
//     a tile), two shared-memory stages: the next tile is read into
//     registers while the current one is multiplied, then stored into the
//     other stage, one barrier a tile;
//   * the window gather (im2col) reads 16 bytes of one tap's channels a
//     load when C_in is a multiple of 16, a byte at a time otherwise;
//   * the weight tile (64 k x 64 channels of HWIO) is read as 4-byte rows
//     and transposed in registers (__byte_perm) into the channel-major order
//     the mma's B operand takes; its shared-memory words are swizzled by
//     the channel's 8-group so that the transposed stores conflict at most
//     two ways and the fragment reads not at all;
//   * where the output tiles would not fill two waves of the SMs (the dense
//     layers, small batches), K is split over blocks that add their s32
//     partials into a zeroed workspace with atomicAdd -- integer sums, so the
//     result is the same in any order -- and a third kernel applies the
//     epilogue.
// Left for later (ROADMAP.md): wgmma and TMA, the 2x2 max-pool and the
// residual add fused into the epilogue, requantization fused into the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output pixels a block
constexpr int kBN = 64;      // output channels a block
constexpr int kBK = 64;      // k a tile (two m16n8k32 steps)
constexpr int kThreads = 128;
constexpr int kRow = 80;     // bytes a shared-memory row: 64 + 16, conflict-free fragment reads
constexpr int kAChunks = kBM * kBK / 16 / kThreads;  // 16-byte A chunks a thread a tile (4)
constexpr int kBBlocks = kBN * kBK / 16 / kThreads;  // 4 x 4-byte B blocks a thread a tile (2)

struct Conv {
  const int8_t* xq;  // the quantized input, NHWC s8
  const float* a;
  const int8_t* w;
  const float* ws;
  const float* shift;
  void* y;
  int* acc;  // the split-K workspace (m x co s32), or null
  long long m;  // n * oh * ow
  int h, w_, c, oh, ow, co, kw, stride, pad, k, relu, ktiles_per_split;
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t quantize(float v, float a) {
  float q = rintf(__fdiv_rn(v, a));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(q))));
}

__device__ __forceinline__ uint32_t pack4(float v0, float v1, float v2, float v3, float a) {
  return quantize(v0, a) | (quantize(v1, a) << 8) | (quantize(v2, a) << 16) |
         (quantize(v3, a) << 24);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 16 consecutive values -> 4 words of s8, in memory order
__device__ __forceinline__ uint4 quantize16(const float* p, float a) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2), v3 = __ldg(v + 3);
  return make_uint4(pack4(v0.x, v0.y, v0.z, v0.w, a), pack4(v1.x, v1.y, v1.z, v1.w, a),
                    pack4(v2.x, v2.y, v2.z, v2.w, a), pack4(v3.x, v3.y, v3.z, v3.w, a));
}

__device__ __forceinline__ uint4 quantize16(const __nv_bfloat16* p, float a) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const uint4 u0 = __ldg(v), u1 = __ldg(v + 1);
  return make_uint4(pack4(bf16_lo(u0.x), bf16_hi(u0.x), bf16_lo(u0.y), bf16_hi(u0.y), a),
                    pack4(bf16_lo(u0.z), bf16_hi(u0.z), bf16_lo(u0.w), bf16_hi(u0.w), a),
                    pack4(bf16_lo(u1.x), bf16_hi(u1.x), bf16_lo(u1.y), bf16_hi(u1.y), a),
                    pack4(bf16_lo(u1.z), bf16_hi(u1.z), bf16_lo(u1.w), bf16_hi(u1.w), a));
}

// the first pass: xq = q(x), 16 elements a thread where the size allows
template <typename T>
__global__ void __launch_bounds__(256) int8_quantize_kernel(const T* __restrict__ x,
                                                            const float* a_ptr,
                                                            int8_t* __restrict__ xq,
                                                            long long n) {
  const float a = __ldg(a_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long groups = n / 16;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < groups;
       i += stride)
    reinterpret_cast<uint4*>(xq)[i] = quantize16(x + 16 * i, a);
  for (long long i = 16 * groups + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    xq[i] = static_cast<int8_t>(quantize(load_f32(x + i), a));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the word of channel n's k-word kw in a B stage (rows of 20 words)
__device__ __forceinline__ int b_word(int n, int kw) { return n * (kRow / 4) + (kw ^ ((n >> 3) & 15)); }

__device__ __forceinline__ void store_out(float* y, float v) { *y = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}
// two neighbouring outputs, the first at an even element: one 8- or 4-byte store
__device__ __forceinline__ void store_pair(float* y, float v0, float v1) {
  *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* y, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
}

// the epilogue of one s32 sum: y = float(z) * (a * ws[c]) + shift[c], two
// rounded operations, then the ReLU (the caller rounds it to its dtype)
__device__ __forceinline__ float finish(const Conv& p, float a, int col, int z) {
  const float scale = __fmul_rn(a, __ldg(p.ws + col));
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(z), scale), __ldg(p.shift + col));
  return (p.relu && !(v > 0.0f)) ? 0.0f : v;
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Conv p) {
  __shared__ __align__(16) uint8_t a_sh[2][kBM * kRow];
  __shared__ __align__(16) uint32_t b_sh[2][kBN * kRow / 4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ktiles = (p.k + kBK - 1) / kBK;
  const int kt_begin = blockIdx.z * p.ktiles_per_split;
  const int kt_end = min(ktiles, kt_begin + p.ktiles_per_split);
  const float a = __ldg(p.a);

  // the A role: chunk c = tid & 3 (k 16c..16c+15 of each tile) of rows
  // (tid >> 2) + 32 j, j < 4
  const int ac = tid & 3;
  long long a_img[kAChunks];
  int iy0[kAChunks], ix0[kAChunks];
  const long long per_img = static_cast<long long>(p.oh) * p.ow;
#pragma unroll
  for (int j = 0; j < kAChunks; ++j) {
    const long long am = m0 + (tid >> 2) + 32 * j;
    if (am < p.m) {
      a_img[j] = am / per_img;
      const int r = static_cast<int>(am - a_img[j] * per_img);
      iy0[j] = (r / p.ow) * p.stride - p.pad;
      ix0[j] = (r % p.ow) * p.stride - p.pad;
    } else {
      a_img[j] = -1;
      iy0[j] = ix0[j] = 0;
    }
  }
  const bool a_vec = (p.c & 15) == 0;
  const bool b_vec = (p.co & 3) == 0;

  uint4 a_reg[kAChunks];
  uint32_t b_reg[kBBlocks][4];

  auto load = [&](int kt) {
    const int k0 = kt * kBK + 16 * ac;
    if (a_vec) {
      int tap = 0, ci = 0, ky = 0, kx = 0;
      const bool kin = k0 < p.k;
      if (kin) {
        tap = k0 / p.c;
        ci = k0 - tap * p.c;
        ky = tap / p.kw;
        kx = tap - ky * p.kw;
      }
#pragma unroll
      for (int j = 0; j < kAChunks; ++j) {
        const int iy = iy0[j] + ky, ix = ix0[j] + kx;
        if (kin && a_img[j] >= 0 && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_)
          a_reg[j] = __ldg(reinterpret_cast<const uint4*>(
              p.xq + ((a_img[j] * p.h + iy) * p.w_ + ix) * p.c + ci));
        else
          a_reg[j] = make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kAChunks; ++j) {
        uint32_t words[4] = {0, 0, 0, 0};
        for (int e = 0; e < 16; ++e) {
          const int kk = k0 + e;
          if (kk >= p.k || a_img[j] < 0) continue;
          const int tap = kk / p.c, ci = kk - tap * p.c;
          const int iy = iy0[j] + tap / p.kw, ix = ix0[j] + tap % p.kw;
          if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w_) continue;
          words[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                               p.xq[((a_img[j] * p.h + iy) * p.w_ + ix) * p.c + ci]))
                           << (8 * (e & 3));
        }
        a_reg[j] = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    // B: block b = tid + 128 j is k-word kq = b / 16 (k 4kq..4kq+3) of
    // channels 4 nq..4 nq+3, nq = b % 16
#pragma unroll
    for (int j = 0; j < kBBlocks; ++j) {
      const int b = tid + kThreads * j;
      const int col = n0 + 4 * (b % 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = kt * kBK + 4 * (b / 16) + i;
        uint32_t word = 0;
        if (kk < p.k && col < p.co) {
          const int8_t* row = p.w + static_cast<long long>(kk) * p.co + col;
          if (b_vec) {
            word = __ldg(reinterpret_cast<const uint32_t*>(row));
          } else {
            for (int e = 0; e < 4; ++e)
              if (col + e < p.co)
                word |= static_cast<uint32_t>(static_cast<uint8_t>(row[e])) << (8 * e);
          }
        }
        b_reg[j][i] = word;
      }
    }
  };

  auto store = [&](int s) {
#pragma unroll
    for (int j = 0; j < kAChunks; ++j)
      *reinterpret_cast<uint4*>(a_sh[s] + ((tid >> 2) + 32 * j) * kRow + 16 * ac) = a_reg[j];
#pragma unroll
    for (int j = 0; j < kBBlocks; ++j) {
      const int b = tid + kThreads * j;
      const int kq = b / 16, n = 4 * (b % 16);
      // transpose the 4 x 4 bytes: word jj holds channel n + jj's k 4kq..4kq+3
      const uint32_t lo01 = __byte_perm(b_reg[j][0], b_reg[j][1], 0x5140);
      const uint32_t hi01 = __byte_perm(b_reg[j][0], b_reg[j][1], 0x7362);
      const uint32_t lo23 = __byte_perm(b_reg[j][2], b_reg[j][3], 0x5140);
      const uint32_t hi23 = __byte_perm(b_reg[j][2], b_reg[j][3], 0x7362);
      b_sh[s][b_word(n + 0, kq)] = __byte_perm(lo01, lo23, 0x5410);
      b_sh[s][b_word(n + 1, kq)] = __byte_perm(lo01, lo23, 0x7632);
      b_sh[s][b_word(n + 2, kq)] = __byte_perm(hi01, hi23, 0x5410);
      b_sh[s][b_word(n + 3, kq)] = __byte_perm(hi01, hi23, 0x7632);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;

  if (kt_begin < kt_end) {
    load(kt_begin);
    store(0);
  }
  __syncthreads();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int s = (kt - kt_begin) & 1;
    const bool more = kt + 1 < kt_end;
    if (more) load(kt + 1);  // in flight while this tile is multiplied
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* r0 = a_sh[s] + (wm + 16 * i + g) * kRow + 32 * ks + 4 * t;
        const uint8_t* r8 = r0 + 8 * kRow;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        const uint32_t b0 = b_sh[s][b_word(n, 8 * ks + t)];
        const uint32_t b1 = b_sh[s][b_word(n, 8 * ks + 4 + t)];
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    if (more) store(s ^ 1);  // the other stage was last read before the barrier below
    __syncthreads();
  }

  // c fragment: element e of tile (i, j) is row g (+8 for e >= 2), column
  // 2t + (e & 1); a row's two columns are stored as one pair where CO is even
  T* y = static_cast<T*>(p.y);
  const bool pairs = (p.co & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wm + 16 * i + g + 8 * half;
        const int col = n0 + wn + 8 * j + 2 * t;
        const int z0 = acc[i][j][2 * half], z1 = acc[i][j][2 * half + 1];
        if (row >= p.m || col >= p.co) continue;
        if (kSplit) {
          atomicAdd(p.acc + row * p.co + col, z0);
          if (col + 1 < p.co) atomicAdd(p.acc + row * p.co + col + 1, z1);
        } else if (pairs) {
          store_pair(y + row * p.co + col, finish(p, a, col, z0),
                     finish(p, a, col + 1, z1));
        } else {
          store_out(y + row * p.co + col, finish(p, a, col, z0));
          if (col + 1 < p.co) store_out(y + row * p.co + col + 1, finish(p, a, col + 1, z1));
        }
      }
}

// the epilogue of a split-K call, one thread an output
template <typename T>
__global__ void __launch_bounds__(256) int8_conv_epilogue_kernel(const Conv p) {
  const float a = __ldg(p.a);
  const long long total = p.m * p.co;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  T* y = static_cast<T*>(p.y);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride)
    store_out(y + i, finish(p, a, static_cast<int>(i % p.co), p.acc[i]));
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int blocks_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 32LL * sm_count()) blocks = 32LL * sm_count();
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// k tiles a block: all of them, unless the output tiles would not fill two
// waves of the SMs; then K is split, each part at least 4 tiles
int ktiles_per_split(long long m, long long co, long long k) {
  const long long blocks = ((m + kBM - 1) / kBM) * ((co + kBN - 1) / kBN);
  const long long ktiles = (k + kBK - 1) / kBK;
  const long long want = 2LL * sm_count();
  if (blocks >= want || ktiles < 8) return static_cast<int>(ktiles);
  long long splits = (want + blocks - 1) / blocks;
  if (splits > ktiles / 4) splits = ktiles / 4;
  if (splits < 1) splits = 1;
  return static_cast<int>((ktiles + splits - 1) / splits);
}

template <typename T>
int launch(const void* x, const float* a, const int8_t* w, const float* ws, const float* shift,
           void* y, int8_t* xq, int* acc, long long n, long long h, long long wd, long long c,
           long long kh, long long kw, long long stride, long long pad, long long oh,
           long long ow, long long co, int relu, cudaStream_t stream) {
  const long long elements = n * h * wd * c;
  int8_quantize_kernel<T><<<blocks_for((elements + 15) / 16, 256), 256, 0, stream>>>(
      static_cast<const T*>(x), a, xq, elements);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Conv p;
  p.xq = xq;
  p.a = a;
  p.w = w;
  p.ws = ws;
  p.shift = shift;
  p.y = y;
  p.acc = nullptr;
  p.m = n * oh * ow;
  p.h = static_cast<int>(h);
  p.w_ = static_cast<int>(wd);
  p.c = static_cast<int>(c);
  p.oh = static_cast<int>(oh);
  p.ow = static_cast<int>(ow);
  p.co = static_cast<int>(co);
  p.kw = static_cast<int>(kw);
  p.stride = static_cast<int>(stride);
  p.pad = static_cast<int>(pad);
  p.k = static_cast<int>(kh * kw * c);
  p.relu = relu;
  p.ktiles_per_split = ktiles_per_split(p.m, co, p.k);
  const int ktiles = (p.k + kBK - 1) / kBK;
  const int splits = (ktiles + p.ktiles_per_split - 1) / p.ktiles_per_split;
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN), static_cast<unsigned>(splits));
  if (splits <= 1) {
    int8_conv_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.acc = acc;
  err = cudaMemsetAsync(acc, 0, sizeof(int) * p.m * co, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_conv_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_conv_epilogue_kernel<T><<<blocks_for(p.m * co, 256), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of K splits a call takes (1: no workspace; more: the caller
// passes an (m x co) s32 workspace, which the call zeroes).
extern "C" int int8_conv_splits(long long m, long long co, long long k) {
  if (m <= 0 || co <= 0 || k <= 0) return 1;
  const long long ktiles = (k + kBK - 1) / kBK;
  const long long per = ktiles_per_split(m, co, k);
  return static_cast<int>((ktiles + per - 1) / per);
}

// x: NHWC (n, h, w, c) f32 or bf16 (kind 0 or 2: the bits of __nv_bfloat16);
// a: one f32 on the device; w: HWIO (kh, kw, c, co) s8; ws, shift: (co,) f32;
// y: (n, oh, ow, co) in x's dtype; xq: an (n, h, w, c) s8 scratch for the
// quantized input; acc: the split-K workspace or null. Three launches at
// most: the quantization, the product, the split-K epilogue.
extern "C" int int8_conv(const void* x, int kind, const float* a, const int8_t* w,
                         const float* ws, const float* shift, void* y, void* xq, int* acc,
                         long long n, long long h, long long wd, long long c, long long kh,
                         long long kw, long long stride, long long pad, long long oh,
                         long long ow, long long co, int relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n * oh * ow == 0 || co == 0) return 0;
  int8_t* q = static_cast<int8_t*>(xq);
  if (kind == 0)
    return launch<float>(x, a, w, ws, shift, y, q, acc, n, h, wd, c, kh, kw, stride, pad, oh,
                         ow, co, relu, st);
  if (kind == 2)
    return launch<__nv_bfloat16>(x, a, w, ws, shift, y, q, acc, n, h, wd, c, kh, kw, stride,
                                 pad, oh, ow, co, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
