// int8 post-training-quantized convolution for Hopper (sm_90a): an implicit
// GEMM with s8 x s8 -> s32 products on the tensor cores, and the same GEMM
// with VGG's 2x2 max-pool taken on its s32 sums.
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
// with x NHWC (f32 or bf16), w given K-major as wk[c][(ky, kx, ci)] (the
// OHWI copy of JAX's HWIO kernel, made once when a quantized tree is put on
// the device: serving/quant_student.py `_tensors`), a the per-tensor
// activation scale (a device scalar), ws the per-channel weight scale (the
// student's w_scale, or ResNet's w_scale * BN gain) and shift the
// per-channel shift (the bias, or the folded BN shift). `a * ws[c]` is one
// f32 product, formed before it meets z, as JAX forms `c["a"] * c["ws"]`. A
// dense layer is a 1x1 conv on a 1x1 image. Stride 1 or 2, any padding, any
// window. With `pool`, y[(n, py, px), c] = dequantize(max over dy, dx < 2 of
// z[(n, 2py + dy, 2px + dx), c]): JAX's order (pool the s32 sums, then
// dequantize; VALID, so an odd last row or column is never computed).
//
// What bounds it: at the main path's shapes the operations (2 M N K at
// 1,979 TOPS dense int8 on an H100 SXM) for VGG's and ResNet's 3x3 convs at
// batch 64-256; the bytes (x read once in its dtype, w once, y written once,
// at 3.35 TB/s) for the 1x1 convs, the first VGG conv and the dense layers.
// The design:
//   * a first pass quantizes x once, each element one IEEE division, into
//     an s8 NHWC copy (a quarter of an f32 input's bytes). Quantizing on
//     the conv's own load would divide each input element 9 x CO / BN
//     times over for a 3x3 conv (measured at 4 % of the int8 rate);
//   * the product (`int8_conv_wgmma_kernel`, the route of every C_in that is
//     a multiple of 16: all of the main path's) is Hopper's wgmma.mma_async
//     m64nNk32 s8 x s8 -> s32, both operands from shared memory, issued by
//     two warpgroups, each 64 rows of a 128 x BN block: the only way to the
//     card's int8 rate (an mma.sync kernel read 174-246 TOPS at VGG's 3x3
//     convs on an H100 SXM at 700 W, 12-18 % of it).
//     BN 256 (one block an SM, 168 registers a thread: half the weight
//     traffic an output of BN 128) where CO > 128, K >= 1024 and the
//     blocks fill the SMs; else BN 128 or 64, two blocks an SM, so that one
//     block's loads and epilogue overlap the other's products (short K:
//     VGG's first conv, ResNet's 1x1 convs);
//   * an asynchronous ring of k-tiles (128 k a stage, 192 KB of dynamic
//     shared memory an SM: 4 stages at BN 256, 3 at 128, 4 at 64 a block;
//     a K of one tile takes BN 64 three an SM, 2 stages each):
//     the weight tile, a plain 2-D box of the K-major (CO, K) matrix,
//     arrives by TMA
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda; the map a __grid_constant__ parameter),
//     completing on the stage's mbarrier; the window gather (im2col) of the
//     quantized input is one 16-byte cp.async a thread and row-chunk, zero
//     filled outside the image and past K (C_in % 16 == 0, so a chunk lies
//     in one tap). Both land in the 128-byte swizzle that the wgmma
//     descriptors name (TMA swizzles its box itself; the gather writes
//     chunk j of row r at j ^ (r % 8)). One to three tiles are in flight
//     ahead of the products; one barrier a tile frees the stage whose
//     products retired (at BN 256 one product group stays in flight across
//     it; where two blocks share the SM each waits for its products);
//   * the K-major copy is made once a tree, not a call: HWIO weights, whose
//     K is not the contiguous axis, would need a transpose on every tile
//     (the mma.sync kernel did it in registers) or every call;
//   * the epilogue dequantizes the s32 accumulators (the same __fmul_rn /
//     __fadd_rn pair), stages the tile in shared memory and writes it back
//     as 16-byte stores of whole rows, coalesced (the fragments' own 4- and
//     8-byte stores bound the 1x1 convs before);
//   * with `pool` the GEMM's rows are ordered ((n, py, px), dy, dx), so the
//     four pixels of a pool window are four neighbouring rows of one
//     warp's fragment: two shuffles take their s32 maximum before the
//     dequantization, and only a quarter of the pixels is written (VGG's
//     pre-pool convs wrote their full-resolution output, then read it back
//     for the pool);
//   * where the output tiles would not fill the SMs once (the dense layers,
//     small batches, ResNet's last stage), K is split over blocks, each
//     writing its s32 partial sums into a slab of its own, and a last
//     kernel adds the slabs (integers: exact, and in a fixed order), pools
//     and dequantizes (atomicAdd into one slab cost the dense layers more
//     than their products).
// Routes by shape (int8_conv_route): C_in % 16 == 0 takes the wgmma kernel;
// any other C_in (narrow or odd test widths, never the main path) takes
// `int8_conv_kernel`, the mma.sync.m16n8k32 kernel (128 x 64 tiles,
// register-staged double buffer, byte gathers), its weights read K-major
// too; it pools through the workspace. Both are bit-equal to
// ops/int8_conv.py int8_conv_plain / int8_conv_pool_plain.
// Left for later (ROADMAP.md): the ResNet residual add + ReLU fused into the
// epilogue, requantization into the next layer's s8 fused into the store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Conv {
  const int8_t* xq;  // the quantized input, NHWC s8
  const float* a;
  const int8_t* wk;  // the K-major weights, (co, k) s8
  const float* ws;
  const float* shift;
  void* y;
  int* acc;          // the workspace (splits x rows x co s32: a slab a K part), or null
  long long rows;    // the GEMM's rows: n * oh * ow, or n * ph * pw * 4 with pool
  int h, w_, c, oh, ow, co, kw, stride, pad, k, relu, pool, ph, pw, ktiles_per_split;
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

// The input pixel (image, top row, left column of the window) of GEMM row
// m; image -1 past the last row. With pool, m = ((n, py, px), dy, dx).
__device__ __forceinline__ void row_origin(const Conv& p, long long m, long long& img, int& iy0,
                                           int& ix0) {
  if (m >= p.rows) {
    img = -1;
    iy0 = ix0 = 0;
    return;
  }
  int oy, ox;
  if (p.pool) {
    const long long pm = m >> 2, per = static_cast<long long>(p.ph) * p.pw;
    const int d = static_cast<int>(m & 3);
    img = pm / per;
    const int r = static_cast<int>(pm - img * per);
    oy = 2 * (r / p.pw) + (d >> 1);
    ox = 2 * (r % p.pw) + (d & 1);
  } else {
    const long long per = static_cast<long long>(p.oh) * p.ow;
    img = m / per;
    const int r = static_cast<int>(m - img * per);
    oy = r / p.ow;
    ox = r % p.ow;
  }
  iy0 = oy * p.stride - p.pad;
  ix0 = ox * p.stride - p.pad;
}

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

// ---------------------------------------------------------------------------
// The wgmma route.

constexpr int kWBM = 128;      // GEMM rows a block: two warpgroups of 64
constexpr int kWBK = 128;      // k a stage: one 128-byte swizzled row
constexpr int kWThreads = 256;
constexpr int kRing = 196608;  // bytes of shared memory an SM's rings share: 192 KB
constexpr int kWideK = 1024;   // the least K that takes 128 x 256 blocks
constexpr int kTinyK = 128;    // K of one tile: 128 x 64 blocks, three an SM

// A block shape: BN channels, kCtas blocks an SM sharing its 192 KB
template <int BN, int kCtas>
struct Tile {
  static constexpr int kA = kWBM * kWBK;  // 16 KB
  static constexpr int kB = BN * kWBK;
  static constexpr int kStage = kA + kB;
  static constexpr int kRingBytes = kRing / kCtas;
  static constexpr int kStages = kRingBytes / kStage;
  // product groups left in flight at a tile's end: one where a block has
  // the SM alone, none where blocks share it (they take turns on it)
  static constexpr int kLag = kCtas == 1 ? 1 : 0;
  static constexpr int kAhead = kStages - 1 - kLag;  // tiles in flight ahead of the products
  static_assert(kAhead >= 1, "a tile ahead");
  // the ring, 1 KB for its alignment, one mbarrier a stage
  static constexpr int kSmem = kStages * kStage + 1024 + 8 * kStages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the generic proxy's writes (cp.async's) made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of the given parity to complete. A wait that never
// ends (a lost copy) traps after ~2^24 polls: a launch failure the wrapper
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
    if (spins > (1 << 24)) __trap();
  }
}

// the B tile: box {kWBK k, BN channels} at (k0, n0) of the K-major matrix
__device__ __forceinline__ void tma_load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int k0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(n0), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO unused by this layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
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
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, s32) += A (64 x 32 s8) * B (N x 32 s8)^T, both from shared memory
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}
template <int BN>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) { wgmma_n64(d, a, b); }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) { wgmma_n128(d, a, b); }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) { wgmma_n256(d, a, b); }
};

// One 128 x BN block of the GEMM over its share of K. 256 threads: two
// warpgroups, each the products of 64 rows; every thread gathers four
// 16-byte chunks of A a tile, thread 0 asks TMA for B.
template <typename T, int BN, int kCtas>
__global__ void __launch_bounds__(kWThreads, kCtas)
    int8_conv_wgmma_kernel(const Conv p, const __grid_constant__ CUtensorMap wmap) {
  using Cfg = Tile<BN, kCtas>;
  constexpr int S = Cfg::kStages;
  constexpr int kAcc = BN / 2;  // s32 accumulators a thread: 64 x BN over 128 threads
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // stages at 1024-byte aligned shared addresses: the 128-byte swizzle
  // repeats every 8 rows, and TMA and wgmma both read it from the address
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + S * Cfg::kStage);
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kWBM;
  const int n0 = blockIdx.y * BN;
  const int ktiles = (p.k + kWBK - 1) / kWBK;
  const int kt_begin = blockIdx.z * p.ktiles_per_split;
  const int nt = min(ktiles, kt_begin + p.ktiles_per_split) - kt_begin;
  const CUtensorMap* map = &wmap;  // the parameter's own address, which TMA reads

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the gather role: chunk gj (k 16 gj..16 gj + 15 of a tile) of rows
  // tid / 8 + 32 i, i < 4: a warp reads four rows' 128 bytes
  const int gj = tid & 7;
  long long g_img[4];
  int g_iy[4], g_ix[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_origin(p, m0 + (tid >> 3) + 32 * i, g_img[i], g_iy[i], g_ix[i]);

  // k-tile kt_begin + t into stage t % S
  auto issue = [&](int t) {
    uint8_t* st = ring + (t % S) * Cfg::kStage;
    const int kt = kt_begin + t;
    if (tid == 0) {
      const uint32_t bar = smem_addr(bars + t % S);
      mbar_expect_tx(bar, Cfg::kB);
      tma_load_b(smem_addr(st + Cfg::kA), map, bar, kt * kWBK, n0);
    }
    const int k0 = kt * kWBK + 16 * gj;
    const bool kin = k0 < p.k;
    int ci = 0, ky = 0, kx = 0;
    if (kin) {
      const int tap = k0 / p.c;
      ci = k0 - tap * p.c;
      ky = tap / p.kw;
      kx = tap - ky * p.kw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const int iy = g_iy[i] + ky, ix = g_ix[i] + kx;
      const bool ok = kin && g_img[i] >= 0 && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_;
      const int8_t* src =
          ok ? p.xq + ((g_img[i] * p.h + iy) * p.w_ + ix) * static_cast<long long>(p.c) + ci
             : p.xq;
      cp_async16(smem_addr(st + r * kWBK + ((gj ^ (r & 7)) << 4)), src, ok ? 16 : 0);
    }
  };

  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  fence_acc<kAcc>(acc);
  const int wg = tid >> 7;

  // the ring: kAhead tiles in flight ahead of the products; the stage of
  // tile t - 1 - kLag refilled once every warpgroup retired its products
  constexpr int kAhead = Cfg::kAhead;
#pragma unroll 1
  for (int t = 0; t < kAhead; ++t) {
    if (t < nt) issue(t);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    const int s = t % S;
    cp_async_wait<kAhead - 1>();  // this thread's chunks of tile t have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; tile t - 1 - kLag's products retired everywhere
    if (t + kAhead < nt) issue(t + kAhead);
    cp_async_commit();
    mbar_wait(smem_addr(bars + s), (t / S) & 1);  // B of tile t
    const uint32_t a_addr = smem_addr(ring + s * Cfg::kStage) + wg * 64 * kWBK;
    const uint32_t b_addr = smem_addr(ring + s * Cfg::kStage + Cfg::kA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 32; ++kk)
      Wgmma<BN>::run(acc, smem_desc(a_addr + 32 * kk), smem_desc(b_addr + 32 * kk));
    wgmma_commit();
    wgmma_wait<Cfg::kLag>();  // the products of tile t - kLag retired
  }
  wgmma_wait<0>();
  fence_acc<kAcc>(acc);

  // the accumulators: warp w of a warpgroup holds rows 16 w + lane / 4 and
  // + 8; element 4 j + 2 half + e is column 8 j + 2 (lane % 4) + e
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row_base = 64 * wg + 16 * ((tid >> 5) & 3) + g;
  if (p.acc != nullptr) {  // K split: this part's sums into its slab, the epilogue kernel adds them
    int* slab = p.acc + blockIdx.z * p.rows * p.co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + row_base + 8 * half;
        const int col = n0 + 8 * j + 2 * t4;
        if (row >= p.rows) continue;
        if (col < p.co) slab[row * p.co + col] = acc[4 * j + 2 * half];
        if (col + 1 < p.co) slab[row * p.co + col + 1] = acc[4 * j + 2 * half + 1];
      }
    return;
  }

  // the shared-memory epilogue: the dequantized tile staged in the ring
  // (rows padded so that the fragments' stores do not conflict), then
  // written back as 16-byte stores of whole rows
  const float a = __ldg(p.a);
  constexpr int kRowBytes = BN * static_cast<int>(sizeof(T)) + (sizeof(T) == 4 ? 32 : 16);
  static_assert(kWBM * kRowBytes <= S * Cfg::kStage, "the staged tile fits in the ring");
  __syncthreads();  // both warpgroups' products retired: the ring is free
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int z0 = acc[4 * j + 2 * half], z1 = acc[4 * j + 2 * half + 1];
      int r = row_base + 8 * half;
      if (p.pool) {  // the window is rows 4 i..4 i + 3: lanes 4 and 8 apart
        z0 = max(z0, __shfl_xor_sync(0xffffffffu, z0, 4));
        z1 = max(z1, __shfl_xor_sync(0xffffffffu, z1, 4));
        z0 = max(z0, __shfl_xor_sync(0xffffffffu, z0, 8));
        z1 = max(z1, __shfl_xor_sync(0xffffffffu, z1, 8));
        if (g & 3) continue;
        r >>= 2;
      }
      const int c = 8 * j + 2 * t4, col = n0 + c;
      const float v0 = col < p.co ? finish(p, a, col, z0) : 0.0f;
      const float v1 = col + 1 < p.co ? finish(p, a, col + 1, z1) : 0.0f;
      store_pair(reinterpret_cast<T*>(ring + r * kRowBytes) + c, v0, v1);
    }
  __syncthreads();
  constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  constexpr int kCpr = BN / kEpc;                          // chunks a row
  const int out_rows = p.pool ? kWBM / 4 : kWBM;
  const long long first = p.pool ? m0 / 4 : m0, last = p.pool ? p.rows / 4 : p.rows;
  const bool vec = p.co % kEpc == 0;
  T* y = static_cast<T*>(p.y);
  for (int q = tid; q < out_rows * kCpr; q += kWThreads) {
    const int r = q / kCpr, col = n0 + (q % kCpr) * kEpc;
    const long long row = first + r;
    if (row >= last || col >= p.co) continue;
    const uint8_t* src = ring + r * kRowBytes + (q % kCpr) * 16;
    T* dst = y + row * p.co + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kEpc && col + e < p.co; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
}

// ---------------------------------------------------------------------------
// The mma.sync route (C_in not a multiple of 16): the first version of this
// kernel, kept for the shapes the wgmma route does not take.

constexpr int kBM = 128;     // output pixels a block
constexpr int kBN = 64;      // output channels a block
constexpr int kBK = 64;      // k a tile (two m16n8k32 steps)
constexpr int kThreads = 128;
constexpr int kRow = 80;     // bytes a shared-memory row: 64 + 16, conflict-free fragment reads
constexpr int kAChunks = kBM * kBK / 16 / kThreads;  // 16-byte A chunks a thread a tile (4)
constexpr int kBChunks = kBN * kBK / 16 / kThreads;  // 16-byte B chunks a thread a tile (2)

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the word of channel n's k-word kw in a B stage (rows of 20 words)
__device__ __forceinline__ int b_word(int n, int kw) { return n * (kRow / 4) + (kw ^ ((n >> 3) & 15)); }

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
#pragma unroll
  for (int j = 0; j < kAChunks; ++j) row_origin(p, m0 + (tid >> 2) + 32 * j, a_img[j], iy0[j], ix0[j]);
  const bool a_vec = (p.c & 15) == 0;
  const bool b_vec = (p.k & 15) == 0;

  uint4 a_reg[kAChunks];
  uint4 b_reg[kBChunks];

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
    // B: chunk b = tid + 128 j is channel b / 4's k 16 (b % 4)..+15 of the
    // K-major weights, already the channel-major order of the mma's B
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int b = tid + kThreads * j;
      const int col = n0 + (b >> 2), kk0 = kt * kBK + 16 * (b & 3);
      uint32_t words[4] = {0, 0, 0, 0};
      if (col < p.co) {
        const int8_t* row = p.wk + static_cast<long long>(col) * p.k + kk0;
        if (b_vec && kk0 < p.k) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
          words[0] = v.x, words[1] = v.y, words[2] = v.z, words[3] = v.w;
        } else if (!b_vec) {
          for (int e = 0; e < 16 && kk0 + e < p.k; ++e)
            words[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[e])) << (8 * (e & 3));
        }
      }
      b_reg[j] = make_uint4(words[0], words[1], words[2], words[3]);
    }
  };

  auto store = [&](int s) {
#pragma unroll
    for (int j = 0; j < kAChunks; ++j)
      *reinterpret_cast<uint4*>(a_sh[s] + ((tid >> 2) + 32 * j) * kRow + 16 * ac) = a_reg[j];
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int b = tid + kThreads * j;
      const int n = b >> 2, kq = 4 * (b & 3);
      b_sh[s][b_word(n, kq + 0)] = b_reg[j].x;
      b_sh[s][b_word(n, kq + 1)] = b_reg[j].y;
      b_sh[s][b_word(n, kq + 2)] = b_reg[j].z;
      b_sh[s][b_word(n, kq + 3)] = b_reg[j].w;
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
        if (row >= p.rows || col >= p.co) continue;
        if (kSplit) {
          int* slab = p.acc + blockIdx.z * p.rows * p.co;
          slab[row * p.co + col] = z0;
          if (col + 1 < p.co) slab[row * p.co + col + 1] = z1;
        } else if (pairs) {
          store_pair(y + row * p.co + col, finish(p, a, col, z0),
                     finish(p, a, col + 1, z1));
        } else {
          store_out(y + row * p.co + col, finish(p, a, col, z0));
          if (col + 1 < p.co) store_out(y + row * p.co + col + 1, finish(p, a, col + 1, z1));
        }
      }
}

// the epilogue of a call through the workspace, one thread an output: the
// sum of its K parts' slabs (integers: exact in any order), with pool the
// maximum of the window's four sums, then the dequantization
template <typename T>
__global__ void __launch_bounds__(256) int8_conv_epilogue_kernel(const Conv p, int splits) {
  const float a = __ldg(p.a);
  const long long total = (p.pool ? p.rows / 4 : p.rows) * p.co;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long slab = p.rows * p.co;
  T* y = static_cast<T*>(p.y);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int col = static_cast<int>(i % p.co);
    const long long first = p.pool ? (i - col) * 4 + col : i;  // the window's first row
    int z = 0;
    for (int d = 0; d < (p.pool ? 4 : 1); ++d) {
      int sum = 0;
      for (int s = 0; s < splits; ++s) sum += p.acc[s * slab + first + d * p.co];
      z = d == 0 ? sum : max(z, sum);
    }
    store_out(y + i, finish(p, a, col, z));
  }
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

int wgmma_route(long long c) { return c % 16 == 0; }
// The block shape of a call: 128 x 64 or 128 x 128 blocks two an SM (the
// one's loads and epilogue overlap the other's products) up to 128
// channels, where K is short, or where 128 x 256 blocks would not fill the
// SMs once; else 128 x 256, one an SM (half the weight traffic an output).
// A K of one tile (ResNet's 1x1 convs from 64 channels) takes 128 x 64
// blocks three an SM: nothing to pipeline, and more blocks hide the loads'
// and the stores' latency
int bn_for(long long rows, long long co, long long k) {
  if (co <= 64 || k <= kTinyK) return 64;
  if (co <= 128 || k < kWideK) return 128;
  return ((rows + kWBM - 1) / kWBM) * ((co + 255) / 256) >= sm_count() ? 256 : 128;
}

// k tiles a block: all of them, unless the output tiles would not give
// every SM a block (the wgmma route: the slabs' round trip costs more than
// a second block an SM gains) or two (the mma.sync route); then K is split,
// each part at least `least` tiles (2 of 128 k on the wgmma route, 4 of 64
// on the other)
int ktiles_per_split(long long rows, long long co, long long k, long long c) {
  const bool wg = wgmma_route(c);
  const long long bm = wg ? kWBM : kBM, bn = wg ? bn_for(rows, co, k) : kBN;
  const long long bk = wg ? kWBK : kBK, least = wg ? 2 : 4;
  const long long blocks = ((rows + bm - 1) / bm) * ((co + bn - 1) / bn);
  const long long ktiles = (k + bk - 1) / bk;
  const long long want = (wg ? 1LL : 2LL) * sm_count();
  if (blocks >= want || ktiles < 2 * least) return static_cast<int>(ktiles);
  long long splits = (want + blocks - 1) / blocks;
  if (splits > ktiles / least) splits = ktiles / least;
  if (splits < 1) splits = 1;
  return static_cast<int>((ktiles + splits - 1) / splits);
}

int splits_of(long long rows, long long co, long long k, long long c) {
  const long long bk = wgmma_route(c) ? kWBK : kBK;
  const long long ktiles = (k + bk - 1) / bk;
  const long long per = ktiles_per_split(rows, co, k, c);
  return static_cast<int>((ktiles + per - 1) / per);
}

// the workspace's s32 elements: a (rows x co) slab a K part where K is
// split, or where the mma.sync route pools; else none
long long workspace(long long rows, long long co, long long k, long long c, int pool) {
  const int splits = splits_of(rows, co, k, c);
  return splits > 1 || (pool && !wgmma_route(c)) ? splits * rows * co : 0;
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

template <typename T, int BN, int kCtas>
int launch_wgmma(const Conv& p, dim3 grid, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k), static_cast<cuuint64_t>(p.co)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k)};  // bytes from channel to channel
  const cuuint32_t box[2] = {kWBK, BN};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.wk),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  if (r != CUDA_SUCCESS) return -static_cast<int>(r) - 1000;
  static bool sized = false;  // one instantiation's shared-memory allowance, set once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_wgmma_kernel<T, BN, kCtas>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN, kCtas>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  int8_conv_wgmma_kernel<T, BN, kCtas>
      <<<grid, kWThreads, Tile<BN, kCtas>::kSmem, stream>>>(p, map);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* a, const int8_t* wk, const float* ws, const float* shift,
           void* y, int8_t* xq, int* acc, long long n, long long h, long long wd, long long c,
           long long kh, long long kw, long long stride, long long pad, long long oh,
           long long ow, long long co, int relu, int pool, cudaStream_t stream) {
  Conv p;
  p.xq = xq;
  p.a = a;
  p.wk = wk;
  p.ws = ws;
  p.shift = shift;
  p.y = y;
  p.acc = nullptr;
  p.pool = pool;
  p.ph = static_cast<int>(oh / 2);
  p.pw = static_cast<int>(ow / 2);
  p.rows = pool ? 4 * n * p.ph * p.pw : n * oh * ow;
  if (p.rows == 0 || co == 0) return 0;
  const long long elements = n * h * wd * c;
  int8_quantize_kernel<T><<<blocks_for((elements + 15) / 16, 256), 256, 0, stream>>>(
      static_cast<const T*>(x), a, xq, elements);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
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
  p.ktiles_per_split = ktiles_per_split(p.rows, co, p.k, c);
  const bool wg = wgmma_route(c);
  const int splits = splits_of(p.rows, co, p.k, c);
  if (workspace(p.rows, co, p.k, c, pool) > 0) {
    if (acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.acc = acc;  // every slab element is written: nothing to zero
  }
  int rc;
  if (wg) {
    const int bn = bn_for(p.rows, co, p.k);
    const dim3 grid(static_cast<unsigned>((p.rows + kWBM - 1) / kWBM),
                    static_cast<unsigned>((co + bn - 1) / bn), static_cast<unsigned>(splits));
    rc = bn == 64 && p.k <= kTinyK ? launch_wgmma<T, 64, 3>(p, grid, stream)
         : bn == 64                ? launch_wgmma<T, 64, 2>(p, grid, stream)
         : bn == 128               ? launch_wgmma<T, 128, 2>(p, grid, stream)
                                   : launch_wgmma<T, 256, 1>(p, grid, stream);
  } else {
    const dim3 grid(static_cast<unsigned>((p.rows + kBM - 1) / kBM),
                    static_cast<unsigned>((co + kBN - 1) / kBN), static_cast<unsigned>(splits));
    if (p.acc == nullptr)
      int8_conv_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
    else
      int8_conv_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0 || p.acc == nullptr) return rc;
  int8_conv_epilogue_kernel<T>
      <<<blocks_for((pool ? p.rows / 4 : p.rows) * co, 256), 256, 0, stream>>>(p, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route a call takes: 0 the wgmma kernel (C_in a multiple of 16), 1
// the mma.sync kernel.
extern "C" int int8_conv_route(long long c) { return wgmma_route(c) ? 0 : 1; }

// The s32 elements of the workspace a call needs (0: none): a (rows x co)
// slab a K part where K is split over blocks, or where the mma.sync route
// pools. rows: n * oh * ow, or 4 n (oh / 2) (ow / 2) with pool.
extern "C" long long int8_conv_workspace(long long rows, long long co, long long k, long long c,
                                         int pool) {
  if (rows <= 0 || co <= 0 || k <= 0) return 0;
  return workspace(rows, co, k, c, pool);
}

// x: NHWC (n, h, w, c) f32 or bf16 (kind 0 or 2: the bits of __nv_bfloat16);
// a: one f32 on the device; wk: the K-major weights (co, kh, kw, c) s8,
// 16-byte aligned; ws, shift: (co,) f32; y: (n, oh, ow, co) in x's dtype, or
// (n, oh / 2, ow / 2, co) with pool; xq: an (n, h, w, c) s8 scratch for the
// quantized input; acc: the workspace or null. Three launches at most: the
// quantization, the product, the workspace's epilogue. Returns 0, a
// cudaError_t, -1 (no cuTensorMapEncodeTiled) or -1000 - CUresult (the
// weights' tensor map refused).
extern "C" int int8_conv(const void* x, int kind, const float* a, const int8_t* wk,
                         const float* ws, const float* shift, void* y, void* xq, int* acc,
                         long long n, long long h, long long wd, long long c, long long kh,
                         long long kw, long long stride, long long pad, long long oh,
                         long long ow, long long co, int relu, int pool, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  if (kind == 0)
    return launch<float>(x, a, wk, ws, shift, y, q, acc, n, h, wd, c, kh, kw, stride, pad, oh,
                         ow, co, relu, pool, st);
  if (kind == 2)
    return launch<__nv_bfloat16>(x, a, wk, ws, shift, y, q, acc, n, h, wd, c, kh, kw, stride,
                                 pad, oh, ow, co, relu, pool, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
