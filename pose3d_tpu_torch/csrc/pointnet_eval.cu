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
// of points read, so the kernel is compute-bound: 0.67 ms at the H100's
// 67 TFLOP/s float32 rate outside the tensor cores. It uses f32 FMA on the
// CUDA cores (no TF32, no wgmma), so that it agrees with the plain version
// at float32 tolerance; tensor cores are later work.
//
// Design. The TPU kernel carries the max across a sequential grid axis in
// its output block; Hopper's blocks run in parallel and in no order, so a
// block owns whole outputs instead:
//   * grid (cloud n, column chunk of W3, point segment). A block holds its
//     256-column chunk of W3 (128 KB), W2 (32 KB) and W1 in shared memory,
//     and walks its segment of the cloud in tiles of 64 points. Per tile it
//     computes layers 1 and 2 into shared memory (transposed, rows padded
//     to 68 floats against bank conflicts), then the 64 x 256 product of
//     layer 3 in registers: 256 threads, 8 points x 8 columns each. A
//     running max per column stays in registers; rows past the cloud's end
//     in the ragged last tile are left out of it. The max starts at -inf,
//     since the last layer has no ReLU.
//   * Layers 1 and 2 are recomputed for each column chunk: 8,384 FMAs a
//     point against 32,768 for the chunk at 256 columns, +26 % (+51 % at
//     128 columns, which is why the chunk is 256 wide).
//   * 213 KB of shared memory allow one block per SM, so the number of
//     blocks is what fills the card. When clouds x chunks would leave SMs
//     idle (serving at batch 1, or N 46), the wrapper splits each cloud's
//     points into segments: each block then writes its partial max to a
//     scratch (N, S, D) buffer and a second small kernel takes the max over
//     the segments and adds b3. No atomics: the result is deterministic.
//   * b3 is added after the max: rounding is monotone, so
//     max_p fl(a_p + b) == fl(max_p a_p + b) exactly.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC1 = 64;         // layer-1 width
constexpr int kC2 = 128;        // layer-2 width
constexpr int kTileP = 64;      // points per tile
constexpr int kChunkD = 256;    // W3 columns per block; == kThreads
constexpr int kLdH = kTileP + 4;  // row stride of the transposed activations

// shared memory, in floats, in this order
constexpr int kW3 = kC2 * kChunkD;
constexpr int kW2 = kC1 * kC2;
constexpr int kH2 = kC2 * kLdH;
constexpr int kH1 = kC1 * kLdH;
constexpr int kW1 = 3 * kC1;
constexpr int kX = 3 * kTileP;
constexpr int kSmemFloats = kW3 + kW2 + kH2 + kH1 + kW1 + kC1 + kC2 + kX;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;  // 218,368
static_assert(kSmemBytes <= 232448, "over Hopper's 227 KB a block");
static_assert(kChunkD == kThreads, "one thread per output column at the end");
static_assert(8 * kChunkD <= kH2, "the final reduction reuses the h2 buffer");

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads, 1)
pointnet_eval_kernel(const float* __restrict__ points,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     float* __restrict__ dst, int p_total, int d_total,
                     int tiles_per_segment, int add_bias) {
  extern __shared__ float4 smem4[];
  float* w3s = reinterpret_cast<float*>(smem4);  // [kC2][kChunkD]
  float* w2s = w3s + kW3;                        // [kC1][kC2]
  float* h2t = w2s + kW2;                        // [kC2][kLdH], h2 transposed
  float* h1t = h2t + kH2;                        // [kC1][kLdH], h1 transposed
  float* w1s = h1t + kH1;                        // [3][kC1]
  float* b1s = w1s + kW1;
  float* b2s = b1s + kC1;
  float* xs = b2s + kC2;                         // [kTileP][3]

  const int t = threadIdx.x;
  const long long n = blockIdx.x;
  const int d0 = blockIdx.y * kChunkD;
  const int segment = blockIdx.z;

  for (int i = t; i < kW3; i += kThreads) {
    const int d = d0 + i % kChunkD;
    w3s[i] = d < d_total ? w3[static_cast<long long>(i / kChunkD) * d_total + d] : 0.0f;
  }
  for (int i = t; i < kW2; i += kThreads) w2s[i] = w2[i];
  if (t < kW1) w1s[t] = w1[t];
  if (t < kC1) b1s[t] = b1[t];
  if (t < kC2) b2s[t] = b2[t];

  // thread roles: layer 1 writes column k1 of h1 for 16 points; layer 2 a
  // 4-point x 8-column block of h2; layer 3 an 8-point x 8-column block
  const int k1 = t % kC1, p1 = (t / kC1) * 16;
  const int ty2 = t / 16, tx2 = t % 16;
  const int ty = t / 32, tx = t % 32;

  float mx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mx[j] = -CUDART_INF_F;

  const float* cloud = points + n * p_total * 3;
  const int tiles = (p_total + kTileP - 1) / kTileP;
  const int tile_end = min(tiles, (segment + 1) * tiles_per_segment);
  for (int tile = segment * tiles_per_segment; tile < tile_end; ++tile) {
    const int p0 = tile * kTileP;
    const int valid = min(kTileP, p_total - p0);
    __syncthreads();  // the previous tile is read; the weights are stored
    if (t < kX) xs[t] = t < 3 * valid ? cloud[3LL * p0 + t] : 0.0f;
    __syncthreads();

    {  // layer 1: h1 = relu(x W1 + b1)
      const float wa = w1s[k1], wb = w1s[kC1 + k1], wc = w1s[2 * kC1 + k1];
      const float bk = b1s[k1];
#pragma unroll
      for (int q = 0; q < 16; q += 4) {
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = xs + 3 * (p1 + q + r);
          v[r] = relu(fmaf(x[2], wc, fmaf(x[1], wb, x[0] * wa)) + bk);
        }
        *reinterpret_cast<float4*>(h1t + k1 * kLdH + p1 + q) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    {  // layer 2: h2 = relu(h1 W2 + b2)
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < kC1; ++k) {
        const float4 a = ld4(h1t + k * kLdH + 4 * ty2);
        const float4 bl = ld4(w2s + k * kC2 + 4 * tx2);
        const float4 bh = ld4(w2s + k * kC2 + kC1 + 4 * tx2);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? 0 : kC1) + 4 * tx2 + (j & 3);
        const float bc = b2s[c];
        *reinterpret_cast<float4*>(h2t + c * kLdH + 4 * ty2) =
            make_float4(relu(acc[0][j] + bc), relu(acc[1][j] + bc),
                        relu(acc[2][j] + bc), relu(acc[3][j] + bc));
      }
    }
    __syncthreads();

    {  // layer 3 without its bias, and the running max over valid points
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < kC2; ++k) {
        const float4 a0 = ld4(h2t + k * kLdH + 8 * ty);
        const float4 a1 = ld4(h2t + k * kLdH + 8 * ty + 4);
        const float4 bl = ld4(w3s + k * kChunkD + 4 * tx);
        const float4 bh = ld4(w3s + k * kChunkD + kChunkD / 2 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (8 * ty + i < valid) {
#pragma unroll
          for (int j = 0; j < 8; ++j) mx[j] = fmaxf(mx[j], acc[i][j]);
        }
      }
    }
  }

  // max over the 8 point rows of threads, through shared memory
  __syncthreads();
  float* red = h2t;  // [8][kChunkD]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty * kChunkD + 4 * tx + j] = mx[j];
    red[ty * kChunkD + kChunkD / 2 + 4 * tx + j] = mx[4 + j];
  }
  __syncthreads();
  const int d = d0 + t;
  if (d < d_total) {
    float m = red[t];
#pragma unroll
    for (int r = 1; r < 8; ++r) m = fmaxf(m, red[r * kChunkD + t]);
    if (add_bias) m += b3[d];
    dst[(n * gridDim.z + segment) * d_total + d] = m;
  }
}

// out[n, d] = max_s partial[n, s, d] + b3[d]
__global__ void __launch_bounds__(kThreads)
segment_max_kernel(const float* __restrict__ partial, const float* __restrict__ b3,
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

}  // namespace

// The dynamic shared memory a block of the main kernel takes, in bytes.
extern "C" int pointnet_eval_smem_bytes() { return static_cast<int>(kSmemBytes); }

// points: (n, p, 3) float32; w1 (3, 64), b1 (64), w2 (64, 128), b2 (128),
// w3 (128, d), b3 (d): the folded parameters, float32; all contiguous on
// the current device. out: (n, d) float32. segments: blocks per cloud along
// the points (1 = no split); with segments > 1, partial is an (n,
// segments, d) float32 scratch buffer, else unused. Launches on `stream`
// and returns the first cudaError_t (0 on success); it neither
// synchronises nor allocates. The caller keeps n < 2^31, 3p < 2^31,
// d <= 65535 * 256 and segments <= 65535.
extern "C" int pointnet_eval(const float* points, const float* w1, const float* b1,
                             const float* w2, const float* b2, const float* w3,
                             const float* b3, float* out, float* partial, long long n,
                             long long p, long long d, int segments, void* stream) {
  if (n <= 0) return 0;
  if (p <= 0 || d <= 0 || segments <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pointnet_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (p + kTileP - 1) / kTileP;
  const int tiles_per_segment = static_cast<int>((tiles + segments - 1) / segments);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>((d + kChunkD - 1) / kChunkD),
                  static_cast<unsigned>(segments));
  pointnet_eval_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      points, w1, b1, w2, b2, w3, b3, segments == 1 ? out : partial,
      static_cast<int>(p), static_cast<int>(d), tiles_per_segment, segments == 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return static_cast<int>(err);
  long long blocks = (n * d + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  segment_max_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, b3, out, n, segments, static_cast<int>(d));
  return static_cast<int>(cudaGetLastError());
}
