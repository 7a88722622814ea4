// Geodesic rotation error between viewpoint label triples, for Hopper (sm_90a).
//
// Replaces the TPU kernel pose3d_tpu/ops/geodesic.py rotation_err_pallas
// (_kernel, _err_math). Same function as pose3d_tpu_torch/geometry.py
// rotation_err: per row, two rotations R = Rz(inp) Rx(ele) Rz(-azi) from
// (azi, ele - 180, inp - 180) degrees; the trace of their elementwise
// product; clamp(trace, -1, 3) (the reference's quirk); then
// acos((t - 1) / 2) in degrees. The TPU kernel stops at the cosine because
// Mosaic has no acos; here acosf runs in the kernel.
//
// What bounds it: each row reads 24 bytes and writes 4, against about 200
// floating-point operations, so the kernel is memory-bound; at evaluation
// sizes (1e3 to 1e6 rows) the launch latency dominates. The design follows:
// one thread per row in a grid-stride loop, 256 threads a block, no shared
// memory, and one sincosf per angle (six per row) instead of a sin and a cos
// per matrix element. It is built without --use_fast_math: the __sinf
// intrinsics lose accuracy at arguments of hundreds of degrees.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs many times over; larger inputs loop
constexpr long long kMaxBlocks = 132 * 32;
constexpr float kDeg2Rad = 3.14159265358979323846f / 180.0f;
constexpr float kRad2Deg = 180.0f / 3.14159265358979323846f;

// Canonical label triple (degrees) -> row-major flattened rotation matrix.
__device__ __forceinline__ void label_to_matrix(float azi_deg, float ele_deg,
                                                float inp_deg, float m[9]) {
  float sa, ca, se, ce, sr, cr;
  sincosf(azi_deg * kDeg2Rad, &sa, &ca);
  sincosf((ele_deg - 180.0f) * kDeg2Rad, &se, &ce);
  sincosf((inp_deg - 180.0f) * kDeg2Rad, &sr, &cr);
  m[0] = cr * ca - sr * ce * sa;
  m[1] = sr * ca + cr * ce * sa;
  m[2] = se * sa;
  m[3] = -cr * sa - sr * ce * ca;
  m[4] = -sr * sa + cr * ce * ca;
  m[5] = se * ca;
  m[6] = sr * se;
  m[7] = -cr * se;
  m[8] = ce;
}

__global__ void __launch_bounds__(kThreads)
geodesic_rotation_err_kernel(const float* __restrict__ pred,
                             const float* __restrict__ gt,
                             float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float a[9], b[9];
    label_to_matrix(pred[3 * i], pred[3 * i + 1], pred[3 * i + 2], a);
    label_to_matrix(gt[3 * i], gt[3 * i + 1], gt[3 * i + 2], b);
    float trace = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) trace += a[k] * b[k];
    const float t = fminf(fmaxf(trace, -1.0f), 3.0f);
    out[i] = acosf((t - 1.0f) * 0.5f) * kRad2Deg;
  }
}

}  // namespace

// pred, gt: (n, 3) float32, contiguous, on the current device; out: (n,)
// float32. Launches on `stream` and returns the cudaError_t of the launch
// (0 on success); it neither synchronises nor allocates.
extern "C" int geodesic_rotation_err(const float* pred, const float* gt,
                                     float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  geodesic_rotation_err_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(pred, gt, out, n);
  return static_cast<int>(cudaGetLastError());
}
