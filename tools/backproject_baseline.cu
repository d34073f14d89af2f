// The back-projection C's row-gather path as it was before its redesign
// (one thread 4 voxels of one line along the column axis, a CTA 8 warps,
// each warp loading its two projection rows a tilt straight from global
// memory through __ldg), kept as it was but for this paragraph and the
// name of its C entry, as tools/backproject_variants.py's and
// chip_smoke.py's yardstick (the variant `baseline`).  It is not part of
// the package and nothing in the package builds it.
//
// Back-projection of a tilt series: the adjoint of WBP and SIRT, row-gather
// path:
//   rows = ((r_dep0 * i0) + (r_dep1 * i1)) + r3
//   r0 = floor(rows), fr = rows - r0
//   gb = (valid(r0) ? p[r0][c] : 0) * (1 - fr)
//      + (valid(r0 + 1) ? p[r0 + 1][c] : 0) * fr
// and acc = acc + gb, tilt after tilt from acc = 0, every operation rounded
// on its own (__fmul_rn, __fadd_rn, __fsub_rn), validity tested on the
// float floor before any conversion to int.  A warp's 32 lanes lie along
// ax_c, the projection's column axis, kVoxels runs of 32 apart; dep1 runs
// over the CTA's warps and grid.y, dep0 over grid.z.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;    // a CTA's warps, along dep1
constexpr int kVoxels = 4;   // voxels a thread, kLanes apart along the lanes
constexpr int kSpan = kLanes * kVoxels;   // voxels a warp covers a line
constexpr int kMaxExtent = 1 << 24;       // float holds every index exactly

__global__ void __launch_bounds__(kLanes * kWarps)
    rowgather_kernel(const float* __restrict__ projs, int n, int h, int w,
                     const float4* __restrict__ coef, float* __restrict__ out,
                     int n0, int n1, int nc, long long s0, long long s1,
                     long long sc) {
  const int i1 = blockIdx.y * kWarps + threadIdx.y;
  if (i1 >= n1) return;
  const int i0 = blockIdx.z;
  const int c0 = blockIdx.x * kSpan + threadIdx.x;
  const float f0 = static_cast<float>(i0);
  const float f1 = static_cast<float>(i1);
  const float hf = static_cast<float>(h);
  const float hm1 = static_cast<float>(h - 1);
  const long long plane = static_cast<long long>(h) * w;
  float acc[kVoxels];
#pragma unroll
  for (int k = 0; k < kVoxels; ++k) acc[k] = 0.0f;
  for (int t = 0; t < n; ++t) {
    const float4 r = __ldg(coef + t);
    const float* p = projs + t * plane;
    const float rows =
        __fadd_rn(__fadd_rn(__fmul_rn(r.x, f0), __fmul_rn(r.y, f1)), r.z);
    const float r0f = floorf(rows);
    const float fr = __fsub_rn(rows, r0f);
    const float w0 = __fsub_rn(1.0f, fr);
    const bool v0 = r0f >= 0.0f && r0f < hf;
    const bool v1 = r0f >= -1.0f && r0f < hm1;
    // r0f in [-1, h) where either tap is valid: convert only then
    const int r0 = (v0 || v1) ? static_cast<int>(r0f) : 0;
    const float* row0 = p + r0 * w;
    const float* row1 = row0 + w;
#pragma unroll
    for (int k = 0; k < kVoxels; ++k) {
      const int c = c0 + k * kLanes;
      const bool in = c < nc;
      const float g0 = (in && v0) ? __ldg(row0 + c) : 0.0f;
      const float g1 = (in && v1) ? __ldg(row1 + c) : 0.0f;
      const float gb = __fadd_rn(__fmul_rn(g0, w0), __fmul_rn(g1, fr));
      acc[k] = __fadd_rn(acc[k], gb);
    }
  }
  const long long base = i0 * s0 + i1 * s1;
#pragma unroll
  for (int k = 0; k < kVoxels; ++k) {
    const int c = c0 + k * kLanes;
    if (c < nc) out[base + c * sc] = acc[k];
  }
}

}  // namespace

// C entry, bound with ctypes.  projs: (n, h, w) float32, contiguous.
// coef: n rows of (r_dep0, r_dep1, r3, 0) float32, contiguous, 16-byte
// aligned, on the same device.  out: (d0, d1, d2) float32, contiguous.
// ax_c (1 or 2) is the column axis; w must equal the output's extent along
// it.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int backproject_baseline_launch(const float* projs, int n, int h,
                                           int w, const float* coef,
                                           int ax_c, float* out, int d0,
                                           int d1, int d2, void* stream) {
  if (n < 0 || h < 1 || w < 1 || d0 < 1 || d1 < 1 || d2 < 1 ||
      h >= kMaxExtent || w >= kMaxExtent || d0 >= kMaxExtent ||
      d1 >= kMaxExtent || d2 >= kMaxExtent ||
      static_cast<long long>(h) * w > INT_MAX ||
      reinterpret_cast<unsigned long long>(coef) % 16 ||
      (ax_c != 1 && ax_c != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims[3] = {d0, d1, d2};
  const long long strides[3] = {static_cast<long long>(d1) * d2, d2, 1};
  const int dep0 = 0, dep1 = ax_c == 2 ? 1 : 2;
  const int n0 = dims[dep0], n1 = dims[dep1], nc = dims[ax_c];
  const dim3 grid((nc + kSpan - 1) / kSpan, (n1 + kWarps - 1) / kWarps, n0);
  if (nc != w || grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rowgather_kernel<<<grid, dim3(kLanes, kWarps), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      projs, n, h, w, reinterpret_cast<const float4*>(coef), out, n0, n1, nc,
      strides[dep0], strides[dep1], strides[ax_c]);
  return static_cast<int>(cudaGetLastError());
}
