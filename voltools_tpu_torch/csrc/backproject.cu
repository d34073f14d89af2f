// Back-projection of a tilt series: the adjoint of WBP and SIRT.
//
// No TPU kernel stands behind this one.  It replaces the JAX package's
// lax.scan over tilts (voltools_tpu/models/reconstruction.py::_make_adjoint,
// :105-145), which XLA compiles, and the port's plain torch loop over
// tilts that computes the same function
// (voltools_tpu_torch/kernels/backproject.py::plain_backproject):
//   acc[w] = sum over tilts t, in order, of bilerp(proj_t, rows_t(w),
//            cols_t(w)),
// (rows, cols) the keep[0] and keep[1] rows of M_t^-1 applied to the output
// voxel w = (z, y, x, 1); a tap outside the projection counts 0.
//
// Two paths, those of the plain version:
//   row-gather  cols is the identity coordinate of output axis ax_c =
//               keep[1] (a single-axis tilt series: every tilt_matrices
//               stack), so rows depends on the two other axes (dep0, dep1)
//               only and the sample is a 1-D lerp across rows:
//                 rows = ((r_dep0 * i0) + (r_dep1 * i1)) + r3
//                 r0 = floor(rows), fr = rows - r0
//                 gb = (valid(r0) ? p[r0][c] : 0) * (1 - fr)
//                    + (valid(r0 + 1) ? p[r0 + 1][c] : 0) * fr
//   general     a 2-D bilinear sample with 4 taps:
//                 rows = ((rr0 * z + rr1 * y) + rr2 * x) + rr3, cols alike
//                 weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
//                 sum ((t00 + t01) + t10) + t11
// and acc = acc + sample, tilt after tilt from acc = 0.  Every operation is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction,
// whatever nvcc's flags), in the plain version's order, so the kernel
// equals the plain version bit for bit.  Validity is tested on the float
// floor before any conversion to int (the plain version converts to int64:
// a row of 1e10 must not wrap).
//
// The per-tilt coefficients come from the wrapper, built on the host from
// the float32 M^-1: row-gather (r_dep0, r_dep1, r3, 0) a tilt, general
// (rr0..rr3), (cc0..cc3) a tilt.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): it must
// write the volume once and read the projections once (they fit the 50 MB
// L2 at the reconstruction's sizes): 4 * D*H*W + 4 * N*H'*W' bytes, 72.75
// MB at 250^3 and 41 tilts, 0.022 ms.  The least arithmetic of the
// row-gather path is a lerp and the sum, 4 flops per voxel a tilt (the
// row coordinate is shared by a whole line of voxels): 2.56 GFLOP, 0.038
// ms.  It is bound by operations.
//
// The design is the simple one: each thread keeps kVoxels output voxels'
// sums in registers, loops over the tilts in order and writes each voxel
// once; no atomics, so the order of the sum is fixed.  A warp's 32 lanes
// lie along one output axis, kVoxels runs of 32 apart:
//   row-gather  along ax_c, the projection's column axis: a warp's rows
//               coordinate is uniform (one floor and one validity test a
//               tilt for the warp), and its loads are 32 consecutive
//               floats of one or two projection rows.  dep1 runs over the
//               CTA's warps and grid.y, dep0 over grid.z: the output voxel
//               maps straight to (dep0, dep1, ax_c), no permute pass.
//   general     along x, the output's contiguous axis (coalesced stores);
//               the 4 taps a voxel are gathers.
// Output offsets are 64-bit; a projection's offsets 32-bit (the launcher
// refuses a projection of 2^31 floats or more).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;    // a CTA's warps, along dep1 (general: y)
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

// One tap of the general path: the projection's value where (iy, ix) lies
// inside it, else 0, times its weight.
__device__ __forceinline__ float tap(const float* p, int w, bool valid,
                                     int iy, int ix, float wgt) {
  return __fmul_rn(valid ? __ldg(p + iy * w + ix) : 0.0f, wgt);
}

__global__ void __launch_bounds__(kLanes * kWarps)
    general_kernel(const float* __restrict__ projs, int n, int h, int w,
                   const float4* __restrict__ coef, float* __restrict__ out,
                   int d0, int d1, int d2) {
  const int y = blockIdx.y * kWarps + threadIdx.y;
  if (y >= d1) return;
  const int z = blockIdx.z;
  const int x0 = blockIdx.x * kSpan + threadIdx.x;
  const float fz = static_cast<float>(z);
  const float fy = static_cast<float>(y);
  const float hf = static_cast<float>(h), hm1 = static_cast<float>(h - 1);
  const float wf = static_cast<float>(w), wm1 = static_cast<float>(w - 1);
  const long long plane = static_cast<long long>(h) * w;
  float acc[kVoxels];
#pragma unroll
  for (int k = 0; k < kVoxels; ++k) acc[k] = 0.0f;
  for (int t = 0; t < n; ++t) {
    const float4 rr = __ldg(coef + 2 * t);
    const float4 cc = __ldg(coef + 2 * t + 1);
    const float* p = projs + t * plane;
    const float ra = __fadd_rn(__fmul_rn(rr.x, fz), __fmul_rn(rr.y, fy));
    const float ca = __fadd_rn(__fmul_rn(cc.x, fz), __fmul_rn(cc.y, fy));
#pragma unroll
    for (int k = 0; k < kVoxels; ++k) {
      const int x = x0 + k * kLanes;
      const float fx = static_cast<float>(x);
      const float rows = __fadd_rn(__fadd_rn(ra, __fmul_rn(rr.z, fx)), rr.w);
      const float cols = __fadd_rn(__fadd_rn(ca, __fmul_rn(cc.z, fx)), cc.w);
      const float y0f = floorf(rows);
      const float x0f = floorf(cols);
      const float ty = __fsub_rn(rows, y0f);
      const float tx = __fsub_rn(cols, x0f);
      const float uy = __fsub_rn(1.0f, ty);
      const float ux = __fsub_rn(1.0f, tx);
      const bool in = x < d2;
      const bool vy0 = in && y0f >= 0.0f && y0f < hf;
      const bool vy1 = in && y0f >= -1.0f && y0f < hm1;
      const bool vx0 = x0f >= 0.0f && x0f < wf;
      const bool vx1 = x0f >= -1.0f && x0f < wm1;
      const int iy = (vy0 || vy1) ? static_cast<int>(y0f) : 0;
      const int ix = (vx0 || vx1) ? static_cast<int>(x0f) : 0;
      const float t00 = tap(p, w, vy0 && vx0, iy, ix, __fmul_rn(uy, ux));
      const float t01 = tap(p, w, vy0 && vx1, iy, ix + 1, __fmul_rn(uy, tx));
      const float t10 = tap(p, w, vy1 && vx0, iy + 1, ix, __fmul_rn(ty, ux));
      const float t11 = tap(p, w, vy1 && vx1, iy + 1, ix + 1,
                            __fmul_rn(ty, tx));
      acc[k] = __fadd_rn(acc[k],
                         __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11));
    }
  }
  const long long base = (static_cast<long long>(z) * d1 + y) * d2;
#pragma unroll
  for (int k = 0; k < kVoxels; ++k) {
    const int x = x0 + k * kLanes;
    if (x < d2) out[base + x] = acc[k];
  }
}

}  // namespace

// C entry, bound with ctypes.  projs: (n, h, w) float32, contiguous.
// coef: float32, contiguous, 16-byte aligned, on the same device: n rows of
// 4 (row-gather: r_dep0, r_dep1, r3, 0) or of 8 (general: row keep0 of
// M^-1, then row keep1).  out: (d0, d1, d2) float32, contiguous; every
// voxel is written.  rowgather: 1 for the row-gather path, whose column
// axis is ax_c (1 or 2; the projection's width w must equal the output's
// extent along it), 0 for the general path (ax_c unread).  Launches on
// `stream`, on the calling thread's current device (the caller makes it the
// tensors' device), without synchronising, and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for arguments out of range).
extern "C" int backproject_launch(const float* projs, int n, int h, int w,
                                  const float* coef, int rowgather, int ax_c,
                                  float* out, int d0, int d1, int d2,
                                  void* stream) {
  if (n < 0 || h < 1 || w < 1 || d0 < 1 || d1 < 1 || d2 < 1 ||
      h >= kMaxExtent || w >= kMaxExtent || d0 >= kMaxExtent ||
      d1 >= kMaxExtent || d2 >= kMaxExtent ||
      static_cast<long long>(h) * w > INT_MAX ||
      reinterpret_cast<unsigned long long>(coef) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims[3] = {d0, d1, d2};
  const long long strides[3] = {static_cast<long long>(d1) * d2, d2, 1};
  const auto cstream = static_cast<cudaStream_t>(stream);
  const dim3 block(kLanes, kWarps);
  if (rowgather) {
    if (ax_c != 1 && ax_c != 2) return static_cast<int>(cudaErrorInvalidValue);
    const int dep0 = 0, dep1 = ax_c == 2 ? 1 : 2;
    const int n0 = dims[dep0], n1 = dims[dep1], nc = dims[ax_c];
    const dim3 grid((nc + kSpan - 1) / kSpan, (n1 + kWarps - 1) / kWarps, n0);
    if (nc != w || grid.y > 65535 || grid.z > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rowgather_kernel<<<grid, block, 0, cstream>>>(
        projs, n, h, w, reinterpret_cast<const float4*>(coef), out, n0, n1,
        nc, strides[dep0], strides[dep1], strides[ax_c]);
  } else {
    const dim3 grid((d2 + kSpan - 1) / kSpan, (d1 + kWarps - 1) / kWarps, d0);
    if (grid.y > 65535 || grid.z > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    general_kernel<<<grid, block, 0, cstream>>>(
        projs, n, h, w, reinterpret_cast<const float4*>(coef), out, d0, d1,
        d2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* backproject_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
