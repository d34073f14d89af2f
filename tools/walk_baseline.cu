// The walk kernel as it was before its redesign (warp lines of 32 voxels
// along x, every voxel through the edge path, 64-bit tap offsets, the
// matrix loaded by every thread), kept as it was but for this paragraph,
// as tools/walk_variants.py's yardstick (the variant `baseline`).  It is not
// part of the package and nothing else builds it.
//
// Affine resampling of a 3-D float32 volume through N 4x4 pull-back matrices.
//
// Replaces the TPU plane-walk Pallas kernel
// voltools_tpu/kernels/pallas_walk.py::_make_walk_kernel (launched by
// _walk_runner_hooked).  Same function and edges: for every output voxel
// (u, v, w) of every matrix M, src = M . (u, v, w, 1), then the trilinear
// (2^3 taps) or cubic B-spline (4^3 taps) sum at src.
//   'constant': points outside [0, n-1] on any axis give cval; in-range
//               cubic taps past the edge mirror (scipy); linear taps clip.
//   'border':   out-of-range taps count zero; points more than half a
//               voxel outside give cval.
// None of the TPU kernel's machinery carries over: no prepared or
// x-shifted source copies, no blocked output, no SMEM payload, no bands.
// Those exist because a TPU has no per-element gather; Hopper has one.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32, an FMA counted
// as 2 flops): it must read the source once and write every output voxel
// once, 4*D*H*W + 4*N*D'*H'*W' bytes, about 125 MB for one 250^3 matrix,
// about 37 us; a batch of N matrices reads the source once for all N.  The
// least arithmetic of the function, per output voxel that lands inside the
// source: 3 coordinates of 3 FMAs (18 flops), 3 fractions, the weights (1
// flop per axis for linear, 14 for cubic) and a separable contraction
// (x, then y, then z) of k^3 + k^2 + k FMAs -- 14 for linear, 84 for cubic.
// That is 52 flops (linear) and 231 flops (cubic); a voxel outside the
// source needs only its 18 coordinate flops.  At 250^3, with about 0.8 of
// the output inside for a random rotation, cubic needs about 2.9 GFLOP,
// about 43 us: cubic is bound by arithmetic, a little above the memory
// time; linear (about 0.7 GFLOP, 10 us) by memory.  This kernel itself is
// not separable: it forms wz*wy per (z, y) pair and does two multiplies
// and an add per tap, about 274 flops per voxel.
//
// Design against that bound, kept simple: one thread per output voxel, 128
// threads along x, so each warp's stores are coalesced.  Taps are gathered
// from the unpermuted (D, H, W) source through the read-only path (__ldg);
// neighbouring threads along x hit neighbouring source voxels, so a tap is
// reused from L1/L2 by the threads around it.  A fast design (shared-memory
// source tiles staged with TMA) is later work.
//
// The per-voxel arithmetic (coordinates, weights, edges, tap sum) is in
// resample_taps.cuh, shared with affine_slab.cu: one rounding per
// operation, in the order of the plain PyTorch version, so both kernels
// and the plain version floor every coordinate alike, and the two kernels
// agree bit for bit.
//
// grid.x runs over (x block, y, z) of the output, grid.y over the matrices;
// output offsets are 64-bit.  One build serves every matrix, cval and
// shape; order (1, 3) and mode are template arguments.  The volume's rows
// lie `pitch` floats apart, so the pitched resident volume that the slab
// kernel's TMA copies need (kernels/layout.py) serves this kernel too.

#include <cuda_runtime.h>

#include <climits>

#include "resample_taps.cuh"

namespace {

constexpr int kThreads = 128;

template <int ORDER, bool CONSTANT>
__global__ void __launch_bounds__(kThreads)
affine_resample_kernel(const float* __restrict__ vol, int d0, int d1, int d2,
                       int pitch, const float* __restrict__ mats,
                       float* __restrict__ out, int o0, int o1, int o2,
                       int x_blocks, float cval) {
  const int row = blockIdx.x / x_blocks;  // z * o1 + y of the output
  const int x = (blockIdx.x - row * x_blocks) * kThreads + threadIdx.x;
  if (x >= o2) return;
  const int y = row % o1;
  const int z = row / o1;
  const int b = blockIdx.y;

  const float* m = mats + 16 * b;
  float s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* r = m + 4 * a;
    s[a] = resample::source_coord(__ldg(r), __ldg(r + 1), __ldg(r + 2),
                                  __ldg(r + 3), static_cast<float>(z),
                                  static_cast<float>(y),
                                  static_cast<float>(x));
  }

  float* dst = out + static_cast<long long>(b) * o0 * o1 * o2 +
               static_cast<long long>(row) * o2 + x;
  if (!resample::inside<CONSTANT>(s, d0, d1, d2)) {
    *dst = cval;
    return;
  }
  const int n[3] = {d0, d1, d2};
  resample::Taps<ORDER> taps;
  resample::make_taps<ORDER, CONSTANT>(s, n, &taps);
  *dst = resample::tap_sum<ORDER, CONSTANT>(
      taps, resample::GlobalSource{vol, d1, pitch});
}

template <int ORDER, bool CONSTANT>
void launch(dim3 grid, cudaStream_t stream, const float* vol, int d0, int d1,
            int d2, int pitch, const float* mats, float* out, int o0, int o1,
            int o2, int x_blocks, float cval) {
  affine_resample_kernel<ORDER, CONSTANT><<<grid, kThreads, 0, stream>>>(
      vol, d0, d1, d2, pitch, mats, out, o0, o1, o2, x_blocks, cval);
}

}  // namespace

// C entry, bound with ctypes.  vol: (d0, d1, d2) float32, rows of x
// contiguous and `pitch` >= d2 floats apart, planes d1 * pitch apart.
// mats: (n, 4, 4) float32, contiguous, on the same device.  out: (n, o0,
// o1, o2) float32, contiguous.  order: 1 or 3.  border: 0 for 'constant',
// 1 for 'border'.  Launches on `stream`, on the calling thread's current
// device (the caller makes it the tensors' device), without synchronising,
// and returns cudaGetLastError() (0 on success).
extern "C" int affine_resample_launch(const float* vol, int d0, int d1,
                                      int d2, int pitch, const float* mats,
                                      int n, float* out, int o0, int o1,
                                      int o2, int order, int border,
                                      float cval, void* stream) {
  if ((order != 1 && order != 3) || d0 < 1 || d1 < 1 || d2 < 1 ||
      pitch < d2 || n < 1 || n > 65535 || o0 < 1 || o1 < 1 || o2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int x_blocks = (o2 + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(x_blocks) * o1 * o0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 1 && !border) {
    launch<1, true>(grid, s, vol, d0, d1, d2, pitch, mats, out, o0, o1, o2, x_blocks, cval);
  } else if (order == 1) {
    launch<1, false>(grid, s, vol, d0, d1, d2, pitch, mats, out, o0, o1, o2, x_blocks, cval);
  } else if (!border) {
    launch<3, true>(grid, s, vol, d0, d1, d2, pitch, mats, out, o0, o1, o2, x_blocks, cval);
  } else {
    launch<3, false>(grid, s, vol, d0, d1, d2, pitch, mats, out, o0, o1, o2, x_blocks, cval);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* affine_resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
