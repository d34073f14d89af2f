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
// not separable: it forms wz*wy per (z, y) pair and does a mul and an FMA
// per tap, about 274 flops per voxel.
//
// Design against that bound, kept simple: one thread per output voxel, 128
// threads along x, so each warp's stores are coalesced.  Taps are gathered
// from the unpermuted (D, H, W) source through the read-only path (__ldg);
// neighbouring threads along x hit neighbouring source voxels, so a tap is
// reused from L1/L2 by the threads around it.  A fast design (shared-memory
// source tiles staged with TMA) is later work.
//
// Coordinates are computed as ((m0*u + m1*v) + m2*w) + m3 with one rounding
// per operation (__fmul_rn / __fadd_rn, no FMA contraction): the plain
// PyTorch version (ops/sampling.py::affine_coords) computes the same values
// bit for bit, so both floor() every coordinate alike.
//
// grid.x runs over (x block, y, z) of the output, grid.y over the matrices;
// output offsets are 64-bit.  One build serves every matrix, cval and
// shape; order (1, 3) and mode are template arguments.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int mirror_index(int idx, int n) {
  // scipy 'mirror' (no edge repeat).  C's % takes the sign of the
  // dividend, so a negative remainder is folded back into [0, period).
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int r = idx % period;
  if (r < 0) r += period;
  return r >= n ? period - r : r;
}

__device__ __forceinline__ void bspline_weights(float f, float w[4]) {
  const float g = 1.0f - f;
  const float f2 = f * f;
  const float g2 = g * g;
  w[0] = (1.0f / 6.0f) * g2 * g;
  w[1] = 2.0f / 3.0f - 0.5f * f2 * (2.0f - f);
  w[2] = 2.0f / 3.0f - 0.5f * g2 * (2.0f - g);
  w[3] = (1.0f / 6.0f) * f2 * f;
}

// Tap index along one axis and whether it lies inside [0, n).
template <bool CONSTANT, int ORDER>
__device__ __forceinline__ int tap_index(int i, int n, bool* ok) {
  *ok = (i >= 0) && (i < n);
  if constexpr (CONSTANT && ORDER == 3) return mirror_index(i, n);
  return min(max(i, 0), n - 1);
}

template <int ORDER, bool CONSTANT>
__global__ void __launch_bounds__(kThreads)
affine_resample_kernel(const float* __restrict__ vol, int d0, int d1, int d2,
                       const float* __restrict__ mats,
                       float* __restrict__ out, int o0, int o1, int o2,
                       int x_blocks, float cval) {
  const int row = blockIdx.x / x_blocks;  // z * o1 + y of the output
  const int x = (blockIdx.x - row * x_blocks) * kThreads + threadIdx.x;
  if (x >= o2) return;
  const int y = row % o1;
  const int z = row / o1;
  const int b = blockIdx.y;

  const float* m = mats + 16 * b;
  const float fz = static_cast<float>(z);
  const float fy = static_cast<float>(y);
  const float fx = static_cast<float>(x);
  float s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* r = m + 4 * a;
    s[a] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(r), fz),
                                         __fmul_rn(__ldg(r + 1), fy)),
                               __fmul_rn(__ldg(r + 2), fx)),
                     __ldg(r + 3));
  }

  float* dst = out + static_cast<long long>(b) * o0 * o1 * o2 +
               static_cast<long long>(row) * o2 + x;

  bool inside;
  if constexpr (CONSTANT) {
    inside = s[0] >= 0.0f && s[0] <= static_cast<float>(d0 - 1) &&
             s[1] >= 0.0f && s[1] <= static_cast<float>(d1 - 1) &&
             s[2] >= 0.0f && s[2] <= static_cast<float>(d2 - 1);
  } else {
    inside = s[0] > -0.5f && s[0] < static_cast<float>(d0) - 0.5f &&
             s[1] > -0.5f && s[1] < static_cast<float>(d1) - 0.5f &&
             s[2] > -0.5f && s[2] < static_cast<float>(d2) - 0.5f;
  }
  if (!inside) {
    *dst = cval;
    return;
  }

  const float z0f = floorf(s[0]);
  const float y0f = floorf(s[1]);
  const float x0f = floorf(s[2]);
  const int z0 = static_cast<int>(z0f);
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const float tz = s[0] - z0f;
  const float ty = s[1] - y0f;
  const float tx = s[2] - x0f;

  constexpr int kTaps = ORDER == 1 ? 2 : 4;
  constexpr int kFirst = ORDER == 1 ? 0 : -1;
  float wz[kTaps], wy[kTaps], wx[kTaps];
  if constexpr (ORDER == 1) {
    wz[0] = 1.0f - tz; wz[1] = tz;
    wy[0] = 1.0f - ty; wy[1] = ty;
    wx[0] = 1.0f - tx; wx[1] = tx;
  } else {
    bspline_weights(tz, wz);
    bspline_weights(ty, wy);
    bspline_weights(tx, wx);
  }

  const long long plane = static_cast<long long>(d1) * d2;
  long long zoff[kTaps];
  int yoff[kTaps], xi[kTaps];
  bool okz[kTaps], oky[kTaps], okx[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    zoff[t] = tap_index<CONSTANT, ORDER>(z0 + kFirst + t, d0, &okz[t]) * plane;
    yoff[t] = tap_index<CONSTANT, ORDER>(y0 + kFirst + t, d1, &oky[t]) * d2;
    xi[t] = tap_index<CONSTANT, ORDER>(x0 + kFirst + t, d2, &okx[t]);
  }

  // summation order of the plain version: acc += ((wz * wy) * wx) * v
  float acc = 0.0f;
#pragma unroll
  for (int tz_ = 0; tz_ < kTaps; ++tz_) {
#pragma unroll
    for (int ty_ = 0; ty_ < kTaps; ++ty_) {
      const float w_zy = wz[tz_] * wy[ty_];
      const float* line = vol + zoff[tz_] + yoff[ty_];
#pragma unroll
      for (int tx_ = 0; tx_ < kTaps; ++tx_) {
        // 'border' skips out-of-range taps (they count zero); 'constant'
        // taps are always in range after clipping or mirroring
        const bool ok = CONSTANT || (okz[tz_] && oky[ty_] && okx[tx_]);
        const float v = ok ? __ldg(line + xi[tx_]) : 0.0f;
        acc = acc + w_zy * wx[tx_] * v;
      }
    }
  }
  *dst = acc;
}

template <int ORDER, bool CONSTANT>
void launch(dim3 grid, cudaStream_t stream, const float* vol, int d0, int d1,
            int d2, const float* mats, float* out, int o0, int o1, int o2,
            int x_blocks, float cval) {
  affine_resample_kernel<ORDER, CONSTANT><<<grid, kThreads, 0, stream>>>(
      vol, d0, d1, d2, mats, out, o0, o1, o2, x_blocks, cval);
}

}  // namespace

// C entry, bound with ctypes.  vol: (d0, d1, d2) float32, contiguous.
// mats: (n, 4, 4) float32, contiguous, on the same device.  out: (n, o0,
// o1, o2) float32, contiguous.  order: 1 or 3.  border: 0 for 'constant',
// 1 for 'border'.  Launches on `stream`, on the calling thread's current
// device (the caller makes it the tensors' device), without synchronising,
// and returns cudaGetLastError() (0 on success).
extern "C" int affine_resample_launch(const float* vol, int d0, int d1,
                                      int d2, const float* mats, int n,
                                      float* out, int o0, int o1, int o2,
                                      int order, int border, float cval,
                                      void* stream) {
  if ((order != 1 && order != 3) || d0 < 1 || d1 < 1 || d2 < 1 || n < 1 ||
      n > 65535 || o0 < 1 || o1 < 1 || o2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int x_blocks = (o2 + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(x_blocks) * o1 * o0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 1 && !border) {
    launch<1, true>(grid, s, vol, d0, d1, d2, mats, out, o0, o1, o2, x_blocks, cval);
  } else if (order == 1) {
    launch<1, false>(grid, s, vol, d0, d1, d2, mats, out, o0, o1, o2, x_blocks, cval);
  } else if (!border) {
    launch<3, true>(grid, s, vol, d0, d1, d2, mats, out, o0, o1, o2, x_blocks, cval);
  } else {
    launch<3, false>(grid, s, vol, d0, d1, d2, mats, out, o0, o1, o2, x_blocks, cval);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* affine_resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
