// The per-voxel arithmetic of the port's two affine kernels.
//
// affine_resample.cu (the port of the TPU plane walk) gathers its taps from
// global memory; affine_slab.cu (the port of the TPU select-tree kernel)
// reads them from a box of the source staged in shared memory.  Both
// compute every output voxel with the functions below, templated on where
// a tap is read from, so the two give bit-identical results and the
// planner's choice between them never shows in the output.  A point whose
// taps all lie inside the volume (interior) may take interior_sum, which
// reads the same taps with the same weights in the same order as tap_sum
// without the edge code.
//
// Every floating-point operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no FMA contraction), in the order of the plain
// PyTorch version (ops/sampling.py::affine_coords, ops/interpolation.py):
//   coordinates  ((m0*u + m1*v) + m2*w) + m3
//   weights      linear 1 - f, f; cubic B-spline as cubic_bspline_weights
//   tap sum      acc + ((w_z * w_y) * w_x) * v, over z, then y, then x
// so the kernels floor every coordinate as the plain version does.
//
// Edges ('constant' / 'border', scipy semantics as the JAX package's):
//   'constant': points outside [0, n-1] on any axis give cval; in-range
//               cubic taps past the edge mirror; linear taps clip.
//   'border':   out-of-range taps count zero; points more than half a
//               voxel outside give cval.

#pragma once

#include <cuda_runtime.h>

namespace resample {

template <int ORDER>
struct TapCount {
  static constexpr int kTaps = ORDER == 1 ? 2 : 4;
  static constexpr int kFirst = ORDER == 1 ? 0 : -1;  // first tap - floor
};

// Source coordinate along one axis of output voxel (u, v, w) for matrix row
// (m0, m1, m2, m3).
__device__ __forceinline__ float source_coord(float m0, float m1, float m2,
                                              float m3, float u, float v,
                                              float w) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m0, u), __fmul_rn(m1, v)),
                __fmul_rn(m2, w)),
      m3);
}

template <bool CONSTANT>
__device__ __forceinline__ bool inside(const float s[3], int d0, int d1,
                                       int d2) {
  if constexpr (CONSTANT) {
    return s[0] >= 0.0f && s[0] <= static_cast<float>(d0 - 1) &&
           s[1] >= 0.0f && s[1] <= static_cast<float>(d1 - 1) &&
           s[2] >= 0.0f && s[2] <= static_cast<float>(d2 - 1);
  } else {
    return s[0] > -0.5f && s[0] < static_cast<float>(d0) - 0.5f &&
           s[1] > -0.5f && s[1] < static_cast<float>(d1) - 0.5f &&
           s[2] > -0.5f && s[2] < static_cast<float>(d2) - 0.5f;
  }
}

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
  const float g = __fsub_rn(1.0f, f);
  const float f2 = __fmul_rn(f, f);
  const float g2 = __fmul_rn(g, g);
  w[0] = __fmul_rn(__fmul_rn(1.0f / 6.0f, g2), g);
  w[1] = __fsub_rn(2.0f / 3.0f,
                   __fmul_rn(__fmul_rn(0.5f, f2), __fsub_rn(2.0f, f)));
  w[2] = __fsub_rn(2.0f / 3.0f,
                   __fmul_rn(__fmul_rn(0.5f, g2), __fsub_rn(2.0f, g)));
  w[3] = __fmul_rn(__fmul_rn(1.0f / 6.0f, f2), f);
}

// The first tap's index (floor(s) + first tap - floor, before any mirror
// or clip) and the taps' weights of one source point, per axis.
template <int ORDER>
struct Weights {
  static constexpr int kTaps = TapCount<ORDER>::kTaps;
  int base[3];
  float w[3][kTaps];
};

template <int ORDER>
__device__ __forceinline__ void make_weights(const float s[3],
                                             Weights<ORDER>* t) {
  constexpr int kFirst = TapCount<ORDER>::kFirst;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f0 = floorf(s[a]);
    const float f = __fsub_rn(s[a], f0);
    t->base[a] = static_cast<int>(f0) + kFirst;
    if constexpr (ORDER == 1) {
      t->w[a][0] = __fsub_rn(1.0f, f);
      t->w[a][1] = f;
    } else {
      bspline_weights(f, t->w[a]);
    }
  }
}

// Whether every tap of a point lies inside the volume on every axis
// (base >= 0 and base + taps - 1 <= n - 1), decided on the bases that
// make_taps floors.  Then tap k along each axis has index base + k, which
// the mirror, the clip and the 'border' flags all leave as it is: a sum
// over base + k reads the taps tap_sum reads, with the same weights.  A
// point exactly at n - 1 (linear's clipped +1 tap, cubic's mirror row) is
// not interior.
template <int ORDER>
__device__ __forceinline__ bool interior(const Weights<ORDER>& t,
                                         const int n[3]) {
  constexpr int kTaps = TapCount<ORDER>::kTaps;
  return t.base[0] >= 0 && t.base[0] + kTaps <= n[0] && t.base[1] >= 0 &&
         t.base[1] + kTaps <= n[1] && t.base[2] >= 0 &&
         t.base[2] + kTaps <= n[2];
}

// Tap indices (after mirror or clip), their in-range flags and weights, of
// one source point, per axis.
template <int ORDER>
struct Taps {
  static constexpr int kTaps = TapCount<ORDER>::kTaps;
  int idx[3][kTaps];
  bool ok[3][kTaps];  // 'border': the tap lies inside [0, n)
  float w[3][kTaps];
};

template <int ORDER, bool CONSTANT>
__device__ __forceinline__ void make_taps(const float s[3], const int n[3],
                                          Taps<ORDER>* t) {
  constexpr int kTaps = TapCount<ORDER>::kTaps;
  Weights<ORDER> wt;
  make_weights<ORDER>(s, &wt);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int i = wt.base[a] + k;
      t->w[a][k] = wt.w[a][k];
      t->ok[a][k] = i >= 0 && i < n[a];
      if constexpr (CONSTANT && ORDER == 3) {
        t->idx[a][k] = mirror_index(i, n[a]);
      } else {
        t->idx[a][k] = min(max(i, 0), n[a] - 1);
      }
    }
  }
}

// The weighted tap sum.  Source S reads a tap: S::Offset is its offset
// type, S::z_offset(z) + S::y_offset(y) the offset of row (z, y), and
// S::load(row, x) the value at column x of that row.  'border' skips
// out-of-range taps (they count zero and are never read); 'constant' taps
// are always in range after clipping or mirroring.
template <int ORDER, bool CONSTANT, class S>
__device__ __forceinline__ float tap_sum(const Taps<ORDER>& t, const S& src) {
  constexpr int kTaps = TapCount<ORDER>::kTaps;
  typename S::Offset zoff[kTaps], yoff[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    zoff[k] = src.z_offset(t.idx[0][k]);
    yoff[k] = src.y_offset(t.idx[1][k]);
  }
  float acc = 0.0f;
#pragma unroll
  for (int iz = 0; iz < kTaps; ++iz) {
#pragma unroll
    for (int iy = 0; iy < kTaps; ++iy) {
      const float w_zy = __fmul_rn(t.w[0][iz], t.w[1][iy]);
      const typename S::Offset row = zoff[iz] + yoff[iy];
#pragma unroll
      for (int ix = 0; ix < kTaps; ++ix) {
        const bool ok =
            CONSTANT || (t.ok[0][iz] && t.ok[1][iy] && t.ok[2][ix]);
        const float v = ok ? src.load(row, t.idx[2][ix]) : 0.0f;
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w_zy, t.w[2][ix]), v));
      }
    }
  }
  return acc;
}

// The tap sum of an interior point (interior()): tap_sum's products and
// additions in tap_sum's order, over rows base + k.  `origin` points at the
// point's first tap (base[0], base[1], base[2]) of a source whose rows lie
// `pitch` and whose planes lie `plane` floats apart, in offsets of type
// Index; row (iz, iy) starts at origin + iz * plane + iy * pitch, its taps
// along x at consecutive addresses, and `row(p, v)` reads the taps of the
// row that starts at p into v.
template <int ORDER, class Index, class Row>
__device__ __forceinline__ float interior_sum(const Weights<ORDER>& t,
                                              const float* origin,
                                              Index plane, Index pitch,
                                              const Row& row) {
  constexpr int kTaps = TapCount<ORDER>::kTaps;
  float acc = 0.0f;
#pragma unroll
  for (int iz = 0; iz < kTaps; ++iz) {
#pragma unroll
    for (int iy = 0; iy < kTaps; ++iy) {
      const float w_zy = __fmul_rn(t.w[0][iz], t.w[1][iy]);
      float v[kTaps];
      row(origin + (static_cast<Index>(iz) * plane +
                    static_cast<Index>(iy) * pitch),
          v);
#pragma unroll
      for (int ix = 0; ix < kTaps; ++ix) {
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w_zy, t.w[2][ix]), v[ix]));
      }
    }
  }
  return acc;
}

// Taps read from the whole (d0, d1, d2) volume in global memory, through
// the read-only path.  Rows of x lie `pitch` >= d2 floats apart (a pitched
// volume, kernels/layout.py); columns past d2 are never read.
struct GlobalSource {
  using Offset = long long;
  const float* __restrict__ vol;
  int d1, pitch;
  __device__ __forceinline__ Offset z_offset(int z) const {
    return static_cast<long long>(z) * d1 * pitch;
  }
  __device__ __forceinline__ Offset y_offset(int y) const {
    return static_cast<long long>(y) * pitch;
  }
  __device__ __forceinline__ float load(Offset row, int x) const {
    return __ldg(vol + row + x);
  }
};

}  // namespace resample
