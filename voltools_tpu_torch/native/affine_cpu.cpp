// The PyTorch port's own copy of voltools_tpu/native/affine_cpu.cpp: every
// line below this header is that file's, byte for byte, so both packages'
// native CPU backends compute the same function from the same source.
// voltools_tpu_torch/native/__init__.py builds it into voltools_tpu_torch/_build/.
//
// Native CPU affine resampler for voltools_tpu.
//
// The reference accelerates its hot path with runtime-compiled CUDA kernels
// (voltools/transforms.py:232-287); our accelerator path is Pallas/Mosaic.
// This file is the native *host* backend: a multithreaded C++ implementation
// of the same pull-back affine resample (trilinear + cubic B-spline with the
// scipy-compatible 'constant' semantics and the texture-style 'border'
// semantics), used when device='cpu' with backend='native'.  It replaces the
// single-threaded scipy path for large volumes.
//
// Built as a plain shared library; Python binds via ctypes (no pybind11).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Shape {
  int64_t d0, d1, d2;
};

inline int64_t mirror_index(int64_t idx, int64_t n) {
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  idx %= period;
  if (idx < 0) idx += period;
  return idx >= n ? period - idx : idx;
}

inline float fetch_constant(const float* v, const Shape& s, int64_t z,
                            int64_t y, int64_t x) {
  // clip semantics: callers guarantee the sample point is in-domain, so a
  // clipped tap is only reached with zero weight (order 1)
  z = z < 0 ? 0 : (z >= s.d0 ? s.d0 - 1 : z);
  y = y < 0 ? 0 : (y >= s.d1 ? s.d1 - 1 : y);
  x = x < 0 ? 0 : (x >= s.d2 ? s.d2 - 1 : x);
  return v[(z * s.d1 + y) * s.d2 + x];
}

inline float fetch_border(const float* v, const Shape& s, int64_t z,
                          int64_t y, int64_t x) {
  if (z < 0 || z >= s.d0 || y < 0 || y >= s.d1 || x < 0 || x >= s.d2)
    return 0.0f;
  return v[(z * s.d1 + y) * s.d2 + x];
}

inline float fetch_mirror(const float* v, const Shape& s, int64_t z,
                          int64_t y, int64_t x) {
  z = mirror_index(z, s.d0);
  y = mirror_index(y, s.d1);
  x = mirror_index(x, s.d2);
  return v[(z * s.d1 + y) * s.d2 + x];
}

inline void bspline_weights(float f, float w[4]) {
  const float g = 1.0f - f;
  w[0] = (1.0f / 6.0f) * g * g * g;
  w[1] = 2.0f / 3.0f - 0.5f * f * f * (2.0f - f);
  w[2] = 2.0f / 3.0f - 0.5f * g * g * (2.0f - g);
  w[3] = (1.0f / 6.0f) * f * f * f;
}

// one output voxel, order 1
template <bool kBorder>
inline float sample_linear(const float* v, const Shape& s, double sz,
                           double sy, double sx, float cval) {
  if (kBorder) {
    if (sz <= -0.5 || sz >= s.d0 - 0.5 || sy <= -0.5 ||
        sy >= s.d1 - 0.5 || sx <= -0.5 || sx >= s.d2 - 0.5)
      return cval;
  } else {
    if (sz < 0.0 || sz > s.d0 - 1 || sy < 0.0 || sy > s.d1 - 1 ||
        sx < 0.0 || sx > s.d2 - 1)
      return cval;
  }
  const double zf = std::floor(sz), yf = std::floor(sy), xf = std::floor(sx);
  const int64_t z0 = (int64_t)zf, y0 = (int64_t)yf, x0 = (int64_t)xf;
  const float fz = (float)(sz - zf), fy = (float)(sy - yf),
              fx = (float)(sx - xf);
  float acc = 0.0f;
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? fz : 1.0f - fz;
    if (wz == 0.0f) continue;
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? fy : 1.0f - fy;
      if (wy == 0.0f) continue;
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? fx : 1.0f - fx;
        if (wx == 0.0f) continue;
        const float val =
            kBorder ? fetch_border(v, s, z0 + dz, y0 + dy, x0 + dx)
                    : fetch_constant(v, s, z0 + dz, y0 + dy, x0 + dx);
        acc += wz * wy * wx * val;
      }
    }
  }
  return acc;
}

// one output voxel, order 3 (64 taps); constant mode mirrors o.o.b. taps
template <bool kBorder>
inline float sample_cubic(const float* v, const Shape& s, double sz,
                          double sy, double sx, float cval) {
  if (kBorder) {
    if (sz <= -0.5 || sz >= s.d0 - 0.5 || sy <= -0.5 ||
        sy >= s.d1 - 0.5 || sx <= -0.5 || sx >= s.d2 - 0.5)
      return cval;
  } else {
    if (sz < 0.0 || sz > s.d0 - 1 || sy < 0.0 || sy > s.d1 - 1 ||
        sx < 0.0 || sx > s.d2 - 1)
      return cval;
  }
  const double zf = std::floor(sz), yf = std::floor(sy), xf = std::floor(sx);
  const int64_t z0 = (int64_t)zf, y0 = (int64_t)yf, x0 = (int64_t)xf;
  float wz[4], wy[4], wx[4];
  bspline_weights((float)(sz - zf), wz);
  bspline_weights((float)(sy - yf), wy);
  bspline_weights((float)(sx - xf), wx);
  float acc = 0.0f;
  for (int dz = 0; dz < 4; ++dz) {
    const int64_t z = z0 + dz - 1;
    for (int dy = 0; dy < 4; ++dy) {
      const int64_t y = y0 + dy - 1;
      const float wzy = wz[dz] * wy[dy];
      for (int dx = 0; dx < 4; ++dx) {
        const int64_t x = x0 + dx - 1;
        const float val = kBorder ? fetch_border(v, s, z, y, x)
                                  : fetch_mirror(v, s, z, y, x);
        acc += wzy * wx[dx] * val;
      }
    }
  }
  return acc;
}

void run_rows(const float* vol, const Shape& in, float* out, const Shape& os,
              const double* m, int order, int border, float cval,
              int64_t row_begin, int64_t row_end) {
  for (int64_t row = row_begin; row < row_end; ++row) {
    const int64_t i = row / os.d1;
    const int64_t j = row % os.d1;
    // summation order matches scipy.ndimage (matrix terms in axis order,
    // offset added last) so knife-edge coordinates round identically
    const double bz = m[0] * i + m[1] * j;
    const double by = m[4] * i + m[5] * j;
    const double bx = m[8] * i + m[9] * j;
    float* dst = out + row * os.d2;
    for (int64_t k = 0; k < os.d2; ++k) {
      const double sz = (bz + m[2] * k) + m[3];
      const double sy = (by + m[6] * k) + m[7];
      const double sx = (bx + m[10] * k) + m[11];
      if (order == 1) {
        dst[k] = border ? sample_linear<true>(vol, in, sz, sy, sx, cval)
                        : sample_linear<false>(vol, in, sz, sy, sx, cval);
      } else {
        dst[k] = border ? sample_cubic<true>(vol, in, sz, sy, sx, cval)
                        : sample_cubic<false>(vol, in, sz, sy, sx, cval);
      }
    }
  }
}

// causal/anticausal cubic B-spline prefilter over one strided line,
// mirror boundary (matches scipy.ndimage.spline_filter mode='mirror')
void prefilter_line(float* c, int64_t n, int64_t step) {
  if (n < 2) return;
  const double pole = std::sqrt(3.0) - 2.0;
  const double lambda = (1.0 - pole) * (1.0 - 1.0 / pole);

  // causal init, mirror extension x[-k] = x[k]: for short lines the
  // truncated geometric sum misses the periodic fold (the extension has
  // period 2n-2), which reaches ~0.6 absolute error at n=2 — fold the
  // whole period and divide by (1 - pole^(2n-2)) instead.  For long
  // lines pole^(2n-2) underflows and the 28-tap truncated sum is exact
  // to double precision.
  double prev;
  if (n <= 30) {
    double s = c[0];
    double zk = pole;                          // pole^k
    for (int64_t k = 1; k <= n - 2; ++k) {
      s += zk * c[k * step];
      zk *= pole;
    }
    s += zk * c[(n - 1) * step];               // zk = pole^(n-1)
    double zr = zk * pole;                     // pole^n
    for (int64_t k = n - 2; k >= 1; --k) {     // reflected half-period
      s += zr * c[k * step];
      zr *= pole;
    }                                          // zr = pole^(2n-2)
    prev = lambda * s / (1.0 - zr);
  } else {
    double sum = c[0];
    double zn = pole;
    for (int64_t k = 1; k <= 28; ++k) {
      sum += zn * c[k * step];
      zn *= pole;
    }
    prev = lambda * sum;
  }
  c[0] = (float)prev;
  for (int64_t k = 1; k < n; ++k) {
    prev = lambda * c[k * step] + pole * prev;
    c[k * step] = (float)prev;
  }
  // anticausal init (mirror): c'[n-1] = p/(p^2-1) * (c[n-1] + p*c[n-2])
  prev = pole / (pole * pole - 1.0) *
         (c[(n - 1) * step] + pole * c[(n - 2) * step]);
  c[(n - 1) * step] = (float)prev;
  for (int64_t k = n - 2; k >= 0; --k) {
    prev = pole * (prev - c[k * step]);
    c[k * step] = (float)prev;
  }
}

void prefilter_axis_range(float* vol, const Shape& s, int axis,
                          int64_t line_begin, int64_t line_end) {
  if (axis == 0) {
    // lines over (y,x), stride d1*d2, length d0
    for (int64_t l = line_begin; l < line_end; ++l)
      prefilter_line(vol + l, s.d0, s.d1 * s.d2);
  } else if (axis == 1) {
    // lines over (z,x): base = z*d1*d2 + x, stride d2, length d1
    for (int64_t l = line_begin; l < line_end; ++l) {
      const int64_t z = l / s.d2, x = l % s.d2;
      prefilter_line(vol + z * s.d1 * s.d2 + x, s.d1, s.d2);
    }
  } else {
    // lines over (z,y), contiguous, length d2
    for (int64_t l = line_begin; l < line_end; ++l)
      prefilter_line(vol + l * s.d2, s.d2, 1);
  }
}

}  // namespace

extern "C" {

// out[i,j,k] = interp(vol, M[:3,:4] @ [i,j,k,1]); m is row-major 3x4 double.
void vt_affine_transform(const float* vol, int64_t d0, int64_t d1, int64_t d2,
                         float* out, int64_t o0, int64_t o1, int64_t o2,
                         const double* m, int order, int border, float cval,
                         int n_threads) {
  const Shape in{d0, d1, d2};
  const Shape os{o0, o1, o2};
  const int64_t rows = o0 * o1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || rows < 2 * n_threads) {
    run_rows(vol, in, out, os, m, order, border, cval, 0, rows);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < rows ? lo + chunk : rows;
    if (lo >= hi) break;
    workers.emplace_back(run_rows, vol, in, out, os, m, order, border, cval,
                         lo, hi);
  }
  for (auto& w : workers) w.join();
}

// in-place cubic B-spline prefilter (mirror boundary), all three axes
void vt_bspline_prefilter(float* vol, int64_t d0, int64_t d1, int64_t d2,
                          int n_threads) {
  const Shape s{d0, d1, d2};
  if (n_threads < 1) n_threads = 1;
  for (int axis = 0; axis < 3; ++axis) {
    const int64_t lines = axis == 0 ? d1 * d2 : (axis == 1 ? d0 * d2 : d0 * d1);
    if (n_threads == 1 || lines < 2 * n_threads) {
      prefilter_axis_range(vol, s, axis, 0, lines);
      continue;
    }
    std::vector<std::thread> workers;
    const int64_t chunk = (lines + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = lo + chunk < lines ? lo + chunk : lines;
      if (lo >= hi) break;
      workers.emplace_back(prefilter_axis_range, vol, s, axis, lo, hi);
    }
    for (auto& w : workers) w.join();
  }
}

}  // extern "C"
