// The per-slab partial sample D as it was before its redesign (D1 one
// launch per shard and source slab, one thread a voxel; D2 one thread a
// ray, its coordinates and 8 taps formed at every plane), kept as it was
// but for this paragraph and the names of its C entries, as
// tools/partial_variants.py's and chip_smoke.py's yardstick (the variant
// `baseline`).  It is not part of the package and nothing in the package
// builds it; it includes voltools_tpu_torch/csrc/resample_taps.cuh, so
// nvcc takes -I voltools_tpu_torch/csrc.
//
// The per-slab partial sample, D: the sharded paths' gather-free samplers.
//
// No TPU kernel stands behind it: the JAX package leaves both functions to
// XLA.  Two entry points:
//
// D1, partial_sample_launch -- one step of the ring stream of
// ShardedVolume (voltools_tpu/parallel/sharded.py::_partial_sample_pertap
// and the stream body that sums it).  A shard's output slab (o0, o1, o2)
// is resampled through its slab-shifted matrix from a volume of TRUE
// extent (d0, d1, d2) whose planes are spread over the shards; this launch
// holds one source slab, global planes [z0, z0 + loc), and adds into the
// accumulator, in place, the part of each output voxel's sample whose taps
// lie in that slab (per-tap zero extension: the partials of all slabs sum
// to the whole sample).  Tap indices resolve as the single-device sampler
// resolves them before the slab test: linear 'constant' taps clip, cubic
// 'constant' taps mirror at the global edges, 'border' taps outside the
// volume count zero.  Only voxels whose source point lies inside the
// volume by the mode's test are sampled; on the ring's last step (`last`)
// the others are set to cval.
//
// D2, partial_project_launch -- the volume-sharded SIRT forward
// (voltools_tpu/models/reconstruction.py::_sirt_mesh, fwd_partial): for
// every tilt n and ray (a, b) of the projection, the sum over the planes
// of the projection axis, in plane order, of the trilinear sample of a
// zero-extended slab (its first plane at global z `off`), each plane's
// sample masked by the global scipy 'constant' inside test.  That is the
// JAX package's fori_loop order; the plain torch version sums chunks of
// planes with torch.sum, so the two agree to the order of a float32 sum.
//
// Every floating-point operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no FMA contraction), in the plain version's order
// (kernels/partial_sample.py): coordinates as resample_taps.cuh's
// source_coord, D1's weights, taps and sums as resample_taps.cuh's
// tap_sum from a partial that starts at 0, then acc + partial; D2's taps
// as _trilinear3d_pertap, weight ((wz * wy) * wx) times the tap, the 8
// taps summed in (dz, dy, dx) order from the first.  A tap, a voxel or a
// plane whose z taps all miss the slab would add exactly +0.0 (weights are
// never negative and no sum starts at -0.0), so skipping it keeps bit
// parity: D1 skips the voxels whose z stencil misses its slab, D2 the
// planes outside a range bounded from the ray's z coordinate and widened.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): D1 reads its
// slab once and reads and writes the accumulator where the stencil meets
// the slab -- at 250^3 on 4 shards, 16 launches a rotation, each a 15.75
// MB slab and a part of a 15.75 MB accumulator, about 0.12-0.23 ms a
// rotation by bytes.  D2 reads the slab once and writes N projections, but
// samples every (tilt, ray, plane) whose stencil meets the slab, 52 flops
// each: about 41 x 250^3 samples a sweep, bound by operations.  Both are
// simple: one thread a voxel (D1) or a ray (D2), warps along x, taps
// gathered through L1 and L2 (a 15.75 MB slab fits the 50 MB L2).  No
// texture filtering: its 8-bit fractions would break parity.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "resample_taps.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;

// rows 0-2 of a 4x4 matrix, passed by value with the launch
struct Rows {
  float m[12];
};

struct Sample {
  const float* __restrict__ slab;
  int loc, z0;         // the slab's planes and its first global plane
  int d0, d1, d2;      // the volume's TRUE extent; the slab's rows, cols
  float* __restrict__ acc;
  int o0, o1, o2;
  Rows rows;
  float cval;
};

template <int ORDER, bool CONSTANT, bool LAST>
__global__ void __launch_bounds__(kLanes * kWarps)
    sample_kernel(const Sample a) {
  constexpr int kTaps = resample::TapCount<ORDER>::kTaps;
  const int w = blockIdx.x * kLanes + threadIdx.x;
  const int v = blockIdx.y * kWarps + threadIdx.y;
  const int u = blockIdx.z;
  if (w >= a.o2 || v >= a.o1) return;
  const float fu = static_cast<float>(u), fv = static_cast<float>(v),
              fw = static_cast<float>(w);
  float s[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s[r] = resample::source_coord(a.rows.m[4 * r], a.rows.m[4 * r + 1],
                                  a.rows.m[4 * r + 2], a.rows.m[4 * r + 3],
                                  fu, fv, fw);
  }
  float* out = a.acc + (static_cast<long long>(u) * a.o1 + v) * a.o2 + w;
  if (!resample::inside<CONSTANT>(s, a.d0, a.d1, a.d2)) {
    if (LAST) *out = a.cval;
    return;
  }
  const int n[3] = {a.d0, a.d1, a.d2};
  resample::Taps<ORDER> t;
  resample::make_taps<ORDER, CONSTANT>(s, n, &t);
  bool own[kTaps];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int zl = t.idx[0][k] - a.z0;
    own[k] = zl >= 0 && zl < a.loc && (CONSTANT || t.ok[0][k]);
    any = any || own[k];
  }
  if (!any) return;
  float partial = 0.0f;
#pragma unroll
  for (int iz = 0; iz < kTaps; ++iz) {
    if (!own[iz]) continue;
    const long long plane =
        static_cast<long long>(t.idx[0][iz] - a.z0) * a.d1;
#pragma unroll
    for (int iy = 0; iy < kTaps; ++iy) {
      const float w_zy = __fmul_rn(t.w[0][iz], t.w[1][iy]);
      const float* row = a.slab + (plane + t.idx[1][iy]) * a.d2;
#pragma unroll
      for (int ix = 0; ix < kTaps; ++ix) {
        const bool ok = CONSTANT || (t.ok[1][iy] && t.ok[2][ix]);
        const float val = ok ? __ldg(row + t.idx[2][ix]) : 0.0f;
        partial = __fadd_rn(partial,
                            __fmul_rn(__fmul_rn(w_zy, t.w[2][ix]), val));
      }
    }
  }
  *out = __fadd_rn(*out, partial);
}

struct Project {
  const float* __restrict__ slab;
  int l, h, w;                      // the slab: (local, H, W)
  const float4* __restrict__ rows;  // (n, 3): rows 0-2 of each matrix
  float off;                        // the slab's first global plane
  int g0, g1, g2;                   // the global volume's shape
  int np, na, nb;                   // planes; the projection's rows, cols
  float* __restrict__ out;          // (n, na, nb)
};

// One tap of the zero-extended slab, weighted: _trilinear3d_pertap's tap.
__device__ __forceinline__ float slab_tap(const Project& a, int z, int y,
                                          int x, float wgt) {
  const bool valid = z >= 0 && z < a.l && y >= 0 && y < a.h && x >= 0 &&
                     x < a.w;
  if (!valid) return 0.0f;
  return __fmul_rn(
      __ldg(a.slab + (static_cast<long long>(z) * a.h + y) * a.w + x), wgt);
}

// The planes [first, last] outside which no plane of the ray can have a
// tap in the slab: where its z coordinate relative to the slab, c p + e,
// lies in [-1, l), widened by one voxel plus a bound on the float32
// rounding of the coordinate, then by one plane.  Every plane inside is
// tested exactly; every plane outside would add +0.0.
__device__ __forceinline__ void plane_range(double c, double e, double mag,
                                            int l, int np, int* first,
                                            int* last) {
  const double slack = 1.0 + 1e-5 * mag;
  const double lo = -1.0 - slack, hi = l + slack;
  if (c == 0.0) {
    const bool meets = e >= lo && e <= hi;
    *first = meets ? 0 : 1;
    *last = meets ? np - 1 : 0;
    return;
  }
  const double p1 = (lo - e) / c, p2 = (hi - e) / c;
  // fmax/fmin drop a NaN: a NaN bound leaves the whole ray to the test
  const double pf = fmax(floor(fmin(p1, p2)) - 1.0, 0.0);
  const double pl = fmin(ceil(fmax(p1, p2)) + 1.0, np - 1.0);
  *first = static_cast<int>(fmin(pf, static_cast<double>(np)));
  *last = static_cast<int>(fmax(pl, -1.0));
}

template <int AXIS>
__global__ void __launch_bounds__(kLanes * kWarps)
    project_kernel(const Project a) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int ia = blockIdx.y * kWarps + threadIdx.y;
  const int n = blockIdx.z;
  if (b >= a.nb || ia >= a.na) return;
  const float4 m0 = a.rows[3 * n], m1 = a.rows[3 * n + 1],
               m2 = a.rows[3 * n + 2];
  // row 0's coefficients of the plane index and of the ray's two indices
  const float cp = AXIS == 0 ? m0.x : AXIS == 1 ? m0.y : m0.z;
  const float ca = AXIS == 0 ? m0.y : m0.x;
  const float cb = AXIS == 2 ? m0.y : m0.z;
  const double e = static_cast<double>(ca) * ia +
                   static_cast<double>(cb) * b + m0.w -
                   static_cast<double>(a.off);
  const double mag = fabs(static_cast<double>(cp)) * a.np +
                     fabs(static_cast<double>(ca)) * ia +
                     fabs(static_cast<double>(cb)) * b + fabs(m0.w) +
                     fabs(a.off);
  int first, last;
  plane_range(cp, e, mag, a.l, a.np, &first, &last);
  const float fa = static_cast<float>(ia), fb = static_cast<float>(b);
  float acc = 0.0f;
  for (int p = first; p <= last; ++p) {
    const float fp = static_cast<float>(p);
    const float w0 = AXIS == 0 ? fp : fa;
    const float w1 = AXIS == 0 ? fa : AXIS == 1 ? fp : fb;
    const float w2 = AXIS == 2 ? fp : fb;
    const float s0 = resample::source_coord(m0.x, m0.y, m0.z, m0.w, w0, w1,
                                            w2);
    const float s1 = resample::source_coord(m1.x, m1.y, m1.z, m1.w, w0, w1,
                                            w2);
    const float s2 = resample::source_coord(m2.x, m2.y, m2.z, m2.w, w0, w1,
                                            w2);
    const bool inside = s0 >= 0.0f && s0 <= static_cast<float>(a.g0 - 1) &&
                        s1 >= 0.0f && s1 <= static_cast<float>(a.g1 - 1) &&
                        s2 >= 0.0f && s2 <= static_cast<float>(a.g2 - 1);
    if (!inside) continue;  // the plain version adds 0.0 there
    const float zz = __fsub_rn(s0, a.off);
    const float z0f = floorf(zz), y0f = floorf(s1), x0f = floorf(s2);
    const float fz = __fsub_rn(zz, z0f), fy = __fsub_rn(s1, y0f),
                fx = __fsub_rn(s2, x0f);
    const float gz = __fsub_rn(1.0f, fz), gy = __fsub_rn(1.0f, fy),
                gx = __fsub_rn(1.0f, fx);
    // an inside point's coordinates are bounded by the volume: no
    // conversion overflows
    const int z = static_cast<int>(z0f), y = static_cast<int>(y0f),
              x = static_cast<int>(x0f);
    const float wzy00 = __fmul_rn(gz, gy), wzy01 = __fmul_rn(gz, fy),
                wzy10 = __fmul_rn(fz, gy), wzy11 = __fmul_rn(fz, fy);
    float val = slab_tap(a, z, y, x, __fmul_rn(wzy00, gx));
    val = __fadd_rn(val, slab_tap(a, z, y, x + 1, __fmul_rn(wzy00, fx)));
    val = __fadd_rn(val, slab_tap(a, z, y + 1, x, __fmul_rn(wzy01, gx)));
    val = __fadd_rn(val, slab_tap(a, z, y + 1, x + 1, __fmul_rn(wzy01, fx)));
    val = __fadd_rn(val, slab_tap(a, z + 1, y, x, __fmul_rn(wzy10, gx)));
    val = __fadd_rn(val, slab_tap(a, z + 1, y, x + 1, __fmul_rn(wzy10, fx)));
    val = __fadd_rn(val, slab_tap(a, z + 1, y + 1, x, __fmul_rn(wzy11, gx)));
    val = __fadd_rn(val,
                    slab_tap(a, z + 1, y + 1, x + 1, __fmul_rn(wzy11, fx)));
    acc = __fadd_rn(acc, val);
  }
  a.out[(static_cast<long long>(n) * a.na + ia) * a.nb + b] = acc;
}

template <int ORDER, bool CONSTANT>
void launch_sample(const Sample& a, bool last, dim3 grid,
                   cudaStream_t stream) {
  const dim3 block(kLanes, kWarps);
  if (last) {
    sample_kernel<ORDER, CONSTANT, true><<<grid, block, 0, stream>>>(a);
  } else {
    sample_kernel<ORDER, CONSTANT, false><<<grid, block, 0, stream>>>(a);
  }
}

}  // namespace

// C entries, bound with ctypes.  Each launches on `stream`, on the calling
// thread's current device (the caller makes it the tensors' device),
// without synchronising, and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for arguments out of range).
//
// D1.  slab: (loc, d1, d2) float32, contiguous: global planes [z0, z0 +
// loc) of a volume of true extent (d0, d1, d2).  matrix: 12 floats in host
// memory, rows 0-2 of the output slab's pull-back matrix (the slab shift
// in column 3), copied into the launch.  acc: (o0, o1, o2) float32,
// contiguous, updated in place.  order: 1 or 3.  border: 0 for 'constant',
// 1 for 'border'.  last: 1 on the ring's last step (outside voxels set to
// cval).
extern "C" int partial_sample_baseline_launch(const float* slab, int loc, int z0,
                                     int d0, int d1, int d2,
                                     const float* matrix, float* acc, int o0,
                                     int o1, int o2, int order, int border,
                                     int last, float cval, void* stream) {
  const dim3 grid((o2 + kLanes - 1) / kLanes, (o1 + kWarps - 1) / kWarps,
                  o0);
  if ((order != 1 && order != 3) || loc < 1 || d0 < 1 || d1 < 1 || d2 < 1 ||
      o0 < 1 || o1 < 1 || o2 < 1 || grid.y > 65535 || grid.z > 65535 ||
      matrix == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sample a{slab, loc, z0, d0, d1, d2, acc, o0, o1, o2, {}, cval};
  for (int i = 0; i < 12; ++i) a.rows.m[i] = matrix[i];
  const auto cstream = static_cast<cudaStream_t>(stream);
  const bool end = last != 0;
  if (order == 1 && !border) {
    launch_sample<1, true>(a, end, grid, cstream);
  } else if (order == 1) {
    launch_sample<1, false>(a, end, grid, cstream);
  } else if (!border) {
    launch_sample<3, true>(a, end, grid, cstream);
  } else {
    launch_sample<3, false>(a, end, grid, cstream);
  }
  return static_cast<int>(cudaGetLastError());
}

// D2.  slab: (l, h, w) float32, contiguous, its first plane at global z
// `off`; h and w are the global volume's g1 and g2.  rows: (n, 3, 4)
// float32, contiguous, 16-byte aligned, on the same device: rows 0-2 of
// each pull-back matrix.  axis: the projection axis (0-2); the projection
// has the other two axes' extents (na, nb) in order, np planes.  out: (n,
// na, nb) float32, contiguous; every value is written.
extern "C" int partial_project_baseline_launch(const float* slab, int l, int h, int w,
                                      const float* rows, int n, float off,
                                      int g0, int g1, int g2, int axis,
                                      float* out, void* stream) {
  if (l < 1 || h != g1 || w != g2 || g0 < 1 || g1 < 1 || g2 < 1 || n < 1 ||
      n > 65535 || axis < 0 || axis > 2 ||
      reinterpret_cast<uintptr_t>(rows) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g[3] = {g0, g1, g2};
  const int np = g[axis];
  const int na = axis == 0 ? g1 : g0;
  const int nb = axis == 2 ? g1 : g2;
  const dim3 grid((nb + kLanes - 1) / kLanes, (na + kWarps - 1) / kWarps, n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Project a{slab, l, h, w, reinterpret_cast<const float4*>(rows), off,
                  g0, g1, g2, np, na, nb, out};
  const dim3 block(kLanes, kWarps);
  const auto cstream = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    project_kernel<0><<<grid, block, 0, cstream>>>(a);
  } else if (axis == 1) {
    project_kernel<1><<<grid, block, 0, cstream>>>(a);
  } else {
    project_kernel<2><<<grid, block, 0, cstream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* partial_sample_baseline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
