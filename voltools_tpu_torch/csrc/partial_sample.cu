// The per-slab partial sample, D: the sharded paths' gather-free samplers.
//
// No TPU kernel stands behind it: the JAX package leaves both functions to
// XLA.  Three entry points:
//
// D1, the ring stream of ShardedVolume
// (voltools_tpu/parallel/sharded.py::_partial_sample_pertap and the stream
// body that sums it).  A shard's output slab (o0, o1, o2) is resampled
// through its slab-shifted matrix from a volume of TRUE extent (d0, d1,
// d2) whose planes are spread over the shards in slabs of `loc` planes;
// a slab's partial is the part of each output voxel's sample whose taps
// lie in it (per-tap zero extension: the partials of all slabs sum to the
// whole sample).  Tap indices resolve as the single-device sampler
// resolves them before the slab test: linear 'constant' taps clip, cubic
// 'constant' taps mirror at the global edges, 'border' taps outside the
// volume count zero.  Only voxels whose source point lies inside the
// volume by the mode's test are sampled; the others end as cval.
//   partial_sample_ring_launch -- one launch a shard: every thread forms
//     its voxel's coordinates, inside test and taps once, then, for each
//     of the shard's slabs in ring order where one of its z taps lands,
//     the slab's partial, added to a register that starts at 0, and
//     writes the sum (or cval) once.  For a mesh whose slabs all lie on
//     the shard's device.
//   partial_sample_launch -- one step of the ring, the same kernel over
//     one slab: its partial added into the accumulator in place; on the
//     ring's last step (`last`) the voxels outside are set to cval.  For
//     a mesh of distinct devices, where a shard holds one source slab at
//     a time.
//
// D2, partial_project_launch -- the volume-sharded SIRT forward
// (voltools_tpu/models/reconstruction.py::_sirt_mesh, fwd_partial): for
// every tilt n and ray (a, b) of the projection, the sum over the planes
// of the projection axis, in plane order, of the trilinear sample of a
// zero-extended slab (its first plane at global z `off`), each plane's
// sample masked by the global scipy 'constant' inside test.  That is the
// JAX package's fori_loop order; the plain torch version sums chunks of
// planes with torch.sum, so the two agree to the order of a float32 sum.
//   The general kernel: a thread a ray; at each plane its three
//     coordinates, the inside test and 8 taps.
//   The line path (`line` = the ray axis b, the second of the two that
//     are not the projection axis): for tilt geometries whose matrices
//     all have row b equal to e_b and column b of the other two rows 0
//     (the wrapper's line_axis(), exact float32 equality), the sample's
//     coordinate along b is b itself, exactly, for every plane: its
//     fraction is +0, its weight 1 - 0 = 1, and the other two coordinates
//     do not depend on b (the product with column b is the same signed
//     zero for every b >= 0).  A warp takes kLanes * kLineRays rays of
//     one line (tilt n, row a) and forms their work once a plane: the two
//     other coordinates, the inside test, floors, fractions, the four
//     weights w_z * w_q and the plane range; each lane then keeps
//     kLineRays rays, each with its own sum, and reads the four taps
//     (z|z+1, q|q+1) at column b, coalesced across the lanes: as column
//     pairs (8-byte loads) where the rows hold an even number of floats
//     and the line runs along them.  The four taps at b + 1 that the
//     general kernel adds carry weight w * 0: each adds exactly +-0, so
//     for a finite slab every sample, and so every ray's sum, equals the
//     general kernel's bit for bit (a sum that starts at +0 never holds
//     -0, so the sign of a zero partial never shows).  A non-finite voxel,
//     whose inf * 0 makes NaN in the general kernel, lies outside that
//     equality; SIRT's iterate is finite.
//
// Every floating-point operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no FMA contraction), in the plain version's order
// (kernels/partial_sample.py): coordinates as resample_taps.cuh's
// source_coord, D1's weights, taps and sums as resample_taps.cuh's
// tap_sum from a partial that starts at 0, then acc + partial; D2's taps
// as _trilinear3d_pertap, weight ((wz * wy) * wx) times the tap, the taps
// summed in (dz, dy, dx) order from the first.  A tap, a slab, a voxel or
// a plane whose z taps all miss the slab would add exactly +0.0 (weights
// are never negative and no sum starts at -0.0), so skipping it keeps bit
// parity: D1 skips the slabs a voxel's z stencil misses, D2 the planes
// outside a range bounded from the ray's z coordinate and widened.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): D1 must
// read each source voxel a shard's taps reach once and write the output
// once -- at 250^3 on 4 shards about the volume read and written, some
// 0.034 ms a rotation, which bounds linear -- and sample each inside
// voxel once, 52 flops linear and 231 cubic (about 0.043 ms a rotation,
// which bounds cubic).  The per-step entry also reads and writes the
// accumulator at every step and forms a voxel's coordinates and taps once
// per slab (a voxel whose z stencil misses the slab returns first); the
// ring entry does neither.  Both give each warp a (4, 8) patch of output
// voxels, whose taps lie close together in the source, and take a cubic
// 'constant' axis whose taps lie inside the volume as they stand, without
// the mirror's remainder per tap.  D2 reads the slab once and writes N
// projections, but samples every (tilt, ray, plane) whose stencil meets
// the slab, about 41 x 250^3 samples a sweep: 53 flops each on the
// general kernel, a bilinear 4-tap sample and its sum on the line path,
// bound by operations either way.  The line path cuts a sample's work to
// its 4 taps, read as column pairs (8-byte loads), 4 products and 4 sums,
// the line's coordinates formed once a plane by each of its 2 warps; it is
// bound by those instructions, not by its loads (tools/partial_variants.py
// times it without them).  No texture filtering: its 8-bit fractions
// would break parity.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "resample_taps.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kMaxRing = 32;  // slabs a ring launch takes
// a ring warp's output patch: kPatchRows rows (along v) of kPatchCols
// voxels (along w), whose source points lie close together
constexpr int kPatchRows = 4;
constexpr int kPatchCols = kLanes / kPatchRows;
constexpr int kLineRays = 4;  // rays a lane of the line path

// rows 0-2 of a 4x4 matrix, passed by value with the launch
struct Rows {
  float m[12];
};

// The source coordinates of output voxel (u, v, w).
__device__ __forceinline__ void voxel_coords(const Rows& rows, int u, int v,
                                             int w, float s[3]) {
  const float fu = static_cast<float>(u), fv = static_cast<float>(v),
              fw = static_cast<float>(w);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s[r] = resample::source_coord(rows.m[4 * r], rows.m[4 * r + 1],
                                  rows.m[4 * r + 2], rows.m[4 * r + 3], fu,
                                  fv, fw);
  }
}

// make_taps's taps of source point s.  Cubic 'constant' mirrors each tap
// at the volume's edges, a remainder a tap: an axis whose taps all lie
// inside the volume takes them as they stand, which the mirror leaves as
// they are.  The other cases clip or flag their taps, cheaper than that
// test (tools/partial_variants.py).
template <int ORDER, bool CONSTANT>
__device__ __forceinline__ void voxel_taps(const float s[3], const int n[3],
                                           resample::Taps<ORDER>* t) {
  if constexpr (ORDER != 3 || !CONSTANT) {
    resample::make_taps<ORDER, CONSTANT>(s, n, t);
  } else {
    constexpr int kTaps = resample::TapCount<ORDER>::kTaps;
    resample::Weights<ORDER> wt;
    resample::make_weights<ORDER>(s, &wt);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool inner = wt.base[a] >= 0 && wt.base[a] + kTaps <= n[a];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int i = wt.base[a] + k;
        t->w[a][k] = wt.w[a][k];
        t->ok[a][k] = i >= 0 && i < n[a];
        t->idx[a][k] = inner ? i : resample::mirror_index(i, n[a]);
      }
    }
  }
}

// The partial of one slab, global planes [z0, z0 + loc) with rows of d2
// columns, d1 rows a plane, at a point whose taps are t: the taps whose z
// index lands in the slab, summed as tap_sum sums them, from 0.  Returns
// false, leaving `partial` as it was, where no z tap lands in the slab:
// its partial would be +0.0.
template <int ORDER, bool CONSTANT>
__device__ __forceinline__ bool slab_partial(const resample::Taps<ORDER>& t,
                                             const float* slab, int z0,
                                             int loc, int d1, int d2,
                                             float* partial) {
  constexpr int kTaps = resample::TapCount<ORDER>::kTaps;
  bool own[kTaps];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int zl = t.idx[0][k] - z0;
    own[k] = zl >= 0 && zl < loc && (CONSTANT || t.ok[0][k]);
    any = any || own[k];
  }
  if (!any) return false;
  float sum = 0.0f;
#pragma unroll
  for (int iz = 0; iz < kTaps; ++iz) {
    if (!own[iz]) continue;
    const long long plane = static_cast<long long>(t.idx[0][iz] - z0) * d1;
#pragma unroll
    for (int iy = 0; iy < kTaps; ++iy) {
      const float w_zy = __fmul_rn(t.w[0][iz], t.w[1][iy]);
      const float* row = slab + (plane + t.idx[1][iy]) * d2;
#pragma unroll
      for (int ix = 0; ix < kTaps; ++ix) {
        const bool ok = CONSTANT || (t.ok[1][iy] && t.ok[2][ix]);
        const float val = ok ? __ldg(row + t.idx[2][ix]) : 0.0f;
        sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(w_zy, t.w[2][ix]), val));
      }
    }
  }
  *partial = sum;
  return true;
}

struct Ring {
  const float* slab[kMaxRing];  // the shard's source slabs, in ring order
  int z0[kMaxRing];             // each slab's first global plane
  int n, loc;                   // slabs; planes a slab
  int d0, d1, d2;               // the volume's TRUE extent
  float* __restrict__ out;
  int o0, o1, o2;
  Rows rows;
  float cval;
};

// Both D1 entries: a thread a voxel, a warp a (kPatchRows, kPatchCols)
// patch.  The ring entry sums all of a shard's slabs from 0 and writes
// cval outside (ACCUMULATE false, LAST true); the per-step entry is the
// same body over one slab, its sum starting from the accumulator's value
// (ACCUMULATE), cval written outside on the ring's last step only (LAST).
// The parameters stay in the launch's constant bank (__grid_constant__):
// the slab table is read there with the loop's index, not copied to local
// memory.
template <int ORDER, bool CONSTANT, bool ACCUMULATE, bool LAST>
__global__ void __launch_bounds__(kLanes * kWarps)
    ring_kernel(const __grid_constant__ Ring a) {
  const int w = blockIdx.x * kPatchCols + threadIdx.x % kPatchCols;
  const int v = (blockIdx.y * kWarps + threadIdx.y) * kPatchRows +
                threadIdx.x / kPatchCols;
  const int u = blockIdx.z;
  if (w >= a.o2 || v >= a.o1) return;
  float s[3];
  voxel_coords(a.rows, u, v, w, s);
  float* out = a.out + (static_cast<long long>(u) * a.o1 + v) * a.o2 + w;
  if (!resample::inside<CONSTANT>(s, a.d0, a.d1, a.d2)) {
    if (LAST) *out = a.cval;
    return;
  }
  if constexpr (ACCUMULATE) {
    // a stencil whose z taps lie inside the volume as they stand (no clip
    // or mirror moves one) and miss every slab adds +0.0: return before
    // forming the taps (a whole ring's slabs cover the volume, so the
    // ring entry does not test)
    const int zb = static_cast<int>(floorf(s[0])) +
                   resample::TapCount<ORDER>::kFirst;
    const int ze = zb + resample::TapCount<ORDER>::kTaps - 1;
    bool miss = zb >= 0 && ze < a.d0;
    for (int k = 0; k < a.n && miss; ++k) {
      miss = ze < a.z0[k] || zb >= a.z0[k] + a.loc;
    }
    if (miss) return;
  }
  const int n[3] = {a.d0, a.d1, a.d2};
  resample::Taps<ORDER> t;
  voxel_taps<ORDER, CONSTANT>(s, n, &t);
  // the plain chain's accumulator: zeros (or the step's accumulator), then
  // + each slab's partial
  float acc = ACCUMULATE ? *out : 0.0f;
#pragma unroll 1
  for (int k = 0; k < a.n; ++k) {
    float partial;
    if (slab_partial<ORDER, CONSTANT>(t, a.slab[k], a.z0[k], a.loc, a.d1,
                                      a.d2, &partial)) {
      acc = __fadd_rn(acc, partial);
    }
  }
  *out = acc;
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

// The plane range of ray (ia, b) of tilt row m0 (row 0 of its matrix).
template <int AXIS>
__device__ __forceinline__ void ray_planes(const Project& a, float4 m0,
                                           int ia, int b, int* first,
                                           int* last) {
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
  plane_range(cp, e, mag, a.l, a.np, first, last);
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
  int first, last;
  ray_planes<AXIS>(a, m0, ia, b, &first, &last);
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

// VEC taps of one row at consecutive columns from p, or zeros where the
// row is not in the slab; a pair is one 8-byte load.
template <int VEC>
__device__ __forceinline__ void row_taps(const float* p, bool valid,
                                         float x[VEC]) {
  if constexpr (VEC == 2) {
    const float2 v = valid ? __ldg(reinterpret_cast<const float2*>(p))
                           : make_float2(0.0f, 0.0f);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = valid ? __ldg(p) : 0.0f;
  }
}

// The line path: a warp a line (tilt n, row ia), kLanes * RAYS rays of it
// a warp, lane `lane` taking the VEC rays from VEC lane + VEC kLanes k.
// The line axis is the ray's second axis (2, or 1 where the projection
// axis is 2); q is the axis that is neither z nor the line's.  VEC 2 reads
// column pairs: the line axis must be 2, the rows an even number of floats
// long and the slab 8-byte aligned.
template <int AXIS, int RAYS, int VEC>
__global__ void __launch_bounds__(kLanes * kWarps)
    line_kernel(const Project a) {
  constexpr int kLine = AXIS == 2 ? 1 : 2;
  constexpr int kQ = 3 - kLine;
  static_assert(VEC == 1 || kLine == 2, "pairs lie along the rows");
  const int ia = blockIdx.y * kWarps + threadIdx.y;
  const int n = blockIdx.z;
  if (ia >= a.na) return;
  const int b0 = blockIdx.x * (kLanes * RAYS) + threadIdx.x * VEC;
  const float4 mz = a.rows[3 * n], mq = a.rows[3 * n + kQ];
  // the general kernel's range, whose b term is 0: column b of row 0 is 0
  int first, last;
  ray_planes<AXIS>(a, mz, ia, 0, &first, &last);
  // along the line, taps lie `step` floats apart; along q, `qstep`
  const long long step = kLine == 2 ? 1 : a.w;
  const long long qstep = kLine == 2 ? a.w : 1;
  const long long plane = static_cast<long long>(a.h) * a.w;
  const int nq = kQ == 1 ? a.h : a.w;
  const float q_max = static_cast<float>((kQ == 1 ? a.g1 : a.g2) - 1);
  const float fa = static_cast<float>(ia);
  const float* base = a.slab + b0 * step;
  float acc[RAYS];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) acc[k] = 0.0f;
  for (int p = first; p <= last; ++p) {
    const float fp = static_cast<float>(p);
    // the general kernel's indices with the line's own as 0: its product
    // with column b of rows z and q is the same signed zero for every b
    const float w0 = AXIS == 0 ? fp : fa;
    const float w1 = AXIS == 0 ? fa : AXIS == 1 ? fp : 0.0f;
    const float w2 = AXIS == 2 ? fp : 0.0f;
    const float sz = resample::source_coord(mz.x, mz.y, mz.z, mz.w, w0, w1,
                                            w2);
    const float sq = resample::source_coord(mq.x, mq.y, mq.z, mq.w, w0, w1,
                                            w2);
    // the line's coordinate, b, is always inside
    const bool inside = sz >= 0.0f && sz <= static_cast<float>(a.g0 - 1) &&
                        sq >= 0.0f && sq <= q_max;
    if (!inside) continue;  // the plain version adds 0.0 there
    const float zz = __fsub_rn(sz, a.off);
    const float z0f = floorf(zz), q0f = floorf(sq);
    const float fz = __fsub_rn(zz, z0f), fq = __fsub_rn(sq, q0f);
    const float gz = __fsub_rn(1.0f, fz), gq = __fsub_rn(1.0f, fq);
    const int z = static_cast<int>(z0f), q = static_cast<int>(q0f);
    const bool z0 = z >= 0 && z < a.l, z1 = z + 1 >= 0 && z + 1 < a.l;
    const bool q0 = q >= 0 && q < nq, q1 = q + 1 >= 0 && q + 1 < nq;
    if (!(z0 || z1)) continue;  // every tap +0.0: the sums keep their value
    // the weights (w_z * w_q) * 1: the line's weight 1 - 0 is exactly 1
    const float w00 = __fmul_rn(gz, gq), w01 = __fmul_rn(gz, fq),
                w10 = __fmul_rn(fz, gq), w11 = __fmul_rn(fz, fq);
    const long long o00 = z * plane + q * qstep;
    const bool v00 = z0 && q0, v01 = z0 && q1, v10 = z1 && q0,
               v11 = z1 && q1;
#pragma unroll
    for (int k = 0; k < RAYS / VEC; ++k) {
      if (b0 + k * kLanes * VEC >= a.nb) break;
      const float* t = base + o00 + k * kLanes * VEC * step;
      float x00[VEC], x01[VEC], x10[VEC], x11[VEC];
      row_taps<VEC>(t, v00, x00);
      row_taps<VEC>(t + qstep, v01, x01);
      row_taps<VEC>(t + plane, v10, x10);
      row_taps<VEC>(t + plane + qstep, v11, x11);
      // a row outside the slab reads as 0, and 0 * w is the +0.0 that
      // the general kernel's tap gives there (w is finite, not negative)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float t00 = __fmul_rn(x00[e], w00);
        const float t01 = __fmul_rn(x01[e], w01);
        const float t10 = __fmul_rn(x10[e], w10);
        const float t11 = __fmul_rn(x11[e], w11);
        acc[k * VEC + e] = __fadd_rn(
            acc[k * VEC + e],
            __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11));
      }
    }
  }
  float* out = a.out + (static_cast<long long>(n) * a.na + ia) * a.nb;
#pragma unroll
  for (int k = 0; k < RAYS / VEC; ++k) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int b = b0 + k * kLanes * VEC + e;
      if (b < a.nb) out[b] = acc[k * VEC + e];
    }
  }
}

// D1's grid: a CTA kWarps patches of kPatchRows rows by kPatchCols voxels
dim3 ring_grid(int o0, int o1, int o2) {
  return dim3((o2 + kPatchCols - 1) / kPatchCols,
              (o1 + kWarps * kPatchRows - 1) / (kWarps * kPatchRows), o0);
}

template <int ORDER, bool CONSTANT>
void launch_ring(const Ring& a, bool accumulate, bool last,
                 cudaStream_t stream) {
  const dim3 grid = ring_grid(a.o0, a.o1, a.o2);
  const dim3 block(kLanes, kWarps);
  if (!accumulate) {
    ring_kernel<ORDER, CONSTANT, false, true><<<grid, block, 0, stream>>>(a);
  } else if (last) {
    ring_kernel<ORDER, CONSTANT, true, true><<<grid, block, 0, stream>>>(a);
  } else {
    ring_kernel<ORDER, CONSTANT, true, false><<<grid, block, 0, stream>>>(a);
  }
}

// Checks D1's arguments and launches the ring body over them.
int launch_d1(const void* const* slabs, const int* z0s, int n, int loc,
              int d0, int d1, int d2, const float* matrix, float* out, int o0,
              int o1, int o2, int order, int border, bool accumulate,
              bool last, float cval, cudaStream_t stream) {
  const dim3 grid = ring_grid(o0, o1, o2);
  if ((order != 1 && order != 3) || n < 1 || n > kMaxRing || loc < 1 ||
      d0 < 1 || d1 < 1 || d2 < 1 || o0 < 1 || o1 < 1 || o2 < 1 ||
      grid.y > 65535 || grid.z > 65535 || matrix == nullptr ||
      slabs == nullptr || z0s == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ring a{};
  for (int k = 0; k < n; ++k) {
    if (slabs[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.slab[k] = static_cast<const float*>(slabs[k]);
    a.z0[k] = z0s[k];
  }
  a.n = n;
  a.loc = loc;
  a.d0 = d0;
  a.d1 = d1;
  a.d2 = d2;
  a.out = out;
  a.o0 = o0;
  a.o1 = o1;
  a.o2 = o2;
  for (int i = 0; i < 12; ++i) a.rows.m[i] = matrix[i];
  a.cval = cval;
  if (order == 1 && !border) {
    launch_ring<1, true>(a, accumulate, last, stream);
  } else if (order == 1) {
    launch_ring<1, false>(a, accumulate, last, stream);
  } else if (!border) {
    launch_ring<3, true>(a, accumulate, last, stream);
  } else {
    launch_ring<3, false>(a, accumulate, last, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// n tilts: the general kernel a thread a ray, the line path a warp a line
template <int AXIS>
void launch_project(const Project& a, int n, bool line,
                    cudaStream_t stream) {
  const dim3 block(kLanes, kWarps);
  const unsigned lines = (a.na + kWarps - 1) / kWarps;
  if (line) {
    constexpr int kSpan = kLanes * kLineRays;
    const dim3 grid((a.nb + kSpan - 1) / kSpan, lines, n);
    // column pairs where the rows allow 8-byte loads
    const bool pairs = AXIS != 2 && a.w % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(a.slab) % 8 == 0;
    if constexpr (AXIS != 2) {
      if (pairs) {
        line_kernel<AXIS, kLineRays, 2><<<grid, block, 0, stream>>>(a);
        return;
      }
    }
    line_kernel<AXIS, kLineRays, 1><<<grid, block, 0, stream>>>(a);
  } else {
    const dim3 grid((a.nb + kLanes - 1) / kLanes, lines, n);
    project_kernel<AXIS><<<grid, block, 0, stream>>>(a);
  }
}

}  // namespace

// C entries, bound with ctypes.  Each launches on `stream`, on the calling
// thread's current device (the caller makes it the tensors' device),
// without synchronising, and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for arguments out of range).
//
// D1, one ring step.  slab: (loc, d1, d2) float32, contiguous: global
// planes [z0, z0 + loc) of a volume of true extent (d0, d1, d2).  matrix:
// 12 floats in host memory, rows 0-2 of the output slab's pull-back matrix
// (the slab shift in column 3), copied into the launch.  acc: (o0, o1, o2)
// float32, contiguous, updated in place.  order: 1 or 3.  border: 0 for
// 'constant', 1 for 'border'.  last: 1 on the ring's last step (outside
// voxels set to cval).
extern "C" int partial_sample_launch(const float* slab, int loc, int z0,
                                     int d0, int d1, int d2,
                                     const float* matrix, float* acc, int o0,
                                     int o1, int o2, int order, int border,
                                     int last, float cval, void* stream) {
  const void* const slabs[1] = {slab};
  return launch_d1(slabs, &z0, 1, loc, d0, d1, d2, matrix, acc, o0, o1, o2,
                   order, border, true, last != 0, cval,
                   static_cast<cudaStream_t>(stream));
}

// D1, a whole ring in one launch.  slabs: n device pointers in host
// memory, the shard's source slabs in ring order, each (loc, d1, d2)
// float32, contiguous, with its first global plane in z0s (n ints in host
// memory); 1 <= n <= kMaxRing (32, the wrapper's RING_CAPACITY).
// matrix, order, border and cval as for partial_sample_launch.  out: (o0,
// o1, o2) float32, contiguous; every voxel is written.
extern "C" int partial_sample_ring_launch(const void* const* slabs,
                                          const int* z0s, int n, int loc,
                                          int d0, int d1, int d2,
                                          const float* matrix, float* out,
                                          int o0, int o1, int o2, int order,
                                          int border, float cval,
                                          void* stream) {
  return launch_d1(slabs, z0s, n, loc, d0, d1, d2, matrix, out, o0, o1, o2,
                   order, border, false, true, cval,
                   static_cast<cudaStream_t>(stream));
}

// D2.  slab: (l, h, w) float32, contiguous, its first plane at global z
// `off`; h and w are the global volume's g1 and g2.  rows: (n, 3, 4)
// float32, contiguous, 16-byte aligned, on the same device: rows 0-2 of
// each pull-back matrix.  axis: the projection axis (0-2); the projection
// has the other two axes' extents (na, nb) in order, np planes.  line: 0
// for the general kernel, or the line path's axis, which must be the
// second of the other two (2, or 1 for axis 2), for matrices that pass
// line_axis() (the kernel cannot test them).  out: (n, na, nb) float32,
// contiguous; every value is written.
extern "C" int partial_project_launch(const float* slab, int l, int h, int w,
                                      const float* rows, int n, float off,
                                      int g0, int g1, int g2, int axis,
                                      int line, float* out, void* stream) {
  if (l < 1 || h != g1 || w != g2 || g0 < 1 || g1 < 1 || g2 < 1 || n < 1 ||
      n > 65535 || axis < 0 || axis > 2 ||
      (line != 0 && line != (axis == 2 ? 1 : 2)) ||
      reinterpret_cast<uintptr_t>(rows) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g[3] = {g0, g1, g2};
  const int np = g[axis];
  const int na = axis == 0 ? g1 : g0;
  const int nb = axis == 2 ? g1 : g2;
  if ((na + kWarps - 1) / kWarps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Project a{slab, l, h, w, reinterpret_cast<const float4*>(rows), off,
                  g0, g1, g2, np, na, nb, out};
  const auto cstream = static_cast<cudaStream_t>(stream);
  const bool on_line = line != 0;
  if (axis == 0) {
    launch_project<0>(a, n, on_line, cstream);
  } else if (axis == 1) {
    launch_project<1>(a, n, on_line, cstream);
  } else {
    launch_project<2>(a, n, on_line, cstream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* partial_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
