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
// What held the first port (one thread a voxel, 128 along x) at 6-26x
// that bound was not DRAM but the work its warps ask of L1 and of the
// issue slots: a warp's load of one tap is served one 128-byte line at a
// time, and the taps of 32 voxels along an output line, under a rotation,
// lie in 20-30 source rows; every voxel near no edge still paid for the
// edge code (the cubic mirror's `%`, the clips, 64-bit offsets); and
// trilinear, about a hundred instructions a voxel, is issue-bound.  The
// design, each part timed on the card by tools/walk_variants.py (PERF.md):
//  1. Warp patches compact in the source -- the CUDA form of the TPU walk
//     kernel's lane packing (pallas_walk.py:27-33).  A CTA of 4 warps
//     holds (kBrickZ, kBrickY, kBrickX) bricks of output voxels; each
//     warp a patch of 32 voxels a brick, flat (1, 4, 8) or deep (2, 2, 8)
//     along (z, y, x).  The launch says which (the planner takes the one
//     whose source image spans fewer rows, kernels/planner.py::walk_patch):
//     a tilt about the output's z keeps the flat patch in one source plane,
//     a rotation that mixes all three axes takes the deep one.  Both keep a
//     warp's stores whole 32-byte sectors of the (D, H, W) output, written
//     in place (no blocked output); voxels past the output's end are
//     masked one by one, and every lane reaches the warp votes.
//  2. Several voxels a thread (Tile<ORDER>::kVoxels bricks stacked along
//     z a CTA), so what a thread does once -- the matrix (three 16-byte
//     loads), its brick (a multiply-shift division of the CTA index) -- is
//     paid once for them all.
//  3. Cubic: an interior fast path.  Where every tap of every in-range
//     voxel of a warp lies inside the volume (resample::interior, decided
//     on the bases make_taps floors, by a warp vote, so no warp diverges),
//     tap k is base + k: no mirror, clip or 'border' flag, a row's offset
//     built once in 32 bits (64 where the volume holds 2^31 floats or
//     more) and its taps along x at consecutive addresses.  A warp with a
//     voxel near an edge runs the edge path, make_taps and tap_sum as
//     before.  Trilinear runs the edge path alone: its fast path was
//     slower on the card (it costs registers, and a clip is cheap).
//  4. Cubic rows as aligned float4 loads, where the rows start on 16-byte
//     boundaries (the wrapper says so) and the warp's rows are many: a
//     row's 4 taps from one or two float4s, picked by base & 3.  Where a
//     warp's rows are few (a tilt series) the selects cost more than the
//     loads they save, and the taps are read one float at a time; the warp
//     counts its distinct rows (__match_any_sync) and chooses.
//  5. Cubic's registers are capped at 64 (Tile<3>::kMinBlocks): with 150
//     and more a CTA, fewer warps hide the loads' latency.
// The fast path (resample::interior_sum) gives the same taps, weights and
// order of additions as the edge path, so both agree with the plain
// version bit for bit.  Each cubic warp counts its in-range voxels that
// took the fast path and adds them to the launch's counter (one atomic a
// warp, spread over kCountSlots cache lines), so a run shows on the
// device how many voxels took it.
//
// The per-voxel arithmetic (coordinates, weights, edges, tap sum) is in
// resample_taps.cuh, shared with affine_slab.cu: one rounding per
// operation, in the order of the plain PyTorch version, so both kernels
// and the plain version floor every coordinate alike, and the two kernels
// agree bit for bit.
//
// grid.x runs over the CTAs' bricks (x fastest, then y, then z), grid.y
// over the matrices; output offsets are 64-bit.  One build serves every
// matrix, cval and shape; order (1, 3), mode, warp patch and, for cubic,
// float4 rows and the fast path's offset width are template arguments (16
// instantiations).  The volume's rows lie `pitch`
// floats apart, so the pitched resident volume that the slab kernel's TMA
// copies need (kernels/layout.py) serves this kernel too.

#include <cuda_runtime.h>

#include <climits>

#include "resample_taps.cuh"

namespace {

// a CTA's brick of output voxels along (z, y, x), tiled by its warps'
// patches
constexpr int kBrickZ = 2;
constexpr int kBrickY = 8;
constexpr int kBrickX = 8;
// the two warp patches (32 voxels along z, y, x) a launch chooses between
constexpr int kFlatZ = 1, kFlatY = 4, kFlatX = 8;
constexpr int kDeepZ = 2, kDeepY = 2, kDeepX = 8;
// per spline order (chosen on the card, tools/walk_variants.py): the
// voxels a thread computes, kBrickZ apart along z (a CTA covers kVoxels
// bricks stacked along z), and the CTAs an SM must hold (__launch_bounds__:
// 8 CTAs of 128 threads cap a thread at 64 registers)
template <int ORDER>
struct Tile {
  static constexpr int kVoxels = ORDER == 1 ? 4 : 2;
  static constexpr int kMinBlocks = ORDER == 1 ? 1 : 8;
};
// cubic reads a warp's rows as float4 loads where the first taps of its
// voxels lie in at least this many distinct rows
constexpr int kVectorRowsFrom = 12;
// the fast-path counter: kCountSlots slots of kCountStride 64-bit words
// (one 128-byte line each, so that no one line takes every warp's atomic),
// whose first word counts in-range voxels that took the fast path; a warp
// adds its count to slot (its CTA's warp index) % kCountSlots
constexpr int kCountSlots = 128;
constexpr int kCountStride = 16;

constexpr int kThreads = kBrickZ * kBrickY * kBrickX;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kWarpMask = 0xffffffffu;

template <int PZ, int PY, int PX>
struct Patch {
  static_assert(PZ * PY * PX == 32, "a patch is one warp");
  static_assert(kBrickZ % PZ == 0 && kBrickY % PY == 0 && kBrickX % PX == 0,
                "patches tile the brick");
  static constexpr int kWarpsY = kBrickY / PY;
  static constexpr int kWarpsX = kBrickX / PX;

  // the first output voxel (z, y, x) of lane `lane` of warp `warp` of the
  // CTA (bz, by, bx), whose threads compute `voxels` voxels each: the
  // warps tile a brick x first, then y, then z
  __device__ __forceinline__ static void voxel(int lane, int warp, int bz,
                                               int by, int bx, int voxels,
                                               int* z, int* y, int* x) {
    *x = bx * kBrickX + warp % kWarpsX * PX + lane % PX;
    *y = by * kBrickY + warp / kWarpsX % kWarpsY * PY + lane / PX % PY;
    *z = bz * (kBrickZ * voxels) + warp / (kWarpsX * kWarpsY) * PZ +
         lane / (PX * PY);
  }
};
using Flat = Patch<kFlatZ, kFlatY, kFlatX>;
using Deep = Patch<kDeepZ, kDeepY, kDeepX>;

// Division of a CTA index (below 2^31) by a divisor d >= 1 fixed for the
// launch, as a multiply-high, an add and a shift (Granlund and
// Montgomery): with s = ceil(log2 d), magic = floor(2^32 (2^s - d) / d) +
// 1, q = (umulhi(a, magic) + a) >> s.
struct FastDiv {
  unsigned d, magic, shift;
  __device__ __forceinline__ int div(int a) const {
    const unsigned u = static_cast<unsigned>(a);
    return static_cast<int>((__umulhi(u, magic) + u) >> shift);
  }
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long magic =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<unsigned>(magic), s};
}

// A row's taps, one float at a time through the read-only path.
template <int TAPS>
struct ScalarRow {
  __device__ __forceinline__ void operator()(const float* __restrict__ p,
                                             float v[TAPS]) const {
#pragma unroll
    for (int k = 0; k < TAPS; ++k) v[k] = __ldg(p + k);
  }
};

// The 4 cubic taps of a row from aligned float4 loads: `row` points at the
// 16-byte boundary r = base & 3 floats before the first tap; the taps are
// r .. r + 3 of two float4s, the second read only where r > 0, so no load
// reaches past the last tap's aligned group of 4.
struct Float4Row {
  int r;
  __device__ __forceinline__ void operator()(const float* __restrict__ row,
                                             float v[4]) const {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(row));
    float4 hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r != 0) hi = __ldg(reinterpret_cast<const float4*>(row + 4));
    const float u[7] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
    const bool odd = r & 1, high = r & 2;
    float q[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) q[j] = odd ? u[j + 1] : u[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = high ? q[k + 2] : q[k];
  }
};

// The address `shift` floats before a point's first tap (base[0], base[1],
// base[2]) in a volume whose rows lie `pitch` and whose planes lie `plane`
// floats apart.
template <int ORDER, class Index>
__device__ __forceinline__ const float* first_tap(
    const float* __restrict__ vol, const resample::Weights<ORDER>& t,
    Index plane, int pitch, int shift) {
  return vol + (static_cast<Index>(t.base[0]) * plane +
                static_cast<Index>(t.base[1]) * pitch + (t.base[2] - shift));
}

// The number of distinct source rows of the first taps of a warp's
// in-range voxels (all interior), as the warp's lanes agree on it.
template <int ORDER, class Index>
__device__ __forceinline__ int warp_rows(const resample::Weights<ORDER>& t,
                                         bool inside, Index plane,
                                         int pitch) {
  const Index key = inside ? static_cast<Index>(t.base[0]) * plane +
                                 static_cast<Index>(t.base[1]) * pitch
                           : -1;
  const unsigned same = __match_any_sync(kWarpMask, key);
  const bool first = inside && __ffs(same) - 1 == threadIdx.x % 32;
  return __popc(__ballot_sync(kWarpMask, first));
}

template <int ORDER, bool CONSTANT, bool VEC, class Index, class P>
__global__ void __launch_bounds__(kThreads, Tile<ORDER>::kMinBlocks)
affine_resample_kernel(const float* __restrict__ vol, int d0, int d1, int d2,
                       int pitch, const float* __restrict__ mats,
                       float* __restrict__ out, int o0, int o1, int o2,
                       FastDiv bricks_x, FastDiv bricks_y, float cval,
                       unsigned long long* __restrict__ counts) {
  // the matrix's 3 rows, three 16-byte loads (the wrapper aligns them)
  const long long b = blockIdx.y;
  float m[12];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(mats + 16 * b) + a);
    m[4 * a] = r.x;
    m[4 * a + 1] = r.y;
    m[4 * a + 2] = r.z;
    m[4 * a + 3] = r.w;
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rest = bricks_x.div(blockIdx.x);
  const int bx = blockIdx.x - rest * static_cast<int>(bricks_x.d);
  const int bz = bricks_y.div(rest);
  const int by = rest - bz * static_cast<int>(bricks_y.d);
  constexpr int kVoxels = Tile<ORDER>::kVoxels;
  int z0, y, x;
  P::voxel(lane, warp, bz, by, bx, kVoxels, &z0, &y, &x);
  const int n[3] = {d0, d1, d2};
  const Index plane = static_cast<Index>(d1) * pitch;
  // this thread's in-range voxels on the fast path
  unsigned fast_voxels = 0;

#pragma unroll
  for (int v = 0; v < kVoxels; ++v) {
    const int z = z0 + v * kBrickZ;
    const bool here = z < o0 && y < o1 && x < o2;
    float s[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a] = resample::source_coord(m[4 * a], m[4 * a + 1], m[4 * a + 2],
                                    m[4 * a + 3], static_cast<float>(z),
                                    static_cast<float>(y),
                                    static_cast<float>(x));
    }
    const bool inside = here && resample::inside<CONSTANT>(s, d0, d1, d2);
    resample::Weights<ORDER> wt;
    bool interior = false;
    if (inside) {
      resample::make_weights<ORDER>(s, &wt);
      interior = resample::interior<ORDER>(wt, n);
    }
    float value = cval;
    // the interior fast path, on a warp vote: cubic only (trilinear runs
    // the edge path alone)
    const bool fast =
        ORDER == 3 && __all_sync(kWarpMask, interior || !inside);
    if (fast) {
      const Index row = pitch;
      // warp-uniform: float4 rows where the warp's rows are many
      if (VEC && warp_rows<ORDER, Index>(wt, inside, plane, pitch) >=
                     kVectorRowsFrom) {
        if constexpr (VEC) {
          if (inside) {
            const int r = wt.base[2] & 3;
            value = resample::interior_sum<ORDER, Index>(
                wt, first_tap(vol, wt, plane, pitch, r), plane, row,
                Float4Row{r});
          }
        }
      } else if (inside) {
        value = resample::interior_sum<ORDER, Index>(
            wt, first_tap(vol, wt, plane, pitch, 0), plane, row,
            ScalarRow<resample::TapCount<ORDER>::kTaps>{});
      }
    } else if (inside) {
      resample::Taps<ORDER> taps;
      resample::make_taps<ORDER, CONSTANT>(s, n, &taps);
      value = resample::tap_sum<ORDER, CONSTANT>(
          taps, resample::GlobalSource{vol, d1, pitch});
    }
    fast_voxels += fast && inside;
    if (here) {
      out[((b * o0 + z) * o1 + y) * static_cast<long long>(o2) + x] = value;
    }
  }
  if constexpr (ORDER == 3) {
    // every lane gets here: the warp's sum, one atomic at most a warp
    fast_voxels = __reduce_add_sync(kWarpMask, fast_voxels);
    if (lane == 0 && fast_voxels) {
      atomicAdd(counts +
                    kCountStride * ((blockIdx.x * kWarps + warp) % kCountSlots),
                static_cast<unsigned long long>(fast_voxels));
    }
  }
}

struct Launch {
  dim3 grid;
  cudaStream_t stream;
  const float* vol;
  int d0, d1, d2, pitch;
  const float* mats;
  float* out;
  int o0, o1, o2;
  FastDiv bricks_x, bricks_y;
  float cval;
  unsigned long long* counts;
};

template <int ORDER, bool CONSTANT, bool VEC, class Index, class P>
void launch(const Launch& a) {
  affine_resample_kernel<ORDER, CONSTANT, VEC, Index, P><<<a.grid, kThreads,
                                                           0, a.stream>>>(
      a.vol, a.d0, a.d1, a.d2, a.pitch, a.mats, a.out, a.o0, a.o1, a.o2,
      a.bricks_x, a.bricks_y, a.cval, a.counts);
}

// The instantiation a launch selects: order, mode, warp patch and, for
// cubic's fast path, 32-bit row offsets where the volume holds fewer than
// 2^31 floats, and float4 rows where they are allowed and the offsets are
// 32-bit (a volume of 2^31 floats or more reads its rows a float at a
// time); trilinear's edge path builds 64-bit offsets itself.
template <int ORDER, bool CONSTANT, class P>
void dispatch(const Launch& a, bool vec, bool offsets32) {
  if constexpr (ORDER == 3) {
    if (vec && offsets32) {
      launch<ORDER, CONSTANT, true, int, P>(a);
    } else if (offsets32) {
      launch<ORDER, CONSTANT, false, int, P>(a);
    } else {
      launch<ORDER, CONSTANT, false, long long, P>(a);
    }
  } else {
    launch<ORDER, CONSTANT, false, long long, P>(a);
  }
}

template <int ORDER, bool CONSTANT>
void dispatch(const Launch& a, bool vec, bool offsets32, bool deep) {
  if (deep) {
    dispatch<ORDER, CONSTANT, Deep>(a, vec, offsets32);
  } else {
    dispatch<ORDER, CONSTANT, Flat>(a, vec, offsets32);
  }
}

}  // namespace

// C entry, bound with ctypes.  vol: (d0, d1, d2) float32, rows of x
// contiguous and `pitch` >= d2 floats apart, planes d1 * pitch apart.
// mats: (n, 4, 4) float32, contiguous and 16-byte aligned, on the same
// device.  out: (n, o0, o1, o2) float32, contiguous.  order: 1 or 3.
// border: 0 for 'constant', 1 for 'border'.  vector_rows: 1 where cubic
// rows may be read as aligned float4 loads, which needs a pitch that is a
// multiple of 4 floats and a 16-byte aligned `vol` (refused otherwise).
// deep: 1 for the deep warp patch, 0 for the flat one.  counts:
// affine_resample_count_words() unsigned 64-bit words on the same device,
// kCountSlots slots of kCountStride words, to whose first words a cubic
// launch adds its in-range output voxels that took the fast path.  Launches on
// `stream`, on the calling thread's current device (the caller makes it
// the tensors' device), without synchronising, and returns
// cudaGetLastError() (0 on success).
extern "C" int affine_resample_launch(const float* vol, int d0, int d1,
                                      int d2, int pitch, const float* mats,
                                      int n, float* out, int o0, int o1,
                                      int o2, int order, int border,
                                      int vector_rows, int deep, float cval,
                                      unsigned long long* counts,
                                      void* stream) {
  if ((order != 1 && order != 3) || d0 < 1 || d1 < 1 || d2 < 1 ||
      pitch < d2 || n < 1 || n > 65535 || o0 < 1 || o1 < 1 || o2 < 1 ||
      static_cast<long long>(d1) * pitch > INT_MAX ||
      reinterpret_cast<unsigned long long>(mats) % 16 || counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vector_rows &&
      (pitch % 4 != 0 || reinterpret_cast<unsigned long long>(vol) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bricks_x = (o2 + kBrickX - 1) / kBrickX;
  const int bricks_y = (o1 + kBrickY - 1) / kBrickY;
  const int stack =
      kBrickZ * (order == 1 ? Tile<1>::kVoxels : Tile<3>::kVoxels);
  const int bricks_z = (o0 + stack - 1) / stack;
  const long long blocks =
      static_cast<long long>(bricks_x) * bricks_y * bricks_z;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(n)),
                 static_cast<cudaStream_t>(stream), vol, d0, d1, d2, pitch,
                 mats, out, o0, o1, o2, fast_div(bricks_x),
                 fast_div(bricks_y), cval, counts};
  const bool vec = vector_rows != 0;
  const bool offsets32 = static_cast<long long>(d0) * d1 * pitch <= INT_MAX;
  if (order == 1 && !border) {
    dispatch<1, true>(a, vec, offsets32, deep);
  } else if (order == 1) {
    dispatch<1, false>(a, vec, offsets32, deep);
  } else if (!border) {
    dispatch<3, true>(a, vec, offsets32, deep);
  } else {
    dispatch<3, false>(a, vec, offsets32, deep);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int affine_resample_count_words() {
  return kCountSlots * kCountStride;
}

extern "C" const char* affine_resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
