// Affine resampling of a 3-D float32 volume through N 4x4 pull-back matrices,
// with the taps of each output brick read from a source box that TMA
// stages in shared memory while the CTA computes the brick before it.
//
// Replaces the TPU select-tree Pallas kernel
// voltools_tpu/kernels/pallas_affine.py::_make_kernel (launched by
// _tree_runner, batched, and affine_sample_pallas_variant).  Same function
// and edges as that kernel and as affine_resample.cu: for every output
// voxel (u, v, w) of every matrix M, src = M . (u, v, w, 1), then the
// trilinear (2^3 taps) or cubic B-spline (4^3 taps) sum at src, 'constant'
// or 'border' with cval.  The per-voxel arithmetic is resample_taps.cuh,
// shared with affine_resample.cu, so the two kernels agree bit for bit.
//
// What it keeps of the TPU kernel: windows of the source in fast memory,
// several in flight at once (the TPU kernel's DMA ring of 2-4 windows,
// pallas_affine.py:257-260, 295-342).  What it does not: the slab of
// full-x rows per (8 x 128) output tile, lane gathers, slop taps, the
// select-tree and the axis permutations.  A CTA gathers from a 3-D box in
// any orientation.
//
// Work items.  An item is one output brick of one matrix ((8, 8, 32) voxels
// for trilinear, (4, 8, 32) for cubic: Tile below), numbered matrix first,
// then the brick's z, y and x (64-bit),
// so CTAs that run at the same time hold neighbouring bricks of one matrix
// and their boxes meet in L2.  The grid is persistent: SMs x CTAs per SM
// (from the occupancy query), and CTA c takes items c, c + grid, c + 2 grid
// and so on, however many matrices the launch has.
//
// Each CTA keeps a ring of `stages` box buffers in dynamic shared memory
// (128-byte aligned), each with its own mbarrier:
//  1. warp 0 works out the box of an item from the source coordinates of
//     its brick's 8 corners: along each axis the box starts at floor(min) +
//     first tap - 1 (along x rounded down to a multiple of 4 floats: TMA
//     reads rows from 16-byte boundaries) and holds the launch's extents
//     (the planner's, for the envelope of the launch's matrices: ceil(span)
//     + taps + 3, and along x 3 more for the rounding, then rounded up to 4
//     floats).  The one voxel of slack each side covers a voxel
//     inside the brick whose coordinate floors one lower or higher than the
//     corners (a rounding at a knife edge), and the 'constant' cubic mirror
//     tap of a point at exactly n-1 (n-3, one below floor - 1).  Lane 0
//     writes the box's origin to shared memory, arms the buffer's barrier
//     with the box's bytes and issues one TMA copy of the box
//     (cp.async.bulk.tensor.3d), which completes the barrier.
//  2. The box is not clipped to the volume: TMA fills the voxels outside it
//     with zeros, and the taps' own masks (resample_taps.cuh: mirror or clip
//     for 'constant', in-range flags for 'border') never read them.
//  3. Before item k all threads pass a __syncthreads, so none still reads
//     buffer (k - 1) % stages; then warp 0 issues item k + stages - 1 into
//     it; then all threads wait on buffer k % stages (phase parity
//     (k / stages) & 1: the ring has gone round k / stages times) and its
//     threads (32 along x, 8 along y, 1 or 2 along z) evaluate the brick's
//     voxels from the box, each walking its column along z.  So the loads
//     of the next stages - 1 items are in flight while item k is computed.
// A voxel with a tap outside its CTA's box (matrices whose box is larger
// than the launch's extents) reads all its taps from global memory and
// counts one overflow, so no stale shared memory is ever read, the result
// is right even then, and the overflow counter says it happened.  Where
// the brick's corners show that the box holds every tap of the brick
// (Origin::whole, decided by warp 0 with the origin), no voxel tests its
// taps against the box.
//
// The tensor map of the volume is encoded on the host for each launch and
// passed as a __grid_constant__ parameter.  TMA needs every global stride
// to be a multiple of 16 bytes, so the volume is pitched: its rows lie
// `pitch` (a multiple of 4) floats apart and the map's x extent is d2, so
// the padding is out of range to TMA and never read (kernels/layout.py).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32, an FMA counted
// as 2 flops): the same function as affine_resample.cu, so the same bound:
// the source read once per launch and every output voxel written once, or
// the function's least arithmetic (52 flops linear, 231 cubic, per output
// voxel inside the source), whichever is larger.  What holds it above that
// bound is not the function but the boxes: the boxes of neighbouring
// bricks overlap, so the source crosses from L2 to shared memory several
// times over (box voxels per output voxel, 3-14 at 250^3), and the taps are
// then read from shared memory.  Measured on the card
// (tools/slab_variants.py, PERF.md): trilinear, the box traffic and the
// compute take about as long as each other; cubic, the compute (64 taps a
// voxel) takes three to four times the traffic.  What this design does
// about it: it reads each source voxel from shared memory for every tap
// that needs it, instead of through L1/L2 per tap as affine_resample.cu
// does; it hides a box's load behind the compute of the items before it
// (and of the other CTAs on the SM), so a CTA's time is the larger of its
// traffic and its compute rather than their sum; per order it takes the
// tile that keeps most warps busy: cubic's 512 threads give a CTA 16
// warps where one CTA fills an SM; and a cubic warp whose voxels lie away
// from the volume's edges and inside the box takes the interior fast path
// that affine_resample.cu's cubic takes (resample::interior_sum), without
// the mirror's `%`, the clips and the per-tap box test (trilinear's fast
// path was slower, tools/slab_variants.py, and trilinear runs the edge
// path, without its box test where the brick's box holds every tap).
// Where the box per output voxel still makes it the slower kernel, the
// planner gives the launch to affine_resample.cu (kernels/planner.py).
// What it leaves for later: a CTA that marched along z could reuse the
// overlap of consecutive boxes (the TPU kernel's window reuse), and the
// cubic kernel takes (8, 8, 32) bricks faster where their boxes fit.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "resample_taps.cuh"

namespace {

// The output brick of a work item and the CTA's threads, per spline order
// (chosen on the card, tools/slab_variants.py): trilinear takes (8, 8, 32)
// bricks, 256 threads each walking 8 voxels along z, which halves the
// per-item overhead against (4, 8, 32); cubic, whose time is its compute,
// takes (4, 8, 32) bricks with 512 threads, 2 along z a column, so a CTA
// has 16 warps even where one CTA fills an SM.
template <int ORDER>
struct Tile {
  static constexpr int kBz = ORDER == 1 ? 8 : 4;  // output brick along z
  static constexpr int kBy = 8;    // threadIdx.y
  static constexpr int kBx = 32;   // threadIdx.x: a warp stores a row of x
  static constexpr int kTz = ORDER == 1 ? 1 : 2;  // threadIdx.z
  static constexpr int kThreads = kBx * kBy * kTz;
  static_assert(kBz % kTz == 0, "threads along z must divide the brick");
};
constexpr int kMaxStages = 4;
constexpr int kMaxBox = 256;  // TMA's largest box extent along any axis
constexpr int kAlign = 128;   // TMA's alignment of a shared-memory box
constexpr int kRowAlign = 4;  // floats: TMA's row unit and x alignment
// 227 KB of shared memory a block, less a reserve for the static barriers
// and box origins
constexpr long long kMaxDynamicBytes = 232448 - 1024;

// error codes of the C entries besides the CUDA runtime's
constexpr int kNoEncoder = -1;     // the driver has no cuTensorMapEncodeTiled
constexpr int kMapRefused = -2;    // it refused the volume's tensor map

// Taps read from a staged box: source voxels from (lz, ly, lx) on, with
// ny x nx voxels per z-plane of the box and nx per row.
struct SharedSource {
  using Offset = int;
  const float* box;
  int lz, ly, lx, ny, nx;
  __device__ __forceinline__ Offset z_offset(int z) const {
    return (z - lz) * ny * nx;
  }
  __device__ __forceinline__ Offset y_offset(int y) const {
    return (y - ly) * nx;
  }
  __device__ __forceinline__ float load(Offset row, int x) const {
    return box[row + x - lx];
  }
};

// One work item: brick (u0..u1, v0..v1, w0..w1) of the output of matrix b.
struct Brick {
  long long b;
  int u0, v0, w0;
  int u1, v1, w1;  // last output voxel along each axis (ragged at the edges)
};

struct Origin {
  int z, y, x;  // the first source voxel of a box
  int whole;    // 1: every tap of every voxel of the brick lies in the box
};

template <int ORDER>
__device__ __forceinline__ Brick brick_of(long long item, long long bricks,
                                          int bricks_y, int bricks_x, int o0,
                                          int o1, int o2) {
  using T = Tile<ORDER>;
  Brick br;
  br.b = item / bricks;
  const int r = static_cast<int>(item - br.b * bricks);
  const int bx = r % bricks_x;
  const int rest = r / bricks_x;
  const int by = rest % bricks_y;
  const int bz = rest / bricks_y;
  br.u0 = bz * T::kBz;
  br.v0 = by * T::kBy;
  br.w0 = bx * T::kBx;
  br.u1 = min(br.u0 + T::kBz, o0) - 1;
  br.v1 = min(br.v0 + T::kBy, o1) - 1;
  br.w1 = min(br.w0 + T::kBx, o2) - 1;
  return br;
}

// The origin of a brick's box: along each source axis, floor(min over the
// brick's 8 corners) + first tap - 1, and along x that rounded down to a
// multiple of 4 (TMA starts a row on a 16-byte boundary; a box whose x
// origin is not one faults with an illegal instruction on the H100).  A
// whole warp calls it: lane 8a + c evaluates corner c along axis a (lanes
// 24-31 repeat axis 2), butterflies over each 8 lanes take the min and the
// max, and every lane gets the origin.  The box of extents e holds every
// tap of the brick ('whole') where, on every axis, floor(max over the
// corners) + last tap lies in it: a voxel's coordinate is monotone in each
// of u, v and w (each product and sum of source_coord is rounded
// monotonically), so the corners bound every voxel's floor, and its taps
// after the clip or the mirror lie between the box's first voxel and that
// last tap.
template <int ORDER>
__device__ __forceinline__ Origin box_origin(const float* m, const Brick& br,
                                             const int e[3]) {
  constexpr int kFirst = resample::TapCount<ORDER>::kFirst;
  constexpr int kTaps = resample::TapCount<ORDER>::kTaps;
  const int a = min(static_cast<int>(threadIdx.x) >> 3, 2);
  const int c = threadIdx.x & 7;
  const float s = resample::source_coord(
      __ldg(m + 4 * a), __ldg(m + 4 * a + 1), __ldg(m + 4 * a + 2),
      __ldg(m + 4 * a + 3), static_cast<float>(c & 4 ? br.u1 : br.u0),
      static_cast<float>(c & 2 ? br.v1 : br.v0),
      static_cast<float>(c & 1 ? br.w1 : br.w0));
  float low = s, high = s;
#pragma unroll
  for (int lane = 1; lane < 8; lane <<= 1) {
    low = fminf(low, __shfl_xor_sync(0xffffffffu, low, lane));
    high = fmaxf(high, __shfl_xor_sync(0xffffffffu, high, lane));
  }
  // clamped first, so that the conversion to int cannot overflow
  constexpr float kFar = 1.0e9f;
  int lo = static_cast<int>(floorf(fminf(fmaxf(low, -kFar), kFar))) +
           kFirst - 1;
  if (a == 2) lo &= ~(kRowAlign - 1);
  const int last = static_cast<int>(floorf(fminf(fmaxf(high, -kFar), kFar))) +
                   kFirst + kTaps - 1;
  const bool fits = last <= lo + (a == 0 ? e[0] : a == 1 ? e[1] : e[2]) - 1;
  return Origin{__shfl_sync(0xffffffffu, lo, 0),
                __shfl_sync(0xffffffffu, lo, 8),
                __shfl_sync(0xffffffffu, lo, 16),
                __all_sync(0xffffffffu, fits) ? 1 : 0};
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(1u)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Stage one box whose first voxel is (z, y, x) into `dst`: arm the barrier
// with the box's bytes (those TMA fills with zeros count too), then one TMA
// copy, which completes the barrier's transaction count when it lands.
__device__ __forceinline__ void stage_box(float* dst, const CUtensorMap* map,
                                          uint64_t* bar, uint32_t bytes,
                                          int z, int y, int x) {
  const uint32_t b = shared_address(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(b)
      : "memory");
}

// Warp 0: issue the load of this CTA's k-th item into buffer k % stages
// (nothing past the last item).
template <int ORDER>
__device__ __forceinline__ void load_item(
    long long k, const CUtensorMap* map, const float* __restrict__ mats,
    long long bricks, int bricks_y, int bricks_x, long long items, int o0,
    int o1, int o2, const int e[3], int stages, float* buffers, int stride,
    uint32_t box_bytes, uint64_t* full, Origin* origin) {
  const long long item = blockIdx.x + k * gridDim.x;
  if (item >= items) return;
  const Brick br =
      brick_of<ORDER>(item, bricks, bricks_y, bricks_x, o0, o1, o2);
  const Origin lo = box_origin<ORDER>(mats + 16 * br.b, br, e);
  if (threadIdx.x == 0) {
    const int i = static_cast<int>(k % stages);
    // read after the barrier's wait: its arrive orders this write
    origin[i] = lo;
    // the threads' reads of this buffer (item k - stages) come before the
    // async proxy's write into it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    stage_box(buffers + i * stride, map, &full[i], box_bytes, lo.z, lo.y,
              lo.x);
  }
}

// A row's taps from the staged box.
template <int TAPS>
struct BoxRow {
  __device__ __forceinline__ void operator()(const float* p,
                                             float v[TAPS]) const {
#pragma unroll
    for (int k = 0; k < TAPS; ++k) v[k] = p[k];
  }
};

// Every voxel of brick `br` that this thread owns (column (v0 + ty, w0 +
// tx), every kTz-th voxel along z from u0 + tz), with its taps read from
// the box at `lo`.  Cubic: a warp (32 threads along x, one column of y and
// z) whose in-range voxels all have every tap inside the volume and inside
// the box takes the interior fast path (resample::interior_sum, rows of
// the box at consecutive addresses, no mirror, clip or box test per tap),
// decided by a warp vote; any other warp, and trilinear (whose fast path
// was slower on the card, tools/slab_variants.py), the edge path.  Cubic
// lanes past a ragged brick's x end are masked, not returned, so every
// lane votes.
template <int ORDER, bool CONSTANT>
__device__ __forceinline__ void brick_from_box(
    const Brick& br, const Origin& lo, const float* box,
    const float* __restrict__ mats, const resample::GlobalSource& global,
    const int n[3], const int e[3], float* __restrict__ out, int o0, int o1,
    int o2, float cval, int* overflows) {
  constexpr int kTaps = resample::TapCount<ORDER>::kTaps;
  constexpr unsigned kWarpMask = 0xffffffffu;
  const int v = br.v0 + threadIdx.y;
  const int w = br.w0 + threadIdx.x;
  // warp-uniform: a warp is one (y, z) column of the CTA
  if (v > br.v1) return;
  // trilinear takes no warp vote: a lane past the brick's x end leaves
  if constexpr (ORDER == 1) {
    if (w > br.w1) return;
  }
  const bool here = w <= br.w1;
  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = __ldg(mats + 16 * br.b + i);
  const SharedSource shared{box, lo.z, lo.y, lo.x, e[1], e[2]};
  const int l[3] = {lo.z, lo.y, lo.x};
  for (int u = br.u0 + static_cast<int>(threadIdx.z); u <= br.u1;
       u += Tile<ORDER>::kTz) {
    float s[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a] = resample::source_coord(m[4 * a], m[4 * a + 1], m[4 * a + 2],
                                    m[4 * a + 3], static_cast<float>(u),
                                    static_cast<float>(v),
                                    static_cast<float>(w));
    }
    float* dst = out + ((br.b * o0 + u) * o1 + v) *
                           static_cast<long long>(o2) + w;
    const bool inside =
        here && resample::inside<CONSTANT>(s, n[0], n[1], n[2]);
    if constexpr (ORDER == 3) {
      resample::Weights<ORDER> wt;
      bool interior = false;
      if (inside) {
        resample::make_weights<ORDER>(s, &wt);
        interior = resample::interior<ORDER>(wt, n);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          interior &=
              wt.base[a] >= l[a] && wt.base[a] + kTaps - l[a] <= e[a];
        }
      }
      if (__all_sync(kWarpMask, interior || !inside)) {
        if (inside) {
          const float* origin =
              box + ((wt.base[0] - l[0]) * e[1] + (wt.base[1] - l[1])) *
                        e[2] +
              (wt.base[2] - l[2]);
          *dst = resample::interior_sum<ORDER, int>(
              wt, origin, e[1] * e[2], e[2], BoxRow<kTaps>{});
        } else if (here) {
          *dst = cval;
        }
        continue;
      }
    }
    if (!inside) {
      if (here) *dst = cval;
      continue;
    }
    resample::Taps<ORDER> taps;
    resample::make_taps<ORDER, CONSTANT>(s, n, &taps);
    // every tap that will be read lies in the box ('border' never reads
    // an out-of-range tap): so for the whole brick, else test the taps
    bool in_box = true;
    if (!lo.whole) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int i = taps.idx[a][k] - l[a];
          in_box &= (!CONSTANT && !taps.ok[a][k]) || (i >= 0 && i < e[a]);
        }
      }
    }
    if (in_box) {
      *dst = resample::tap_sum<ORDER, CONSTANT>(taps, shared);
    } else {
      *dst = resample::tap_sum<ORDER, CONSTANT>(taps, global);
      atomicAdd(overflows, 1);
    }
  }
}

template <int ORDER, bool CONSTANT>
__global__ void __launch_bounds__(Tile<ORDER>::kThreads)
affine_slab_kernel(const __grid_constant__ CUtensorMap map,
                   const float* __restrict__ vol, int d0, int d1, int d2,
                   int pitch, const float* __restrict__ mats,
                   float* __restrict__ out, int o0, int o1, int o2,
                   int bricks_y, int bricks_x, long long bricks,
                   long long items, int e0, int e1, int e2, int stages,
                   float cval, int* overflows) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ Origin origin[kMaxStages];

  // the ring: `stages` buffers of one box each, 128-byte aligned
  const uint32_t skew = (kAlign - shared_address(smem) % kAlign) % kAlign;
  float* const buffers = reinterpret_cast<float*>(smem + skew);
  const int box_floats = e0 * e1 * e2;
  constexpr int kAlignFloats = kAlign / 4;
  const int stride =
      (box_floats + kAlignFloats - 1) / kAlignFloats * kAlignFloats;
  const uint32_t box_bytes = 4u * static_cast<uint32_t>(box_floats);

  if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) {
    for (int i = 0; i < stages; ++i) barrier_init(&full[i]);
    // the barriers' initialisation is seen by the async proxy (TMA) too
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int n[3] = {d0, d1, d2};
  const int e[3] = {e0, e1, e2};
  const bool producer = threadIdx.y == 0 && threadIdx.z == 0;  // warp 0
  if (producer) {
    for (int k = 0; k < stages - 1; ++k) {
      load_item<ORDER>(k, &map, mats, bricks, bricks_y, bricks_x, items, o0,
                       o1, o2, e, stages, buffers, stride, box_bytes, full,
                       origin);
    }
  }
  const resample::GlobalSource global{vol, d1, pitch};
  for (long long k = 0;; ++k) {
    const long long item = blockIdx.x + k * gridDim.x;
    if (item >= items) break;
    // no thread still reads the buffer of item k - 1: load item
    // k + stages - 1 into it, then compute item k
    __syncthreads();
    if (producer) {
      load_item<ORDER>(k + stages - 1, &map, mats, bricks, bricks_y,
                       bricks_x, items, o0, o1, o2, e, stages, buffers,
                       stride, box_bytes, full, origin);
    }
    const int i = static_cast<int>(k % stages);
    barrier_wait(&full[i], static_cast<uint32_t>((k / stages) & 1));
    const Origin lo = origin[i];
    const Brick br =
        brick_of<ORDER>(item, bricks, bricks_y, bricks_x, o0, o1, o2);
    brick_from_box<ORDER, CONSTANT>(br, lo, buffers + i * stride, mats,
                                    global, n, e, out, o0, o1, o2, cval,
                                    overflows);
  }
}

using Kernel = void (*)(CUtensorMap, const float*, int, int, int, int,
                        const float*, float*, int, int, int, int, int,
                        long long, long long, int, int, int, int, float, int*);

// A kernel and its tile: brick (bz, by, bx) and threads (bx, by, tz).
struct Launch {
  Kernel kernel;
  int bz, by, bx, tz;
  int threads() const { return bx * by * tz; }
};

template <int ORDER, bool CONSTANT>
Launch launch_of() {
  using T = Tile<ORDER>;
  return Launch{affine_slab_kernel<ORDER, CONSTANT>, T::kBz, T::kBy, T::kBx,
                T::kTz};
}

Launch kernel_for(int order, int border) {
  if (order == 1 && !border) return launch_of<1, true>();
  if (order == 1) return launch_of<1, false>();
  if (!border) return launch_of<3, true>();
  return launch_of<3, false>();
}

// Dynamic shared memory of a launch: `stages` boxes, each rounded up to
// 128 bytes, and 128 bytes to align the first.
long long shared_bytes(int e0, int e1, int e2, int stages) {
  const long long box = 4LL * e0 * e1 * e2;
  return stages * ((box + kAlign - 1) / kAlign * kAlign) + kAlign;
}

bool box_ok(int e0, int e1, int e2, int stages) {
  return e0 >= 1 && e1 >= 1 && e2 >= 1 && e0 <= kMaxBox && e1 <= kMaxBox &&
         e2 <= kMaxBox && e2 % kRowAlign == 0 && stages >= 1 &&
         stages <= kMaxStages &&
         shared_bytes(e0, e1, e2, stages) <= kMaxDynamicBytes;
}

// Allow `smem` bytes of dynamic shared memory per block (above 48 KB only
// after asking), and ask for the SM's largest shared-memory carveout, so
// that as many CTAs share an SM as the occupancy query reports, whatever
// carveout the CUDA runtime would pick by itself.
cudaError_t prepare(Kernel kernel, long long smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled is a driver call: its entry point comes from the
// driver through the runtime, so the library does not link libcuda.
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(fn)
               : nullptr;
  }();
  return encode;
}

// The tensor map of a pitched (d0, d1, d2) float32 volume for boxes of
// (e0, e1, e2) voxels: x extent d2 (the padding is out of range), rows
// 4 * pitch bytes apart, voxels outside the volume filled with zeros.
int encode_map(CUtensorMap* map, const float* vol, int d0, int d1, int d2,
               int pitch, int e0, int e1, int e2) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d2),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d0)};
  const cuuint64_t strides[2] = {4ULL * pitch, 4ULL * pitch * d1};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(e2),
                             static_cast<cuuint32_t>(e1),
                             static_cast<cuuint32_t>(e0)};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(vol), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapRefused;
}

}  // namespace

// C entry, bound with ctypes.  vol: (d0, d1, d2) float32, rows of x
// contiguous and `pitch` floats apart (a multiple of 4, >= d2), planes
// d1 * pitch apart, 16-byte aligned.  mats: (n, 4, 4) float32, contiguous,
// on the same device.  out: (n, o0, o1, o2) float32, contiguous.  (e0, e1,
// e2): the box extents, each at most 256, e2 a multiple of 4.  stages: box
// buffers per CTA, 1 to 4 (1: no load overlaps the compute).  order: 1 or
// 3.  border: 0 for 'constant', 1 for 'border'.  overflows: one int32 on
// the device, incremented for each voxel with a tap outside its box.
// Launches a persistent grid on `stream`, on the calling thread's current
// device (the caller makes it the tensors' device), without synchronising,
// and returns the first error (0 on success).
extern "C" int affine_slab_launch(const float* vol, int d0, int d1, int d2,
                                  int pitch, const float* mats, long long n,
                                  float* out, int o0, int o1, int o2, int e0,
                                  int e1, int e2, int stages, int order,
                                  int border, float cval, int* overflows,
                                  void* stream) {
  if ((order != 1 && order != 3) || d0 < 1 || d1 < 1 || d2 < 1 ||
      pitch < d2 || pitch % 4 != 0 ||
      reinterpret_cast<uintptr_t>(vol) % 16 != 0 || n < 1 || o0 < 1 ||
      o1 < 1 || o2 < 1 || !box_ok(e0, e1, e2, stages) ||
      overflows == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch k = kernel_for(order, border);
  const int bricks_z = (o0 + k.bz - 1) / k.bz;
  const int bricks_y = (o1 + k.by - 1) / k.by;
  const int bricks_x = (o2 + k.bx - 1) / k.bx;
  const long long bricks =
      static_cast<long long>(bricks_z) * bricks_y * bricks_x;
  if (bricks > INT_MAX || n > LLONG_MAX / bricks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = n * bricks;
  const long long smem = shared_bytes(e0, e1, e2, stages);

  cudaError_t err = prepare(k.kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k.kernel, k.threads(), static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long full_grid = static_cast<long long>(sms) * per_sm;
  const unsigned grid =
      static_cast<unsigned>(items < full_grid ? items : full_grid);

  CUtensorMap map;
  const int code = encode_map(&map, vol, d0, d1, d2, pitch, e0, e1, e2);
  if (code != 0) return code;
  k.kernel<<<grid, dim3(k.bx, k.by, k.tz), static_cast<size_t>(smem),
             static_cast<cudaStream_t>(stream)>>>(
      map, vol, d0, d1, d2, pitch, mats, out, o0, o1, o2, bricks_y, bricks_x,
      bricks, items, e0, e1, e2, stages, cval, overflows);
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of the kernel with `stages` boxes of (e0, e1, e2) fit one
// SM at a time, into *blocks; returns the first error (0 on success).
extern "C" int affine_slab_blocks_per_sm(int e0, int e1, int e2, int stages,
                                         int order, int border,
                                         int* blocks) {
  if ((order != 1 && order != 3) || !box_ok(e0, e1, e2, stages) ||
      blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = shared_bytes(e0, e1, e2, stages);
  const Launch k = kernel_for(order, border);
  const cudaError_t err = prepare(k.kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k.kernel, k.threads(), static_cast<size_t>(smem)));
}

extern "C" const char* affine_slab_error_string(int code) {
  if (code == kNoEncoder) {
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  }
  if (code == kMapRefused) {
    return "cuTensorMapEncodeTiled refused the volume's tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
