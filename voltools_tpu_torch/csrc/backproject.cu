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
// a row of 1e10 must not wrap).  No atomics and no split over tilts: the
// order of the sum is fixed.
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
// ms.  It is bound by operations.  Bit parity forbids contraction, so a
// voxel-tilt costs at least 4 separate FP32 instructions (0.076 ms at
// 33.5 T instructions a second).
//
// Row-gather design.  A CTA owns a tile of lines: `warps` lines along dep0
// (one a warp) by LINES along dep1 (one thread's, its sums in registers),
// times kTileCols columns along ax_c.  A warp's lanes lie along the
// columns, two neighbouring columns a lane (float2) and kPairs pairs 64
// apart, so a line's rows coordinate, floor and weights are uniform in the
// warp.  In a single-axis series rows is affine in (dep0, dep1), so a tile
// of 4 x 8 lines reads about 10 projection rows a tilt.  For each tilt the
// CTA:
//   * evaluates the rows expression, rounded as above, at the tile's four
//     corners.  Each rounded step is monotone in i0 and in i1, so the
//     corners' floors bound every line's; the window's first row is the
//     lowest floor, clipped to [0, h) in float before any int conversion
//     (rows of +-1e10 stage nothing and never wrap);
//   * stages `cap` rows from there, its columns of them, with one TMA copy
//     (cp.async.bulk.tensor) into a ring of kStages windows, each with its
//     mbarrier: the next tilt's rows land while this tilt is summed, and no
//     thread spends an instruction on the copy.  TMA needs rows 16 bytes
//     apart, so the wrapper hands 250-float rows (1000 bytes) over as a
//     pitched copy (10 MB at 250^3); rows past the projection and columns
//     past its width arrive as zeros;
//   * writes a table of its lines: (1 - fr, fr, and each tap's offset in
//     shared memory: its staged row, a row of zeros where the tap is off
//     the projection, or -(row + 2) where it lies outside the window).
// A tilt whose table holds no such miss (every tilt whose window the host
// sized) is summed with no branch a line and no select: each line reads
// its two rows' float2 pairs from shared memory, the zero row standing in
// for the plain version's select.  A tilt with a miss (a window capped by
// the host) reads those taps from global memory and counts them in
// `misses`, so the result stays right.  The barrier that publishes a
// window also ORs the threads' miss flags (__syncthreads_or).  The host
// sizes the tile (kernels/backproject.py::rowgather_tile): the first tile
// whose window, bounded from the rows span over the launch's tilts, fits
// TMA's box and the dynamic shared memory.  Keeping the last line's rows
// in registers (where r0 steps by one, the next line's g0 is the last
// line's g1) costs more in branches than the reads it saves on an H100
// (tools/backproject_variants.py, `reuse`), so every line reads both.
//
// The general path is the simple design: each thread keeps kVoxels output
// voxels' sums in registers along x, the output's contiguous axis
// (coalesced stores), and gathers its 4 taps a voxel through __ldg.
// Output offsets are 64-bit; a projection's offsets 32-bit (the launcher
// refuses a projection of 2^31 floats or more).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxExtent = 1 << 24;       // float holds every index exactly

// row-gather path.  Its layout is the wrapper's LAYOUT table
// (kernels/backproject.py), which the build passes as -D flags: the host
// sizes tiles and shared memory from the same numbers.
#if !defined(BP_PAIRS) || !defined(BP_WARPS) || !defined(BP_LINES) || \
    !defined(BP_STAGES) || !defined(BP_MAX_CAP) || !defined(BP_ALIGN)
#error "build with the -D flags of kernels/backproject.py's LAYOUT"
#endif
constexpr int kPairs = BP_PAIRS;          // float2 column pairs a thread
constexpr int kTileCols = kLanes * 2 * kPairs;   // a tile's columns
constexpr int kMaxTileWarps = BP_WARPS;   // warps a CTA: its dep0 lines
constexpr int kLines = BP_LINES;          // dep1 lines a thread, large tiles
constexpr int kStages = BP_STAGES;        // the ring of staged windows
constexpr int kMaxCap = BP_MAX_CAP;       // rows a TMA box may hold
constexpr int kAlign = BP_ALIGN;          // TMA's shared-memory alignment
constexpr int kMinBlocks = 2;             // CTAs an SM, for the registers
static_assert(kStages >= 2, "a ring of at least two windows");
constexpr int kNoEncoder = -1;     // the driver has no cuTensorMapEncodeTiled
constexpr int kMapRefused = -2;    // cuTensorMapEncodeTiled refused the map

// general path
constexpr int kWarps = 8;    // a CTA's warps, along y
constexpr int kVoxels = 4;   // voxels a thread, kLanes apart along x
constexpr int kSpan = kLanes * kVoxels;   // voxels a warp covers a line

struct RowGather {
  const float* projs;
  int n, h, w;                 // w == the output's extent along ax_c
  int pitch;                   // floats from a projection row to the next
  const float4* coef;
  float* out;
  int n0, n1;                  // lines along dep0 and dep1
  long long s0, s1, sc;        // output strides of dep0, dep1, ax_c
  int cap;                     // rows a window holds
  int* misses;                 // taps read outside the window
};

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

// Stage one window: arm the barrier with the box's bytes (those TMA fills
// with zeros count too), then one TMA copy of the box whose first element
// is (column x, row y, tilt z), which completes the barrier when it lands.
// With no row to stage, arrive on the barrier alone.
__device__ __forceinline__ void stage_window(float* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, uint32_t bytes,
                                             int x, int y, int z) {
  const uint32_t b = shared_address(bar);
  // the threads' reads of this window (tilt t - kStages) come before the
  // async proxy's write into it
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (bytes == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b)
                 : "memory");
    return;
  }
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

// The rows coordinate of line (f0, f1), rounded as the plain version does.
__device__ __forceinline__ float rows_at(float4 r, float f0, float f1) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r.x, f0), __fmul_rn(r.y, f1)), r.z);
}

// A thread's kPairs column pairs of one staged row.
__device__ __forceinline__ void read_row(float2 (&g)[kPairs],
                                         const float* row) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    g[p] = *reinterpret_cast<const float2*>(row + 2 * kLanes * p);
  }
}

// A tap of a column pair on the path of a tilt with window misses: the
// staged row (or the zero row) where the line table gives an offset, else
// the projection's row -off - 2 from global memory, counted.
__device__ __forceinline__ float2 tap_or_miss(int off, const float* s,
                                              const float* g, int pitch,
                                              int w, int c, int& missed) {
  if (off >= 0) return *reinterpret_cast<const float2*>(s + off);
  const float* row = g + static_cast<long long>(-off - 2) * pitch;
  float2 v = make_float2(0.0f, 0.0f);
  if (c < w) {
    v.x = __ldg(row);
    ++missed;
  }
  if (c + 1 < w) {
    v.y = __ldg(row + 1);
    ++missed;
  }
  return v;
}

// acc = acc + ((g0 * w0) + (g1 * fr)), each operation rounded on its own
__device__ __forceinline__ void accumulate(float2 (&acc)[kPairs],
                                           const float2 (&g0)[kPairs],
                                           const float2 (&g1)[kPairs],
                                           float w0, float fr) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    acc[p].x = __fadd_rn(acc[p].x, __fadd_rn(__fmul_rn(g0[p].x, w0),
                                             __fmul_rn(g1[p].x, fr)));
    acc[p].y = __fadd_rn(acc[p].y, __fadd_rn(__fmul_rn(g0[p].y, w0),
                                             __fmul_rn(g1[p].y, fr)));
  }
}

template <int LINES>
__global__ void __launch_bounds__(kLanes * kMaxTileWarps, kMinBlocks)
    rowgather_kernel(const __grid_constant__ CUtensorMap map,
                     const RowGather a) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t full[kStages];
  const int warps = blockDim.y;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int entries = warps * LINES;
  // after up to kAlign bytes that align the windows for TMA: kStages
  // windows of cap rows, then the zero row (every tap off the projection
  // reads it), then kStages line tables (a float4 a line), the dynamic
  // shared memory the wrapper's smem_bytes gives
  const uint32_t skew = (kAlign - shared_address(smem) % kAlign) % kAlign;
  float* const staged = reinterpret_cast<float*>(smem + skew);
  const int window_floats = a.cap * kTileCols;
  const int zero_row = kStages * window_floats;
  float4* const table = reinterpret_cast<float4*>(staged + zero_row +
                                                  kTileCols);
  const uint32_t box_bytes = 4u * static_cast<uint32_t>(window_floats);

  const int c0 = blockIdx.x * kTileCols;
  const int i1s = blockIdx.y * LINES;
  const int i0s = blockIdx.z * warps;
  // the tile's corner lines, clipped to the volume
  const float f0a = static_cast<float>(i0s);
  const float f0b = static_cast<float>(min(i0s + warps, a.n0) - 1);
  const float f1a = static_cast<float>(i1s);
  const float f1b = static_cast<float>(min(i1s + LINES, a.n1) - 1);
  const float hf = static_cast<float>(a.h);
  const float hm1 = static_cast<float>(a.h - 1);
  const long long plane = static_cast<long long>(a.h) * a.pitch;

  for (int i = tid; i < kTileCols; i += kLanes * warps) {
    staged[zero_row + i] = 0.0f;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) barrier_init(&full[i]);
    // the barriers' initialisation is seen by the async proxy (TMA) too
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // Stage tilt t into ring slot `slot`: the threads of the tile's lines
  // write its line table, thread 0 also starts the window's TMA copy.
  // Returns whether this thread's line has a tap outside the window.
  auto stage = [&](int t, int slot) {
    if (tid >= entries) return false;
    const float4 r = __ldg(a.coef + t);
    const float q00 = floorf(rows_at(r, f0a, f1a));
    const float q01 = floorf(rows_at(r, f0a, f1b));
    const float q10 = floorf(rows_at(r, f0b, f1a));
    const float q11 = floorf(rows_at(r, f0b, f1b));
    const float lo_f = fmaxf(fminf(fminf(q00, q01), fminf(q10, q11)), 0.0f);
    const float hi_f =
        fminf(__fadd_rn(fmaxf(fmaxf(q00, q01), fmaxf(q10, q11)), 1.0f), hm1);
    const bool any = lo_f <= hi_f;   // a row of the tile's taps is valid
    const int lo = any ? static_cast<int>(lo_f) : 0;   // in [0, h) only now
    const int first = slot * window_floats;
    bool miss = false;
    const int j0 = i0s + tid / LINES, j1 = i1s + tid % LINES;
    float4 e = make_float4(0.0f, 0.0f, __int_as_float(zero_row),
                           __int_as_float(zero_row));
    if (j0 < a.n0 && j1 < a.n1) {
      const float rows =
          rows_at(r, static_cast<float>(j0), static_cast<float>(j1));
      const float r0f = floorf(rows);
      const float fr = __fsub_rn(rows, r0f);
      const bool v0 = r0f >= 0.0f && r0f < hf;
      const bool v1 = r0f >= -1.0f && r0f < hm1;
      // r0f in [-1, h) where either tap is valid: convert only then
      const int r0 = (v0 || v1) ? static_cast<int>(r0f) : 0;
      // a tap's offset: the zero row where it is off the projection, its
      // staged row, or -(row + 2) where it lies outside the window
      auto offset = [&](bool valid, int row) {
        if (!valid) return zero_row;
        if (row >= lo && row - lo < a.cap) {
          return first + (row - lo) * kTileCols;
        }
        miss = true;
        return -(row + 2);
      };
      e = make_float4(__fsub_rn(1.0f, fr), fr, __int_as_float(offset(v0, r0)),
                      __int_as_float(offset(v1, r0 + 1)));
    }
    table[slot * entries + tid] = e;
    if (tid == 0) {
      stage_window(staged + first, &map, &full[slot], any ? box_bytes : 0u,
                   c0, lo, t);
    }
    return miss;
  };

  const int lane = threadIdx.x;
  float2 acc[LINES][kPairs];
#pragma unroll
  for (int k = 0; k < LINES; ++k) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) acc[k][p] = make_float2(0.0f, 0.0f);
  }
  int missed = 0;
  unsigned missing = 0;   // bit s: this thread's line misses in slot s
  auto stage_ahead = [&](int t, int slot) {
    if (t < a.n) {
      missing &= ~(1u << slot);
      if (stage(t, slot)) missing |= 1u << slot;
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage_ahead(t, t);
  for (int t = 0; t < a.n; ++t) {
    const int slot = t % kStages;
    barrier_wait(&full[slot], static_cast<uint32_t>((t / kStages) & 1));
    // the barrier publishes the slot's line table and tells every thread
    // whether any line misses; past it every warp is done with the slot
    // of tilt t - 1, which the next stage takes
    const bool slow = __syncthreads_or((missing >> slot) & 1u);
    stage_ahead(t + kStages - 1, (t + kStages - 1) % kStages);
    const float4* lines = table + slot * entries + threadIdx.y * LINES;
    const float* s = staged + 2 * lane;
    float2 g0[kPairs], g1[kPairs];
    if (!slow) {
      // every tap lies in the window or on the zero row: no branch
#pragma unroll
      for (int k = 0; k < LINES; ++k) {
        const float4 e = lines[k];
        const int off0 = __float_as_int(e.z), off1 = __float_as_int(e.w);
        read_row(g0, s + off0);
        read_row(g1, s + off1);
        accumulate(acc[k], g0, g1, e.x, e.y);
      }
    } else {
      const float* g = a.projs + t * plane + c0 + 2 * lane;
#pragma unroll
      for (int k = 0; k < LINES; ++k) {
        const float4 e = lines[k];
        const int off0 = __float_as_int(e.z), off1 = __float_as_int(e.w);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const int o = 2 * kLanes * p;
          const int c = c0 + 2 * lane + o;
          g0[p] = tap_or_miss(off0, s + o, g + o, a.pitch, a.w, c, missed);
          g1[p] = tap_or_miss(off1, s + o, g + o, a.pitch, a.w, c, missed);
        }
        accumulate(acc[k], g0, g1, e.x, e.y);
      }
    }
  }
  const int i0 = i0s + static_cast<int>(threadIdx.y);
  if (i0 < a.n0) {
#pragma unroll
    for (int k = 0; k < LINES; ++k) {
      if (i1s + k < a.n1) {
        const long long base = i0 * a.s0 + (i1s + k) * a.s1;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const int c = c0 + 2 * lane + 2 * kLanes * p;
          if (c < a.w) a.out[base + c * a.sc] = acc[k][p].x;
          if (c + 1 < a.w) a.out[base + (c + 1) * a.sc] = acc[k][p].y;
        }
      }
    }
  }
  if (missed) atomicAdd(a.misses, missed);
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

// The tensor map of the (n, h, w) projections, rows `pitch` floats apart,
// for windows of (kTileCols columns, cap rows, 1 tilt); elements outside
// the projections (columns past w, rows past h) fill with zeros.
int encode_map(CUtensorMap* map, const float* projs, int n, int h, int w,
               int pitch, int cap) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {4ULL * pitch, 4ULL * pitch * h};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kTileCols),
                             static_cast<cuuint32_t>(cap), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(projs),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapRefused;
}

template <int LINES>
int launch_rowgather(const RowGather& a, int warps, int smem,
                     cudaStream_t stream) {
  const dim3 grid((a.w + kTileCols - 1) / kTileCols,
                  (a.n1 + LINES - 1) / LINES, (a.n0 + warps - 1) / warps);
  if (grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const int code = encode_map(&map, a.projs, a.n, a.h, a.w, a.pitch, a.cap);
  if (code != 0) return code;
  const auto kernel = rowgather_kernel<LINES>;
  if (smem > 48 * 1024) {   // above 48 KB only by this attribute
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, dim3(kLanes, warps), smem, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes.  projs: (n, h, w) float32, rows `pitch`
// floats apart, tilts h * pitch apart.  coef: float32, contiguous, 16-byte
// aligned, on the same device: n rows of 4 (row-gather: r_dep0, r_dep1,
// r3, 0) or of 8 (general: row keep0 of M^-1, then row keep1).  out: (d0,
// d1, d2) float32, contiguous; every voxel is written.  rowgather: 1 for
// the row-gather path, whose column axis is ax_c (1 or 2; the projection's
// width w must equal the output's extent along it), 0 for the general
// path (pitch == w; the arguments after d2 up to the stream unread).
// Row-gather only: projs 16-byte aligned and pitch a multiple of 4 (TMA's
// strides); the tile is `warps` (1, 2, 4 or kMaxTileWarps) lines along
// dep0 by `lines` (1 or kLines) along dep1, with windows of `cap` rows (1
// to kMaxCap), in `smem` bytes of dynamic shared memory (the wrapper's
// smem_bytes of the tile); `misses` an int32 on the device that counts the
// taps read outside the window.  Launches on `stream`, on the calling
// thread's current device (the caller makes it the tensors' device),
// without synchronising, and
// returns the first error (0 on success; cudaErrorInvalidValue for
// arguments out of range; the error of a refused shared-memory size;
// kNoEncoder or kMapRefused for the tensor map).
extern "C" int backproject_launch(const float* projs, int n, int h, int w,
                                  int pitch, const float* coef,
                                  int rowgather, int ax_c, float* out,
                                  int d0, int d1, int d2, int warps,
                                  int lines, int cap, int smem,
                                  int* misses, void* stream) {
  if (n < 0 || h < 1 || w < 1 || d0 < 1 || d1 < 1 || d2 < 1 ||
      pitch < w || h >= kMaxExtent || w >= kMaxExtent || d0 >= kMaxExtent ||
      d1 >= kMaxExtent || d2 >= kMaxExtent ||
      static_cast<long long>(h) * pitch > INT_MAX ||
      reinterpret_cast<uintptr_t>(coef) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims[3] = {d0, d1, d2};
  const long long strides[3] = {static_cast<long long>(d1) * d2, d2, 1};
  const auto cstream = static_cast<cudaStream_t>(stream);
  if (rowgather) {
    const bool tile_ok = (warps == 1 || warps == 2 || warps == 4 ||
                          warps == kMaxTileWarps) &&
                         (lines == 1 || lines == kLines) && cap >= 1 &&
                         cap <= kMaxCap && smem > 0;
    if ((ax_c != 1 && ax_c != 2) || !tile_ok || pitch % 4 != 0 ||
        reinterpret_cast<uintptr_t>(projs) % 16 != 0 || misses == nullptr ||
        dims[ax_c] != w) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int dep0 = 0, dep1 = ax_c == 2 ? 1 : 2;
    const RowGather a{projs, n, h, w, pitch,
                      reinterpret_cast<const float4*>(coef), out,
                      dims[dep0], dims[dep1], strides[dep0], strides[dep1],
                      strides[ax_c], cap, misses};
    return lines == kLines
               ? launch_rowgather<kLines>(a, warps, smem, cstream)
               : launch_rowgather<1>(a, warps, smem, cstream);
  }
  const dim3 grid((d2 + kSpan - 1) / kSpan, (d1 + kWarps - 1) / kWarps, d0);
  if (pitch != w || grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  general_kernel<<<grid, dim3(kLanes, kWarps), 0, cstream>>>(
      projs, n, h, w, reinterpret_cast<const float4*>(coef), out, d0, d1,
      d2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* backproject_error_string(int code) {
  if (code == kNoEncoder) {
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  }
  if (code == kMapRefused) {
    return "cuTensorMapEncodeTiled refused the projections' tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
