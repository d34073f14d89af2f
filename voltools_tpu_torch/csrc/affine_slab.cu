// Affine resampling of a 3-D float32 volume through N 4x4 pull-back matrices,
// with the taps of each output brick read from a source box staged in
// shared memory.
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
// What it computes of the TPU kernel, not how: the TPU kernel DMAs a slab
// of w0 x w1 full-x rows per (8 x 128) output tile into VMEM, resolves x by
// lane gathers with slop taps and rows by a select-tree.  None of that
// carries over (no x padding to 128 lanes, no axis permutation, no
// select-tree, no slop taps, no DMA pipeline): a CTA gathers from a 3-D box
// in any orientation.
//
// Each CTA computes one (4, 8, 32) output brick of one matrix (grid.x runs
// over the bricks, grid.y over the matrices; output offsets are 64-bit):
//  1. it works out its source box from the source coordinates of the
//     brick's 8 corners: per axis, floor(min) + first tap - 1 to floor(max)
//     + last tap + 1, clipped to the volume.  The one voxel of slack on
//     each side covers a voxel inside the brick whose coordinate floors one
//     lower or higher than the corners (a rounding at a knife edge), and
//     the 'constant' cubic mirror tap of a point at exactly n-1 (n-3, one
//     below floor - 1);
//  2. it copies the box from global memory into dynamic shared memory, a
//     warp per row of x, coalesced, with cp.async: every thread starts all
//     its copies back to back and waits once, so a warp has many copies in
//     flight (a plain load waits for each before its store to shared
//     memory, one in flight per warp), then __syncthreads();
//  3. its 256 threads (32 along x, 8 along y) each evaluate 4 voxels along
//     z, with every tap read from shared memory.
// The launch allocates the box extents the planner computed for the
// envelope of its matrices (kernels/planner.py).  A CTA whose box would
// exceed them clips the box and counts one overflow; a voxel with a tap
// outside its CTA's box reads all its taps from global memory and counts
// one overflow.  So no tap is ever read from outside the box, the result
// is right even then, and the overflow counter says it happened.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32, an FMA counted
// as 2 flops): the same function as affine_resample.cu, so the same bound:
// the source read once per launch and every output voxel written once, or
// the function's least arithmetic (52 flops linear, 231 cubic, per output
// voxel inside the source), whichever is larger.  What this design does
// about it: it reads each source voxel from shared memory for every tap of
// every voxel of the brick that needs it, instead of through L1/L2 per tap
// as affine_resample.cu does.  What it leaves for later: the boxes of
// neighbouring CTAs overlap, so the source is read several times over from
// L2 (about box / brick = 10x for a 250^3 tilt); the box load is not
// overlapped with the CTA's compute (TMA and a pipeline would).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "resample_taps.cuh"

namespace {

constexpr int kBz = 4;   // output brick along z, walked by each thread
constexpr int kBy = 8;   // threadIdx.y
constexpr int kBx = 32;  // threadIdx.x: a warp stores one row of x
constexpr int kThreads = kBx * kBy;
constexpr long long kMaxSharedBytes = 232448;  // 227 KB per block

// Taps read from the staged box: source voxels from (lz, ly, lx) on, with
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

template <int ORDER, bool CONSTANT>
__global__ void __launch_bounds__(kThreads)
affine_slab_kernel(const float* __restrict__ vol, int d0, int d1, int d2,
                   const float* __restrict__ mats, float* __restrict__ out,
                   int o0, int o1, int o2, int bricks_y, int bricks_x,
                   int e0, int e1, int e2, float cval, int* overflows) {
  extern __shared__ float box[];
  constexpr int kTaps = resample::TapCount<ORDER>::kTaps;
  constexpr int kFirst = resample::TapCount<ORDER>::kFirst;

  const int bx = blockIdx.x % bricks_x;
  const int rest = blockIdx.x / bricks_x;
  const int by = rest % bricks_y;
  const int bz = rest / bricks_y;
  const int u0 = bz * kBz, v0 = by * kBy, w0 = bx * kBx;
  // last output voxel of the brick along each axis (ragged at the edges)
  const int u1 = min(u0 + kBz, o0) - 1;
  const int v1 = min(v0 + kBy, o1) - 1;
  const int w1 = min(w0 + kBx, o2) - 1;
  const int b = blockIdx.y;

  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = __ldg(mats + 16 * b + i);

  // 1. the source box of this brick
  const int n[3] = {d0, d1, d2};
  const int e[3] = {e0, e1, e2};
  int lo[3], cnt[3];
  bool clipped = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float smin = INFINITY, smax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float s = resample::source_coord(
          m[4 * a], m[4 * a + 1], m[4 * a + 2], m[4 * a + 3],
          static_cast<float>(c & 4 ? u1 : u0),
          static_cast<float>(c & 2 ? v1 : v0),
          static_cast<float>(c & 1 ? w1 : w0));
      smin = fminf(smin, s);
      smax = fmaxf(smax, s);
    }
    // clamped first, so that the conversion to int cannot overflow
    constexpr float kFar = 1.0e9f;
    const int flo = static_cast<int>(floorf(fminf(fmaxf(smin, -kFar), kFar)));
    const int fhi = static_cast<int>(floorf(fminf(fmaxf(smax, -kFar), kFar)));
    const int l = max(flo + kFirst - 1, 0);
    const int h = min(fhi + kFirst + kTaps, n[a] - 1);
    int count = max(h - l + 1, 0);
    if (count > e[a]) {
      count = e[a];
      clipped = true;
    }
    lo[a] = l;
    cnt[a] = count;
  }
  if (clipped && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(overflows, 1);
  }

  // 2. stage it in shared memory, a warp per row
  const int rows = cnt[0] * cnt[1];
  for (int r = threadIdx.y; r < rows; r += kBy) {
    const int zz = r / cnt[1];
    const int yy = r - zz * cnt[1];
    const float* src =
        vol + (static_cast<long long>(lo[0] + zz) * d1 + (lo[1] + yy)) * d2 +
        lo[2];
    float* dst = box + r * cnt[2];
    for (int xx = threadIdx.x; xx < cnt[2]; xx += kBx) {
      __pipeline_memcpy_async(dst + xx, src + xx, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 3. every voxel of the brick, from the box
  const int v = v0 + threadIdx.y;
  const int w = w0 + threadIdx.x;
  if (v > v1 || w > w1) return;
  const SharedSource shared{box, lo[0], lo[1], lo[2], cnt[1], cnt[2]};
  const resample::GlobalSource global{vol, d1, d2};
  for (int u = u0; u <= u1; ++u) {
    float s[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a] = resample::source_coord(m[4 * a], m[4 * a + 1], m[4 * a + 2],
                                    m[4 * a + 3], static_cast<float>(u),
                                    static_cast<float>(v),
                                    static_cast<float>(w));
    }
    float* dst = out + ((static_cast<long long>(b) * o0 + u) * o1 + v) *
                           static_cast<long long>(o2) + w;
    if (!resample::inside<CONSTANT>(s, d0, d1, d2)) {
      *dst = cval;
      continue;
    }
    resample::Taps<ORDER> taps;
    resample::make_taps<ORDER, CONSTANT>(s, n, &taps);
    // every tap that will be read lies in the box ('border' never reads
    // an out-of-range tap)
    bool in_box = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int i = taps.idx[a][k] - lo[a];
        in_box &= (!CONSTANT && !taps.ok[a][k]) || (i >= 0 && i < cnt[a]);
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

using Kernel = void (*)(const float*, int, int, int, const float*, float*,
                        int, int, int, int, int, int, int, int, float, int*);

Kernel kernel_for(int order, int border) {
  if (order == 1 && !border) return affine_slab_kernel<1, true>;
  if (order == 1) return affine_slab_kernel<1, false>;
  if (!border) return affine_slab_kernel<3, true>;
  return affine_slab_kernel<3, false>;
}

// Allow `smem` bytes of dynamic shared memory per block (above 48 KB only
// after asking), and ask for the SM's largest shared-memory carveout, so
// that as many CTAs share an SM as affine_slab_blocks_per_sm reports,
// whatever carveout the CUDA runtime would pick by itself.
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

}  // namespace

// C entry, bound with ctypes.  vol: (d0, d1, d2) float32, contiguous.
// mats: (n, 4, 4) float32, contiguous, on the same device.  out: (n, o0,
// o1, o2) float32, contiguous.  (e0, e1, e2): the box extents per CTA,
// at most 227 KB of float32.  order: 1 or 3.  border: 0 for 'constant', 1
// for 'border'.  overflows: one int32 on the device, incremented for each
// CTA whose box exceeded the extents and each voxel read past its box.
// Launches on `stream`, on the calling thread's current device (the caller
// makes it the tensors' device), without synchronising, and returns the
// first error (0 on success).
extern "C" int affine_slab_launch(const float* vol, int d0, int d1, int d2,
                                  const float* mats, int n, float* out,
                                  int o0, int o1, int o2, int e0, int e1,
                                  int e2, int order, int border, float cval,
                                  int* overflows, void* stream) {
  if ((order != 1 && order != 3) || d0 < 1 || d1 < 1 || d2 < 1 || n < 1 ||
      n > 65535 || o0 < 1 || o1 < 1 || o2 < 1 || e0 < 1 || e1 < 1 ||
      e2 < 1 || overflows == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = 4LL * e0 * e1 * e2;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int bricks_z = (o0 + kBz - 1) / kBz;
  const int bricks_y = (o1 + kBy - 1) / kBy;
  const int bricks_x = (o2 + kBx - 1) / kBx;
  const long long blocks =
      static_cast<long long>(bricks_z) * bricks_y * bricks_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);

  const Kernel kernel = kernel_for(order, border);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  const dim3 block(kBx, kBy);
  kernel<<<grid, block, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      vol, d0, d1, d2, mats, out, o0, o1, o2, bricks_y, bricks_x, e0, e1, e2,
      cval, overflows);
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of the kernel with a box of (e0, e1, e2) fit one SM at a
// time, into *blocks; returns the first error (0 on success).
extern "C" int affine_slab_blocks_per_sm(int e0, int e1, int e2, int order,
                                         int border, int* blocks) {
  const long long smem = 4LL * e0 * e1 * e2;
  if ((order != 1 && order != 3) || e0 < 1 || e1 < 1 || e2 < 1 ||
      smem > kMaxSharedBytes || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = kernel_for(order, border);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, static_cast<size_t>(smem)));
}

extern "C" const char* affine_slab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
