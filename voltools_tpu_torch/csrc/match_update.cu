// Template matching's update: the score of one orientation and the running
// best score and its orientation's index, in one streaming pass.
//
// No TPU kernel stands behind this one: the JAX package has no template
// matching.  It replaces four PyTorch kernels of
// voltools_tpu_torch/models/matching.py::TemplateMatcher._score (a multiply,
// a compare into a bool map, a maximum, a masked fill), which the port keeps
// as the kernel's plain version
// (voltools_tpu_torch/kernels/match_update.py::plain_match_update):
//   s       = cc * inv                       (one rounding, __fmul_rn)
//   better  = s > best                       (strict: a tie keeps the index)
//   best    = torch.maximum(best, s)
//   index   = better ? orientation : index
// torch.maximum on the card is: best where best is NaN, else s where s is
// NaN, else fmaxf(best, s).  The kernel computes that same value in that
// order, so it equals the four kernels bit for bit, NaN, infinities and the
// sign of a zero included: where inv is 0 a score of -0 (cc < 0) meets +0
// (cc > 0), and the kernel keeps whichever fmaxf(best, s) keeps, as
// torch.maximum does.  A NaN best stays NaN and its index is never replaced
// (NaN > x is false).
//
// What bounds it on an H100 SXM (3.35 TB/s): the pass must read cc, inv and
// the best scores once, 12 bytes a voxel (805 MB, 0.240 ms at the
// tomogram's 67.1 M voxels), and write a score and an index only where the
// orientation changes the best.  After a reset every voxel changes on the
// first orientation (20 bytes a voxel, 0.401 ms); after k orientations
// about 1/k of the voxels improve, so in a long sweep the writes vanish.
// The four kernels moved 10.5 passes of 268 MB (2.8 GB) an orientation.
//
// Design.  A thread takes kGroups float4 groups kThreads apart inside its
// CTA's chunk and issues all their loads before any arithmetic, so
// 3 x kGroups 16-byte loads are in flight a thread: cc through ld.cs
// (evict first: it is dead after the pass), inv through the read-only
// path, the best scores through plain loads (the same thread may write
// them back).  A score is stored only where its bits change, an index only
// where s > best: a group whose four voxels all change stores one float4
// (int4), any other stores voxel by voxel.  Nothing reads the index map.
// The n % 4 voxels past the last group are taken one a thread by the
// first CTA.  Improved voxels (s > best) are counted in a 64-bit device
// counter: each warp sums its lanes' counts (__reduce_add_sync) and its
// lane 0 adds the sum with one atomic, only where the warp improved any.
// One launch an orientation, on the caller's stream; the kernel allocates
// nothing and does not synchronise.
//
// The max-only entry, match_noise_update_launch: the running best of the
// noise template's scores under pytom-match-pick's random-phase
// correction, with no index and no count:
//   noise = torch.maximum(noise, cc * inv)
// the same pass with the index writes and the counter compiled out
// (kIndexed false): it reads cc, inv and the noise map once and writes a
// noise score only where its bits change, bit for bit the plain version
// (voltools_tpu_torch/kernels/match_update.py::plain_match_noise_update).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 256 x 4 of the layouts timed on an H100 (threads 128-512, 1-8 groups):
// 4 groups keep enough loads in flight at 64 registers (PERF.md)
constexpr int kThreads = 256;          // a CTA's threads
constexpr int kGroups = 4;             // float4 groups a thread, in flight
constexpr unsigned kWarpMask = 0xffffffffu;
static_assert(kThreads % 32 == 0, "whole warps");

// One voxel: torch.maximum(best, s)'s value, whether its bits differ from
// the best's, and whether s > best.
struct Voxel {
  float score;
  bool store;
  bool better;
};

__device__ __forceinline__ Voxel voxel(float c, float v, float best) {
  const float s = __fmul_rn(c, v);
  const float m = isnan(best) ? best : (isnan(s) ? s : fmaxf(best, s));
  return {m, __float_as_uint(m) != __float_as_uint(best), s > best};
}

// kIndexed: the index map and the improved-voxel count are kept (the
// template's update); without it only the scores (the noise map's).
template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
    match_update_kernel(const float* __restrict__ cc,
                        const float* __restrict__ inv,
                        float* __restrict__ scores,
                        int* __restrict__ indices, long long n, int index,
                        unsigned long long* __restrict__ improved) {
  const long long groups = n >> 2;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads *
                              kGroups + threadIdx.x;
  const float4* cc4 = reinterpret_cast<const float4*>(cc);
  const float4* inv4 = reinterpret_cast<const float4*>(inv);
  float4* scores4 = reinterpret_cast<float4*>(scores);
  int4* indices4 = reinterpret_cast<int4*>(indices);
  float4 c[kGroups], v[kGroups], b[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const long long g = first + static_cast<long long>(k) * kThreads;
    if (g < groups) {
      c[k] = __ldcs(cc4 + g);
      v[k] = __ldg(inv4 + g);
      b[k] = scores4[g];
    }
  }
  unsigned count = 0;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const long long g = first + static_cast<long long>(k) * kThreads;
    if (g < groups) {
      const Voxel x = voxel(c[k].x, v[k].x, b[k].x);
      const Voxel y = voxel(c[k].y, v[k].y, b[k].y);
      const Voxel z = voxel(c[k].z, v[k].z, b[k].z);
      const Voxel w = voxel(c[k].w, v[k].w, b[k].w);
      if (x.store && y.store && z.store && w.store) {
        scores4[g] = make_float4(x.score, y.score, z.score, w.score);
      } else {
        float* s = scores + 4 * g;
        if (x.store) s[0] = x.score;
        if (y.store) s[1] = y.score;
        if (z.store) s[2] = z.score;
        if (w.store) s[3] = w.score;
      }
      if constexpr (kIndexed) {
        if (x.better && y.better && z.better && w.better) {
          indices4[g] = make_int4(index, index, index, index);
        } else {
          int* i = indices + 4 * g;
          if (x.better) i[0] = index;
          if (y.better) i[1] = index;
          if (z.better) i[2] = index;
          if (w.better) i[3] = index;
        }
        count += x.better + y.better + z.better + w.better;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long t = 4 * groups + threadIdx.x;
    const Voxel x = voxel(__ldcs(cc + t), __ldg(inv + t), scores[t]);
    if (x.store) scores[t] = x.score;
    if constexpr (kIndexed) {
      if (x.better) indices[t] = index;
      count += x.better;
    }
  }
  if constexpr (kIndexed) {
    // every lane of every warp reaches here: the CTA holds whole warps and
    // no thread leaves early
    count = __reduce_add_sync(kWarpMask, count);
    if ((threadIdx.x & 31) == 0 && count != 0) {
      atomicAdd(improved, static_cast<unsigned long long>(count));
    }
  }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// The launch of either form over n voxels; a cudaError_t.
template <bool kIndexed>
int launch(const float* cc, const float* inv, float* scores, int* indices,
           long long n, int index, unsigned long long* improved,
           void* stream) {
  const long long per_block = static_cast<long long>(kThreads) * kGroups;
  const long long blocks = ((n >> 2) + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  match_update_kernel<kIndexed>
      <<<blocks > 0 ? static_cast<unsigned>(blocks) : 1u, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(cc, inv, scores, indices, n,
                                              index, improved);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Update ``scores`` and ``indices`` (n voxels each) with the orientation
// ``index`` whose correlation is ``cc``, scaled by ``inv``; count the
// voxels it improved into ``*improved``.  Every pointer 16-byte aligned.
// Returns a cudaError_t.
extern "C" int match_update_launch(const float* cc, const float* inv,
                                   float* scores, int* indices, long long n,
                                   int index, unsigned long long* improved,
                                   void* stream) {
  if (n < 1 || improved == nullptr || misaligned(cc) || misaligned(inv) ||
      misaligned(scores) || misaligned(indices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(cc, inv, scores, indices, n, index, improved, stream);
}

// Keep in ``noise`` (n voxels) the larger of it and ``cc * inv``, as
// torch.maximum(noise, cc * inv) does.  Every pointer 16-byte aligned.
// Returns a cudaError_t.
extern "C" int match_noise_update_launch(const float* cc, const float* inv,
                                         float* noise, long long n,
                                         void* stream) {
  if (n < 1 || misaligned(cc) || misaligned(inv) || misaligned(noise)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(cc, inv, noise, nullptr, n, 0, nullptr, stream);
}

extern "C" const char* match_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
