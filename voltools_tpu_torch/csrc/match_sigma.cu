// Template matching's local sigma under a rotated mask, from the two float64
// moments to the orientation's 1 / (N n sigma) map, in two launches.
//
// No TPU kernel stands behind this one: the JAX package has no template
// matching.  It replaces, in voltools_tpu_torch/models/matching.py
// (TemplateMatcher._local_inv, under a mask that is not spherical), the C2R
// along x of both moments and the map's plain passes (the scale, addcmul_,
// the float32 copy, the maximum, the floor's compare, rsqrt_, masked_fill_),
// which stay as its plain version
// (voltools_tpu_torch/kernels/match_sigma.py::plain_match_sigma).
//
// match_sigma_launch: for each (z, y) row, both moments' X / 2 + 1
// half-spectrum entries (complex128, already inverted along z and y), their
// inverse along x, w = (N n) mean_sq' - mean'^2 in float64 (the scale, then
// a fused multiply-add of -mean', mean' and it), rounded to float32 and
// written (Z, Y, X) contiguous, as the update kernel reads the map; and
// max(w, 0) folded into one device word by atomicMax on the float's bits,
// which is exact and the same in any order (a NaN above every number, as
// torch's max propagates it).  match_sigma_finish_launch, in place: inv =
// w <= floor * max ? 0 : rsqrt(w), in float32.
//
// What bounds it on an H100 SXM (3.35 TB/s): the bytes.  At tm512 (a (256,
// 512, 512) tomogram) the first launch reads the two half-spectra (1.078 GB)
// and writes the float32 map (0.268 GB): 0.402 ms; the finish reads and
// writes the map (0.537 GB): 0.160 ms.  The torch path it replaces writes
// both float64 moments (0.537 GB each) and passes over them and their
// float32 offspring seven times more.  The transforms' 2 x 5 H log2 H
// operations a row are about a fifth of the card's float64 rate at that
// time.
//
// Two designs, chosen by X, one launch either way.  The inverse along x of
// a real row of X points is, for an even X, one complex inverse FFT of H =
// X / 2 points: with W = exp(2 pi i / X) and, for k < H,
//   E[k] = F[k] + conj(F[H - k]),  O[k] = W^k (F[k] - conj(F[H - k])),
//   Z[k] = E[k] + i O[k]
// (F[0] and F[H] taken real, as a C2R takes them), z = ifft_H(Z),
// unnormalised, holds z[m] = x[2m] + i x[2m + 1].  An odd X is one complex
// inverse FFT of X points of the Hermitian row (F[k] for k <= X / 2,
// conj(F[X - k]) above it, F[0] taken real), x the real part.
//
// The register design takes a power of two X from 128 to 2048.  A CTA
// takes kRows consecutive y at one z, every x': the moments lie y
// innermost, so at each x' its loads are one 128-byte line.  Each row's H
// points are held by H / kRadix threads, kRadix a thread, in the layout of
// match_zpass.cu's register design, through the same passes of radix 16
// (match_fft.cuh).  The mean square's loads are issued once the mean's
// transform ends, which holds a thread to 168 registers, so kResident
// threads (3 CTAs at X = 512) share an SM and other CTAs' loads fill each
// one's transform (at tm512, 0.479 ms against 0.512 with both moments
// loaded first at 254 registers and 2 CTAs an SM, and 0.485 with the mean
// square prefetched to L2 meanwhile: PERF.md).  A row's F goes to shared
// memory once, where each thread reads the partners F[H - k] of its
// points; the same buffer then serves the passes' exchanges.  The mean's
// x stay in registers while the mean square's transform runs, so w is
// formed where that transform leaves its points, each thread writing
// float2 pairs.
//
// The shared-memory design takes any other X up to kMaxWidth: the complex
// FFT of P points (H, or X for an odd X) by match_fft.cuh's Stockham
// passes of P's radices, or, where P has a prime factor above the
// wrapper's match_zpass.MAX_DIRECT, by Bluestein's convolution with the
// tables the wrapper passes (match_zpass.chirp_tables of P), as
// match_zpass.cu's shared-memory design takes them.  A CTA takes up to
// kMaxRows consecutive y at one z, a row's threads taking its points in
// turn; each moment's row is staged into shared memory by cp.async, turned
// into the FFT's input there, and transformed between two buffers; the
// mean's x are kept in shared memory while the mean square's transform
// runs, and w is written with the CTA's threads along x, so a warp writes
// whole lines of the map.  Rows sit in shared memory at an odd pitch where
// there are more than two, so that reads along x take distinct banks.
// Its time is set by how many warps an SM holds: Stockham's passes take
// radix 8 at most, 8 points a thread and 2 CTAs an SM (128 registers a
// thread), which at widths 180 to 1000 took 0.71-0.82 of the time of
// radix 16, 16 points a thread and one CTA's 190 registers; Bluestein's
// two buffers of L points a row fill the SM whatever the threads, and
// keep radix 16 (PERF.md; tools/match_sigma_variants.py).
//
// Either design reduces each warp's largest bits, each CTA's through
// shared memory, and folds them into the word with one atomic a CTA; the
// launch zeroes the word on the stream first.  The finish reads the word
// once a thread and takes the map in float4 groups.  Both launch on the
// caller's stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "match_fft.cuh"

namespace {

constexpr int kMinLog2 = 6;         // the register design: H = X / 2 from 64
constexpr int kMaxLog2 = 10;        // to 1024, a power of two
constexpr int kRows = 8;            // y a CTA: a 128-byte line of complex128
constexpr int kResident = 384;      // threads an SM: 12 warps, 168 registers
constexpr int kMaxWidth = 2048;     // the shared-memory design: any X to this
constexpr int kMaxRows = 32;        // its y a CTA, at most
constexpr int kMaxThreads = 256;    // its threads a CTA, at most
constexpr int kBudget = 100 * 1024;         // its shared memory a CTA, aimed
constexpr int kMaxShared = 227 * 1024;      // and at most
// its largest radix, also its points a thread (L / radix threads a row),
// and its CTAs an SM at least: Stockham's passes alone (so 128 registers
// a thread), and Bluestein's, whose two L-point buffers a row fill an SM
constexpr int kStockhamRadix = 8;
constexpr int kStockhamBlocks = 2;
constexpr int kBluesteinRadix = 16;
constexpr int kBluesteinBlocks = 1;
constexpr int kThreads = 256;       // the finish's threads a CTA
constexpr int kGroups = 4;          // its float4 groups a thread, in flight
constexpr unsigned kWarpMask = 0xffffffffu;
constexpr unsigned kNaN = 0x7fc00000u;      // a quiet NaN's bits

struct Args {
  const double2* moments[2];     // mean', mean_sq': (Z, Y, H + 1) each
  long long z_stride, y_stride, x_stride;   // their strides, in elements
  const float* weight;           // n, the rotated mask's sum
  float* map;                    // (Z, Y, X), contiguous
  unsigned* largest;             // the bits of max(w, 0)
  long long voxels;              // N = Z Y X
  int height;                    // Y
  int tiles;                     // y tiles of a CTA's rows a z
  // the shared-memory design only
  int width;                     // X
  int points;                    // P: the FFT's points, H or X
  const double2* chirp;          // Bluestein's tables of P, or null
  int length;                    // L: the FFTs' length, P or Bluestein's
  int rows, pitch, threads;      // y a CTA, its rows' pitch, threads a row
  int passes;                    // L = radices[0] ... radices[passes - 1]
  int radices[kMaxPasses];
};

// the bits whose unsigned order is that of max(w, 0), NaN above all
__device__ __forceinline__ unsigned key(float w) {
  return isnan(w) ? kNaN : (w > 0.0f ? __float_as_uint(w) : 0u);
}

// The CTA's largest bits into *to: each warp's, then the CTA's through
// *cta (zeroed before a barrier the whole CTA passed), one atomic a CTA.
// Every thread of the CTA reaches it; its last warp may be partial.
__device__ __forceinline__ void fold(unsigned largest, unsigned* cta,
                                     unsigned* to) {
  const unsigned lanes = min(32u, blockDim.x - (threadIdx.x & ~31u));
  largest = __reduce_max_sync(
      lanes == 32u ? kWarpMask : (1u << lanes) - 1u, largest);
  if ((threadIdx.x & 31) == 0) atomicMax(cta, largest);
  __syncthreads();
  if (threadIdx.x == 0 && *cta != 0u) atomicMax(to, *cta);
}

// One moment's rows: F (the thread's points k = j + q T in v, F[H] in
// nyquist on thread j = 0) to z = ifft_H(Z), unnormalised, z[m] in v[q]
// for m = j + q T.  Opens with a barrier, so the tables written before it
// are seen; the exchange buffer is free again when it returns.
template <int H>
__device__ __forceinline__ void row_inverse(double2 (&v)[kRadix],
                                            double2 nyquist, double2* exch,
                                            const double2* tw,
                                            const double2* roots, int j,
                                            int c) {
  constexpr int T = H / kRadix;
#pragma unroll
  for (int q = 0; q < kRadix; ++q) exch[(j + q * T) * kRows + c] = v[q];
  if (j == 0) exch[H * kRows + c] = nyquist;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kRadix; ++q) {
    const int k = j + q * T;
    double2 a = v[q];
    double2 b = exch[(H - k) * kRows + c];      // F[H - k]
    b.y = -b.y;
    if (k == 0) {
      a.y = 0.0;
      b.y = 0.0;
    }
    const double2 e = cadd(a, b);
    const double2 o = cmul(csub(a, b), roots[k]);
    v[q] = double2{e.x - o.y, e.y + o.x};
  }
  __syncthreads();
  fft<double2, H, true, kRows>(v, exch, tw, j, c);
}

// A row's points of one moment: F[j + q T] into v, F[H] into nyquist on
// thread j = 0; zeros off the volume.
template <int H>
__device__ __forceinline__ void load(double2 (&v)[kRadix], double2& nyquist,
                                     const double2* row, long long x_stride,
                                     bool live, int j) {
  constexpr int T = H / kRadix;
#pragma unroll
  for (int q = 0; q < kRadix; ++q) {
    v[q] = live ? __ldcs(row + (j + q * T) * x_stride) : double2{0.0, 0.0};
  }
  if (live && j == 0) nyquist = __ldcs(row + H * x_stride);
}

// the CTAs an SM holds at kResident threads
template <int H>
constexpr int kBlocks = kRows * H / kRadix >= kResident
                            ? 1
                            : kResident / (kRows * H / kRadix);

template <int H>
__global__ void __launch_bounds__(kRows * H / kRadix, kBlocks<H>)
    match_sigma_kernel(const Args args) {
  using C = double2;
  constexpr int T = H / kRadix;
  extern __shared__ __align__(16) unsigned char smem[];
  C* tw = reinterpret_cast<C*>(smem);         // exp(-2 pi i p / H), p < H
  C* roots = tw + H;                          // W^k = exp(i pi k / H), k < H
  C* exch = roots + H;                        // (H + 1) x kRows
  __shared__ unsigned cta_largest;
  const int c = static_cast<int>(threadIdx.x) % kRows;
  const int j = static_cast<int>(threadIdx.x) / kRows;
  const long long z = blockIdx.x / args.tiles;
  const long long y =
      static_cast<long long>(blockIdx.x % args.tiles) * kRows + c;
  const bool live = y < args.height;
  const long long at = z * args.z_stride + y * args.y_stride;
  C mean[kRadix], sq[kRadix];
  C mean_h{0.0, 0.0}, sq_h{0.0, 0.0};
  load<H>(mean, mean_h, args.moments[0] + at, args.x_stride, live, j);
  if (threadIdx.x == 0) cta_largest = 0u;
  for (int p = threadIdx.x; p < H; p += blockDim.x) {
    double s, co;
    sincospi(2.0 * p / H, &s, &co);
    tw[p] = C{co, -s};
    sincospi(static_cast<double>(p) / H, &s, &co);
    roots[p] = C{co, s};
  }
  row_inverse<H>(mean, mean_h, exch, tw, roots, j, c);
  // the mean square's loads after the mean's transform: fewer registers,
  // so more CTAs an SM keep loads in flight (the source's note)
  load<H>(sq, sq_h, args.moments[1] + at, args.x_stride, live, j);
  row_inverse<H>(sq, sq_h, exch, tw, roots, j, c);
  const double scale =
      static_cast<double>(args.voxels) * static_cast<double>(*args.weight);
  float2* row = reinterpret_cast<float2*>(args.map) +
                (z * args.height + y) * H;
  unsigned largest = 0u;
#pragma unroll
  for (int q = 0; q < kRadix; ++q) {
    const double w0 = __fma_rn(-mean[q].x, mean[q].x, __dmul_rn(sq[q].x,
                                                                  scale));
    const double w1 = __fma_rn(-mean[q].y, mean[q].y, __dmul_rn(sq[q].y,
                                                                  scale));
    const float2 w = make_float2(__double2float_rn(w0), __double2float_rn(w1));
    if (live) __stcs(row + j + q * T, w);
    largest = max(largest, max(key(w.x), key(w.y)));
  }
  fold(largest, &cta_largest, args.largest);
}

// The shared-memory design.  A CTA takes args.rows consecutive y at one z;
// a row's args.threads threads take its points in turn.  Shared memory:
// the table of the L roots, the roots W^k (an even X), two (L + 1)-point
// buffers of each row the passes ping-pong between (each moment's F
// staged in the second), and the mean's X values of each row; row r's
// point k at [k pitch + r].  Its FFTs take passes of radix kTop at most.
template <int kTop, int kBlocks>
__global__ void __launch_bounds__(kMaxThreads, kBlocks)
    match_sigma_shared_kernel(const Args args) {
  using C = double2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int plan[kMaxPasses];
  __shared__ unsigned cta_largest;
  const int width = args.width, p = args.points, len = args.length;
  const int rows = args.rows, pitch = args.pitch, threads = args.threads;
  const bool even = width % 2 == 0;
  const int half = width / 2;                 // F's entries: half + 1
  C* tw = reinterpret_cast<C*>(smem);         // exp(-2 pi i q / L), q < L
  C* roots = tw + len;                        // W^k = exp(i pi k / H), k < H
  C* buf0 = roots + (even ? p : 0);
  C* buf1 = buf0 + (len + 1) * pitch;
  double* kept = reinterpret_cast<double*>(buf1 + (len + 1) * pitch);
  const C* chirp = args.chirp;
  const C* filter = chirp + p;
  const int c = static_cast<int>(threadIdx.x) % rows;
  const int j = static_cast<int>(threadIdx.x) / rows;
  const long long z = blockIdx.x / args.tiles;
  const long long y0 = static_cast<long long>(blockIdx.x % args.tiles) * rows;
  const bool live = y0 + c < args.height;
  for (int q = threadIdx.x; q < kMaxPasses; q += blockDim.x) {
    plan[q] = args.radices[q];
  }
  if (threadIdx.x == 0) cta_largest = 0u;
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    double s, co;
    sincospi(2.0 * q / len, &s, &co);
    tw[q] = C{co, -s};
  }
  if (even) {
    for (int q = threadIdx.x; q < p; q += blockDim.x) {
      double s, co;
      sincospi(static_cast<double>(q) / p, &s, &co);
      roots[q] = C{co, s};
    }
  }
  const double scale =
      static_cast<double>(args.voxels) * static_cast<double>(*args.weight);
  float* map = args.map + (z * args.height + y0) * width;
  unsigned largest = 0u;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    // the moment's F into shared memory
    const C* row = args.moments[s] + z * args.z_stride +
                   (y0 + c) * args.y_stride;
    for (int k = j; k <= half; k += threads) {
      if (live) {
        stage_async(buf1 + k * pitch + c, row + k * args.x_stride);
      } else {
        buf1[k * pitch + c] = C{0.0, 0.0};
      }
    }
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // the FFT's input: Z = E + i O of an even X, the Hermitian row of an
    // odd one; through Bluestein's chirp, its conjugate
    for (int k = j; k < len; k += threads) {
      C v{0.0, 0.0};
      if (k < p) {
        if (even) {
          C a = buf1[k * pitch + c];
          C b = conj(buf1[(p - k) * pitch + c]);      // conj(F[H - k])
          if (k == 0) {
            a.y = 0.0;
            b.y = 0.0;
          }
          const C e = cadd(a, b);
          const C o = cmul(csub(a, b), roots[k]);
          v = C{e.x - o.y, e.y + o.x};
        } else {
          v = k <= half ? buf1[k * pitch + c]
                        : conj(buf1[(width - k) * pitch + c]);
          if (k == 0) v.y = 0.0;
        }
        if (chirp) v = cmul(conj(v), __ldg(chirp + k));
      }
      buf0[k * pitch + c] = v;
    }
    __syncthreads();
    const C* result =
        chirp ? convolve<kTop>(buf0, buf1, tw, plan, args.passes, len,
                               filter, pitch, threads, j, c)
              : fft_shared<true, kTop>(buf0, buf1, tw, plan, args.passes,
                                       len, pitch, threads, j, c);
    // x along the rows, the CTA's threads along x
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width, t = i % width;
      const int m = even ? t / 2 : t;
      C v = result[m * pitch + r];
      if (chirp) v = conj(cmul(v, __ldg(chirp + m)));
      const double x = even && (t & 1) ? v.y : v.x;
      if (s == 0) {
        kept[t * pitch + r] = x;
      } else if (y0 + r < args.height) {
        const double mean = kept[t * pitch + r];
        const float w =
            __double2float_rn(__fma_rn(-mean, mean, __dmul_rn(x, scale)));
        __stcs(map + static_cast<long long>(r) * width + t, w);
        largest = max(largest, key(w));
      }
    }
    __syncthreads();
  }
  fold(largest, &cta_largest, args.largest);
}

__device__ __forceinline__ float inverse(float w, float limit) {
  return w <= limit ? 0.0f : rsqrtf(w);
}

__global__ void __launch_bounds__(kThreads)
    match_sigma_finish_kernel(float* __restrict__ map, long long n,
                              const unsigned* __restrict__ largest,
                              float floor) {
  const float limit = __fmul_rn(floor, __uint_as_float(*largest));
  const long long groups = n >> 2;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads *
                              kGroups + threadIdx.x;
  float4* map4 = reinterpret_cast<float4*>(map);
  float4 v[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const long long g = first + static_cast<long long>(k) * kThreads;
    if (g < groups) v[k] = __ldcs(map4 + g);
  }
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const long long g = first + static_cast<long long>(k) * kThreads;
    if (g < groups) {
      __stcs(map4 + g, make_float4(inverse(v[k].x, limit),
                                   inverse(v[k].y, limit),
                                   inverse(v[k].z, limit),
                                   inverse(v[k].w, limit)));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long t = 4 * groups + threadIdx.x;
    map[t] = inverse(map[t], limit);
  }
}

bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

template <int H>
int launch(const Args& args, long long blocks, cudaStream_t stream) {
  constexpr int threads = kRows * H / kRadix;
  constexpr int smem =
      (2 * H + (H + 1) * kRows) * static_cast<int>(sizeof(double2));
  const auto kernel = match_sigma_kernel<H>;
  if (smem > 48 * 1024) {
    const cudaError_t code = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (code != cudaSuccess) return static_cast<int>(code);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int L = kMinLog2>
int launch_h(int log2h, const Args& args, long long blocks,
             cudaStream_t stream) {
  if (log2h == L) return launch<1 << L>(args, blocks, stream);
  if constexpr (L < kMaxLog2) {
    return launch_h<L + 1>(log2h, args, blocks, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shared-memory design's launch: P, L and the radices of L (kTop at
// most); L / kTop threads a row, at most kMaxThreads; rows a CTA while its
// threads stay within kMaxThreads, fewer while its shared memory passes
// kBudget (but for whole 32-byte sectors of y) or the card's most.
template <int kTop, int kBlocks>
int launch_shared(Args args, int depth, cudaStream_t stream) {
  constexpr int size = static_cast<int>(sizeof(double2));
  const int width = args.width;
  const bool even = width % 2 == 0;
  const int p = even ? width / 2 : width;
  int len = p;
  if (args.chirp != nullptr) {
    for (len = 1; len < 2 * p - 1;) len *= 2;
  }
  args.points = p;
  args.length = len;
  args.passes = radix_plan(len, args.radices, kTop);
  if (args.passes < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto pitch = [](int rows) { return rows > 2 ? rows + 1 : rows; };
  auto shared = [&](int rows) {
    return size * (len + (even ? p : 0) + 2 * (len + 1) * pitch(rows)) +
           static_cast<int>(sizeof(double)) * width * pitch(rows);
  };
  const int threads = min((len + kTop - 1) / kTop, kMaxThreads);
  int rows = kMaxRows;
  while (rows > 1 && rows * threads > kMaxThreads) rows /= 2;
  while (rows > 32 / size && shared(rows) > kBudget) rows /= 2;
  while (rows > 1 && shared(rows) > kMaxShared) rows /= 2;
  if (shared(rows) > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  args.rows = rows;
  args.pitch = pitch(rows);
  args.threads = threads;
  args.tiles = (args.height + rows - 1) / rows;
  const long long blocks = static_cast<long long>(args.tiles) * depth;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = match_sigma_shared_kernel<kTop, kBlocks>;
  const int smem = shared(rows);
  if (smem > 48 * 1024) {
    const cudaError_t code = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (code != cudaSuccess) return static_cast<int>(code);
  }
  kernel<<<static_cast<unsigned>(blocks), rows * threads, smem, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The map w = (N n) mean_sq' - mean'^2 of a (depth, height, width) volume
// into map (contiguous float32), from the moments' half-spectra along x
// (complex128, (depth, height, width / 2 + 1) each, one set of strides in
// elements, inverted along z and y, unnormalised), n at weight (float32 on
// the device), N = depth height width; *largest = the bits of the largest
// max(w, 0), zeroed on the stream first.  width from 1 to kMaxWidth: a
// power of two from 2^(1 + kMinLog2) to 2^(1 + kMaxLog2) takes the
// register design, any other width the shared-memory design, through
// Bluestein's convolution where chirp is not null: then chirp holds
// match_zpass.cu's tables of P points (P = width / 2 for an even width,
// width for an odd one).  Returns a cudaError_t.
extern "C" int match_sigma_launch(const void* mean, const void* mean_sq,
                                  long long z_stride, long long y_stride,
                                  long long x_stride, int depth, int height,
                                  int width, const float* weight, float* map,
                                  unsigned* largest, const void* chirp,
                                  void* stream) {
  if (depth < 1 || height < 1 || width < 1 || width > kMaxWidth ||
      z_stride < 0 || y_stride < 0 || x_stride < 0 || mean == nullptr ||
      mean_sq == nullptr || weight == nullptr || map == nullptr ||
      largest == nullptr || misaligned(mean, 16) || misaligned(mean_sq, 16) ||
      misaligned(map, 8) || misaligned(largest, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{{static_cast<const double2*>(mean),
             static_cast<const double2*>(mean_sq)},
            z_stride, y_stride, x_stride, weight, map, largest,
            static_cast<long long>(depth) * height * width, height, 0, width,
            0, static_cast<const double2*>(chirp)};
  const auto s = static_cast<cudaStream_t>(stream);
  // the status returned is this launch's, not one an earlier call left
  (void)cudaGetLastError();
  const cudaError_t code = cudaMemsetAsync(largest, 0, sizeof(unsigned), s);
  if (code != cudaSuccess) return static_cast<int>(code);
  int log2h = 0;
  while ((2 << log2h) < width) ++log2h;
  if ((2 << log2h) == width && log2h >= kMinLog2 && log2h <= kMaxLog2 &&
      chirp == nullptr) {
    args.tiles = (height + kRows - 1) / kRows;
    const long long blocks = static_cast<long long>(args.tiles) * depth;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    return launch_h(log2h, args, blocks, s);
  }
  return chirp == nullptr
             ? launch_shared<kStockhamRadix, kStockhamBlocks>(args, depth, s)
             : launch_shared<kBluesteinRadix, kBluesteinBlocks>(args, depth,
                                                                s);
}

// In place over the n floats of map (16-byte aligned): 0 where w <= floor
// times the float whose bits are *largest, else rsqrt(w).  Returns a
// cudaError_t.
extern "C" int match_sigma_finish_launch(float* map, long long n,
                                         const unsigned* largest, float floor,
                                         void* stream) {
  if (n < 1 || map == nullptr || largest == nullptr || misaligned(map, 16) ||
      misaligned(largest, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = static_cast<long long>(kThreads) * kGroups;
  const long long blocks = ((n >> 2) + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  match_sigma_finish_kernel<<<blocks > 0 ? static_cast<unsigned>(blocks) : 1u,
                              kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      map, n, largest, floor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* match_sigma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
