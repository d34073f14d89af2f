// Template matching's spectral pass along z: for each (y, x') column of the
// half-spectrum grid, the forward FFT along z of the placed template's
// planes, the product with the tomogram's spectrum (or with two spectra),
// and the inverse FFT along z, in one pass that reads each spectrum once and
// writes each result once.
//
// No TPU kernel stands behind this one: the JAX package has no template
// matching.  It replaces, in voltools_tpu_torch/models/matching.py, the
// whole-grid forward pass of the correlation's rfftn, the product with the
// spectrum (the mask's two products under a non-spherical mask) and the
// inverse's pass along the same axis: three tomogram-sized passes that
// torch runs one after another on the same columns, each reading and
// writing the whole grid.  Its plain version is those torch operations
// (voltools_tpu_torch/kernels/match_zpass.py::plain_match_zpass).
//
// Why z.  Torch finishes each inverse with one c2c pass and the C2R along
// x.  cuFFT through torch returns a c2c pass with its axis innermost, and
// the C2R keeps its batch axes in their input's stride order, so the
// correlation comes back (Z, Y, X) contiguous, as the update kernel reads
// it, only when that last c2c pass runs along y.  So this kernel takes z.
//
// What bounds it on an H100 SXM (3.35 TB/s): the bytes.  At tm512 (a
// (256, 512, 512) tomogram, a 48^3 template) a complex64 correlation reads
// the template's 48 y-transformed planes (51 MB) and the spectrum (270 MB)
// and writes the result (270 MB): 0.176 ms.  The non-spherical mask's
// complex128 moments read its planes (101 MB) and two spectra and write two
// results (2.26 GB): 0.674 ms.  The FFTs' 2 x 5 N log2 N operations a
// column are under a tenth of the card's fp32 (fp64) rate at that time.
//
// Two designs, chosen by N, one launch a correlation either way.
//
// The register design takes a power of two from 64 to 1024.  A CTA takes
// kColumns consecutive y (one 128-byte line of a row) at one x', every z.
// Each column's N points are held by N / kRadix threads, kRadix points a
// thread: thread j holds z = j + q (N / kRadix), q < kRadix, so a warp's
// loads and stores at one q are whole lines along y.  An FFT is Stockham's
// autosort in passes of radix 16 (the last pass the radix left over): each
// pass takes the thread's own points, applies the twiddles, an in-register
// DFT of radix 2 stages, and writes to a shared-memory exchange buffer,
// from which each thread reads its own points back; the last pass writes
// its outputs straight to the thread's own registers.  So the forward's
// output is in registers in the layout the product and the inverse's first
// pass take, and nothing but the passes' exchanges touches shared memory.
// Each thread issues its points' spectrum loads before the forward and
// multiplies once it ends, so the loads are in flight during the forward
// (at tm512, 0.214 ms against 0.268 with the loads after it, and 0.213
// staging them in shared memory with cp.async; complex128, 0.832 against
// 0.877 and 0.863; PERF.md).  At N = 1024 its 1024-thread CTAs cap a
// thread at 64 registers (complex64) and 128 (complex128), and it spills;
// it is still faster there than the shared-memory design (PERF.md).
//
// The shared-memory design takes any other N up to kMaxPoints: Stockham's
// autosort in passes of N's radices (16 while it divides, the power of two
// left, then its odd primes), each pass from one shared-memory buffer to
// the other, a column's threads taking its butterflies in turn; 3, 5 and 7
// as compile-time butterflies, a larger prime as paired direct sums.  The
// spectrum is staged into shared memory by cp.async before the forward.
// Where N has a prime factor above the wrapper's MAX_DIRECT, the direct
// sums' N p cost passes that of Bluestein's convolution, and the wrapper
// passes its tables: each N-point DFT is then a chirp times a circular
// convolution by FFTs of a power of two L >= 2N - 1.
//
// Twiddles: a table of the roots of unity in shared memory, each computed
// in float64 with sincospi and rounded once; the radix-2 stages use
// compile-time constants.  Both FFTs are unnormalised (as torch.fft.fft,
// and ifft with norm="forward").  With two spectra the forward is computed
// again from the planes, which the second read finds in L2, rather than
// held.  The kernel runs on the caller's stream, allocates nothing and
// does not synchronise.  Both designs' FFTs are match_fft.cuh's.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

#include "match_fft.cuh"

namespace {

constexpr int kMinLog2 = 6;         // the register design: N from 64
constexpr int kMaxLog2 = 10;        // to 1024, a power of two
constexpr int kMaxPoints = 2048;    // the shared-memory design: any N to this
constexpr int kPoints = 16;         // its threads a column: N / kPoints
constexpr int kMaxThreads = 256;    // its threads a CTA, at most
constexpr int kBudget = 100 * 1024;         // its shared memory a CTA, aimed
constexpr int kMaxShared = 227 * 1024;      // and at most

template <typename Real>
using Complex =
    std::conditional_t<std::is_same_v<Real, float>, float2, double2>;

// y columns a CTA takes: one 128-byte line of a row
template <typename Real>
constexpr int kColumns = 128 / static_cast<int>(sizeof(Complex<Real>));

struct Args {
  const void* planes;            // (depth, Y, X') planes
  long long plane_z, plane_y, plane_x;   // their strides, in elements
  const void* spectra[2];        // (N, Y, X') each
  void* out[2];                  // (N, Y, X') each
  long long z_stride, y_stride, x_stride;   // of spectra and outputs
  int depth, centre;             // the planes' z window (see the entry)
  int height;                    // Y
  int tiles;                     // y tiles of a CTA's columns a column of x'
  // the shared-memory design only
  int points;                    // N
  const void* chirp;             // Bluestein's tables (see the entry), or null
  int length;                    // L: the FFTs' length, N or Bluestein's
  int cols, threads;             // y columns a CTA, threads a column
  int passes;                    // L = radices[0] ... radices[passes - 1]
  int radices[kMaxPasses];
};

// the z of a column that holds plane p: z = p (p <= centre), z = p + N -
// depth after it; so plane(z) is z up to centre, z - N + depth from N -
// depth + centre + 1 on, and no plane between
__device__ __forceinline__ int plane_at(int z, int n, int depth,
                                        int centre) {
  if (z <= centre) return z;
  const int p = z - n + depth;
  return p > centre ? p : -1;
}

template <typename Real, int N, int kSpectra>
__global__ void __launch_bounds__(kColumns<Real> * N / kRadix)
    match_zpass_kernel(const Args args) {
  using C = Complex<Real>;
  constexpr int kCols = kColumns<Real>;
  constexpr int T = N / kRadix;
  extern __shared__ __align__(16) unsigned char smem[];
  C* tw = reinterpret_cast<C*>(smem);         // exp(-2 pi i p / N), p < N
  C* exch = tw + N;                           // N x kCols
  const int c = static_cast<int>(threadIdx.x) % kCols;
  const int j = static_cast<int>(threadIdx.x) / kCols;
  const long long x = blockIdx.x / args.tiles;
  const long long y = (blockIdx.x % args.tiles) * kCols + c;
  const bool live = y < args.height;
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    double s, co;
    sincospi(2.0 * p / N, &s, &co);
    tw[p] = C{static_cast<Real>(co), static_cast<Real>(-s)};
  }
  __syncthreads();
  const C* planes = static_cast<const C*>(args.planes) + y * args.plane_y +
                    x * args.plane_x;
  const long long at = y * args.y_stride + x * args.x_stride;
#pragma unroll 1
  for (int s = 0; s < kSpectra; ++s) {
    C v[kRadix];
#pragma unroll
    for (int q = 0; q < kRadix; ++q) {
      const int plane = plane_at(j + q * T, N, args.depth, args.centre);
      v[q] = live && plane >= 0 ? planes[plane * args.plane_z] : C{0, 0};
    }
    // the spectrum's loads are issued before the forward, which hides them
    const C* spectrum = static_cast<const C*>(args.spectra[s]) + at;
    C held[kRadix];
    if (live) {
#pragma unroll
      for (int q = 0; q < kRadix; ++q) {
        held[q] = __ldcs(spectrum + (j + q * T) * args.z_stride);
      }
    }
    fft<C, N, false, kCols>(v, exch, tw, j, c);
    if (live) {
#pragma unroll
      for (int q = 0; q < kRadix; ++q) v[q] = cmul(v[q], held[q]);
    }
    fft<C, N, true, kCols>(v, exch, tw, j, c);
    C* out = static_cast<C*>(args.out[s]) + at;
    if (live) {
#pragma unroll
      for (int q = 0; q < kRadix; ++q) {
        __stcs(out + (j + q * T) * args.z_stride, v[q]);
      }
    }
  }
}

template <typename Real, int N, int kSpectra>
int launch(const Args& args, long long blocks, cudaStream_t stream) {
  constexpr int threads = kColumns<Real> * N / kRadix;
  constexpr int smem = N * (kColumns<Real> + 1) *
                       static_cast<int>(sizeof(Complex<Real>));
  const auto kernel = match_zpass_kernel<Real, N, kSpectra>;
  if (smem > 48 * 1024) {
    const cudaError_t code = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (code != cudaSuccess) return static_cast<int>(code);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real, int kSpectra, int L = kMinLog2>
int launch_n(int log2n, const Args& args, long long blocks,
             cudaStream_t stream) {
  if (log2n == L) return launch<Real, 1 << L, kSpectra>(args, blocks, stream);
  if constexpr (L < kMaxLog2) {
    return launch_n<Real, kSpectra, L + 1>(log2n, args, blocks, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- The shared-memory design: any N up to kMaxPoints ----

// A CTA takes args.cols consecutive y at one x', every z; a column's
// args.threads threads take z = j, j + threads, ... of it.  Shared memory:
// the table of the L roots, two L x cols buffers the passes ping-pong
// between, and an N x cols one the spectrum is staged into by cp.async
// before the forward, so its loads are in flight during the forward.
//
// With Bluestein's tables (chirp w_z = exp(-i pi z^2 / N), z < N, then the
// filter's spectrum over L), L is a power of two at least 2N - 1 and each
// N-point DFT is w_k times the convolution of x_z w_z with conj(w):
// X = DFT_N(x) so; the inverse, unnormalised, is conj(DFT_N(conj(Y))).
template <typename Real, int kSpectra>
__global__ void __launch_bounds__(kMaxThreads)
    match_zpass_shared_kernel(const Args args) {
  using C = Complex<Real>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int plan[kMaxPasses];
  const int n = args.points, len = args.length, cols = args.cols;
  const int threads = args.threads, passes = args.passes;
  const int depth = args.depth, centre = args.centre;
  C* tw = reinterpret_cast<C*>(smem);         // exp(-2 pi i p / L), p < L
  C* buf0 = tw + len;
  C* buf1 = buf0 + len * cols;
  C* staged = buf1 + len * cols;
  const C* chirp = static_cast<const C*>(args.chirp);
  const C* filter = chirp + n;
  const int c = static_cast<int>(threadIdx.x) % cols;
  const int j = static_cast<int>(threadIdx.x) / cols;
  const long long x = blockIdx.x / args.tiles;
  const long long y = static_cast<long long>(blockIdx.x % args.tiles) * cols
                      + c;
  const bool live = y < args.height;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (threadIdx.x == p) plan[p] = args.radices[p];
  }
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    double s, co;
    sincospi(2.0 * p / len, &s, &co);
    tw[p] = C{static_cast<Real>(co), static_cast<Real>(-s)};
  }
  const C* planes = static_cast<const C*>(args.planes) + y * args.plane_y +
                    x * args.plane_x;
  const long long at = y * args.y_stride + x * args.x_stride;
#pragma unroll 1
  for (int s = 0; s < kSpectra; ++s) {
    const C* spectrum = static_cast<const C*>(args.spectra[s]) + at;
    if (live) {
      for (int z = j; z < n; z += threads) {
        stage_async(staged + z * cols + c, spectrum + z * args.z_stride);
      }
    }
    asm volatile("cp.async.commit_group;");
    for (int z = j; z < len; z += threads) {
      C v{0, 0};
      if (z < n) {
        const int plane = plane_at(z, n, depth, centre);
        if (live && plane >= 0) v = planes[plane * args.plane_z];
        if (chirp) v = cmul(v, __ldg(chirp + z));
      }
      buf0[z * cols + c] = v;
    }
    __syncthreads();
    C* ft = chirp ? convolve(buf0, buf1, tw, plan, passes, len, filter, cols,
                             threads, j, c)
                  : fft_shared<false>(buf0, buf1, tw, plan, passes, len,
                                      cols, threads, j, c);
    C* other = ft == buf0 ? buf1 : buf0;
    // each thread multiplies the points it staged itself
    asm volatile("cp.async.wait_all;" ::: "memory");
    for (int z = j; z < len; z += threads) {
      C v{0, 0};
      if (z < n) {
        v = ft[z * cols + c];
        if (chirp) v = cmul(v, __ldg(chirp + z));
        v = cmul(v, staged[z * cols + c]);
        if (chirp) v = cmul(conj(v), __ldg(chirp + z));
      }
      ft[z * cols + c] = v;
    }
    __syncthreads();
    const C* result =
        chirp ? convolve(ft, other, tw, plan, passes, len, filter, cols,
                         threads, j, c)
              : fft_shared<true>(ft, other, tw, plan, passes, len, cols,
                                 threads, j, c);
    C* out = static_cast<C*>(args.out[s]) + at;
    if (live) {
      for (int z = j; z < n; z += threads) {
        C v = result[z * cols + c];
        if (chirp) v = conj(cmul(v, __ldg(chirp + z)));
        __stcs(out + z * args.z_stride, v);
      }
    }
    __syncthreads();
  }
}

template <typename Real, int kSpectra>
int launch_shared(Args args, int width, cudaStream_t stream) {
  constexpr int size = static_cast<int>(sizeof(Complex<Real>));
  const int n = args.points;
  int len = n;
  if (args.chirp != nullptr) {
    for (len = 1; len < 2 * n - 1;) len *= 2;
  }
  args.length = len;
  args.passes = radix_plan(len, args.radices);
  if (args.passes < 0) return static_cast<int>(cudaErrorInvalidValue);
  // whole 128-byte lines of y where the budget allows, whole 32-byte
  // sectors where the card does
  auto shared = [&](int cols) { return size * (len + (2 * len + n) * cols); };
  const int threads = (len + kPoints - 1) / kPoints;
  int cols = kColumns<Real>;
  while (cols > 1 && cols * threads > kMaxThreads) cols /= 2;
  while (cols > 32 / size && shared(cols) > kBudget) cols /= 2;
  while (cols > 1 && shared(cols) > kMaxShared) cols /= 2;
  if (shared(cols) > kMaxShared || cols * threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  args.cols = cols;
  args.threads = threads;
  args.tiles = (args.height + cols - 1) / cols;
  const long long blocks = static_cast<long long>(args.tiles) * width;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = match_zpass_shared_kernel<Real, kSpectra>;
  const int smem = shared(cols);
  if (smem > 48 * 1024) {
    const cudaError_t code = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (code != cudaSuccess) return static_cast<int>(code);
  }
  kernel<<<static_cast<unsigned>(blocks), cols * threads, smem, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_s = ifft_z(fft_z(columns) * spectrum_s), unnormalised, for s < 2 where
// spectrum1 is not null (then complex128), else s = 0 (then complex64).
// The columns are N points along z (1 <= N <= kMaxPoints), zero but on the
// planes' z window: planes (depth, Y, X') at z = p for p <= centre and at
// z = p + N - depth after it (depth <= N, centre < depth), as
// models/matching.py::_window places them.  A power of two from 2^kMinLog2
// to 2^kMaxLog2 takes the register design, any other N the shared-memory
// design, through Bluestein's convolution where chirp is not null: then
// chirp holds exp(-i pi (z^2 mod 2N) / N) for z < N, then the spectrum of
// the filter (conj of it at z and L - z, z < N, 0 between) divided by L,
// for the power of two L >= 2N - 1, in the spectra's dtype.  Strides in
// elements, each tensor's element 8 (complex64) or 16 (complex128) bytes
// aligned.  Returns a cudaError_t.
extern "C" int match_zpass_launch(
    const void* planes, long long plane_z, long long plane_y,
    long long plane_x, const void* spectrum0, const void* spectrum1,
    void* out0, void* out1, long long z_stride, long long y_stride,
    long long x_stride, int points, int depth, int centre, int height,
    int width, const void* chirp, void* stream) {
  const bool wide = spectrum1 != nullptr;
  if (points < 1 || points > kMaxPoints || depth < 1 || depth > points ||
      centre < 0 || centre >= depth || height < 1 || width < 1 ||
      planes == nullptr || spectrum0 == nullptr || out0 == nullptr ||
      (wide && out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{planes, plane_z, plane_y, plane_x, {spectrum0, spectrum1},
            {out0, out1}, z_stride, y_stride, x_stride, depth, centre,
            height, 0, points, chirp};
  const auto s = static_cast<cudaStream_t>(stream);
  // the status returned is this launch's, not one an earlier call left
  (void)cudaGetLastError();
  int log2n = 0;
  while ((1 << log2n) < points) ++log2n;
  if ((1 << log2n) == points && log2n >= kMinLog2 && log2n <= kMaxLog2 &&
      chirp == nullptr) {
    const int cols = wide ? kColumns<double> : kColumns<float>;
    args.tiles = (height + cols - 1) / cols;
    const long long blocks = static_cast<long long>(args.tiles) * width;
    if (blocks > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return wide ? launch_n<double, 2>(log2n, args, blocks, s)
                : launch_n<float, 1>(log2n, args, blocks, s);
  }
  return wide ? launch_shared<double, 2>(args, width, s)
              : launch_shared<float, 1>(args, width, s);
}

extern "C" const char* match_zpass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
