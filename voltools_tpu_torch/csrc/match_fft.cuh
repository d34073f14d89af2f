// Template matching's FFTs along one axis of a CTA's columns, shared by
// match_zpass.cu (the spectral pass along z) and match_sigma.cu (the local
// sigma's C2R along x).  Each source includes this header in its one
// translation unit.
//
// Two designs.  The register design: a power of two N, N / kRadix threads
// a column, kRadix points a thread, Stockham's autosort in passes of radix
// kRadix (the last pass the radix left over) through a shared-memory
// exchange buffer, the last pass leaving each thread its own points in
// registers (pass, fft).  The shared-memory design: any length, Stockham
// passes of its radices (radix_plan: 16 while it divides, the power of two
// left, then its odd primes) from one shared-memory buffer to the other, a
// column's threads taking its butterflies in turn; 3, 5 and 7 as
// compile-time butterflies, a larger prime as paired direct sums
// (fft_shared), and Bluestein's convolution for a length whose prime
// factor is too large for direct sums (convolve).  Both are unnormalised:
// the forward is torch.fft.fft, the inverse ifft with norm="forward".

#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kRadix = 16;          // points a thread holds; the pass radix
constexpr int kMaxPasses = 12;      // radices of a shared-memory FFT, at most

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  return {a.x + b.x, a.y + b.y};
}

template <typename C>
__device__ __forceinline__ C csub(C a, C b) {
  return {a.x - b.x, a.y - b.y};
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}

// cos(2 pi p / 16) for p in [-8, 8]
__host__ __device__ constexpr double cos16(int p) {
  p = p < 0 ? -p : p;
  return p == 0   ? 1.0
         : p == 1 ? 0.92387953251128675613
         : p == 2 ? 0.70710678118654752440
         : p == 3 ? 0.38268343236508977173
         : p == 4 ? 0.0
         : p == 5 ? -0.38268343236508977173
         : p == 6 ? -0.70710678118654752440
         : p == 7 ? -0.92387953251128675613
                  : -1.0;
}

// a exp(-2 pi i p / 16) forward, a exp(+2 pi i p / 16) inverse, p in [0, 8)
template <int P, bool kInverse, typename C>
__device__ __forceinline__ C rotate(C a) {
  using R = decltype(a.x);
  if constexpr (P == 0) {
    return a;
  } else if constexpr (P == 4) {
    return kInverse ? C{-a.y, a.x} : C{a.y, -a.x};
  } else {
    constexpr double s = cos16(4 - P);         // sin(2 pi P / 16)
    return cmul(a, C{static_cast<R>(cos16(P)),
                     static_cast<R>(kInverse ? s : -s)});
  }
}

// One radix-2 Stockham stage over r points held in registers: butterfly t
// of the stage whose sub-transforms have ns points.
template <int r, int ns, int t, bool kInverse, typename C>
__device__ __forceinline__ void butterfly(const C (&a)[r], C (&b)[r]) {
  constexpr int k = t % ns;
  constexpr int d = (t / ns) * ns * 2 + k;
  const C x0 = a[t];
  const C x1 = rotate<k * 8 / ns, kInverse>(a[t + r / 2]);
  b[d] = cadd(x0, x1);
  b[d + ns] = csub(x0, x1);
}

template <int r, int ns, bool kInverse, typename C, int... t>
__device__ __forceinline__ void stage(const C (&a)[r], C (&b)[r],
                                      std::integer_sequence<int, t...>) {
  (butterfly<r, ns, t, kInverse>(a, b), ...);
}

// The r-point DFT of a, in place, in natural order (r a power of two, at
// most 16).
template <int r, bool kInverse, int ns = 1, typename C>
__device__ __forceinline__ void dft(C (&a)[r]) {
  if constexpr (ns < r) {
    C b[r];
    stage<r, ns, kInverse>(a, b, std::make_integer_sequence<int, r / 2>{});
#pragma unroll
    for (int i = 0; i < r; ++i) a[i] = b[i];
    dft<r, kInverse, 2 * ns>(a);
  }
}

// One Stockham pass of radix r over N points whose sub-transforms so far
// have Ns points.  Thread j holds points j + q T (T = N / kRadix) in v[q],
// and runs the pass's butterflies jj = j + m T, m < kRadix / r, whose
// inputs jj + k N / r are its own v[m + k kRadix / r].  Outputs go to
// (jj / Ns) Ns r + jj % Ns + k Ns: through the exchange buffer (element z
// of the CTA's column c at exch[z kCols + c]), or, on the last pass, where
// they are the thread's own points, straight to v.
template <typename C, int N, int r, int Ns, bool kInverse, int kCols>
__device__ __forceinline__ void pass(C (&v)[kRadix], C* exch, const C* tw,
                                     int j, int c) {
  constexpr int T = N / kRadix;
  constexpr int M = kRadix / r;
  constexpr int step = N / (Ns * r);          // twiddle index per Ns
  constexpr bool kLast = Ns * r == N;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int jj = j + m * T;
    C a[r];
#pragma unroll
    for (int k = 0; k < r; ++k) a[k] = v[m + k * M];
    if constexpr (Ns > 1) {
      const int base = (jj % Ns) * step;
#pragma unroll
      for (int k = 1; k < r; ++k) {
        C w = tw[base * k];
        if (kInverse) w.y = -w.y;
        a[k] = cmul(a[k], w);
      }
    }
    dft<r, kInverse>(a);
    if constexpr (kLast) {
#pragma unroll
      for (int k = 0; k < r; ++k) v[m + k * M] = a[k];
    } else {
      const int d = (jj / Ns) * Ns * r + jj % Ns;
#pragma unroll
      for (int k = 0; k < r; ++k) exch[(d + k * Ns) * kCols + c] = a[k];
    }
  }
  if constexpr (!kLast) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRadix; ++q) v[q] = exch[(j + q * T) * kCols + c];
    __syncthreads();
  }
}

// The N-point FFT of every column of the CTA, the thread's points in v.
template <typename C, int N, bool kInverse, int kCols, int Ns = 1>
__device__ __forceinline__ void fft(C (&v)[kRadix], C* exch, const C* tw,
                                    int j, int c) {
  constexpr int r = N / Ns >= kRadix ? kRadix : N / Ns;
  pass<C, N, r, Ns, kInverse, kCols>(v, exch, tw, j, c);
  if constexpr (Ns * r < N) {
    fft<C, N, kInverse, kCols, Ns * r>(v, exch, tw, j, c);
  }
}

// The R-point DFT of a, in place: radix-2 stages for a power of two, else
// the direct sums, with the R roots of unity from the table of N.
template <int R, bool kInverse, typename C>
__device__ __forceinline__ void small_dft(C (&a)[R], const C* tw, int n) {
  if constexpr ((R & (R - 1)) == 0) {
    dft<R, kInverse>(a);
  } else {
    C w[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      w[m] = tw[m * (n / R)];
      if (kInverse) w[m].y = -w[m].y;
    }
    C b[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      C acc = a[0];
#pragma unroll
      for (int i = 1; i < R; ++i) acc = cadd(acc, cmul(a[i], w[i * k % R]));
      b[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = b[k];
  }
}

// One Stockham pass of radix R from src to dst (element z of the CTA's
// column c at [z cols + c]) whose sub-transforms so far have ns points:
// butterfly b < N / R takes the inputs b + k N / R, twiddled by
// w_N^((b % ns) (N / (ns R)) k), and writes its DFT's output k to
// (b / ns) ns R + b % ns + k ns.  A column's threads take the butterflies
// in turn.
template <int R, bool kInverse, typename C>
__device__ __forceinline__ void radix_pass(const C* src, C* dst, const C* tw,
                                           int n, int ns, int cols,
                                           int threads, int j, int c) {
  const int m = n / R;
  const int step = m / ns;
  for (int b = j; b < m; b += threads) {
    const int q = b % ns;
    C a[R];
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = src[(b + k * m) * cols + c];
    if (ns > 1) {
#pragma unroll
      for (int k = 1; k < R; ++k) {
        C w = tw[q * step * k];
        if (kInverse) w.y = -w.y;
        a[k] = cmul(a[k], w);
      }
    }
    small_dft<R, kInverse>(a, tw, n);
    const int d = (b - q) * R + q;
#pragma unroll
    for (int k = 0; k < R; ++k) dst[(d + k * ns) * cols + c] = a[k];
  }
}

// radix_pass for an odd prime radix r above 7, known only at run time, as
// direct sums.  First each butterfly's inputs are twiddled and paired in
// place: u_i = x_i + x_{r-i} at i, v_i = x_i - x_{r-i} at r - i (0 < i <=
// h = (r - 1) / 2).  Then, with w_r^(i k) = c + i s, outputs k and r - k
// are x_0 + sum_i (c u_i +- i s v_i): a root and two points read serve
// two outputs.  A column's threads take the (butterfly, pair) items in
// turn, in both steps.
template <bool kInverse, typename C>
__device__ void prime_pass(int r, C* src, C* dst, const C* tw, int n,
                           int ns, int cols, int threads, int j, int c) {
  const int m = n / r;
  const int step = m / ns;
  const int h = (r - 1) / 2;
  const int line = m * cols;           // from input i to input i + 1
  for (int o = j; o < m * h; o += threads) {
    const int b = o / h, i = o % h + 1, q = b % ns;
    C* at = src + b * cols + c;
    C wi = tw[q * step * i];
    C wr = tw[q * step * (r - i)];
    if (kInverse) {
      wi.y = -wi.y;
      wr.y = -wr.y;
    }
    const C xi = cmul(at[i * line], wi);
    const C xr = cmul(at[(r - i) * line], wr);
    at[i * line] = cadd(xi, xr);
    at[(r - i) * line] = csub(xi, xr);
  }
  __syncthreads();
  for (int o = j; o < m * (h + 1); o += threads) {
    const int b = o / (h + 1), k = o % (h + 1), q = b % ns;
    const C* at = src + b * cols + c;
    C* to = dst + ((b - q) * r + q) * cols + c;
    C plus = at[0];
    C minus = plus;
    int root = 0;                      // i k m mod N
    for (int i = 1; i <= h; ++i) {
      root += k * m;
      if (root >= n) root -= n;
      const C w = tw[root];
      const decltype(w.x) s = kInverse ? -w.y : w.y;
      const C u = at[i * line];
      const C v = at[(r - i) * line];
      const C cu{w.x * u.x, w.x * u.y};
      const C sv{-s * v.y, s * v.x};
      plus = cadd(plus, cadd(cu, sv));
      minus = cadd(minus, csub(cu, sv));
    }
    to[k * ns * cols] = plus;
    if (k > 0) to[(r - k) * ns * cols] = minus;
  }
}

// The L-point FFT of each of the CTA's columns, from src through the
// passes of plan (powers of two up to kTop), ping-ponging between src and
// dst; returns the buffer that holds the result.  Every pass ends in a
// barrier.
template <bool kInverse, int kTop = 16, typename C>
__device__ __forceinline__ C* fft_shared(C* src, C* dst, const C* tw,
                                         const int* plan, int passes, int len,
                                         int cols, int threads, int j,
                                         int c) {
  int ns = 1;
  for (int p = 0; p < passes; ++p) {
    const int r = plan[p];
    switch (r) {
      case 16:
        if constexpr (kTop >= 16) {
          radix_pass<16, kInverse>(src, dst, tw, len, ns, cols, threads, j,
                                   c);
        }
        break;
      case 8:
        if constexpr (kTop >= 8) {
          radix_pass<8, kInverse>(src, dst, tw, len, ns, cols, threads, j,
                                  c);
        }
        break;
      case 4:
        radix_pass<4, kInverse>(src, dst, tw, len, ns, cols, threads, j, c);
        break;
      case 2:
        radix_pass<2, kInverse>(src, dst, tw, len, ns, cols, threads, j, c);
        break;
      case 3:
        radix_pass<3, kInverse>(src, dst, tw, len, ns, cols, threads, j, c);
        break;
      case 5:
        radix_pass<5, kInverse>(src, dst, tw, len, ns, cols, threads, j, c);
        break;
      case 7:
        radix_pass<7, kInverse>(src, dst, tw, len, ns, cols, threads, j, c);
        break;
      default:
        prime_pass<kInverse>(r, src, dst, tw, len, ns, cols, threads, j, c);
    }
    __syncthreads();
    C* t = src;
    src = dst;
    dst = t;
    ns *= r;
  }
  return src;
}

// Bluestein's circular convolution of each column of a (L points) with
// the chirp's filter: FFT, the product with the filter's spectrum (over L,
// so the unnormalised inverse divides by L), inverse FFT.
template <int kTop = 16, typename C>
__device__ __forceinline__ C* convolve(C* a, C* other, const C* tw,
                                       const int* plan, int passes, int len,
                                       const C* filter, int cols,
                                       int threads, int j, int c) {
  C* f = fft_shared<false, kTop>(a, other, tw, plan, passes, len, cols,
                                 threads, j, c);
  C* g = f == a ? other : a;
  for (int z = j; z < len; z += threads) {
    f[z * cols + c] = cmul(f[z * cols + c], __ldg(filter + z));
  }
  __syncthreads();
  return fft_shared<true, kTop>(f, g, tw, plan, passes, len, cols, threads,
                                j, c);
}

template <typename C>
__device__ __forceinline__ C conj(C a) {
  return {a.x, -a.y};
}

template <typename C>
__device__ __forceinline__ void stage_async(C* to, const C* from) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(to));
  if constexpr (sizeof(C) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(at), "l"(from));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(at), "l"(from));
  }
}

// The radices of n, largest powers of two first (top while it divides,
// then the power of two left), then its odd primes ascending; their count,
// or -1 past kMaxPasses.
int radix_plan(int n, int* radices, int top = 16) {
  int passes = 0;
  auto add = [&](int r) {
    if (passes < kMaxPasses) radices[passes] = r;
    ++passes;
    n /= r;
  };
  while (n % top == 0) add(top);
  for (int r = top / 2; r >= 2; r /= 2) {
    if (n % r == 0) add(r);
  }
  for (int f = 3; n > 1; f += 2) {
    while (n % f == 0) add(f);
  }
  return passes <= kMaxPasses ? passes : -1;
}

}  // namespace
