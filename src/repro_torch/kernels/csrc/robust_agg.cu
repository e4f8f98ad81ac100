// Coordinate-wise median and trimmed mean of client updates (the Median
// [Yin et al.] and Bulyan-trimmed [El Mhamdi et al.] baselines).
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py:55
// `robust_agg_kernel` (Pallas).  For the (N, D) fp32 update matrix U and
// a Byzantine budget f it writes, per column c,
//
//     med_c  = the median of U[:, c]  (the mean of the two middle values
//              for even N)
//     trim_c = the mean of the U[i, c] with |U[i, c] - med_c| <= t_c,
//              where t_c is the (N - 2f)-th smallest of those distances
//              (ties are admitted; the mean divides by the actual count)
//
// which is what src/repro/kernels/ref.py's median_ref and trimmed_ref
// compute.  N <= 64 (the TPU kernel's own limit); the wrapper refuses
// more.  Inputs are finite: NaN ordering is not matched (fminf/fmaxf
// drop a NaN where a sort would place it last).
//
// Bound: bytes.  Any implementation reads U once (N D 4 bytes) and writes
// two (D,) vectors; at (23, 199210) that is 19.9 MB, 5.95 us at 3.35 TB/s.
// The operations depend on the algorithm (a sorting network's size), so
// the bound does not count them.
//
// Design: one thread per column holds the column in registers, padded
// with +inf to the bucket P (8, 16, 24, 32, 48 or 64 >= N), so the warp's
// loads are coalesced along D and no thread waits on another.  Batcher's
// odd-even merge sort for P elements (Knuth's merge exchange; 132
// compare-swaps at P = 24, 191 at 32, against the 253 of the odd-even
// transposition network at N = 23) sorts it with every index a
// compile-time constant: the comparator list is built by a constexpr
// function and unrolled by a fold, so the column never leaves registers.
// The pads stay at the end (a compare-swap against +inf never moves it).
// No second sort: in the sorted column s the distances |s_a - m| fall,
// then rise (fp32 subtraction is monotone and m - s = -(s - m) exactly),
// so the keep_n nearest values form a contiguous window and
//
//     t = min over a of max(m - s[a], s[a + keep_n - 1] - m)
//
// is exactly the keep_n-th smallest distance, the reference's threshold
// (a window that runs past N meets a +inf pad and drops out).  N and
// keep_n are run-time values but the same in every thread, so the middle
// pair and the window walk sit behind switches whose cases index the
// column with constants.  The admitted values, ties included, are the
// run of s within [m - t, m + t], summed from the registers in sorted
// order; U is read once.  One wave of blocks walks the columns a grid
// apart, each thread loading its next column while it sorts this one, so
// HBM streams under the sorting.  No atomics: two launches give identical
// bits.
//
// The first kernel (the column staged in shared memory, sorted twice
// by an odd-even transposition network, U read a second time for the
// trimmed sum) stays below as robust_agg_f32_v1, a reference that the
// on-card check holds the median to, bit for bit, and times beside this
// one; no path calls it.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxPairs = 543;   // Batcher's network at 64 elements
// columns a thread walks where D fills the card: its next column's loads
// run under this one's sort, and the first column's (the only ones with
// nothing to hide under) are a quarter of the bytes
constexpr int kColsPerThread = 4;

// Batcher's odd-even merge sort for n elements, comparator by comparator:
// for p = 1, 2, 4, ...; k = p, p/2, ..., 1; j = k mod p, j + 2k, ... up to
// n - 1 - k; i = 0 .. min(k - 1, n - j - k - 1): compare (i + j, i + j + k)
// when both lie in one block of 2p.
struct Net {
  int a[kMaxPairs];
  int b[kMaxPairs];
  int count;
};

__host__ __device__ constexpr Net make_net(int n) {
  Net net{};
  for (int p = 1; p < n; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j <= n - 1 - k; j += 2 * k)
        for (int i = 0; i <= k - 1 && i <= n - j - k - 1; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.a[net.count] = i + j;
            net.b[net.count] = i + j + k;
            ++net.count;
          }
  return net;
}

template <int P>
struct Network {
  static constexpr Net net = make_net(P);
  static constexpr int count = net.count;
};

template <int P, int K>
struct Pair {
  static constexpr int a = Network<P>::net.a[K];
  static constexpr int b = Network<P>::net.b[K];
};

__device__ __forceinline__ void cswap(float& x, float& y) {
  const float lo = fminf(x, y);
  y = fmaxf(x, y);
  x = lo;
}

template <int P, int... K>
__device__ __forceinline__ void sort_pairs(float (&s)[P],
                                           std::integer_sequence<int, K...>) {
  (cswap(s[Pair<P, K>::a], s[Pair<P, K>::b]), ...);
}

// the least N of bucket P (the bucket below holds fewer): rows below it
// are always loaded, with no run-time test
__host__ __device__ constexpr int bucket_floor(int p) {
  return p <= 8 ? 1 : p <= 16 ? 9 : p <= 24 ? 17 : p <= 32 ? 25
                    : p <= 48 ? 33 : 49;
}

// column c of u (n values, +inf pads to P), one pointer step a row;
// nothing is read past D
template <int P>
__device__ __forceinline__ void load_column(float (&s)[P], const float* u,
                                            int n, int64_t d, int64_t c) {
  if (c < d) {
    const float* p = u + c;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      s[i] = i < bucket_floor(P) || i < n ? __ldg(p) : INFINITY;
      p += d;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) s[i] = INFINITY;
  }
}

// min over windows [a, a + K) of the sorted column of the window's
// largest distance to m, read off its two ends
template <int P, int K>
__device__ __forceinline__ float window_threshold(const float (&s)[P],
                                                  float m) {
  float t = INFINITY;
#pragma unroll
  for (int a = 0; a + K - 1 < P; ++a)
    t = fminf(t, fmaxf(m - s[a], s[a + K - 1] - m));
  return t;
}

// switches on a run-time value that is the same in every thread, each
// case with constant indices, so the column stays in registers
#define ROBUST_MID(k)              \
  case k:                          \
    if constexpr (k < P) {         \
      lo = s[k > 0 ? k - 1 : 0];   \
      hi = s[k];                   \
    }                              \
    break;
#define ROBUST_MID8(b)                                                \
  ROBUST_MID(b) ROBUST_MID(b + 1) ROBUST_MID(b + 2) ROBUST_MID(b + 3) \
  ROBUST_MID(b + 4) ROBUST_MID(b + 5) ROBUST_MID(b + 6) ROBUST_MID(b + 7)
#define ROBUST_WIN(k)                                       \
  case k:                                                   \
    if constexpr (k <= P) t = window_threshold<P, k>(s, m); \
    break;
#define ROBUST_WIN8(b)                                                    \
  ROBUST_WIN(b + 1) ROBUST_WIN(b + 2) ROBUST_WIN(b + 3) ROBUST_WIN(b + 4) \
  ROBUST_WIN(b + 5) ROBUST_WIN(b + 6) ROBUST_WIN(b + 7) ROBUST_WIN(b + 8)

template <int P>
__global__ void __launch_bounds__(kThreads)
    robust_agg_kernel(const float* __restrict__ u, float* __restrict__ med,
                      float* __restrict__ trim, int n, int64_t d,
                      int keep_n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float next[P];
  load_column(next, u, n, d, c);
  for (; c < d; c += step) {
    float s[P];
#pragma unroll
    for (int i = 0; i < P; ++i) s[i] = next[i];
    load_column(next, u, n, d, c + step);   // in flight under this sort
    sort_pairs(s, std::make_integer_sequence<int, Network<P>::count>{});

    float lo = s[0], hi = s[0];
    switch (n >> 1) {
      ROBUST_MID8(0) ROBUST_MID8(8) ROBUST_MID8(16) ROBUST_MID8(24)
      ROBUST_MID(32)
    }
    const float m = (n & 1) ? hi : 0.5f * (lo + hi);
    float t = INFINITY;
    switch (keep_n) {
      ROBUST_WIN8(0) ROBUST_WIN8(8) ROBUST_WIN8(16) ROBUST_WIN8(24)
      ROBUST_WIN8(32) ROBUST_WIN8(40) ROBUST_WIN8(48) ROBUST_WIN8(56)
    }

    float sum = 0.f, count = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (fabsf(s[i] - m) <= t) {
        sum += s[i];
        count += 1.f;
      }
    med[c] = m;
    trim[c] = sum / fmaxf(count, 1.f);
  }
}

#undef ROBUST_MID8
#undef ROBUST_MID
#undef ROBUST_WIN8
#undef ROBUST_WIN

// `blocks` blocks (<= 0: kColsPerThread columns a thread where D fills
// the card, one otherwise), at most one wave (as many as fit the card at
// once), each thread walking columns a grid apart
template <int P>
int launch(const float* u, float* med, float* trim, int n, int64_t d,
           int keep_n, int blocks, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, robust_agg_kernel<P>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (d + kThreads - 1) / kThreads;
  int64_t grid = blocks > 0 ? blocks
                            : std::max<int64_t>(
                                  sms, (needed + kColsPerThread - 1) /
                                           kColsPerThread);
  grid = std::min<int64_t>({grid, static_cast<int64_t>(sms) * per_sm,
                            needed});
  robust_agg_kernel<P><<<static_cast<unsigned int>(grid), kThreads, 0,
                         stream>>>(u, med, trim, n, d, keep_n);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------
// The first kernel, kept as a reference for the on-card check: one
// thread per column stages it in shared memory as smem[i * kThreads +
// tid], sorts it with an odd-even transposition network of N passes,
// overwrites it with |s - med|, sorts again for t = ds[keep_n - 1] and
// re-reads U (from L2) in client order for the trimmed sum.
// ----------------------------------------------------------------------
namespace v1 {

// odd-even transposition sort of one column held at s[i * kThreads]
__device__ __forceinline__ void oddeven_sort(float* s, int n) {
  for (int it = 0; it < n; ++it) {
    for (int i = it & 1; i + 1 < n; i += 2) {
      const float a = s[i * kThreads];
      const float b = s[(i + 1) * kThreads];
      s[i * kThreads] = fminf(a, b);
      s[(i + 1) * kThreads] = fmaxf(a, b);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    robust_agg_kernel(const float* __restrict__ u, float* __restrict__ med,
                      float* __restrict__ trim, int n, int64_t d,
                      int keep_n) {
  __shared__ float buf[kMaxN * kThreads];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  float* s = buf + threadIdx.x;
  for (int i = 0; i < n; ++i) s[i * kThreads] = __ldg(u + i * d + c);
  oddeven_sort(s, n);
  const int h = n / 2;
  const float m = (n & 1) ? s[h * kThreads]
                          : 0.5f * (s[(h - 1) * kThreads] + s[h * kThreads]);
  for (int i = 0; i < n; ++i) s[i * kThreads] = fabsf(s[i * kThreads] - m);
  oddeven_sort(s, n);
  const float t = s[(keep_n - 1) * kThreads];
  float sum = 0.f, count = 0.f;
  for (int i = 0; i < n; ++i) {
    const float v = __ldg(u + i * d + c);
    if (fabsf(v - m) <= t) {
      sum += v;
      count += 1.f;
    }
  }
  med[c] = m;
  trim[c] = sum / fmaxf(count, 1.f);
}

}  // namespace v1

}  // namespace

extern "C" {

// u: (n, d) fp32 contiguous, 1 <= n <= 64; med, trim: (d,) fp32;
// 1 <= keep_n <= n; blocks: the grid (<= 0: one full wave of the card).
// Launches on `stream` and returns the CUDA error (0 on success); a bad n
// or keep_n returns cudaErrorInvalidValue.
int robust_agg_f32(const void* u, void* med, void* trim, int n, int64_t d,
                   int keep_n, int blocks, void* stream) {
  if (n < 1 || n > kMaxN || keep_n < 1 || keep_n > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* uu = static_cast<const float*>(u);
  auto* mm = static_cast<float*>(med);
  auto* tt = static_cast<float*>(trim);
  auto st = static_cast<cudaStream_t>(stream);
  if (n <= 8) return launch<8>(uu, mm, tt, n, d, keep_n, blocks, st);
  if (n <= 16) return launch<16>(uu, mm, tt, n, d, keep_n, blocks, st);
  if (n <= 24) return launch<24>(uu, mm, tt, n, d, keep_n, blocks, st);
  if (n <= 32) return launch<32>(uu, mm, tt, n, d, keep_n, blocks, st);
  if (n <= 48) return launch<48>(uu, mm, tt, n, d, keep_n, blocks, st);
  return launch<64>(uu, mm, tt, n, d, keep_n, blocks, st);
}

// The first kernel, the same arguments and result
int robust_agg_f32_v1(const void* u, void* med, void* trim, int n, int64_t d,
                      int keep_n, void* stream) {
  if (n < 1 || n > kMaxN || keep_n < 1 || keep_n > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((d + kThreads - 1) / kThreads);
    v1::robust_agg_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<float*>(med),
        static_cast<float*>(trim), n, d, keep_n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* robust_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
