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
// Bound: at N = 23 the HBM bytes (N*D*4 read, 2*D*4 written) and the
// compare-swaps of the two odd-even networks (2*N*floor(N/2) per column,
// two operations each) give similar times; the network's shared-memory
// traffic (four accesses per compare-swap) is what this simple design
// actually waits on.
//
// Design: one thread per column walks that column's N values in order,
// so the loads of a warp are coalesced along D and no thread depends on
// another.  The column is staged in shared memory as
// smem[i * kThreads + tid], so the 32 threads of a warp touch 32
// consecutive words (no bank conflicts); N <= 64 at 128 threads is
// 32 KB, under the 48 KB of static shared memory.  An odd-even
// transposition network of N passes sorts it; the median is read off the
// middle.  The buffer is then overwritten with |s - med|, which has the
// same multiset as |u - med|, sorted again, and t = ds[keep_n - 1].  A
// last pass re-reads U (from L2) in client order and sums the admitted
// values.  No atomics: two launches give identical bits.
//
// Left for a later PR: the network moves every value through shared
// memory twice per pass.  Keeping the column in registers (a network
// unrolled for a padded N of 32 or 64) would take the shared memory out.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;

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

}  // namespace

extern "C" {

// u: (n, d) fp32 contiguous, 1 <= n <= 64; med, trim: (d,) fp32;
// 1 <= keep_n <= n.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); a bad n or keep_n returns cudaErrorInvalidValue.
int robust_agg_f32(const void* u, void* med, void* trim, int n, int64_t d,
                   int keep_n, void* stream) {
  if (n < 1 || n > kMaxN || keep_n < 1 || keep_n > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((d + kThreads - 1) / kThreads);
    robust_agg_kernel<<<blocks, kThreads, 0,
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
