// Masked mean of client updates for DiverseFL Step 5 (Eq. 6).
//
// Replaces the TPU kernel src/repro/kernels/masked_agg.py:84
// `masked_agg_kernel` (Pallas).  For the (N, D) update matrix U and
// an (N,) weight vector w (the bool keep mask, or fp32 weights) it
// computes, per column c,
//
//     s_c = acc_c + sum_i w_i * U[i, c]      (i = 0 .. N-1, in client order)
//     out_c = normalize ? s_c / max(sum_i w_i, 1) : s_c
//
// With w the 0/1 keep mask and normalize = 1 this is Eq. 6, and an empty
// mask gives exactly 0.  The kernel reads the bool mask itself, so Eq. 6
// is one launch.  The optional accumulator `acc` (nullptr = 0) with fp32
// weights and normalize = 0 is the weighted fold acc + sum_i w_i u_i that
// the TPU's `masked_agg_update_kernel` (src/repro/kernels/masked_agg.py:47)
// computes; the wrapper masked_agg_update_cuda launches it so for
// FLTrust and for the streaming fold of an fp32 or bf16 client block.
// `out` must not alias `acc` or `u` (both are __restrict__): that wrapper
// writes a fresh buffer instead of updating acc in place.
//
// U is fp32, or bf16 (the bf16 uplink's payload).  A bf16 element is
// widened with __bfloat162float, which is exact, so folding a bf16 block
// is bit for bit folding its fp32 decode, as the TPU kernel's in-kernel
// cast does.
//
// Bound: HBM bytes.  U is read once (N*D*4 bytes, N*D*2 in bf16), the
// output written once; 2 flops per element of U.
//
// Design: one thread per output column.  Each thread walks the clients in
// order, so reads along D are coalesced, there are no atomics, and the
// result is deterministic: for 0/1 weights it is bit for bit the strict
// left fold of core/diversefl.masked_sum_fold followed by one division.
// Every thread also sums the weights in the same order (w is a broadcast
// read that stays in L1), which avoids a separate pass for the
// denominator.
//
// Left for a later PR: at the paper's D = 7,850 the grid has only 31
// blocks of 256 threads, so most SMs idle.  At N = 23 the call is
// launch-bound anyway, but a deep client axis (N = 1,024) makes each
// thread walk 1,024 rows in sequence, far from the byte bound.  Smaller
// blocks and float4 columns would spread D over more SMs; splitting the
// client loop over blocks would need a second fixed-order pass to stay
// deterministic.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float weight(bool m) { return m ? 1.f : 0.f; }
__device__ __forceinline__ float weight(float w) { return w; }

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename U, typename W>
__global__ void __launch_bounds__(kThreads)
    masked_agg_kernel(const U* __restrict__ u, const W* __restrict__ w,
                      const float* __restrict__ acc, float* __restrict__ out,
                      int64_t n, int64_t d, int normalize) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = acc != nullptr ? acc[c] : 0.f;
  float total = 0.f;
#pragma unroll 4
  for (int64_t i = 0; i < n; ++i) {
    const float wi = weight(w[i]);
    s = fmaf(load(u + i * d + c), wi, s);
    total += wi;
  }
  if (normalize) s /= fmaxf(total, 1.f);
  out[c] = s;
}

template <typename U>
void launch(const U* u, const void* w, int w_is_bool, const float* acc,
            float* out, int64_t n, int64_t d, int normalize,
            cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((d + kThreads - 1) / kThreads);
  if (w_is_bool) {
    masked_agg_kernel<<<blocks, kThreads, 0, stream>>>(
        u, static_cast<const bool*>(w), acc, out, n, d, normalize);
  } else {
    masked_agg_kernel<<<blocks, kThreads, 0, stream>>>(
        u, static_cast<const float*>(w), acc, out, n, d, normalize);
  }
}

}  // namespace

extern "C" {

// u: (n, d) fp32 (u_is_bf16 = 0) or bf16 (u_is_bf16 = 1) contiguous; w: (n,)
// bool (w_is_bool = 1) or fp32 (w_is_bool = 0); acc: (d,) fp32 or nullptr;
// out: (d,) fp32.  Launches on `stream` and returns cudaGetLastError() (0
// on success).
int masked_agg_fold(const void* u, int u_is_bf16, const void* w,
                    int w_is_bool, const void* acc, void* out, int64_t n,
                    int64_t d, int normalize, void* stream) {
  if (d > 0) {
    const float* af = static_cast<const float*>(acc);
    float* of = static_cast<float*>(out);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (u_is_bf16) {
      launch(static_cast<const __nv_bfloat16*>(u), w, w_is_bool, af, of, n,
             d, normalize, st);
    } else {
      launch(static_cast<const float*>(u), w, w_is_bool, af, of, n, d,
             normalize, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* masked_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
