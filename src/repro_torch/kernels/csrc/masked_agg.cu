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
// output written once; 2 flops per element of U.  At the paper's
// (23, 7850) that is 0.72 MB, 0.23 us at 3.35 TB/s: the call is as long as
// the HBM latencies it waits through in sequence, plus the launch.
//
// Design: one thread per output column.  Each thread walks the clients in
// register chunks of R rows: it issues a chunk's loads (predicated at the
// ragged end of N) before any of its FMAs, so one HBM latency covers R
// clients.  Above N = 8, R = 32 in blocks of 128 threads (the 7,850
// columns of S1 spread over 62 blocks, and N = 23 takes one latency);
// each block reads the (N,) weights (bool mask or fp32) into shared
// memory as fp32, at most kWChunk clients at a time, while the first
// chunk's loads are in flight.  Up to N = 8 (a streamed block), R = 8 in
// blocks of 256 threads with the weights in registers: a thread has only
// N loads to keep in flight, so what counts is how many threads an SM
// holds, and the 32-row chunk's registers would halve that.  The
// arithmetic keeps the client order, s = fmaf(u_i, w_i, s) and total +=
// w_i for i = 0 .. N-1, then one division: reads along D are coalesced,
// there are no atomics, and for 0/1 weights the result is bit for bit the
// strict left fold of core/diversefl.masked_sum_fold followed by one
// division (the loads may be reordered; the arithmetic is not).
//
// Left for a later PR: a deep client axis (N = 1,024) still walks every
// row in one thread, one chunk's latency at a time, with few threads in
// flight; staging row chunks through shared memory with cp.async would
// keep more bytes in flight, and splitting the client loop over blocks
// would need a second fixed-order pass to stay deterministic.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWChunk = 1024;    // weights held in shared memory at a time

// columns a block for a register chunk of R rows
__host__ __device__ constexpr int block_threads(int r) {
  return r <= 8 ? 256 : 128;
}

__device__ __forceinline__ float weight(bool m) { return m ? 1.f : 0.f; }
__device__ __forceinline__ float weight(float w) { return w; }

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// rows j0 .. j0 + R - 1 of column c (0 past `rows` or for a dead thread)
template <int R, typename U>
__device__ __forceinline__ void load_rows(float (&x)[R], const U* u,
                                          int64_t d, int64_t c, int j0,
                                          int rows, bool live) {
#pragma unroll
  for (int j = 0; j < R; ++j)
    x[j] = live && j0 + j < rows ? load(u + (j0 + j) * d + c) : 0.f;
}

// R: client rows a thread loads before its FMAs
template <int R, typename U, typename W>
__global__ void __launch_bounds__(block_threads(R))
    masked_agg_kernel(const U* __restrict__ u, const W* __restrict__ w,
                      const float* __restrict__ acc, float* __restrict__ out,
                      int64_t n, int64_t d, int normalize) {
  constexpr int kThreads = block_threads(R);
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = c < d;
  float s = live && acc != nullptr ? acc[c] : 0.f;
  float total = 0.f;
  if constexpr (R <= 8) {   // n <= R: one chunk, its weights in registers
    float x[R], wr[R];
    const int m = static_cast<int>(n);
    load_rows(x, u, d, c, 0, m, live);
#pragma unroll
    for (int j = 0; j < R; ++j) wr[j] = j < m ? weight(w[j]) : 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < m) {
        s = fmaf(x[j], wr[j], s);
        total += wr[j];
      }
    }
  } else {
    __shared__ float ws[kWChunk];
    for (int64_t i0 = 0; i0 < n; i0 += kWChunk) {
      const int m = n - i0 < kWChunk ? static_cast<int>(n - i0) : kWChunk;
      const U* ui = u + i0 * d;
      float x[R];
      load_rows(x, ui, d, c, 0, m, live);   // in flight with the weights
      if (i0 > 0) __syncthreads();         // the previous chunk is consumed
      for (int i = threadIdx.x; i < m; i += kThreads)
        ws[i] = weight(w[i0 + i]);
      __syncthreads();
      for (int j0 = 0; j0 < m; j0 += R) {
        if (j0 > 0) load_rows(x, ui, d, c, j0, m, live);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (j0 + j < m) {
            const float wi = ws[j0 + j];
            s = fmaf(x[j], wi, s);
            total += wi;
          }
        }
      }
    }
  }
  if (!live) return;
  if (normalize) s /= fmaxf(total, 1.f);
  out[c] = s;
}

template <int R, typename U>
void launch(const U* u, const void* w, int w_is_bool, const float* acc,
            float* out, int64_t n, int64_t d, int normalize,
            cudaStream_t stream) {
  constexpr int kThreads = block_threads(R);
  const unsigned int blocks =
      static_cast<unsigned int>((d + kThreads - 1) / kThreads);
  if (w_is_bool) {
    masked_agg_kernel<R><<<blocks, kThreads, 0, stream>>>(
        u, static_cast<const bool*>(w), acc, out, n, d, normalize);
  } else {
    masked_agg_kernel<R><<<blocks, kThreads, 0, stream>>>(
        u, static_cast<const float*>(w), acc, out, n, d, normalize);
  }
}

// the register chunk from N (see the design note)
template <typename U>
void launch(const U* u, const void* w, int w_is_bool, const float* acc,
            float* out, int64_t n, int64_t d, int normalize,
            cudaStream_t stream) {
  if (n <= 8)
    launch<8>(u, w, w_is_bool, acc, out, n, d, normalize, stream);
  else
    launch<32>(u, w, w_is_bool, acc, out, n, d, normalize, stream);
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
