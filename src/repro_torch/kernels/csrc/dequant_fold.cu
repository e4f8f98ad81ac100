// Fused dequantize-and-fold of an int8 client block for the streaming
// aggregation (the compressed uplink's server side).
//
// Replaces the TPU kernel src/repro/kernels/dequant_fold.py:40
// `dequant_fold_update_kernel` (Pallas).  For an int8 payload Q (n, D),
// row-major, its per-block fp32 scales S (n, nb) with nb = ceil(D / qblock),
// fp32 weights w (n,) and the carried fp32 accumulator acc (D,) it writes,
// per column c,
//
//     t_i   = q[i, c] * S[i, c / qblock]          (exactly rounded product)
//     out_c = acc_c + sum_i w_i * t_i             (i = 0 .. n-1, in order)
//
// `t_i` is computed with __fmul_rn, which nvcc never contracts into the
// following fma, so it is bit for bit the decoded value of the port's one
// decode definition (kernels/dequant_fold.dequant_int8: q * scale in fp32).
// Each step of the client loop is then one fmaf(t_i, w_i, s), the same
// step masked_agg.cu takes on a decoded fp32 block: with 0/1 weights the
// fold is bitwise the dense lossy path (decode, then the masked mean).
// The last scale block may be partial; the column index picks its block,
// so nothing is padded.  `out` must not alias `acc` (both __restrict__):
// the wrapper writes a new buffer.
//
// Bound: HBM bytes.  Q is read once (n*D bytes), the scales once
// (4*n*nb), acc read and out written once (8*D); 3 operations per element
// of Q, about 3 per byte, far below what would make fp32 arithmetic the
// limit.
//
// Design: one thread per output column walks the clients in order, so
// reads along D are coalesced, there are no atomics and two launches give
// identical bits.  The scale and weight reads are broadcasts within a
// block (qblock = 128 columns share one scale) and stay in L1.
//
// Left for a later PR: one byte per thread per client makes each warp's
// load 32 B, a quarter of a 128 B line per request; four columns per
// thread (char4) and splitting the client loop over blocks with a
// fixed-order second pass would move more bytes per request.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dequant_fold_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        const float* __restrict__ w,
                        const float* __restrict__ acc,
                        float* __restrict__ out, int64_t n, int64_t d,
                        int64_t nb, int64_t qblock) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  const int64_t blk = c / qblock;
  float s = acc[c];
#pragma unroll 4
  for (int64_t i = 0; i < n; ++i) {
    const float t = __fmul_rn(static_cast<float>(__ldg(q + i * d + c)),
                              __ldg(scale + i * nb + blk));
    s = fmaf(t, __ldg(w + i), s);
  }
  out[c] = s;
}

}  // namespace

extern "C" {

// q: (n, d) int8; scale: (n, nb) fp32; w: (n,) fp32; acc, out: (d,) fp32;
// all contiguous.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int dequant_fold_f32(const void* q, const void* scale, const void* w,
                     const void* acc, void* out, int64_t n, int64_t d,
                     int64_t nb, int64_t qblock, void* stream) {
  if (d > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((d + kThreads - 1) / kThreads);
    dequant_fold_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<const float*>(w), static_cast<const float*>(acc),
        static_cast<float*>(out), n, d, nb, qblock);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dequant_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
