// Per-client similarity statistics for DiverseFL Step 4.
//
// Replaces the TPU kernel src/repro/kernels/similarity.py:44
// `similarity_kernel` (Pallas).  For every client row j of the stacked
// update matrix Z and guide matrix G (both (N, D) fp32, row-major,
// contiguous) it writes out[j] = [z_j . g_j, |z_j|^2, |g_j|^2] in fp32.
//
// Bound: HBM bytes.  The kernel reads each operand once (2*N*D*4 bytes)
// and does 6 flops per element pair, about 0.75 flop/byte, far below the
// ~20 flop/byte at which fp32 arithmetic on the H100 would be the limit.
//
// Design: one block per client row.  Threads stride over D with float4
// loads (a scalar head up to the 16-byte boundary, a scalar tail after the
// last full vector); z and g must share their 16-byte alignment, which
// the Python wrapper checks.  Each thread keeps three fp32 partials; the
// block reduces them with a fixed-order warp-shuffle tree and then a
// fixed-order pass over the per-warp partials in shared memory.  There
// are no atomics, so two launches on the same inputs give identical bits.
//
// Left for a later PR: at the paper's N = 23 only 23 of the 132 SMs get a
// block, so a wide row (the 3-NN's D = 199,210) is latency-bound on those
// SMs.  Splitting each row over several blocks, with a second fixed-order
// pass over the per-block partials, would fill the card.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void accumulate(float z, float g, float& zg,
                                           float& zz, float& gg) {
  zg = fmaf(z, g, zg);
  zz = fmaf(z, z, zz);
  gg = fmaf(g, g, gg);
}

__device__ __forceinline__ float warp_sum(float v) {
  // fixed tree: lane l adds lane l + o for o = 16, 8, 4, 2, 1
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    similarity_stats_kernel(const float* __restrict__ z,
                            const float* __restrict__ g,
                            float* __restrict__ out, int64_t d) {
  const int64_t row = blockIdx.x;
  const float* zr = z + row * d;
  const float* gr = g + row * d;
  float zg = 0.f, zz = 0.f, gg = 0.f;

  // D not a multiple of 4 makes rows drift off the 16-byte boundary; the
  // wrapper guarantees that z and g share their alignment, so one scalar
  // head brings both rows to the boundary of their float4 loads.
  const uintptr_t za = reinterpret_cast<uintptr_t>(zr);
  const int64_t to_boundary =
      static_cast<int64_t>((16u - (za & 15u)) & 15u) / 4;
  const int64_t head = to_boundary < d ? to_boundary : d;
  for (int64_t i = threadIdx.x; i < head; i += kThreads)
    accumulate(zr[i], gr[i], zg, zz, gg);

  const int64_t nvec = (d - head) / 4;
  const float4* z4 = reinterpret_cast<const float4*>(zr + head);
  const float4* g4 = reinterpret_cast<const float4*>(gr + head);
  for (int64_t v = threadIdx.x; v < nvec; v += kThreads) {
    const float4 a = __ldg(z4 + v);
    const float4 b = __ldg(g4 + v);
    accumulate(a.x, b.x, zg, zz, gg);
    accumulate(a.y, b.y, zg, zz, gg);
    accumulate(a.z, b.z, zg, zz, gg);
    accumulate(a.w, b.w, zg, zz, gg);
  }
  for (int64_t i = head + nvec * 4 + threadIdx.x; i < d; i += kThreads)
    accumulate(zr[i], gr[i], zg, zz, gg);

  __shared__ float partial[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  zg = warp_sum(zg);
  zz = warp_sum(zz);
  gg = warp_sum(gg);
  if (lane == 0) {
    partial[0][warp] = zg;
    partial[1][warp] = zz;
    partial[2][warp] = gg;
  }
  __syncthreads();
  if (warp == 0) {
    zg = lane < kWarps ? partial[0][lane] : 0.f;
    zz = lane < kWarps ? partial[1][lane] : 0.f;
    gg = lane < kWarps ? partial[2][lane] : 0.f;
    zg = warp_sum(zg);
    zz = warp_sum(zz);
    gg = warp_sum(gg);
    if (lane == 0) {
      out[row * 3 + 0] = zg;
      out[row * 3 + 1] = zz;
      out[row * 3 + 2] = gg;
    }
  }
}

}  // namespace

extern "C" {

// z, g: (n, d) fp32 contiguous; out: (n, 3) fp32.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int similarity_stats_f32(const void* z, const void* g, void* out, int64_t n,
                         int64_t d, void* stream) {
  if (n > 0) {
    similarity_stats_kernel<<<static_cast<unsigned int>(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(z), static_cast<const float*>(g),
        static_cast<float*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* similarity_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
