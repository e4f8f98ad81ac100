// Mamba-1 selective scan: the zoo's SSM recurrence on the card.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py:46
// `mamba_scan_kernel` (Pallas).  For dA, dBx (B, S, di, n) fp32 and
// C (B, S, n) fp32 it computes, per batch b and channel d, from h = 0,
//
//     h_t = dA_t * h_{t-1} + dBx_t      (elementwise over the n states)
//     y_t = sum_n h_t[n] * C_t[n]       (n = 0 .. n-1, in order)
//
// and writes y (B, S, di) fp32 and the final state h_S (B, di, n) fp32.
// The TPU kernel writes only y; the port's prefill hands h_S to decode,
// the state the reference's plain path exports.
//
// Bound: HBM bytes.  dA and dBx are read once (8 n bytes per (t, d) each
// for n = 16: 128 B), y written once (4 B), C and h_S are small; about
// 0.25 operations per byte.  At falcon-mamba-7b's prefill (B 2, S 4096,
// di 8192, n 16) that is 8.9 GB, 2.65 ms at 3.35 TB/s.
//
// Design: one thread per (b, channel d) keeps h[n] in registers and walks
// t.  A channel's n = 16 states are 64 contiguous bytes, loaded as four
// float4, so a warp's loads of one step cover 2 KB contiguous and
// coalesce.  The loads of U = 4 steps are issued before their arithmetic
// (they do not depend on h), so each thread keeps 512 B in flight.  C is
// the same for every channel of a batch: the block stages 64 steps of it
// in shared memory.  Ragged S and di are masked in the kernel; n is a
// template parameter, built for the state sizes the zoo's configs use:
// 16 (every full config) and 8 (their SMOKE variants).
//
// Left for a later PR: at B * di = 16,384 threads the card holds 6 % of
// its thread slots, so the bytes in flight per SM come from the unrolled
// loads alone; splitting the sequence into chunks scanned in parallel
// (a second pass carrying each chunk's entry state) would fill it.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTC = 64;   // steps of C staged in shared memory
constexpr int kU = 4;     // steps whose loads are issued together

template <int N>
__device__ __forceinline__ void load_state(const float* __restrict__ p,
                                           float (&out)[N]) {
  static_assert(N % 4 == 0, "a channel's states load as float4");
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = __ldg(p4 + i);
    out[4 * i] = x.x;
    out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z;
    out[4 * i + 3] = x.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ da,
                      const float* __restrict__ dbx,
                      const float* __restrict__ c, float* __restrict__ y,
                      float* __restrict__ h_last, int64_t S, int64_t di) {
  __shared__ float Cs[kTC * N];
  const int64_t b = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = d < di;

  float h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) h[i] = 0.0f;

  for (int64_t t0 = 0; t0 < S; t0 += kTC) {
    const int tn = static_cast<int>(S - t0 < kTC ? S - t0 : kTC);
    __syncthreads();                   // the previous C chunk is consumed
    for (int i = threadIdx.x; i < tn * N; i += kThreads)
      Cs[i] = c[(b * S + t0) * N + i];
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < tn; tt += kU) {
      float a[kU][N], bx[kU][N];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (tt + u < tn) {
          const int64_t off = ((b * S + t0 + tt + u) * di + d) * N;
          load_state<N>(da + off, a[u]);
          load_state<N>(dbx + off, bx[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (tt + u < tn) {
          const float* ct = Cs + (tt + u) * N;
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            h[i] = fmaf(a[u][i], h[i], bx[u][i]);
            acc = fmaf(h[i], ct[i], acc);
          }
          y[(b * S + t0 + tt + u) * di + d] = acc;
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) h_last[(b * di + d) * N + i] = h[i];
  }
}

template <int N>
int launch(const float* da, const float* dbx, const float* c, float* y,
           float* h_last, int64_t B, int64_t S, int64_t di,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(B));
  mamba_scan_kernel<N><<<grid, kThreads, 0, stream>>>(da, dbx, c, y, h_last,
                                                      S, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// da, dbx: (B, S, di, n) fp32; c: (B, S, n) fp32; y: (B, S, di) fp32;
// h_last: (B, di, n) fp32; all contiguous, da and dbx 16-byte aligned.
// n is 8 or 16.  Launches on `stream` and returns the CUDA error (0 on
// success); any other n returns cudaErrorInvalidValue.
int mamba_scan_f32(const void* da, const void* dbx, const void* c, void* y,
                   void* h_last, int64_t B, int64_t S, int64_t di, int64_t n,
                   void* stream) {
  if (B <= 0 || di <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(da);
  const float* bx = static_cast<const float*>(dbx);
  const float* cc = static_cast<const float*>(c);
  float* yy = static_cast<float*>(y);
  float* hl = static_cast<float*>(h_last);
  switch (n) {
    case 8:
      return launch<8>(a, bx, cc, yy, hl, B, S, di, st);
    case 16:
      return launch<16>(a, bx, cc, yy, hl, B, S, di, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
