// Causal GQA flash attention (forward) in fp32 with an optional sliding
// window and tanh logit softcap: the fp32 variants of the zoo's prefill
// attention on the card.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:70
// `flash_attention_kernel` (Pallas) for fp32 inputs; bf16 inputs, the
// models' serving dtype, go to the tensor-core kernel in
// flash_attention_bf16.cu.  For q (B, H, Sq, dh) and k, v (B, K, Sk, dh),
// query head h reads KV head h / (H / K), and query row i (position i)
// attends to keys j with
//
//     j <= i  and, with a window w,  j > i - w
//
// through an online softmax in fp32: s = (q . k) * (1 / sqrt(dh)), then
// s = tanh(s / cap) * cap with a softcap, masked scores take the finite
// NEG_INF = -2^30 of the reference, and per key tile
//
//     m' = max(m, rowmax s), a = exp(m - m'), p = exp(s - m'),
//     l  = l a + sum p,      acc = acc a + p v,
//
// the output is acc / max(l, 1e-30).  A tile that is fully masked for a
// row (the first tile a sliding window reaches) adds exp(0) = 1 per masked
// key to l and acc, and the first real score wipes that with a = 0, as on
// the TPU; masked keys beyond Sk read V as 0, so nothing that is not
// finite enters.
//
// Bound: operations.  Inside the causal window every (query, key) pair
// costs 4 dh operations (q.k and p v), fp32, 67 TFLOP/s outside the
// tensor cores.  Bytes (q, k, v read once, o written once) are two orders
// of magnitude below at the model's shapes: at h2o-danube-1.8b's prefill
// (B 2, H 32, K 8, S 8192, dh 80, window 4096) 515 GFLOP, 7.7 ms, against
// 420 MB, 125 us.  The tensor cores stay out on purpose: TF32 or bf16
// operands would round q, k and v, which the fp32 variants' parity (1e-4)
// refuses.
//
// Design: one block of 256 threads per (64-row q tile, head, batch).  The
// q tile and one 64-key tile of K and V sit in shared memory (K and q rows
// padded to an odd stride, so the 16 key rows a half-warp reads fall in 16
// banks); each thread owns 4 rows x 4 keys of the score tile and 4 rows x
// ceil(dh/16) columns of the accumulator, in registers, so one shared load
// feeds two multiply-adds.  The 16 threads that share a row are 16 lanes
// of one warp: the row max and sum are 4 shuffles.  Key tiles run from the
// first one the window reaches to the causal frontier; tiles outside are
// never loaded.  Ragged Sq and Sk are masked in the kernel, with no
// padding copy.  Every tensor is read through its own (batch, head,
// sequence) strides with a unit stride along dh, so the model's
// (B, S, H, dh) tensors go in and out without a transpose copy.  Above
// 48 KB of shared memory (dh > 32) the kernel raises its limit with
// cudaFuncSetAttribute; dh = 256 takes 214 KB.
//
// Left for a later PR: cp.async loads of the next K/V tile under the
// current one's arithmetic, and splitting long key ranges across blocks.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;           // row stride of the p tile
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Strides {
  int64_t b, h, s;
};

// odd row stride >= dh for the q and k tiles
__host__ __device__ __forceinline__ int qk_stride(int dh) {
  return dh | 1;
}

template <int NC>
__host__ __device__ __forceinline__ size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(2 * kBQ) * qk_stride(dh) +
                          static_cast<size_t>(kBK) * 16 * NC +
                          static_cast<size_t>(kBQ) * kPS);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int group, int Sq, int Sk, int dh, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale,
                     int window, float softcap) {
  extern __shared__ float smem[];
  const int KS = qk_stride(dh);
  constexpr int VS = 16 * NC;
  float* Qs = smem;                    // [kBQ][KS]
  float* Ks = Qs + kBQ * KS;           // [kBK][KS]
  float* Vs = Ks + kBK * KS;           // [kBK][VS], columns >= dh are 0
  float* Ps = Vs + kBK * VS;           // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int rg = tid >> 4;             // rows rg*4 .. rg*4+3
  const int cg = tid & 15;             // keys cg + 16c, columns cg + 16cc
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int row = q0 + r;
    Qs[r * KS + d] = row < Sq ? to_f32(qb[row * qs.s + d]) : 0.0f;
  }
  for (int idx = tid; idx < kBK * VS; idx += kThreads) Vs[idx] = 0.0f;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = 0.0f;
  }

  const int q_last = min(q0 + kBQ - 1, Sq - 1);
  const int kt_end = min(q_last, Sk - 1) / kBK;  // causal frontier
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                   // the previous tile is consumed
    for (int idx = tid; idx < kBK * dh; idx += kThreads) {
      const int r = idx / dh;
      const int d = idx - r * dh;
      const int key = k0 + r;
      const bool in = key < Sk;
      Ks[r * KS + d] = in ? to_f32(kb[key * ks.s + d]) : 0.0f;
      Vs[r * VS + d] = in ? to_f32(vb[key * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * KS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(cg + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + cg + 16 * c;
        float x = s[i][c] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        const bool keep = key <= qpos && key < Sk &&
                          (window <= 0 || key > qpos - window);
        s[i][c] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        Ps[(rg * 4 + i) * kPS + cg + 16 * c] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();                   // the p tile is complete

    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * kPS + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = Vs[j * VS + cg + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = cg + 16 * cc;
      if (d < dh) store(ob + row * os.s + d, acc[i][cc] * inv);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int Sq, int Sk, int dh, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>(dh);
  auto kern = flash_fwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, Sq, Sk, dh, qs,
      ks, vs, os, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int K, int Sq, int Sk, int dh, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int window, float softcap,
             cudaStream_t stream) {
#define FLASH_LAUNCH(NC)                                                    \
  return launch<T, NC>(q, k, v, o, B, H, K, Sq, Sk, dh, qs, ks, vs, os,     \
                       scale, window, softcap, stream)
  if (dh <= 16) FLASH_LAUNCH(1);
  if (dh <= 32) FLASH_LAUNCH(2);
  if (dh <= 64) FLASH_LAUNCH(4);
  if (dh <= 80) FLASH_LAUNCH(5);
  if (dh <= 128) FLASH_LAUNCH(8);
  if (dh <= 256) FLASH_LAUNCH(16);
#undef FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, H, Sq, dh), k and v (B, K, Sk, dh), o (B, H, Sq, dh), all fp32,
// each with its own (batch, head, sequence) element strides and unit
// stride along dh.  window <= 0: no window; softcap <= 0: none.  Launches
// on `stream` and returns the CUDA error (0 on success); dh > 256 or
// H % K != 0 returns cudaErrorInvalidValue.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int K, int Sq, int Sk, int dh,
                        int64_t q_sb, int64_t q_sh, int64_t q_ss,
                        int64_t k_sb, int64_t k_sh, int64_t k_ss,
                        int64_t v_sb, int64_t v_sh, int64_t v_ss,
                        int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale,
                        int window, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh <= 0 || dh > 256 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  return dispatch<float>(q, k, v, o, B, H, K, Sq, Sk, dh, qs, ks, vs, os,
                         scale, window, softcap,
                         static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
