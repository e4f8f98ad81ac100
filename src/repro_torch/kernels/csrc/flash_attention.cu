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
//     m' = max(m, rowmax s), a = 2^(m - m'), p = 2^(s - m'),
//     l  = l a + sum p,      acc = acc a + p v,
//
// with s and m in log2 units (without a softcap s stays raw and scale *
// log2 e enters the exponent's FMA, exact for NEG_INF, a power of two;
// with one, 1 / softcap is folded into the scale and log2 e into the
// softcap), and the output is acc / max(l, 1e-30).  A tile that is fully
// masked for a row (the first tile a sliding window reaches) adds 2^0 = 1
// per masked key to l and acc, and the first real score wipes that with
// a = 0, as in the reference; masked keys beyond Sk read V as 0.
//
// Bound: operations.  Inside the causal window every (query, key) pair
// costs 4 dh operations (q.k and p v) as fp32 FMAs, 67 TFLOP/s outside the
// tensor cores.  Bytes (q, k, v read once, o written once) are two orders
// of magnitude below at the model's shapes: at h2o-danube-1.8b's prefill
// (B 2, H 32, K 8, S 8192, dh 80, window 4096) 515 GFLOP, 7.7 ms, against
// 420 MB, 125 us.  The tensor cores stay out on purpose: TF32 or bf16
// operands would round q, k and v, which the fp32 variants' parity (1e-4)
// refuses.  An SM sub-partition issues one warp instruction a clock and
// runs one FMA instruction a clock, so every instruction that is not an
// FMA (a shared load, the softmax, the mask, an address) costs an FMA's
// slot: the design keeps that share near a tenth.
//
// Design: one block of 4 warps per (64-row q tile, head, batch[, key
// split]).  A warp owns 16 query rows outright: lane (r, c) of the 4 x 8
// lanes holds rows r + 4i (i < 4) of the warp's score tile against keys
// c + 8j (j < 4) of a 32-key tile, and the same rows against output
// columns VW c + 8 VW t (t < NT; VW 2 or 4, 8 VW NT = the bucket's padded
// dh DP).  Q, K and V tiles sit row-major in shared memory with a row
// stride of DP + 4 floats, an odd number of 16-byte units, so the 4 rows
// or 8 keys a warp reads at one d fall in distinct bank groups; q.k takes
// 4 d at a time, one 16-byte load per row and per key, 64 FMAs for 8
// loads, and p v takes one 16-byte load of 4 rows' p and NT loads of V
// per key, 4 VW NT FMAs for NT + 1 loads.  p goes from the score
// registers into the warp's own [key][row] buffer (16-byte stores) and
// back, so no other warp waits on it.  K and V alternate in one buffer
// each, filled by cp.async: V(t) lands under q.k of tile t, K(t + 1)
// under p v of tile t, two barriers a tile.  The copies are 16 bytes
// where dh % 4 == 0 and every base and (batch, head, sequence) stride of
// q, k and v is 16-byte aligned, else 4 bytes; a thread walks its copies
// with a fixed address step and one carry, no division or multiply per
// copy.  The padding columns up to DP are zeroed once and never copied.
// A warp skips a key tile that is fully masked for all its rows; only
// diagonal, window-edge and ragged tiles compute the mask.  Blocks run
// heaviest q tile first, the heads of one q tile together.  Where
// B H ceil(Sq / 64) blocks would not fill the card's block slots twice
// over (kernel_bench's 128 blocks), the wrapper's plan splits each q
// tile's key range into up to 8 contiguous chunks, enough for one and a
// half waves: each block writes its unnormalised o, m and l to a
// workspace, and a second kernel combines the chunks in chunk order
// (read-only loads, each split's weight computed once a row), so the
// result is deterministic.  Up to dh = 80 four blocks fit an SM (16 warps,
// at most 128 registers a thread); at dh = 128 three (75.8 KB of shared
// memory a block; 168 registers); at dh = 256 one (141 KB; a thread holds
// 128 accumulators).
//
// Measured and dropped (NVIDIA H100 80GB HBM3, kernel_probe.py; PERF.md
// holds the numbers): q.k unrolled by 2 and p v by 4 spill at the
// 128-register cap; splits for one wave (4 at kernel_bench) lose to one
// and a half (5); a combine with plain loads serialised each column's
// loads behind the previous store; copies that recomputed their address
// from (row, unit) cost about 30 instructions each.
//
// Left for a later PR: K/V tiles by TMA bulk copies on an mbarrier (a
// copy still costs about 23 instructions of a tile's ~3,600 a warp at
// dh = 80), and more rows a warp at dh = 128 (needs registers).
//
// The first SIMT kernel (64-row tiles, scalar shared loads, one
// 64-key tile at a time with three barriers and no overlap) stays below
// as flash_attention_fwd_simt_v1, a reference that the on-card check
// times beside this one; no path calls it.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 16;                  // query rows a warp
constexpr int kBQ = kWarps * kWarpRows;        // query rows a block
constexpr int kBK = 32;                        // keys a tile
constexpr int kMaxSplits = 8;                  // key chunks a q tile
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;
};

// a bucket of head dims: DP the padded dh, a lane's output columns VW-wide
// vectors NT times (8 VW NT = DP), kMinBlocks blocks an SM (registers)
template <int DP>
struct Bucket;
template <>
struct Bucket<16> {
  static constexpr int VW = 2, NT = 1, kMinBlocks = 4;
};
template <>
struct Bucket<32> {
  static constexpr int VW = 4, NT = 1, kMinBlocks = 4;
};
template <>
struct Bucket<64> {
  static constexpr int VW = 4, NT = 2, kMinBlocks = 4;
};
template <>
struct Bucket<80> {
  static constexpr int VW = 2, NT = 5, kMinBlocks = 4;
};
template <>
struct Bucket<128> {
  static constexpr int VW = 4, NT = 4, kMinBlocks = 3;
};
template <>
struct Bucket<256> {
  static constexpr int VW = 4, NT = 8, kMinBlocks = 1;
};

// row stride of the Q, K and V tiles: DP + 4 floats, an odd number of
// 16-byte units for every bucket (DP % 8 == 0)
__host__ __device__ constexpr int row_stride(int dp) { return dp + 4; }

__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) *
                              row_stride(dp) +
                          static_cast<size_t>(kWarps) * kBK * kWarpRows);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* ws_o;        // splits > 1: (splits, B H Sq, dh) unnormalised o
  float* ws_ml;       // splits > 1: (splits, B H Sq, 2) m and l
  int B, H, group, Sq, Sk, dh, n_qt, window, splits;
  Strides qs, ks, vs, os;
  float c;            // scale * log2 e (no softcap), else 1
  float cap_in;       // scale / softcap
  float cap_out;      // softcap * log2 e
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (through L1); zero-fills when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the SFU (relative error ~2^-22; 2^-2^30 flushes to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A thread's walk over the copies of a tile: copy n of the tile is
// (row n / C, unit n % C), C the copies a row; a thread takes n = tid +
// 128 k, stepping by (128 / C rows, 128 % C units) with one carry.
struct Walk {
  int r0, u0, dr, du, C, unit;   // unit: floats a copy (4 or 1)
};

__device__ __forceinline__ Walk make_walk(int dh, bool vec16) {
  Walk w;
  w.unit = vec16 ? 4 : 1;
  w.C = vec16 ? dh / 4 : dh;
  w.r0 = threadIdx.x / w.C;
  w.u0 = threadIdx.x - w.r0 * w.C;
  w.dr = kThreads / w.C;
  w.du = kThreads - w.dr * w.C;
  return w;
}

// rows [row0, row0 + kRows) of a (seq, dh) slice with row stride `stride`
// into a [kRows][RS] tile; rows at or past `limit` are zero-filled.  The
// thread's global and shared addresses step with its walk (a fixed step
// and one carry), so a copy costs no multiply.
template <int kRows, int RS, int kUnit>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int row0,
                                          int limit, const Walk& w) {
  int r = w.r0, u = w.u0;
  const float* g = src + (row0 + r) * stride + kUnit * u;
  uint32_t sd = smem_u32(dst + r * RS + kUnit * u);
  const int64_t g_step = w.dr * stride + kUnit * w.du;
  const int64_t g_carry = stride - kUnit * w.C;
  const uint32_t s_step = 4 * (w.dr * RS + kUnit * w.du);
  const uint32_t s_carry = 4 * (RS - kUnit * w.C);
  while (r < kRows) {
    const bool in = row0 + r < limit;
    if (kUnit == 4)
      cp_async16(sd, in ? g : src, in);
    else
      cp_async4(sd, in ? g : src, in);
    r += w.dr;
    u += w.du;
    g += g_step;
    sd += s_step;
    if (u >= w.C) {
      u -= w.C;
      ++r;
      g += g_carry;
      sd += s_carry;
    }
  }
}

template <int kRows, int RS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int row0,
                                          int limit, const Walk& w) {
  if (w.unit == 4)
    load_rows<kRows, RS, 4>(dst, src, stride, row0, limit, w);
  else
    load_rows<kRows, RS, 1>(dst, src, stride, row0, limit, w);
}

// S = Q K^T for a lane's 4 rows x 4 keys: d runs 4 at a time over the
// zero-padded head dim (dh rounded up to 4)
template <int RS>
__device__ __forceinline__ void qk_tile(float (&s)[4][4], const float* qw,
                                        const float* kw, int d_end) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  const float* const q_end = qw + d_end;
#pragma unroll 1
  for (; qw < q_end; qw += 4, kw += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qw + 4 * i * RS);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(kw + 8 * j * RS);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// the online-softmax step of a lane's 4 rows on one key tile: the softcap,
// on an edge tile the causal / window / ragged-Sk mask, the row max over
// the 8 lanes of a row (lane bits 0-2), l and o rescaled, p into the
// warp's [key][row] buffer.  l is the lane's own partial sum.
template <bool kCap, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[4][4], float (&m)[4],
                                             float (&l)[4],
                                             float (&o)[4][NO], bool edge,
                                             const Params& p, int row0,
                                             int k0, int lr, int lc,
                                             float* pw) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = kCap ? tanhf(s[i][j] * p.cap_in) * p.cap_out : s[i][j];
      if (edge) {
        const int key = k0 + lc + 8 * j;
        const int row = row0 + lr + 4 * i;
        const bool keep = key <= row && key < p.Sk &&
                          (p.window <= 0 || key > row - p.window);
        x = keep ? x : kNegInf;
      }
      s[i][j] = x;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = exp2_sfu((m[i] - m_new) * p.c);
    m[i] = m_new;
    const float mc = -m_new * p.c;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = exp2_sfu(fmaf(s[i][j], p.c, mc));
      sum += s[i][j];
    }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] *= alpha;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(pw + (lc + 8 * j) * kWarpRows + 4 * lr) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// o += P V for a lane's 4 rows and NT VW-wide column vectors; pw points at
// the lane's 4 rows of key 0 in the warp's [key][row] p buffer, vw at its
// first column of key 0 in the V tile
template <int RS, int VW, int NT>
__device__ __forceinline__ void pv_tile(float (&o)[4][VW * NT],
                                        const float* pw, const float* vw) {
#pragma unroll 2
  for (int j = 0; j < kBK; ++j, pw += kWarpRows, vw += RS) {
    const float4 pr = *reinterpret_cast<const float4*>(pw);
    const float pj[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float* src = vw + 8 * VW * t;
      float vv[VW];
      if constexpr (VW == 4) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        vv[0] = x.x;
        vv[1] = x.y;
        vv[2] = x.z;
        vv[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(src);
        vv[0] = x.x;
        vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          o[i][VW * t + e] = fmaf(pj[i], vv[e], o[i][VW * t + e]);
    }
  }
}

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, Bucket<DP>::kMinBlocks)
    flash_fwd_kernel(const Params p, bool vec16) {
  constexpr int RS = row_stride(DP);
  constexpr int VW = Bucket<DP>::VW;
  constexpr int NT = Bucket<DP>::NT;
  constexpr int NO = VW * NT;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][RS]
  float* Ks = Qs + kBQ * RS;           // [kBK][RS]
  float* Vs = Ks + kBK * RS;           // [kBK][RS]
  float* Ps = Vs + kBK * RS;           // [kWarps][kBK][kWarpRows]

  // heaviest q tile first; the heads of one q tile run together; a q
  // tile's key splits run side by side
  int item = blockIdx.x;
  const int split = item % p.splits;
  item /= p.splits;
  const int hb = item % (p.H * p.B);
  const int qt = p.n_qt - 1 - item / (p.H * p.B);
  const int h = hb % p.H;
  const int b = hb / p.H;
  const int kh = h / p.group;
  const int q0 = qt * kBQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lr = lane >> 3;            // rows lr + 4 i of the warp's 16
  const int lc = lane & 7;             // keys lc + 8 j, columns VW lc + ...
  const int row0 = q0 + kWarpRows * warp;
  const int row_last = min(row0 + kWarpRows, p.Sq) - 1;

  // the padding columns [dh, DP) stay zero: no copy writes them
  for (int idx = tid; idx < (kBQ + 2 * kBK) * (DP - p.dh); idx += kThreads) {
    const int r = idx / (DP - p.dh);
    Qs[r * RS + p.dh + idx - r * (DP - p.dh)] = 0.0f;
  }

  const Walk walk = make_walk(p.dh, vec16);
  const float* qb = p.q + b * p.qs.b + h * p.qs.h;
  const float* kb = p.k + b * p.ks.b + kh * p.ks.h;
  const float* vb = p.v + b * p.vs.b + kh * p.vs.h;

  // key tiles from the first one the window reaches to the causal
  // frontier of the block's last row; this block's chunk of them
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int t_end = min(q_last, p.Sk - 1) / kBK;
  const int t_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kBK : 0;
  const int n_t = t_end - t_begin + 1;
  const int t_lo = t_begin + n_t * split / p.splits;
  const int t_hi = t_begin + n_t * (split + 1) / p.splits;   // exclusive

  float m[4], l[4], o[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.0f;
  }

  const float* qw = Qs + (kWarpRows * warp + lr) * RS;
  const float* kw = Ks + lc * RS;
  const float* vw = Vs + VW * lc;
  float* pw = Ps + warp * kBK * kWarpRows;
  const int d_end = (p.dh + 3) & ~3;

  if (t_lo < t_hi) {
    load_tile<kBQ, RS>(Qs, qb, p.qs.s, q0, p.Sq, walk);
    load_tile<kBK, RS>(Ks, kb, p.ks.s, t_lo * kBK, p.Sk, walk);
    cp_async_commit();
  }
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    cp_async_wait_all();
    __syncthreads();                   // K(t) landed; V(t - 1) consumed
    load_tile<kBK, RS>(Vs, vb, p.vs.s, k0, p.Sk, walk);
    cp_async_commit();
    // the warp's rows against keys [k0, k0 + kBK): skipped when all are
    // masked, the mask computed only where some pair is
    const bool active =
        row0 <= row_last && k0 <= row_last &&
        (p.window <= 0 || k0 + kBK - 1 > row0 - p.window);
    if (active) {
      const bool edge = k0 + kBK - 1 > row0 || k0 + kBK > p.Sk ||
                        (p.window > 0 && k0 <= row_last - p.window);
      float s[4][4];
      qk_tile<RS>(s, qw, kw, d_end);
      softmax_step<kCap, NO>(s, m, l, o, edge, p, row0, k0, lr, lc, pw);
    }
    cp_async_wait_all();
    __syncthreads();                   // V(t) landed; K(t) consumed
    if (t + 1 < t_hi) {
      load_tile<kBK, RS>(Ks, kb, p.ks.s, k0 + kBK, p.Sk, walk);
      cp_async_commit();
    }
    if (active) pv_tile<RS, VW, NT>(o, pw + 4 * lr, vw);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + lr + 4 * i;
    if (row >= p.Sq) continue;
    if (p.splits == 1) {
      float* ob = p.o + b * p.os.b + h * p.os.h + row * p.os.s;
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int d = VW * lc + 8 * VW * t + e;
          if (d < p.dh) ob[d] = o[i][VW * t + e] * inv;
        }
    } else {
      const int64_t r = split * rows + (static_cast<int64_t>(hb) * p.Sq + row);
      float* wo = p.ws_o + r * p.dh;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int d = VW * lc + 8 * VW * t + e;
          if (d < p.dh) wo[d] = o[i][VW * t + e];
        }
      if (lc == 0) {
        p.ws_ml[2 * r] = m[i];
        p.ws_ml[2 * r + 1] = l[i];
      }
    }
  }
}

// the key splits of each row, combined in split order: one warp a row.
// Lane s < splits reads split s's m and l; the row's m and l come from
// fixed shuffle trees over lanes 0-7, each split's weight 2^(m_s - m) is
// broadcast to every lane, and a lane sums its columns over the splits
// in order.
__global__ void __launch_bounds__(kThreads)
    flash_combine_kernel(const Params p) {
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const bool own = lane < p.splits;
  const int64_t rs = (own ? lane : 0) * rows + r;
  const float ms = own ? __ldg(p.ws_ml + 2 * rs) : kNegInf;
  const float ls = own ? __ldg(p.ws_ml + 2 * rs + 1) : 0.0f;
  float m = ms;
#pragma unroll
  for (int off = 1; off < kMaxSplits; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  m = __shfl_sync(0xffffffffu, m, 0);
  const float w = own ? exp2_sfu((ms - m) * p.c) : 0.0f;
  float l = w * ls;
#pragma unroll
  for (int off = 1; off < kMaxSplits; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  l = __shfl_sync(0xffffffffu, l, 0);
  float wt[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    wt[s] = __shfl_sync(0xffffffffu, w, s);
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  const int row = static_cast<int>(r % p.Sq);
  const int hb = static_cast<int>(r / p.Sq);
  float* ob = p.o + (hb / p.H) * p.os.b + (hb % p.H) * p.os.h + row * p.os.s;
  const float* wo = p.ws_o + r * p.dh;
  const int64_t split_stride = rows * p.dh;
  // read-only loads, so a column's loads need not wait on the store of
  // the one before
#pragma unroll 4
  for (int d = lane; d < p.dh; d += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < p.splits)
        acc = fmaf(wt[s], __ldg(wo + s * split_stride + d), acc);
    ob[d] = acc * inv;
  }
}

template <int DP, bool kCap>
int launch(const Params& p, bool vec16, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  auto kern = flash_fwd_kernel<DP, kCap>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>(p.n_qt) * p.H * p.B * p.splits;
  kern<<<blocks, kThreads, smem, stream>>>(p, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  flash_combine_kernel<<<static_cast<unsigned int>((rows + kWarps - 1) /
                                                   kWarps),
                         kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const Params& p, bool cap, bool vec16, cudaStream_t stream) {
  return cap ? launch<DP, true>(p, vec16, stream)
             : launch<DP, false>(p, vec16, stream);
}

// ----------------------------------------------------------------------
// The first SIMT kernel, kept as a reference for the on-card check:
// one block of 256 threads per (64-row q tile, head, batch); the q tile
// and one 64-key tile of K and V in shared memory, loaded element by
// element between barriers; each thread owns 4 rows x 4 keys of the
// score tile and 4 rows x ceil(dh/16) columns of the accumulator, one
// scalar shared load for two multiply-adds.
// ----------------------------------------------------------------------
namespace v1 {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;           // row stride of the p tile

// odd row stride >= dh for the q and k tiles
__host__ __device__ __forceinline__ int qk_stride(int dh) { return dh | 1; }

template <int NC>
__host__ __device__ __forceinline__ size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(2 * kBQ) * qk_stride(dh) +
                          static_cast<size_t>(kBK) * 16 * NC +
                          static_cast<size_t>(kBQ) * kPS);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int group, int Sq, int Sk, int dh, Strides qs,
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int row = q0 + r;
    Qs[r * KS + d] = row < Sq ? qb[row * qs.s + d] : 0.0f;
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
      Ks[r * KS + d] = in ? kb[key * ks.s + d] : 0.0f;
      Vs[r * VS + d] = in ? vb[key * vs.s + d] : 0.0f;
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
        const float pv = expf(s[i][c] - m_new);
        sum += pv;
        Ps[(rg * 4 + i) * kPS + cg + 16 * c] = pv;
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = cg + 16 * cc;
      if (d < dh) ob[row * os.s + d] = acc[i][cc] * inv;
    }
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int K, int Sq, int Sk, int dh, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>(dh);
  auto kern = flash_fwd_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, H, H / K, Sq, Sk, dh,
                                          qs, ks, vs, os, scale, window,
                                          softcap);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* q, const float* k, const float* v, float* o, int B,
             int H, int K, int Sq, int Sk, int dh, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int window, float softcap,
             cudaStream_t stream) {
#define FLASH_LAUNCH(NC)                                                    \
  return launch<NC>(q, k, v, o, B, H, K, Sq, Sk, dh, qs, ks, vs, os, scale, \
                    window, softcap, stream)
  if (dh <= 16) FLASH_LAUNCH(1);
  if (dh <= 32) FLASH_LAUNCH(2);
  if (dh <= 64) FLASH_LAUNCH(4);
  if (dh <= 80) FLASH_LAUNCH(5);
  if (dh <= 128) FLASH_LAUNCH(8);
  FLASH_LAUNCH(16);
#undef FLASH_LAUNCH
}

}  // namespace v1

}  // namespace

extern "C" {

// q (B, H, Sq, dh), k and v (B, K, Sk, dh), o (B, H, Sq, dh), all fp32,
// each with its own (batch, head, sequence) element strides and unit
// stride along dh.  window <= 0: no window; softcap <= 0: none.  splits:
// key chunks a q tile (1 to 8); above 1, ws_o holds splits * B * H * Sq *
// dh floats and ws_ml splits * B * H * Sq * 2.  vec16: 16-byte copies
// (the caller checked dh % 4 == 0 and 16-byte bases and strides of q, k
// and v), else 4-byte ones.  Launches on `stream` and returns the CUDA
// error (0 on success); dh > 256, H % K != 0 or a bad split count returns
// cudaErrorInvalidValue.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* ws_o, void* ws_ml, int B, int H, int K, int Sq,
                        int Sk, int dh, int64_t q_sb, int64_t q_sh,
                        int64_t q_ss, int64_t k_sb, int64_t k_sh,
                        int64_t k_ss, int64_t v_sb, int64_t v_sh,
                        int64_t v_ss, int64_t o_sb, int64_t o_sh,
                        int64_t o_ss, float scale, int window, float softcap,
                        int splits, int vec16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh <= 0 || dh > 256 || Sk <= 0 ||
      splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!ws_o || !ws_ml)) ||
      (vec16 && dh % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.ws_o = static_cast<float*>(ws_o);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.B = B;
  p.H = H;
  p.group = H / K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.dh = dh;
  p.n_qt = (Sq + kBQ - 1) / kBQ;
  p.window = window;
  p.splits = splits;
  p.qs = Strides{q_sb, q_sh, q_ss};
  p.ks = Strides{k_sb, k_sh, k_ss};
  p.vs = Strides{v_sb, v_sh, v_ss};
  p.os = Strides{o_sb, o_sh, o_ss};
  const bool cap = softcap > 0.0f;
  p.c = cap ? 1.0f : scale * kLog2e;
  p.cap_in = cap ? scale / softcap : 0.0f;
  p.cap_out = cap ? softcap * kLog2e : 0.0f;
  auto st = static_cast<cudaStream_t>(stream);
  const bool v16 = vec16 != 0;
  if (dh <= 16) return launch<16>(p, cap, v16, st);
  if (dh <= 32) return launch<32>(p, cap, v16, st);
  if (dh <= 64) return launch<64>(p, cap, v16, st);
  if (dh <= 80) return launch<80>(p, cap, v16, st);
  if (dh <= 128) return launch<128>(p, cap, v16, st);
  return launch<256>(p, cap, v16, st);
}

// The first SIMT kernel, the same arguments as flash_attention_fwd without
// the workspace, splits and copy width
int flash_attention_fwd_simt_v1(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int K, int Sq, int Sk,
                                int dh, int64_t q_sb, int64_t q_sh,
                                int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                int64_t v_ss, int64_t o_sb, int64_t o_sh,
                                int64_t o_ss, float scale, int window,
                                float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh <= 0 || dh > 256 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return v1::dispatch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, H, K, Sq, Sk,
      dh, Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
      Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss}, scale, window,
      softcap, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
