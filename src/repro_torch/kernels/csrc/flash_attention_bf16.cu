// Causal GQA flash attention (forward) in bf16 on the tensor cores, with an
// optional sliding window and tanh logit softcap: the zoo's prefill
// attention on the card.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:70
// `flash_attention_kernel` (Pallas) for bf16 inputs; fp32 inputs go to the
// SIMT kernel in flash_attention.cu.  For q (B, H, Sq, dh) and k, v
// (B, K, Sk, dh) in bf16, query head h reads KV head h / (H / K), and query
// row i (position i) attends to keys j with
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
// with s and m in log2 units (log2 e folded into the scale, which enters
// the exponent's FMA), and the output is acc / max(l, 1e-30) in bf16.  l
// sums the fp32 p.  The tensor cores take bf16 operands, so p v is two
// products into the same fp32 accumulators: p_hi = bf16(p) and
// p_lo = bf16(p - p_hi) (the difference is exact in fp32), acc += p_hi v +
// p_lo v.  p then enters with about 16 significant bits (a relative error
// near 2^-17) where one bf16 operand would keep 8 (2^-9); v is bf16 input
// and exact.  The plain version and the reference take p v in fp32.  A
// tile that is fully masked for a row (the first tile a sliding window
// reaches) adds 2^0 = 1 per masked key to l and acc, and the first real
// score wipes that with a = 0, as in the reference.
//
// Bound: operations.  Inside the causal window every (query, key) pair
// costs 4 dh operations (q.k and p v) on the bf16 tensor cores (989
// TFLOP/s dense); q, k, v and o cross HBM once in 1/8 of that time at the
// model's shapes.  The split p v issues 6 dh a pair; the bound counts the
// function's 4 dh.  At h2o-danube-1.8b's prefill (B 2, H 32, K 8, S 8192,
// dh 80, window 4096): 515 GFLOP, 0.521 ms, against 210 MB, 63 us.  Each
// pair also takes one exp2 on the SFU (16 a clock an SM against the tensor
// cores' 4096 flops), which at dh = 80 costs 80 % of the product's time
// at peak; the two overlap across warps.
//
// Design (FlashAttention-2's forward on Hopper's warp-level instructions):
// one block of 4 warps per (q tile, head, batch).  Both products are
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators: S = Q K^T
// takes Q's A-fragments (ldmatrix; held in registers for the whole key
// loop when they fit) and K's B-fragments (ldmatrix from the [key][dh]
// tile), O += P V takes P straight from S's accumulators (an m16n8 fp32
// fragment, packed two at a time into bf16, is an m16k16 A-fragment, so P
// never touches shared memory) and V's B-fragments through ldmatrix.trans.
// The fp32 p stays in S's registers, and each k16 slice's p_hi and p_lo
// fragments are packed just before their two products, so the split holds
// no second P array; still, a 64-key tile's fp32 p beside dh = 256's 128
// accumulators spills, so that bucket takes 16-key tiles.  Up to dh = 80
// a warp owns two 16-row tiles (128-row q tiles), so every K and V
// fragment feeds two products; above, one (64 rows), since two tiles'
// fp32 accumulators no longer fit in 255 registers without a spill.  Row
// max and row sum live in the 4 lanes of a quad (two shuffles).  K and V
// tiles of 64 keys (16 at dh = 256) stream through a 2-stage ring in
// shared memory by cp.async.cg (16 bytes a thread), one barrier a tile:
// tile t+1 loads while tile t is in the tensor cores.  Rows are dh padded
// to the bucket DP (32, 64, 80, 128, 256) plus 16 bytes, so the 8 rows an
// ldmatrix reads fall in 8 distinct 4-bank groups; the padding columns are
// zeroed once and never loaded.  Only the diagonal, window-edge and ragged
// tiles compute the mask; key tiles outside the window or past the causal
// frontier are never loaded.  Blocks run heaviest q tile first, heads of
// one q tile together (GQA heads share K/V in L2).  Every tensor is read
// through its (batch, head, sequence) strides with a unit stride along dh;
// the wrapper checks 16-byte alignment (cp.async) and dh % 8 == 0.
//
// Left for a later PR: wgmma on warpgroups with TMA loads of the K/V tiles
// into an mbarrier ring and producer/consumer warp specialisation (the only
// way to the full tensor-core rate); two row tiles a warp at dh = 128,
// which needs a smaller register footprint (key tiles of 32 still spill).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1073741824.0f;      // -2^30, the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// 16-row tiles a warp: two share each K and V fragment where their
// accumulators fit in registers with no spill
__host__ __device__ constexpr int row_tiles(int dp) { return dp <= 80 ? 2 : 1; }
// query rows a block
__host__ __device__ constexpr int block_rows(int dp) {
  return 16 * row_tiles(dp) * kWarps;
}
// keys a tile: 64, or 16 at dh = 256, whose 128 accumulators a thread
// leave no room for a larger tile's fp32 p beside the split's halves (32
// keys still spilled under a softcap)
__host__ __device__ constexpr int key_tile(int dp) {
  return dp > 128 ? 16 : 64;
}

struct Strides {
  int64_t b, h, s;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int H, B, group, Sq, Sk, dh, n_qt, window;
  Strides qs, ks, vs, os;
  float scale_log2;   // scale * log2 e (no softcap)
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: one m16n8k16 product, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (relative error ~2^-22; 2^-2^30 flushes to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 (a in the low half) -> two registers of two bf16 each: hi =
// bf16(x) and lo = bf16(x - hi), so hi + lo carries about 16 bits of x
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// `rows` rows of dh bf16 from `src` (row stride `stride`), starting at row
// `row0`, into a [rows][DP + 8] tile; rows at or past `limit` are zeroed
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int row0, int rows,
                                          int limit, int nch) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    if (c < nch) {
      const int row = row0 + r;
      const bool in = row < limit;
      const bf16* g = src + (in ? static_cast<int64_t>(row) * stride : 0) +
                      c * 8;
      cp_async16(smem_u32(dst + r * LD + c * 8), g, in);
    }
  }
}

// one 16-row tile's scores: the softcap (into log2 units), and on an
// edge tile the causal / window / ragged-Sk mask at NEG_INF.  Element e of
// n tile j is (row row0 + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1)).
template <bool kMask, bool kCap, int NT>
__device__ __forceinline__ void cap_mask(float (&s)[NT][4], const Params& p,
                                         int row0, int k0, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kCap ? tanhf(s[j][e] * p.cap_in) * p.cap_out : s[j][e];
      if (kMask) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool keep = key <= row && key < p.Sk &&
                          (p.window <= 0 || key > row - p.window);
        x = keep ? x : kNegInf;
      }
      s[j][e] = x;
    }
}

// the online-softmax step of one 16-row tile on one key tile: the softcap
// and mask, the new row max over the quad, l and o rescaled, p added to l
// in fp32 and left in s for P V.  Rows row0 (e = 0, 1)
// and row0 + 8 (e = 2, 3).  Without a softcap s and m stay raw and the
// scale (times log2 e) enters the exponent's FMA, which is exact for the
// NEG_INF of a fully masked row (a power of two): 2^0 = 1 as the
// reference's exp(0).
template <bool kCap, int NT, int ND>
__device__ __forceinline__ void softmax_step(
    float (&s)[NT][4], float (&m)[2],
    float (&l)[2], float (&o)[ND][4], bool edge, const Params& p, int row0,
    int k0, int t) {
  if (edge)
    cap_mask<true, kCap>(s, p, row0, k0, t);
  else
    cap_mask<false, kCap>(s, p, row0, k0, t);
  const float c = kCap ? 1.0f : p.scale_log2;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2_sfu((m[i] - mx[i]) * c);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
  const float mc0 = -mx[0] * c, mc1 = -mx[1] * c;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float p0 = exp2_sfu(fmaf(s[j][0], c, mc0));
    const float p1 = exp2_sfu(fmaf(s[j][1], c, mc0));
    const float p2 = exp2_sfu(fmaf(s[j][2], c, mc1));
    const float p3 = exp2_sfu(fmaf(s[j][3], c, mc1));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    s[j][0] = p0;
    s[j][1] = p1;
    s[j][2] = p2;
    s[j][3] = p3;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const Params p) {
  constexpr int LD = DP + 8;          // row stride in elements (+16 bytes)
  constexpr int CH = DP / 8;          // 16-byte chunks of a padded row
  constexpr int KD = DP / 16;         // k steps of q k^T over dh
  constexpr int ND = DP / 8;          // n tiles of the output
  constexpr int kBK = key_tile(DP);   // keys a tile
  constexpr int NT = kBK / 8;         // n tiles of the score tile
  constexpr int R = row_tiles(DP);
  constexpr int kBQ = block_rows(DP);
  constexpr bool kQinRegs = R * DP <= 128;   // else ldmatrix'd every tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                        // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                    // [2][kBK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;            // fragment row (and row + 8)
  const int t = lane & 3;             // fragment column pair
  // heaviest q tile first; the heads of one q tile run together
  const int hb = blockIdx.x % (p.H * p.B);
  const int qt = p.n_qt - 1 - blockIdx.x / (p.H * p.B);
  const int h = hb % p.H;
  const int b = hb / p.H;
  const int kh = h / p.group;
  const int q0 = qt * kBQ;
  const int nch = p.dh >> 3;

  const bf16* qb = p.q + b * p.qs.b + h * p.qs.h;
  const bf16* kb = p.k + b * p.ks.b + kh * p.ks.h;
  const bf16* vb = p.v + b * p.vs.b + kh * p.vs.h;

  // the padding columns dh..DP-1 of every tile row: zero, never loaded
  if (nch < CH) {
    const int pad = CH - nch;
    for (int idx = tid; idx < (kBQ + 4 * kBK) * pad; idx += kThreads) {
      const int r = idx / pad;
      const int c = nch + idx - r * pad;
      *reinterpret_cast<uint4*>(Qs + r * LD + c * 8) = make_uint4(0, 0, 0, 0);
    }
  }

  const int q_last = min(q0 + kBQ - 1, p.Sq - 1);
  const int kt_end = min(q_last, p.Sk - 1) / kBK;  // causal frontier
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kBK : 0;

  load_tile<DP>(Qs, qb, p.qs.s, q0, kBQ, p.Sq, nch);
  load_tile<DP>(Ks, kb, p.ks.s, kt_begin * kBK, kBK, p.Sk, nch);
  load_tile<DP>(Vs, vb, p.vs.s, kt_begin * kBK, kBK, p.Sk, nch);
  cp_async_commit();

  uint32_t qf[kQinRegs ? R : 1][kQinRegs ? KD : 1][4];
  float o[R][ND][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][n][e] = 0.0f;
  float m[R][2], l[R][2];             // l: this thread's share of the sums
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r][0] = m[r][1] = kNegInf;
    l[r][0] = l[r][1] = 0.0f;
  }

  // ldmatrix row addresses: lane -> (row, 8-column half) of its matrix
  const bf16* q_lane =
      Qs + (warp * 16 * R + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int row0 = q0 + warp * 16 * R + g;   // tile r: row0 + 16 r (+ 8)

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait_all();
    // tile kt (and Q) visible to all, and every warp is done with tile
    // kt - 1, whose stage the next load takes
    __syncthreads();
    if (kt < kt_end) {
      const int nxt = (kt + 1) * kBK;
      load_tile<DP>(Ks + (st ^ 1) * kBK * LD, kb, p.ks.s, nxt, kBK, p.Sk, nch);
      load_tile<DP>(Vs + (st ^ 1) * kBK * LD, vb, p.vs.s, nxt, kBK, p.Sk, nch);
      cp_async_commit();
    }
    if (kQinRegs && kt == kt_begin) {
#pragma unroll
      for (int r = 0; r < (kQinRegs ? R : 0); ++r)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix_x4(qf[kQinRegs ? r : 0][kQinRegs ? kk : 0],
                      smem_u32(q_lane + r * 16 * LD + kk * 16));
    }
    const bf16* Kt = Ks + st * kBK * LD;
    const bf16* Vt = Vs + st * kBK * LD;
    const int k0 = kt * kBK;
    // only the diagonal, window-edge and ragged tiles are masked
    const bool edge = k0 + kBK - 1 > q0 || k0 + kBK > p.Sk ||
                      (p.window > 0 && k0 <= q_last - p.window);

    // S = Q K^T (16 rows x kBK keys a row tile), each K fragment feeding
    // every row tile; then the softmax step, P into A-fragments
    float s[R][NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (kQinRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            qa[r][e] = qf[kQinRegs ? r : 0][kQinRegs ? kk : 0][e];
        } else {
          ldmatrix_x4(qa[r], smem_u32(q_lane + r * 16 * LD + kk * 16));
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(Kt + np * 16 * LD + kk * 16 + k_off));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mma_bf16(s[r][2 * np], qa[r], kf[0], kf[1]);
          mma_bf16(s[r][2 * np + 1], qa[r], kf[2], kf[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      softmax_step<kCap, NT, ND>(s[r], m[r], l[r], o[r], edge, p,
                                 row0 + 16 * r, k0, t);

    // O += P_hi V + P_lo V, one k16 slice of P at a time, each V fragment
    // feeding both halves of every row tile
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[R][4], pl[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        split_bf16(s[r][2 * kk][0], s[r][2 * kk][1], ph[r][0], pl[r][0]);
        split_bf16(s[r][2 * kk][2], s[r][2 * kk][3], ph[r][1], pl[r][1]);
        split_bf16(s[r][2 * kk + 1][0], s[r][2 * kk + 1][1], ph[r][2],
                   pl[r][2]);
        split_bf16(s[r][2 * kk + 1][2], s[r][2 * kk + 1][3], ph[r][3],
                   pl[r][3]);
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(Vt + kk * 16 * LD + dp * 16 + v_off));
        // the hi products of every tile first: no two neighbouring mmas
        // share an accumulator
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mma_bf16(o[r][2 * dp], ph[r], vf[0], vf[1]);
          mma_bf16(o[r][2 * dp + 1], ph[r], vf[2], vf[3]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mma_bf16(o[r][2 * dp], pl[r], vf[0], vf[1]);
          mma_bf16(o[r][2 * dp + 1], pl[r], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait_all();                 // nothing in flight past the loop

  bf16* ob = p.o + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[r][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.0f / fmaxf(li, 1e-30f);
      const int row = row0 + 16 * r + 8 * i;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        if (8 * n < p.dh) {
          const __nv_bfloat162 val = __floats2bfloat162_rn(
              o[r][n][2 * i] * inv, o[r][n][2 * i + 1] * inv);
          *reinterpret_cast<__nv_bfloat162*>(ob + row * p.os.s + 8 * n +
                                             2 * t) = val;
        }
      }
    }
}

template <int DP, bool kCap>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (block_rows(DP) + 4 * key_tile(DP)) * (DP + 8);
  auto kern = flash_bf16_kernel<DP, kCap>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params args = p;
  args.n_qt = (p.Sq + block_rows(DP) - 1) / block_rows(DP);
  const unsigned int blocks =
      static_cast<unsigned int>(args.n_qt) * p.H * p.B;
  kern<<<blocks, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(const Params& p, bool softcap, cudaStream_t stream) {
  return softcap ? launch<DP, true>(p, stream) : launch<DP, false>(p, stream);
}

}  // namespace

extern "C" {

// q (B, H, Sq, dh), k and v (B, K, Sk, dh), o (B, H, Sq, dh), all bf16,
// each with its own (batch, head, sequence) element strides, multiples of
// 8, a unit stride along dh and a 16-byte-aligned base; dh a multiple of
// 8 up to 256.  window <= 0: no window; softcap <= 0: none.  Launches on
// `stream` and returns the CUDA error (0 on success); a shape it does not
// take returns cudaErrorInvalidValue.
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int K, int Sq, int Sk,
                             int dh, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                             int64_t k_sb, int64_t k_sh, int64_t k_ss,
                             int64_t v_sb, int64_t v_sh, int64_t v_ss,
                             int64_t o_sb, int64_t o_sh, int64_t o_ss,
                             float scale, int window, float softcap,
                             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0 || dh <= 0 || dh > 256 || dh % 8 != 0 ||
      Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.H = H;
  p.B = B;
  p.group = H / K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.dh = dh;
  p.window = window;
  p.qs = Strides{q_sb, q_sh, q_ss};
  p.ks = Strides{k_sb, k_sh, k_ss};
  p.vs = Strides{v_sb, v_sh, v_ss};
  p.os = Strides{o_sb, o_sh, o_ss};
  p.scale_log2 = scale * kLog2e;
  const bool cap = softcap > 0.0f;
  p.cap_in = cap ? scale / softcap : 0.0f;
  p.cap_out = cap ? softcap * kLog2e : 0.0f;
  auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 32) return launch<32>(p, cap, st);
  if (dh <= 64) return launch<64>(p, cap, st);
  if (dh <= 80) return launch<80>(p, cap, st);
  if (dh <= 128) return launch<128>(p, cap, st);
  return launch<256>(p, cap, st);
}

const char* flash_attention_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
