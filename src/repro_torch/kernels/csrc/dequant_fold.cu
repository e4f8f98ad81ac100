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
// Design: a block of 4 warps owns a tile of columns and walks the clients
// in order, so each column's fold is the one above whatever the grid; the
// client loop is never split.  The bytes arrive in 16-byte copies: both
// widths the paths run (199,210 and 28,146,762) are 10 mod 16, so a row of
// Q starts only 2-byte aligned and a vector load straight from the row
// would be misaligned.  Instead the block stages a (clients x columns)
// int8 tile in shared memory with cp.async.cg, 16 bytes a copy, each
// row's aligned covering range of the tile (zero-filled past the row's
// end), and beside it each row's scales for the tile (4-byte cp.async; a
// tile meets at most tile / 32 + 1 blocks of qblock >= 32) and the
// weights, so the fold itself reads shared memory only.  The copies of the
// next chunk of clients are in flight while the current one is folded (two
// stages).  The chunk follows n: 8 clients up to n = 8 (a streamed block,
// one stage), n rounded up to 8 below 32, 32 above.  A thread owns runs of
// 4 consecutive columns (lane l: columns 4l .. 4l + 3 of each 128-column
// group of its warp); it reads a run as two consecutive aligned words of
// the staged row at the row's own byte offset and one funnel shift (the
// lanes read consecutive words, no bank conflict), and one scale a client
// serves the run (a 4-column run never straddles a scale block when qblock
// is a multiple of 4).  The runs a thread owns follow n as well: where n
// <= 8 a thread has only 8 rows of a run to load, so it owns two runs
// (tiles of 1024 columns, 64 bytes a thread in flight); above, one (tiles
// of 512), which doubles the warps at D = 199,210 to about a dozen an SM
// to share the fold's latency (its client loop is serial per column).
// Each int8 becomes its float with a byte permute and one add (2^23 + b +
// 128, less 2^23 + 128: exact) rather than the conversion unit, which runs
// at a quarter of the rate.  Other qblocks (not a multiple of 4, or below
// 32) read each column's scale from global memory.
//
// The pre-redesign kernel (one thread a column, one byte load a client)
// stays below as dequant_fold_percolumn_f32, a reference that the on-card
// check holds the new kernel to bit for bit; no path launches it.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ---- the kernel of the path ----

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 32;                  // clients a stage, at most
// below this many clients (one chunk of 8) a thread owns two runs, else one
constexpr int kWideRunsUpTo = 8;
// scale blocks a staged row holds: a tile of T columns meets at most
// T / 32 + 1 blocks when qblock >= 32; smaller qblocks read scales from
// global memory
constexpr int kMinStagedQblock = 32;

// the tile of a block whose threads own R 4-column runs each
template <int R>
struct Tile {
  static constexpr int kWarpCols = 32 * 4 * R;           // 128 R
  static constexpr int kCols = kWarps * kWarpCols;       // 512 R a block
  static constexpr int kRowBytes = kCols + 16;           // a staged row
  static constexpr int kRowCopies = kRowBytes / 16;      // 32 R + 1
  static constexpr int kScaleSlots = kCols / kMinStagedQblock + 1;
  // a stage: the q rows, then each row's scales, then the weights
  __host__ __device__ static constexpr int stage_bytes(int chunk) {
    return (chunk * (kRowBytes + 4 * kScaleSlots + 4) + 15) & ~15;
  }
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

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

// 4 bytes global -> shared (through L1); zero-fills when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the clients [i0, i0 + rows) of the tile at column c0 into `stage`: each
// row's 16-byte-aligned covering range of [c0, c0 + Tile<R>::kCols), copies
// that hold no byte of the row zero-filled (so none reads past Q's end);
// with kStaged the row's scale blocks [b0, b0 + nbt); the weights
template <bool kStaged, int R>
__device__ __forceinline__ void stage_rows(unsigned char* stage,
                                           const int8_t* q,
                                           const float* scale,
                                           const float* w, int64_t d,
                                           int64_t nb, int64_t c0,
                                           int64_t b0, int nbt, int64_t i0,
                                           int rows, int chunk) {
  using T = Tile<R>;
  for (int idx = threadIdx.x; idx < rows * T::kRowCopies; idx += kThreads) {
    const int r = idx / T::kRowCopies;
    const int j = idx - r * T::kRowCopies;
    const uintptr_t row = reinterpret_cast<uintptr_t>(q + (i0 + r) * d);
    const uintptr_t start = (row + c0) & ~static_cast<uintptr_t>(15);
    const uintptr_t src = start + 16 * j;
    const bool in = src < row + d;
    cp_async16(smem_u32(stage + r * T::kRowBytes + 16 * j),
               reinterpret_cast<const void*>(in ? src : start), in);
  }
  unsigned char* sc = stage + chunk * T::kRowBytes;
  if constexpr (kStaged) {
    for (int idx = threadIdx.x; idx < rows * nbt; idx += kThreads) {
      const int r = idx / nbt;
      const int j = idx - r * nbt;
      cp_async4(smem_u32(sc + 4 * (r * T::kScaleSlots + j)),
                scale + (i0 + r) * nb + b0 + j, true);
    }
  }
  unsigned char* ws = sc + 4 * chunk * T::kScaleSlots;
  for (int r = threadIdx.x; r < rows; r += kThreads)
    cp_async4(smem_u32(ws + 4 * r), w + i0 + r, true);
}

// int8 byte e of v as an exact float without the conversion unit: the
// byte, offset by 128, becomes the low mantissa bits of 2^23
__device__ __forceinline__ float byte_to_float(uint32_t v_biased, int e) {
  return __int_as_float(static_cast<int>(
             __byte_perm(v_biased, 0x4B000000u, 0x7650u | e))) -
         8388736.0f;   // 2^23 + 128
}

// kStaged: qblock % 4 == 0 and qblock >= 32, so one scale a client serves
// a 4-column run and the tile's scales fit in the stage; else each column
// reads its scale from global memory.  R: 4-column runs a thread.
template <bool kStaged, int R>
__global__ void __launch_bounds__(kThreads)
    dequant_fold_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        const float* __restrict__ w,
                        const float* __restrict__ acc,
                        float* __restrict__ out, int64_t n, int64_t d,
                        int64_t nb, int64_t qblock, int chunk, int stages,
                        bool vec) {
  using T = Tile<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * T::kCols;
  // the tile's scale blocks [b0, b0 + nbt)
  const int64_t b0 = c0 / qblock;
  const int nbt = static_cast<int>(
      imin((c0 + T::kCols - 1) / qblock, nb - 1) - b0 + 1);
  // run k: tile columns cc[k] .. cc[k] + 3; its scale slot (kStaged) or
  // its columns' scale blocks, clamped past the end
  int cc[R];
  int64_t blk[R][kStaged ? 1 : 4];
  float s[R][4];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    cc[k] = warp * T::kWarpCols + k * 128 + 4 * lane;
    const int64_t c = c0 + cc[k];
#pragma unroll
    for (int e = 0; e < (kStaged ? 1 : 4); ++e)
      blk[k][e] = imin((c + e) / qblock, nb - 1) - (kStaged ? b0 : 0);
    if (vec && c + 3 < d) {
      const float4 a = *reinterpret_cast<const float4*>(acc + c);
      s[k][0] = a.x;
      s[k][1] = a.y;
      s[k][2] = a.z;
      s[k][3] = a.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[k][e] = c + e < d ? acc[c + e] : 0.f;
    }
  }

  const int sbytes = T::stage_bytes(chunk);
  const int64_t nch = (n + chunk - 1) / chunk;
  stage_rows<kStaged, R>(smem, q, scale, w, d, nb, c0, b0, nbt, 0,
                         static_cast<int>(imin(chunk, n)), chunk);
  cp_async_commit();
  for (int64_t ch = 0; ch < nch; ++ch) {
    const int64_t i0 = ch * chunk;
    if (ch + 1 < nch) {
      // the next chunk's copies fly while this one is folded
      const int64_t i1 = i0 + chunk;
      stage_rows<kStaged, R>(smem + ((ch + 1) % stages) * sbytes, q, scale,
                             w, d, nb, c0, b0, nbt, i1,
                             static_cast<int>(imin(chunk, n - i1)), chunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = smem + (ch % stages) * sbytes;
    const float* st_scale = reinterpret_cast<const float*>(
        st + chunk * T::kRowBytes);
    const float* st_w = st_scale + chunk * T::kScaleSlots;
    const int rows = static_cast<int>(imin(chunk, n - i0));
    // a row's byte offset in its staged copy; the next row's is d bytes on
    int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(q + i0 * d + c0) & 15u);
    const int d16 = static_cast<int>(d & 15);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(
          st + r * T::kRowBytes + (off & ~3));
      const int shift = (off & 3) * 8;
      off = (off + d16) & 15;
      const float wi = st_w[r];
      const float* si = kStaged ? st_scale + r * T::kScaleSlots
                                : scale + (i0 + r) * nb;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const uint32_t v = __funnelshift_r(words[cc[k] >> 2],
                                           words[(cc[k] >> 2) + 1], shift) ^
                           0x80808080u;
        float sc[4];
        if constexpr (kStaged) {
          sc[0] = sc[1] = sc[2] = sc[3] = si[blk[k][0]];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[e] = __ldg(si + blk[k][e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[k][e] = fmaf(__fmul_rn(byte_to_float(v, e), sc[e]), wi, s[k][e]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int64_t c = c0 + cc[k];
    if (vec && c + 3 < d) {
      *reinterpret_cast<float4*>(out + c) =
          make_float4(s[k][0], s[k][1], s[k][2], s[k][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) out[c + e] = s[k][e];
    }
  }
}

// ---- the pre-redesign kernel, kept as the on-card check's reference ----

constexpr int kColThreads = 256;

__global__ void __launch_bounds__(kColThreads)
    dequant_fold_percolumn_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ w,
                                  const float* __restrict__ acc,
                                  float* __restrict__ out, int64_t n,
                                  int64_t d, int64_t nb, int64_t qblock) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * kColThreads + threadIdx.x;
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

template <int R>
int launch(const void* q, const void* scale, const void* w, const void* acc,
           void* out, int64_t n, int64_t d, int64_t nb, int64_t qblock,
           int chunk, int stages, bool vec, bool staged, void* stream) {
  using T = Tile<R>;
  const int smem = stages * T::stage_bytes(chunk);
  const unsigned int blocks =
      static_cast<unsigned int>((d + T::kCols - 1) / T::kCols);
  auto kern = staged ? dequant_fold_kernel<true, R>
                     : dequant_fold_kernel<false, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(w), static_cast<const float*>(acc),
      static_cast<float*>(out), n, d, nb, qblock, chunk, stages, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (n, d) int8; scale: (n, nb) fp32; w: (n,) fp32; acc, out: (d,) fp32;
// all contiguous.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int dequant_fold_f32(const void* q, const void* scale, const void* w,
                     const void* acc, void* out, int64_t n, int64_t d,
                     int64_t nb, int64_t qblock, void* stream) {
  if (d <= 0) return 0;
  if (qblock < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the chunk follows n: n rounded up to 8 (at least 8), at most
  // kMaxChunk; two stages only where there is a next chunk to load
  const int chunk = static_cast<int>(
      n < kMaxChunk ? (n > 8 ? ((n + 7) / 8) * 8 : 8) : kMaxChunk);
  const int stages = n > chunk ? 2 : 1;
  const bool vec = ((reinterpret_cast<uintptr_t>(acc) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const bool staged = qblock % 4 == 0 && qblock >= kMinStagedQblock;
  return n <= kWideRunsUpTo
             ? launch<2>(q, scale, w, acc, out, n, d, nb, qblock, chunk,
                         stages, vec, staged, stream)
             : launch<1>(q, scale, w, acc, out, n, d, nb, qblock, chunk,
                         stages, vec, staged, stream);
}

// The pre-redesign kernel, same arguments: for the on-card check only.
int dequant_fold_percolumn_f32(const void* q, const void* scale,
                               const void* w, const void* acc, void* out,
                               int64_t n, int64_t d, int64_t nb,
                               int64_t qblock, void* stream) {
  if (d > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((d + kColThreads - 1) / kColThreads);
    dequant_fold_percolumn_kernel<<<blocks, kColThreads, 0,
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
