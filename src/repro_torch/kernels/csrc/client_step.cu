// The client step's epilogue: one local SGD step's update rows, written once.
//
// Replaces no TPU kernel.  The reference computes a client's (or a
// guide's) last local SGD step and its update as a chain of elementwise
// ops that XLA fuses into the gradient's consumers; the port's eager path
// ran each as its own (c, D) pass (the ridge term, lr·g, θ - lr·g, the
// difference from the start, the flattening) and a CUDA graph replays
// them all.  Here the whole chain is one pass: for a block of c clients,
// leaf k of the params and the per-client data-loss gradient g of the
// step, it writes
//
//     out[row0 + i, col_k + j] =
//         θ0[i, j] - round_T(θp[i, j] - lr * (g[i, j] + l2 * θp[i, j]))
//
// for i < rows, j < n_k, in fp32.  θ0 is the params the client started
// from and θp the params the step started from, each with a client stride
// of its own: 0 for params every client shares (θ0 always, θp at step 1),
// n_k for per-client params (θp after step 1 when E > 1).  round_T rounds
// to the params' type T (fp32: the identity; bf16: round to nearest even)
// and is widened back exactly, so a bf16 step is rounded once, as
// core/diversefl.sgd_round_once rounds it.  Every operation is rounded on
// its own (__fmul_rn, __fadd_rn, __fsub_rn: no contraction into an FMA),
// in the order of the plain version (kernels/client_step.py), so the two
// agree bit for bit; with l2 = 0 the ridge term is not added at all.
// The columns col_k are core/aggregators.flatten_updates' layout (leaves
// in sorted key order, each ravelled), so the rows land in the (C, D)
// update or guide matrix at their final place.
//
// lr is read on the device from a 0-d fp32 tensor when `lr_ptr` is given
// (the graphed round's rate: no host read, nothing copied under capture),
// else taken from the argument.
//
// Bound: HBM bytes.  Per call g is read once (c*n*size(T)), the rows are
// written once (c*n*4), and a shared θ0 and θp are read once per call
// (n*size(T)) and then served from L2 to the other rows: at the 3-NN's
// (64, 199210) in fp32, 102.8 MB, 30.7 us at 3.35 TB/s.
//
// Design: one thread block of kThreads threads covers a tile of kTile =
// kThreads*kItems consecutive columns of one leaf in one client row;
// each thread loads its kItems columns (kThreads apart, so every load and
// store instruction of a warp is one coalesced 128-byte line) before any
// arithmetic, so kItems loads of each operand are in flight a thread.
// Tiles follow leaf boundaries: a leaf's first tile starts at its own
// column 0, so no tile straddles two leaves, whatever the column
// alignment (w1 of the 3-NN starts at column 410, and every other row of
// D = 199210 fp32 starts 8 and not 16 bytes aligned): the kernel does
// scalar 4-byte (bf16: 2-byte) accesses and needs no alignment at all.
// The block index runs over rows fastest, so the c blocks of one tile run
// together and a shared θ0/θp tile comes from HBM once, then from L2.
// The leaves of a launch (at most kMaxLeaves) travel in the kernel's
// parameter block (__grid_constant__: indexed in place, never copied to
// local memory); a block finds its leaf by a uniform scan of the leaves'
// first tiles.  More leaves take one launch per kMaxLeaves.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int64_t kTile = kThreads * kItems;
constexpr int kMaxLeaves = 32;

struct Leaf {
  const void* g;     // (c, n) rows, g row i at g + i*sg
  const void* t0;    // θ0 row i at t0 + i*s0
  const void* tp;    // θp row i at tp + i*sp
  int64_t sg, s0, sp;
  int64_t n;         // columns of the leaf
  int64_t col;       // its first column in out
  int64_t tile0;     // its first tile in the launch
};

struct Args {
  Leaf leaf[kMaxLeaves];
  float* out;
  int64_t ld;        // out's row stride (D)
  int64_t row0;      // out row of client 0
  int64_t rows;      // client rows written
  const float* lr_ptr;
  float lr, l2;
  int count;         // leaves in this launch
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    client_step_rows_kernel(const __grid_constant__ Args a) {
  const int64_t b = blockIdx.x;
  const int64_t tile = b / a.rows;
  const int64_t i = b - tile * a.rows;
  int k = 0;
  while (k + 1 < a.count && tile >= a.leaf[k + 1].tile0) ++k;
  const Leaf& L = a.leaf[k];
  const int64_t j0 = (tile - L.tile0) * kTile + threadIdx.x;
  const T* g = static_cast<const T*>(L.g) + i * L.sg;
  const T* t0 = static_cast<const T*>(L.t0) + i * L.s0;
  const T* tp = static_cast<const T*>(L.tp) + i * L.sp;
  float* out = a.out + (a.row0 + i) * a.ld + L.col;
  const float lr = a.lr_ptr != nullptr ? __ldg(a.lr_ptr) : a.lr;
  float gv[kItems], pv[kItems], zv[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t j = j0 + static_cast<int64_t>(u) * kThreads;
    if (j < L.n) {
      gv[u] = widen(g[j]);
      pv[u] = widen(tp[j]);
      zv[u] = widen(t0[j]);
    }
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t j = j0 + static_cast<int64_t>(u) * kThreads;
    if (j < L.n) {
      float gl = gv[u];
      if (a.l2 != 0.f) gl = __fadd_rn(gl, __fmul_rn(a.l2, pv[u]));
      const float tn = round_to<T>(__fsub_rn(pv[u], __fmul_rn(lr, gl)));
      out[j] = __fsub_rn(zv[u], tn);
    }
  }
}

}  // namespace

extern "C" {

// g, t0, tp: `count` device pointers each (leaf k's gradient, θ0 and θp,
// all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1)); meta: 5 int64 a leaf,
// (g's, θ0's and θp's client strides in elements, the leaf's columns, its
// first column in out); out: fp32 with row stride ld, rows row0 ..
// row0 + rows - 1 written; lr_ptr: a device fp32 scalar or nullptr (then
// lr).  Launches ceil(non-empty leaves / 32) kernels on `stream` and
// returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for a
// grid out of range.
int client_step_rows(const void* const* g, const void* const* t0,
                     const void* const* tp, const int64_t* meta, int count,
                     int is_bf16, void* out, int64_t ld, int64_t row0,
                     int64_t rows, const void* lr_ptr, float lr, float l2,
                     void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.out = static_cast<float*>(out);
  a.ld = ld;
  a.row0 = row0;
  a.rows = rows;
  a.lr_ptr = static_cast<const float*>(lr_ptr);
  a.lr = lr;
  a.l2 = l2;
  int k = 0;
  while (k < count) {
    a.count = 0;
    int64_t tiles = 0;
    for (; k < count && a.count < kMaxLeaves; ++k) {
      const int64_t* m = meta + 5 * k;
      if (m[3] <= 0) continue;
      Leaf& L = a.leaf[a.count++];
      L.g = g[k];
      L.t0 = t0[k];
      L.tp = tp[k];
      L.sg = m[0];
      L.s0 = m[1];
      L.sp = m[2];
      L.n = m[3];
      L.col = m[4];
      L.tile0 = tiles;
      tiles += (m[3] + kTile - 1) / kTile;
    }
    if (a.count == 0) continue;
    const int64_t blocks = tiles * rows;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16) {
      client_step_rows_kernel<__nv_bfloat16>
          <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(a);
    } else {
      client_step_rows_kernel<float>
          <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* client_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
