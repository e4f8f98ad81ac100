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
// Design: each row is cut into fixed segments, and one thread-block
// cluster (Hopper) reduces a row: grid (C, N), cluster (C, 1), so eight or
// 23 rows of a wide model still spread over all 132 SMs in one launch.  A
// row reads as a scalar head up to its first 16-byte boundary, float4s
// from there and a scalar tail.  Segment s holds float4s [2048 s,
// 2048 (s + 1)) counted from that boundary; the head belongs to segment 0
// and the tail to the last.  Block c of the cluster walks segments c,
// c + C, c + 2C, ... in turn: thread t loads its 8 float4s of z and g in a
// segment (t + 256 j, j = 0..7) before any arithmetic and keeps three
// fp32 FMA partials across its segments; the block reduces them with a
// fixed-order warp-shuffle tree and a fixed-order pass over the warps'
// partials, and block 0 of the cluster then sums the C blocks' results in
// rank order through distributed shared memory (cluster.map_shared_rank),
// between two cluster barriers.  No workspace and no second launch.  The
// kernel holds about 80 registers a thread, so two or three blocks share
// an SM and a 16-block cluster fits in a GPC beside others; loading two
// segments at once took 185 and slowed the small shapes.
// Where a row has one segment for every alignment (D up to ~8192, S1's
// 7850) C is 1 and the one block writes the row's result.
//
// The plan of a row (head, float4s, segments) is computed by the Python
// wrapper from D and the row's address mod 16, for each of the four
// alignments, and passed in with C = min(16, the largest segment count),
// also a function of D: a row's reduction order depends on D and its
// alignment only, never on N, the grid or the card.  So a row of a fresh
// 8-row block gives the bits of the same row in the 23-row matrix, which
// the streaming rounds need to equal the dense ones bit for bit.  There
// are no atomics: two launches on the same inputs give identical bits.
// z and g must share their 16-byte alignment (the wrapper checks).  C
// above 8 is a non-portable cluster size, which the H100 takes.
#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = 8;
constexpr int64_t kSegVec = kThreads * kVecPerThread;   // float4s a segment
constexpr int kMaxCluster = 16;

// by (row address mod 16) / 4
struct Plan {
  int64_t head[4];   // scalars before the row's first 16-byte boundary
  int64_t nvec[4];   // float4s from there
  int64_t nseg[4];   // segments: max(1, ceil(nvec / kSegVec))
};

// entry a of a 4-entry parameter array without indexing it at run time
// (which would copy the array to local memory)
__device__ __forceinline__ int64_t pick(const int64_t (&v)[4], int a) {
  return a == 0 ? v[0] : a == 1 ? v[1] : a == 2 ? v[2] : v[3];
}

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

// the block's three sums in a fixed order, valid in thread 0
__device__ __forceinline__ void block_sum(float& zg, float& zz, float& gg) {
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
    zg = warp_sum(lane < kWarps ? partial[0][lane] : 0.f);
    zz = warp_sum(lane < kWarps ? partial[1][lane] : 0.f);
    gg = warp_sum(lane < kWarps ? partial[2][lane] : 0.f);
  }
}

// row blockIdx.y; block blockIdx.x of a cluster of gridDim.x blocks
// (kCluster), or the row's only block (!kCluster)
template <bool kCluster>
__global__ void __launch_bounds__(kThreads)
    similarity_stats_kernel(const float* __restrict__ z,
                            const float* __restrict__ g,
                            float* __restrict__ out, int64_t d,
                            const Plan plan) {
  __shared__ float result[3];
  const int64_t row = blockIdx.y;
  const int rank = blockIdx.x;
  const int csize = gridDim.x;
  const float* zr = z + row * d;
  const float* gr = g + row * d;
  const int a = static_cast<int>(
      (reinterpret_cast<uintptr_t>(zr) & 15u) >> 2);
  const int64_t head = pick(plan.head, a);
  const int64_t nvec = pick(plan.nvec, a);
  const int64_t nseg = pick(plan.nseg, a);
  const int t = threadIdx.x;
  const float4* z4 = reinterpret_cast<const float4*>(zr + head);
  const float4* g4 = reinterpret_cast<const float4*>(gr + head);
  float zg = 0.f, zz = 0.f, gg = 0.f;

  for (int64_t seg = rank; seg < nseg; seg += csize) {
    if (seg == 0 && t < head) accumulate(zr[t], gr[t], zg, zz, gg);
    const int64_t v0 = seg * kSegVec + t;
    float4 za[kVecPerThread], ga[kVecPerThread];
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      const int64_t v = v0 + j * kThreads;
      if (v < nvec) {
        za[j] = __ldg(z4 + v);
        ga[j] = __ldg(g4 + v);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      if (v0 + j * kThreads < nvec) {
        accumulate(za[j].x, ga[j].x, zg, zz, gg);
        accumulate(za[j].y, ga[j].y, zg, zz, gg);
        accumulate(za[j].z, ga[j].z, zg, zz, gg);
        accumulate(za[j].w, ga[j].w, zg, zz, gg);
      }
    }
    if (seg == nseg - 1) {
      const int64_t i = head + 4 * nvec + t;
      if (i < d) accumulate(zr[i], gr[i], zg, zz, gg);
    }
  }
  block_sum(zg, zz, gg);

  if constexpr (!kCluster) {
    if (t == 0) {
      out[row * 3 + 0] = zg;
      out[row * 3 + 1] = zz;
      out[row * 3 + 2] = gg;
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    if (t == 0) {
      result[0] = zg;
      result[1] = zz;
      result[2] = gg;
    }
    cluster.sync();   // every block's result is in its shared memory
    if (rank == 0 && t == 0) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < csize; ++r) {
        const float* rr = cluster.map_shared_rank(result, r);
        s0 += rr[0];
        s1 += rr[1];
        s2 += rr[2];
      }
      out[row * 3 + 0] = s0;
      out[row * 3 + 1] = s1;
      out[row * 3 + 2] = s2;
    }
    cluster.sync();   // no block leaves while block 0 reads its result
  }
}

}  // namespace

extern "C" {

// z, g: (n, d) fp32 contiguous; out: (n, 3) fp32.  plan: 12 int64, the
// heads, float4 counts and segment counts of the four alignments (row
// address mod 16 = 0, 4, 8, 12); cluster: the blocks a row, 1..16.
// Launches on `stream` and returns the CUDA error (0 on success); a plan
// whose segment counts do not follow its float4 counts, a cluster size
// out of range, or more than 65535 rows returns cudaErrorInvalidValue.
int similarity_stats_f32(const void* z, const void* g, void* out, int64_t n,
                         int64_t d, const int64_t* plan, int cluster,
                         void* stream) {
  if (n <= 0) return 0;
  Plan p;
  for (int a = 0; a < 4; ++a) {
    p.head[a] = plan[a];
    p.nvec[a] = plan[4 + a];
    p.nseg[a] = plan[8 + a];
    const int64_t want =
        p.nvec[a] > 0 ? (p.nvec[a] + kSegVec - 1) / kSegVec : 1;
    if (p.nseg[a] != want || p.head[a] < 0 || p.head[a] > 3)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 65535 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* zf = static_cast<const float*>(z);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(cluster),
                  static_cast<unsigned int>(n));
  if (cluster == 1) {
    similarity_stats_kernel<false><<<grid, kThreads, 0, st>>>(zf, gf, of, d,
                                                              p);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = similarity_stats_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, zf, gf, of, d, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* similarity_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
