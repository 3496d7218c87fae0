// Batched root-feasibility scan over the scheduler's flat resource graph.
//
// Replaces the Pallas TPU kernel `_feasible_pallas` / `_feasible_kernel` of
// src/repro/kernels/feasibility.py (called by FlatGraph.feasible_roots_batch,
// the backfill prefilter). For request row u and vertex v:
//
//   out[u, v] = vtype[v] == tid[u] && vok[v] != 0 && vsize[v] >= msize[u]
//               && (vmask[v] & rmask[u]) == rmask[u]
//               && agg[v, t] >= need[u, t] for every type t
//
// What bounds it on an H100: bytes. Per vertex it reads 17 + 4T bytes of
// columns and writes U bytes; per (u, v) pair it does about 5 + T integer
// compares, far under the CUDA cores' rate. What the design does about it:
//
//  - one thread per vertex reads that vertex's columns once and loops over
//    the request rows, which the block holds in shared memory (a backfill
//    window deduplicates to a handful of distinct shapes; rows past
//    kRowsPerBlock go to further blocks along grid y);
//  - out is [U, V] row-major, so for each row the stores of a warp are 32
//    neighbouring bytes;
//  - the 62-bit property masks are native int64 (the TPU kernel split them
//    into two int31 halves, having no int64 lanes);
//  - nothing is padded or transposed on the host: agg is read as [V, T]
//    through its row stride (the host table grows its type columns in
//    steps of 4, so agg[:n, :T] is a strided view) and the ragged edge of
//    V is a bounds check.
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;

__global__ void __launch_bounds__(kThreads)
feasible_kernel(const int32_t* __restrict__ vtype, const uint8_t* __restrict__ vok,
                const int32_t* __restrict__ vsize, const int64_t* __restrict__ vmask,
                const int32_t* __restrict__ agg, long long agg_stride,
                const int32_t* __restrict__ tid, const int32_t* __restrict__ msize,
                const int64_t* __restrict__ rmask, const int32_t* __restrict__ need,
                int V, int T, int U, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_rmask = reinterpret_cast<int64_t*>(smem);                   // [rows]
  int32_t* s_tid = reinterpret_cast<int32_t*>(s_rmask + kRowsPerBlock);  // [rows]
  int32_t* s_msize = s_tid + kRowsPerBlock;                              // [rows]
  int32_t* s_need = s_msize + kRowsPerBlock;                             // [rows, T]

  const int u0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, U - u0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s_tid[i] = tid[u0 + i];
    s_msize[i] = msize[u0 + i];
    s_rmask[i] = rmask[u0 + i];
  }
  for (int i = threadIdx.x; i < rows * T; i += blockDim.x)
    s_need[i] = need[(long long)u0 * T + i];
  __syncthreads();

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const bool ok = vok[v] != 0;
  const int32_t ty = vtype[v];
  const int32_t sz = vsize[v];
  const int64_t m = vmask[v];
  const int32_t* a = agg + v * agg_stride;
  uint8_t* o = out + (long long)u0 * V + v;
  for (int r = 0; r < rows; ++r) {
    bool f = ok && ty == s_tid[r] && sz >= s_msize[r] && (m & s_rmask[r]) == s_rmask[r];
    for (int t = 0; f && t < T; ++t) f = a[t] >= s_need[r * T + t];
    o[(long long)r * V] = f ? 1 : 0;
  }
}

}  // namespace

extern "C" int feasible_fwd(const void* vtype, const void* vok, const void* vsize,
                            const void* vmask, const void* agg, long long agg_stride,
                            int V, int T, const void* tid, const void* msize,
                            const void* rmask, const void* need, int U, void* out,
                            void* stream) {
  dim3 grid((V + kThreads - 1) / kThreads, (U + kRowsPerBlock - 1) / kRowsPerBlock);
  size_t smem = kRowsPerBlock * (sizeof(int64_t) + (2 + T) * sizeof(int32_t));
  feasible_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vtype), static_cast<const uint8_t*>(vok),
      static_cast<const int32_t*>(vsize), static_cast<const int64_t*>(vmask),
      static_cast<const int32_t*>(agg), agg_stride, static_cast<const int32_t*>(tid),
      static_cast<const int32_t*>(msize), static_cast<const int64_t*>(rmask),
      static_cast<const int32_t*>(need), V, T, U, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
