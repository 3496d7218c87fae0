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
// What bounds it on an H100: bytes, and at the scheduler's sizes the time
// to get them. Per vertex it reads 17 + 4T bytes of columns and writes U
// bytes; per (u, v) pair it does about 5 + T integer compares, far under
// the CUDA cores' rate. At LLNL Quartz (117,703 vertices, T 4, U 6) that
// is 3.9 MB in and 0.7 MB out, 1.4 us at 3.35 TB/s: the launch and a DRAM
// round trip are most of a launch. What the design does about it:
//
//  - each thread takes kVpt = 2 consecutive vertices and issues every load
//    of them before any compare, so it waits for one DRAM round trip:
//    vtype and vsize as 8-byte vectors, vok as one 2-byte word, vmask as
//    one 16-byte load, and each agg row as one int4 where T is 4 and the
//    rows lie 16 bytes apart (the host table grows its type columns in
//    steps of 4, so Quartz's agg is [V, 4]): 66 bytes in flight a thread.
//    Blocks of kThreads = 256 make 230 blocks at Quartz on the 132 SMs.
//    Those two were the fastest of VPT 2, 4 and 8 at 128 or 256 threads
//    (PERF.md, tools/feasibility_variants.py);
//  - no barrier and no dependent load stands between those loads and the
//    compares: a block takes at most 32 request rows (a backfill window
//    deduplicates to a handful of distinct shapes; rows past 32 go to
//    further blocks along grid y), and lane i of every warp loads row i
//    into registers beside its vertex loads, so both arrive in the same
//    round trip; the compare loop broadcasts row r from lane r by
//    shuffles. (Rows staged in shared memory behind a barrier, and rows
//    read from device memory inside the row loop, were built and measured
//    slower: PERF.md.) A vertex's agg row stays in registers across the
//    rows; the compares are branch-free;
//  - out is [U, V] row-major: each thread stores its kVpt bytes of a row
//    where it computes them, so a warp's stores of a row are 32 kVpt
//    neighbouring bytes, and a warp stores as soon as its own loads have
//    arrived. The stores are a small part of a launch; staging the mask
//    in shared memory to write each row with 16-byte
//    stores over its aligned middle (a row starts at u V, not 16-byte
//    aligned for an odd V) was built and measured slower, behind a block
//    barrier (which makes every warp wait for the block's slowest loads)
//    and per warp alike (PERF.md, tools/feasibility_variants.py);
//  - a general path in the same kernel takes per-element loads where the
//    vector loads do not apply: columns not 16-byte aligned (views that
//    start inside their storage), agg rows of another stride or width
//    (T > 4 reads agg inside the compare loop), and the ragged tail of V;
//  - the 62-bit property masks are native int64 (the TPU kernel split them
//    into two int31 halves, having no int64 lanes).
//
// The launch plan (grid, which loads are vectors) is computed by the
// wrapper, kernels/feasibility.py::feasible_plan, and passed in with the
// VPT and block size it assumed, which must be kVpt and kThreads; the CPU
// tests hold its partition of the work (tests/test_torch_feasibility_plan.py).
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRowsPerBlock = 32;     // a lane of every warp holds one
constexpr int kVpt = 2;               // consecutive vertices a thread
constexpr int kThreads = 256;         // threads a block

template <int B>
struct Word;   // an unsigned type of B bytes, loadable with __ldg
template <>
struct Word<1> { using T = unsigned char; };
template <>
struct Word<2> { using T = unsigned short; };
template <>
struct Word<4> { using T = unsigned int; };
template <>
struct Word<8> { using T = uint2; };
template <>
struct Word<16> { using T = uint4; };

// dst = src[0 .. N), in pieces of up to 16 bytes; src aligned to a piece
template <typename E, int N>
__device__ __forceinline__ void load_vec(E (&dst)[N], const E* src) {
  constexpr int kBytes = static_cast<int>(sizeof(E)) * N;
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kPiece>::T;
  W w[kBytes / kPiece];
#pragma unroll
  for (int i = 0; i < kBytes / kPiece; ++i) w[i] = __ldg(reinterpret_cast<const W*>(src) + i);
  memcpy(dst, w, kBytes);
}

// grid (ceil(V / (kVpt kThreads)), ceil(U / 32)); block b.x covers vertices
// [b.x kVpt kThreads, + kVpt kThreads) and rows [32 b.y, + 32), thread t
// the kVpt vertices from t kVpt. vec_cols: vtype, vok, vsize and vmask are
// 16-byte aligned; vec_agg: T == 4, agg 16-byte aligned, its row stride a
// multiple of 4.
__global__ void __launch_bounds__(kThreads)
feasible_kernel(const int32_t* __restrict__ vtype, const uint8_t* __restrict__ vok,
                const int32_t* __restrict__ vsize, const int64_t* __restrict__ vmask,
                const int32_t* __restrict__ agg, long long agg_stride,
                const int32_t* __restrict__ tid, const int32_t* __restrict__ msize,
                const int64_t* __restrict__ rmask, const int32_t* __restrict__ need, int V, int T,
                int U, int vec_cols, int vec_agg, uint8_t* __restrict__ out) {
  const int u0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, U - u0);
  const long long v0 = static_cast<long long>(blockIdx.x) * kVpt * kThreads;
  const int n = static_cast<int>(min(static_cast<long long>(kVpt) * kThreads, V - v0));
  const int first = threadIdx.x * kVpt;         // this thread's first vertex, from v0
  const long long vt = v0 + first;
  const bool whole = first + kVpt <= n;

  // every load of this thread's vertices, before any compare
  int32_t ty[kVpt], sz[kVpt], ag[kVpt][4];
  uint8_t ok[kVpt];
  int64_t m[kVpt];
  if (whole && vec_cols) {
    load_vec(ty, vtype + vt);
    load_vec(sz, vsize + vt);
    load_vec(ok, vok + vt);
    load_vec(m, vmask + vt);
  } else {
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const bool in = first + k < n;
      ty[k] = in ? vtype[vt + k] : 0;
      sz[k] = in ? vsize[vt + k] : 0;
      ok[k] = in ? vok[vt + k] : 0;
      m[k] = in ? vmask[vt + k] : 0;
    }
  }
  if (whole && vec_agg) {
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(agg + (vt + k) * agg_stride));
      ag[k][0] = a.x;
      ag[k][1] = a.y;
      ag[k][2] = a.z;
      ag[k][3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVpt; ++k)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ag[k][t] = first + k < n && t < T ? agg[(vt + k) * agg_stride + t] : 0;
  }

  // request row u0 + lane (the last row for lanes past it), need padded
  // to 4 columns with the least int
  const int lane = threadIdx.x % 32;
  const long long ul = u0 + min(lane, rows - 1);
  const int32_t lane_tid = __ldg(tid + ul), lane_size = __ldg(msize + ul);
  const int64_t lane_mask = __ldg(rmask + ul);
  int32_t lane_need[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) lane_need[t] = t < T ? __ldg(need + ul * T + t) : INT32_MIN;

  // the compares, each byte stored where it is computed
  for (int r = 0; r < rows; ++r) {
    const unsigned all = 0xffffffffu;
    const int32_t rt = __shfl_sync(all, lane_tid, r), rs = __shfl_sync(all, lane_size, r);
    const int64_t rm = __shfl_sync(all, lane_mask, r);
    int32_t nd4[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) nd4[t] = __shfl_sync(all, lane_need[t], r);
    const long long u = u0 + r;
    uint8_t* o = out + u * V + vt;
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      bool f = (ok[k] != 0) & (ty[k] == rt) & (sz[k] >= rs) & ((m[k] & rm) == rm);
      if (T <= 4) {
#pragma unroll
        for (int t = 0; t < 4; ++t) f &= ag[k][t] >= nd4[t];
      } else if (first + k < n) {
        const int32_t* a = agg + (vt + k) * agg_stride;
        const int32_t* nd = need + u * T;
        for (int t = 0; t < T; ++t) f &= a[t] >= nd[t];
      }
      if (first + k < n) o[k] = f;
    }
  }
}

}  // namespace

// plan: vpt and threads (must be kVpt and kThreads), grid x, grid y,
// vec_cols, vec_agg (feasible_plan in kernels/feasibility.py). out is a
// contiguous [U, V] uint8; need a contiguous [U, T] int32.
extern "C" int feasible_fwd(const void* vtype, const void* vok, const void* vsize,
                            const void* vmask, const void* agg, long long agg_stride,
                            int V, int T, const void* tid, const void* msize,
                            const void* rmask, const void* need, int U, void* out,
                            const int* plan, void* stream) {
  if (plan[0] != kVpt || plan[1] != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  feasible_kernel<<<dim3(plan[2], plan[3]), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vtype), static_cast<const uint8_t*>(vok),
      static_cast<const int32_t*>(vsize), static_cast<const int64_t*>(vmask),
      static_cast<const int32_t*>(agg), agg_stride, static_cast<const int32_t*>(tid),
      static_cast<const int32_t*>(msize), static_cast<const int64_t*>(rmask),
      static_cast<const int32_t*>(need), V, T, U, plan[4], plan[5], static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
