// Mamba2 SSD intra-chunk kernels for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernel `ssd_chunk_pallas` / `_ssd_chunk_kernel` of
// src/repro/kernels/ssd_scan.py. Per (batch, chunk, head), with the chunk's
// Q positions, x [Q, P], dt [Q], A (this head's), B, C [Q, N] (the head's
// group, h / (H / G)):
//
//   seg      = cumsum(dt * A)                          (within the chunk)
//   y[i]     = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//   state    = sum_j exp(total - seg_j) B_j^T (dt_j x_j)   [N, P]
//   decay    = total = seg[Q - 1]
//
// The inter-chunk recurrence stays outside (kernels/ops.py::ssd_scan_op), as
// in the JAX package.
//
// What bounds it on an H100: operations, barely. The scores S = C B^T depend
// on the group and not on the head, so the work the contract needs is
// Q(Q+1)/2 * N * 2 per (batch, chunk, group) and Q(Q+1)/2 * P * 2 + Q*N*P*2
// per (batch, chunk, head): at the mamba2-2.7b serving shape (b 8, s 512,
// Q 256, H 80, P 64, G 1, N 128) 10.9 GFLOP, 0.066 ms at the tensor cores'
// fastest fp32-accurate rate (3 TF32 passes at 495 TFLOP/s), against 0.064
// ms for its 215 MB of inputs and outputs at 3.35 TB/s. The contract is fp32
// (atol = rtol = 1e-4): one TF32 pass (10-bit mantissa) or bf16 misses it,
// so every product is 3xTF32: a = a_hi + a_lo with a_hi = tf32(a) and a_lo =
// tf32(a - a_hi), and a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, three
// mma.sync.m16n8k8 TF32 products with fp32 sums (the dropped a_lo b_lo is
// 2^-22 of a b). What the design does about it, in two launches:
//
//  ssd_scores_kernel, once per (batch, chunk, group), 128 threads:
//   - one block per lower-triangular 64x64 tile of S (10 at Q 256): C and B
//     tiles come into shared memory by cp.async, each warp computes 16 rows
//     by 3xTF32 mma.sync, and the tile goes out, staged through shared
//     memory, in the order of the second kernel's A fragments (16 bytes per
//     lane per 16x8 fragment), into a scratch the wrapper allocates
//     ([b, nc, G, ceil(Q/16), ceil(Q/8), 32, 4] fp32, 4.2 MB at the mamba2
//     shape, which stays in L2);
//   - one more block per (batch, chunk, group) computes seg for the group's
//     heads, one thread a head: each dt*A rounded to fp32 (as the reference
//     rounds it), summed over the chunk in fp64 (53 bits hold the sum of
//     such terms exactly unless their magnitudes span more than about 20
//     binades, so the order of summation does not matter), and kept as an
//     fp32 pair hi + lo, hi the sum rounded to fp32 and lo the rounding of
//     the rest. At chunk 256 seg reaches about -190, where an fp32 ulp is
//     1.5e-5, and L = exp(seg_i - seg_j) is formed from the difference of
//     two such values: one fp32 seg puts y up to 3.5x the 1e-4 tolerance
//     from an fp32 sum in another order, the pair within a quarter of it
//     from the formula evaluated in fp64 (PERF.md;
//     tests/test_torch_ssd_numerics.py). hi and lo go to a scratch [2, b,
//     nc, Q, H] (dt's rows read across heads), hi's total to decay.
//
//  ssd_chunk_kernel, one block per (head, chunk, batch), 256 threads:
//   - heads vary fastest, so the blocks that read one chunk's S and B run
//     together and find them in L2;
//   - x and B come in 64-key tiles through a double-buffered cp.async ring,
//     16-byte pieces with consecutive threads on consecutive pieces of a row
//     (4-byte pieces where a row or stride is not 16-byte aligned); columns
//     and keys past P, N and Q are zero-filled, so every mma tile is whole;
//   - dt*x is split into its tf32 high and low parts once per tile in shared
//     memory, since all 8 warps read it as the B operand of both products;
//   - each warp owns 16-row fragments of the outputs, accumulated in
//     registers over the key tiles: y rows 16w.. and 16(15-w).. (so that the
//     causal work is the same for every warp) and state rows 16w..;
//     fragments wholly above the diagonal are never visited;
//   - y's A fragments are read from the scores scratch straight into
//     registers (one 16-byte load a lane, prefetched a step ahead), and the
//     mask and decay L = exp((hi_i - hi_j) + (lo_i - lo_j)) [j <= i] are
//     applied there, exp taken only where j <= i (above it exp may
//     overflow); the state's A fragments are B^T scaled by w = exp(total -
//     seg_j), formed from the pairs the same way, read from shared memory
//     without bank conflicts (row pitches of 8 mod 32 floats);
//   - y and the states go out as 16-byte stores after one shuffle a pair of
//     lanes.
//
// Shared memory: 66 KB a scores block, 126 KB a chunk block (one an SM; a
// thread may hold 255 registers, 96 of them accumulators). x, dt, B and C
// are read through their strides (unit stride on the last axis), so views
// into the model's projections need no copy. At 8 warps an SM the chunk
// kernel runs well above its bound, paced by instruction issue and the
// latency of its mma.sync chains more than by the tensor cores' rate
// (PERF.md, tools/ssd_chunk_variants.py).
//
// The backward (ssd_chunk_bwd; the Pallas kernel has none: the JAX package
// differentiates the jnp ssd_chunked with XLA) follows the forward kernels,
// with its own note.
//
// Plain C interface for ctypes. The kernels launch on the caller's stream,
// allocate nothing and each entry point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kTile = 64;             // rows of a score tile; keys of a key tile
constexpr int kScoreThreads = 128;    // 4 warps x 16 rows of a score tile
constexpr int kThreads = 256;         // 8 warps
constexpr int kCP = kMaxN + 4;        // C / B row pitch of a score block (4 mod 32)
constexpr int kSP = kTile + 4;        // staged score tile pitch (4 mod 32)
constexpr int kXP = kMaxP + 8;        // x tile pitch of a chunk block (8 mod 32)
constexpr int kBP = kMaxN + 8;        // B tile pitch of a chunk block (8 mod 32)
constexpr int kScoreSmem = 2 * kTile * kCP * static_cast<int>(sizeof(float));
constexpr int kChunkSmem =
    (4 * kMaxQ + 3 * kTile * kXP + 2 * kTile * kBP) * static_cast<int>(sizeof(float));
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long xb, xs, xh;   // x  [b, s, H, P]
  long long db, ds, dh;   // dt [b, s, H]
  long long bb, bs, bg;   // B  [b, s, G, N]
  long long cb, cs, cg;   // C  [b, s, G, N]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, 16 or 4 bytes; src-size 0 zero-fills, src still valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a = hi + lo to 2^-22: hi = tf32(a) (round to nearest, ties away), lo =
// tf32(a - hi), where a - hi is exact in fp32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
}

// c += a b on the tensor cores, TF32 inputs, fp32 sums. m16n8k8 fragments,
// g = lane / 4, t = lane % 4:
//   A (16x8): a0 (row g, col t), a1 (row g+8, col t), a2 (row g, col t+4),
//             a3 (row g+8, col t+4)
//   B (8x8):  b0 (row t, col g), b1 (row t+4, col g)
//   C (16x8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b + 0 on the tensor cores
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc[n] += A B_n for the NF column fragments n of one k-step, in 3xTF32,
// from A and B already split into their tf32 high and low parts. The
// tensor cores add with truncation, so a long chain of mma.sync into one
// accumulator drifts by up to an ulp of the running sum per step: each
// k-step's three products are summed from zero on the tensor cores (the
// two small ones first), and the k-steps are summed by fp32 adds, rounded
// to nearest, as a CUDA-core loop would.
template <int NF>
__device__ __forceinline__ void mma3(float (&acc)[NF][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[NF][2],
                                     const uint32_t (&bl)[NF][2]) {
  float d[NF][4];
#pragma unroll
  for (int n = 0; n < NF; ++n) mma_tf32_zero(d[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NF; ++n) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NF; ++n) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += d[n][r];
}

// mma3 with A in fp32, split here
template <int NF>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NF][4], const float (&a)[4],
                                           const uint32_t (&bh)[NF][2],
                                           const uint32_t (&bl)[NF][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
  mma3(acc, ah, al, bh, bl);
}

// acc[n] += A B_n in 3xTF32 as one chain on the tensor cores (the two small
// products first), for the backward, whose checks are relative to each
// gradient's largest value: no temporaries, no fp32 adds
template <int NF>
__device__ __forceinline__ void mma3_chain(float (&acc)[NF][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[NF][2],
                                           const uint32_t (&bl)[NF][2]) {
#pragma unroll
  for (int n = 0; n < NF; ++n) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NF; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NF; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
}

template <int NF>
__device__ __forceinline__ void mma3_chain(float (&acc)[NF][4], const float (&a)[4],
                                           const uint32_t (&bh)[NF][2],
                                           const uint32_t (&bl)[NF][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
  mma3_chain(acc, ah, al, bh, bl);
}

// e^x on the SFU: ex2.approx (2 ulp) of x log2(e); x <= 0 here, where the
// rounding of x log2(e) adds |x| 2^-24 to the exponent
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// Rows row0..row0+63 of a row-major fp32 matrix whose rows lie `rs` apart
// into dst [64][pitch], columns 0..width-1: those at or past nrows or ncols
// are zero-filled. 16-byte pieces when `vec` (pointer, strides and ncols
// multiples of 4 floats; width a multiple of 4), else 4-byte ones;
// consecutive threads copy consecutive pieces of a row.
template <int NT>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src, long long rs,
                                          int row0, int nrows, int ncols, int width, bool vec,
                                          int tid) {
  if (vec) {
    const int pieces = width / 4;
    for (int idx = tid; idx < kTile * pieces; idx += NT) {
      const int r = idx / pieces, c = idx % pieces * 4;
      const bool ok = row0 + r < nrows && c < ncols;
      cp_async_16(smem_u32(dst + r * pitch + c), ok ? src + (row0 + r) * rs + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < kTile * width; idx += NT) {
      const int r = idx / width, c = idx % width;
      const bool ok = row0 + r < nrows && c < ncols;
      cp_async_4(smem_u32(dst + r * pitch + c), ok ? src + (row0 + r) * rs + c : src, ok);
    }
  }
}

// grid (G * (pairs + 1), nc, b): blockIdx.x = g * (pairs + 1) + p, where p <
// pairs is a score tile (it, jt), jt <= it, and p == pairs the group's seg.
__global__ void __launch_bounds__(kScoreThreads)
ssd_scores_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ B, const float* __restrict__ C,
                  float* __restrict__ scores, float* __restrict__ seg,
                  float* __restrict__ seg_lo, float* __restrict__ decay, int H, int G, int N,
                  int Q, Strides st, int vec_b, int vec_c) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  const int g = blockIdx.x / (pairs + 1), p = blockIdx.x % (pairs + 1);
  const int c = blockIdx.y, bb = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(c) * Q;

  if (p == pairs) {
    const int hpg = H / G;
    for (int k = tid; k < hpg; k += kScoreThreads) {
      const int h = g * hpg + k;
      const float a = A[h];
      const float* dp = dt + bb * st.db + t0 * st.ds + h * st.dh;
      const long long o = (static_cast<long long>(bb) * nc + c) * Q * H + h;
      double acc = 0.0;
      float hi = 0.f;
#pragma unroll 8
      for (int i = 0; i < Q; ++i) {
        acc += static_cast<double>(__fmul_rn(dp[i * st.ds], a));   // no FMA contraction
        hi = __double2float_rn(acc);
        seg[o + static_cast<long long>(i) * H] = hi;
        seg_lo[o + static_cast<long long>(i) * H] = __double2float_rn(acc - hi);
      }
      decay[(static_cast<long long>(bb) * nc + c) * H + h] = hi;
    }
    return;
  }

  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  const int jt = p - it * (it + 1) / 2;
  float* sC = smem;                   // [kTile][kCP]  C rows of the query tile
  float* sB = smem + kTile * kCP;     // [kTile][kCP]  B rows of the key tile
  const int width = (N + 7) / 8 * 8;
  load_tile<kScoreThreads>(sC, kCP, C + bb * st.cb + t0 * st.cs + g * st.cg, st.cs,
                           it * kTile, Q, N, width, vec_c, tid);
  load_tile<kScoreThreads>(sB, kCP, B + bb * st.bb + t0 * st.bs + g * st.bg, st.bs,
                           jt * kTile, Q, N, width, vec_b, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S[i, j] = sum_n C[i, n] B[j, n]: rows 16 warp.., all 64 keys
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  const float* ca = sC + (warp * 16 + gq) * kCP + tq;
  for (int k = 0; k < width; k += 8) {
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* bq = sB + (n * 8 + gq) * kCP + k + tq;
      split_tf32(bq[0], bh[n][0], bl[n][0]);
      split_tf32(bq[4], bh[n][1], bl[n][1]);
    }
    const float a[4] = {ca[k], ca[k + 8 * kCP], ca[k + 4], ca[k + 8 * kCP + 4]};
    mma_3xtf32(acc, a, bh, bl);
  }
  __syncthreads();   // every warp is done with sC and sB

  float* sS = smem;  // [kTile][kSP]
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float* o = sS + (warp * 16 + gq) * kSP + n * 8 + 2 * tq;
    o[0] = acc[n][0];
    o[1] = acc[n][1];
    o[8 * kSP] = acc[n][2];
    o[8 * kSP + 1] = acc[n][3];
  }
  __syncthreads();

  // out in A-fragment order: fragment (r, ks) of rows 16r.. and keys 8ks..
  // is 32 lanes x {a0, a1, a2, a3}; fragments wholly above the diagonal
  // are not written (the chunk kernel never reads them)
  const int r16 = (Q + 15) / 16, k8 = (Q + 7) / 8;
  float4* out = reinterpret_cast<float4*>(scores) +
                ((static_cast<long long>(bb) * nc + c) * G + g) * r16 * k8 * 32;
  for (int idx = tid; idx < 4 * 8 * 32; idx += kScoreThreads) {
    const int l = idx % 32, kl = idx / 32 % 8, rl = idx / 256;
    const int r = it * 4 + rl, ks = jt * 8 + kl;
    if (r >= r16 || ks >= k8 || ks > 2 * r + 1) continue;
    const float* q = sS + (rl * 16 + l / 4) * kSP + kl * 8 + l % 4;
    out[(static_cast<long long>(r) * k8 + ks) * 32 + l] =
        make_float4(q[0], q[8 * kSP], q[4], q[8 * kSP + 4]);
  }
}

// grid (H, nc, b)
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ B, const float* __restrict__ scores,
                 const float* __restrict__ seg, const float* __restrict__ seg_lo,
                 float* __restrict__ y,
                 float* __restrict__ states, int s, int H, int P, int G, int N, int Q,
                 Strides st, int vec_x, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  float* sSeg = smem;                   // [kMaxQ]  seg of the chunk, high part (0 past Q)
  float* sSegLo = sSeg + kMaxQ;         // [kMaxQ]  its low part
  float* sDt = sSegLo + kMaxQ;          // [kMaxQ]  dt
  float* sW = sDt + kMaxQ;              // [kMaxQ]  exp(total - seg)
  float* sXlo = sW + kMaxQ;             // [kTile][kXP]  tf32 low part of dt*x
  float* sX = sXlo + kTile * kXP;       // [2][kTile][kXP]  x, then the high part of dt*x
  float* sB = sX + 2 * kTile * kXP;     // [2][kTile][kBP]  B rows of the key tile

  const int h = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const long long t0 = static_cast<long long>(c) * Q;
  const float* xp = x + bb * st.xb + t0 * st.xs + h * st.xh;
  const float* bp = B + bb * st.bb + t0 * st.bs + g * st.bg;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int r16 = (Q + 15) / 16, k8 = (Q + 7) / 8, rn = (N + 15) / 16;

  auto issue = [&](int kt) {
    load_tile<kThreads>(sX + (kt & 1) * kTile * kXP, kXP, xp, st.xs, kt * kTile, Q, P, kMaxP,
                        vec_x, tid);
    load_tile<kThreads>(sB + (kt & 1) * kTile * kBP, kBP, bp, st.bs, kt * kTile, Q, N, rn * 16,
                        vec_b, tid);
  };
  issue(0);
  cp_async_commit();

  const long long so = (static_cast<long long>(bb) * nc + c) * Q * H + h;
  const float* dp = dt + bb * st.db + t0 * st.ds + h * st.dh;
  for (int i = tid; i < kMaxQ; i += kThreads) {
    sSeg[i] = i < Q ? seg[so + static_cast<long long>(i) * H] : 0.f;
    sSegLo[i] = i < Q ? seg_lo[so + static_cast<long long>(i) * H] : 0.f;
    sDt[i] = i < Q ? dp[i * st.ds] : 0.f;
  }
  __syncthreads();
  const float total = sSeg[Q - 1], total_lo = sSegLo[Q - 1];
  for (int i = tid; i < kMaxQ; i += kThreads)
    sW[i] = i < Q ? expf((total - sSeg[i]) + (total_lo - sSegLo[i])) : 0.f;

  // this warp's fragments: y rows 16 ry[0].. and 16 ry[1].., state rows 16 warp..
  const int ry[2] = {warp, 15 - warp};
  const bool has_y[2] = {warp < r16, 15 - warp < r16};
  const bool has_s = warp < rn;
  float segi[2][2], segi_lo[2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    segi[q][0] = sSeg[16 * ry[q] + gq];
    segi[q][1] = sSeg[16 * ry[q] + gq + 8];
    segi_lo[q][0] = sSegLo[16 * ry[q] + gq];
    segi_lo[q][1] = sSegLo[16 * ry[q] + gq + 8];
  }
  float acc[3][8][4];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[q][n][r] = 0.f;

  // y fragment (r, ks) is live while ks < k8 and its keys reach row 16r + 15
  const float4* sf = reinterpret_cast<const float4*>(scores) +
                     ((static_cast<long long>(bb) * nc + c) * G + g) * r16 * k8 * 32 + lane;
  auto live = [&](int q, int ks) { return has_y[q] && ks < k8 && ks <= 2 * ry[q] + 1; };
  float4 next[2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (live(q, 0)) next[q] = __ldcg(sf + static_cast<long long>(ry[q]) * k8 * 32);

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) issue(kt + 1);
    cp_async_commit();               // an empty group on the last tile
    cp_async_wait<1>();              // tile kt has landed
    __syncthreads();
    float* xt = sX + (kt & 1) * kTile * kXP;
    const float* bt = sB + (kt & 1) * kTile * kBP;
    for (int idx = tid; idx < kTile * kMaxP; idx += kThreads) {
      const int j = idx / kMaxP, p = idx % kMaxP;
      uint32_t hi, lo;
      split_tf32(__fmul_rn(xt[j * kXP + p], sDt[kt * kTile + j]), hi, lo);
      xt[j * kXP + p] = __uint_as_float(hi);
      sXlo[j * kXP + p] = __uint_as_float(lo);
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < 8; ++kk) {
      const int ks = kt * 8 + kk;
      if (ks >= k8) break;
      const bool on[2] = {live(0, ks), live(1, ks)};
      if (!(on[0] || on[1] || has_s)) continue;
      // B fragments of dt*x: keys 8kk + t (+4), columns 8n + g
      uint32_t bh[8][2], bl[8][2];
      const int jo = (kk * 8 + tq) * kXP + gq;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        bh[n][0] = __float_as_uint(xt[jo + n * 8]);
        bh[n][1] = __float_as_uint(xt[jo + 4 * kXP + n * 8]);
        bl[n][0] = __float_as_uint(sXlo[jo + n * 8]);
        bl[n][1] = __float_as_uint(sXlo[jo + 4 * kXP + n * 8]);
      }
      const int j = kt * kTile + kk * 8 + tq;      // key of a0 / a1; a2 / a3 at j + 4
      const float sj0 = sSeg[j], sj1 = sSeg[j + 4], lj0 = sSegLo[j], lj1 = sSegLo[j + 4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!on[q]) continue;
        const float4 sv = next[q];
        if (live(q, ks + 1))
          next[q] = __ldcg(sf + (static_cast<long long>(ry[q]) * k8 + ks + 1) * 32);
        const int i = 16 * ry[q] + gq;             // row of a0 / a2; a1 / a3 at i + 8
        const float a[4] = {
            j <= i ? sv.x * exp_fast((segi[q][0] - sj0) + (segi_lo[q][0] - lj0)) : 0.f,
            j <= i + 8 ? sv.y * exp_fast((segi[q][1] - sj0) + (segi_lo[q][1] - lj0)) : 0.f,
            j + 4 <= i ? sv.z * exp_fast((segi[q][0] - sj1) + (segi_lo[q][0] - lj1)) : 0.f,
            j + 4 <= i + 8 ? sv.w * exp_fast((segi[q][1] - sj1) + (segi_lo[q][1] - lj1)) : 0.f};
        mma_3xtf32(acc[q], a, bh, bl);
      }
      if (has_s) {
        // A = (B w)^T: state rows 16 warp + g (+8), keys 8kk + t (+4)
        const float* bq = bt + (kk * 8 + tq) * kBP + 16 * warp + gq;
        const float w0 = sW[j], w1 = sW[j + 4];
        const float a[4] = {bq[0] * w0, bq[8] * w0, bq[4 * kBP] * w1, bq[4 * kBP + 8] * w1};
        mma_3xtf32(acc[2], a, bh, bl);
      }
    }
    __syncthreads();   // every warp is done with this stage before it refills
  }

  // 16-byte stores: lanes t and t^1 swap halves, the even lane then holds
  // row g, columns 8n + 2t..+3, the odd one row g + 8, columns 8n + 2t - 2..+1
  const bool odd = tq & 1;
  const int col = (tq & ~1) * 2;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (q < 2 ? !has_y[q] : !has_s) continue;
    const int row = 16 * (q < 2 ? ry[q] : warp) + gq + (odd ? 8 : 0);
    const bool ok = row < (q < 2 ? Q : N);
    float* o = q < 2 ? y + ((bb * static_cast<long long>(s) + t0 + row) * H + h) * P
                     : states + ((static_cast<long long>(bb) * nc + c) * H + h) * N * P +
                           static_cast<long long>(row) * P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* v = acc[q][n];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      if (ok && n * 8 + col < P)
        *reinterpret_cast<float4*>(o + n * 8 + col) =
            odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
    }
  }
}

// ---------------------------------------------------------------------- //
// The backward: gradients of x, dt, A, B and C from those of y, the states
// and decay (kernels/ref.py::ref_ssd_chunk_bwd has the formulas). Per
// (batch, chunk, head), with u = dt x, S = C B^T of the head's group, L =
// exp(seg_i - seg_j) [j <= i], M = S o L, w = exp(total - seg), v = B
// gstate and R = gM o M:
//
//   gM = gy u^T o [j <= i]       gu = M^T gy + w o v     gx = gu dt
//   G_S = sum over the group's heads of gM o L
//   gC = G_S B                   gB = G_S^T C + sum over the heads of (w o u) gstate^T
//   g(dA_k) = sum_{j < k <= i} R_ij + sum_{j < k} r_j + gdecay,  r_j = w_j u_j . v_j
//   gdt = g(dA) A + sum_p gu x   gA = sum over (b, c, k) of g(dA) dt
//
// What bounds it on an H100: operations. The causal half of gM and gu, v,
// the state term and C's and B's products in 3xTF32 are about 10.96 GFLOP
// at the mamba2 training shape (b 2, s 1024, H 80, P 64, G 1, N 128, Q
// 256): 0.066 ms at 3 x 495 TFLOP/s, against 152 MB of inputs and outputs
// (0.045 ms). Six launches, no atomics (every sum has a fixed order, so
// two calls agree bit for bit), and nothing a head computes for its group
// in device memory:
//
//  ssd_scores_kernel again: S in A-fragment order and the seg pairs;
//  ssd_bwd_head_kernel, one block per (head, chunk, batch), 256 threads,
//   114 KB of shared memory and 128 registers, so two blocks (16 warps) an
//   SM:
//   - gy's row tiles and gstate's 64-row pieces stream through a cp.async
//     ring of two stages, the next item loading while the block works on
//     this one; x of a key tile rides with its first item. Each item is
//     split once into tf32 high and low parts in shared memory, as is u =
//     dt x once a key tile, since several warps read each as an operand;
//   - per (row tile I, key tile J): gM = gy u^T by 3xTF32 mma.sync, its B
//     operand read with the keys permuted so that each lane's C fragment
//     holds the keys of S's A fragment, which comes from the scores scratch
//     straight into registers, one 16-byte load a lane; L is applied there,
//     exp taken only where j <= i < Q; M goes to shared memory for gu +=
//     M^T gy, read with k = i permuted to rows 2t and 2t + 1 so that both
//     operands' reads are free of bank conflicts;
//   - g(dA) without a serial loop: the pairs j < k <= i are those of the
//     columns m < k less those of the rows m < k (R is 0 above the
//     diagonal, and its diagonal cancels), so g(dA_k) = sum_{m < k} (cs_m -
//     rs_m + r_m) + gdecay, cs and rs R's column and row sums off the
//     diagonal: warp shuffles over the accumulator fragments, then the
//     warps' partials added in a fixed order, then one exclusive scan over
//     the chunk (shuffles within each warp, the warps' totals in order);
//   - v = B[J] gstate (B's A fragments from device memory), gu += w v, gx,
//     r and sum_p gu x by shuffles; gdt, and the block's share of gA;
//   - its products accumulate on the tensor cores as one chain (the
//     forward's per-k-step sums need 16 more registers, and at two blocks
//     an SM the kernel then spills; the checks here are relative to each
//     gradient's largest value, where the chain costs at most about 0.01 of
//     the tolerance, tests/test_torch_ssd_bwd_numerics.py);
//  ssd_bwd_state_kernel, one block per (key tile, head slice, chunk, batch
//   x group), and ssd_bwd_pair_kernel, one per (causal pair (I, J), head
//   slice, chunk, batch x group): gB's state term sum_h (w o u) gstate^T and
//   G_S = sum_h gM o L over a slice of the group's heads in order, by wgmma
//   (Hopper's warpgroup product, m64nNk8 TF32, operands read from shared
//   memory in its K-major core-matrix layout, each head's products one chain
//   on the tensor cores, the heads added in fp32), two warpgroups a block:
//   a head's products run while the block splits the next head's tiles
//   (low parts double-buffered), and the pair kernel computes the
//   diagonal tile's L meanwhile; off the diagonal L = e^(seg_i - ref)
//   e^(ref - seg_j), both factors at most 1, is taken into the operands'
//   rows as they are split. The heads are cut into ns = min(4, H / G)
//   slices, a fixed count, so the scratch of parts (9.4 MB at the training
//   shape) does not grow with H while G = 1 still makes 448 blocks;
//  ssd_bwd_group_kernel, one block per (tile, role, 64 columns, chunk,
//   batch x group): the slices summed in order, gC[I] = sum_J G_S[I, J]
//   B[J] and gB[J] = sum_I G_S[I, J]^T C[I] plus the summed state term;
//  ssd_bwd_gA_kernel: gA[h], the blocks' shares summed over (batch, chunk)
//   in order.
//
// What was measured (PERF.md): about 0.80 ms at the mamba2 training shape
// (head 0.38, pair 0.23, state 0.11, group 0.04, scores 0.02), 12x the
// bound. Each block works through its heads or pairs as a chain of short
// steps (a tile's load, its split, the products, the decay, a barrier)
// that 8 to 16 warps an SM do not hide: removing any one step saves about
// the same time, a single k-step in place of eight saves little, and a
// deeper ring of loads or more slices changes nothing. The mma.sync
// operands' high and low fragments take two shared-memory wavefronts a
// product, and the register file of 16 warps an SM is full.
constexpr int kGP = kTile + 4;   // pitch of the backward's tiles read by 4-byte loads (4 mod 32)
constexpr int kFP = kTile + 8;   // pitch of its tiles read as 8-byte pairs (8 mod 32)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeadSmem =
    (6 * kTile * kGP + 8 * kMaxQ + 6 * kTile) * static_cast<int>(sizeof(float));
constexpr int kGroupSmem = (2 * kTile * kFP + 2 * kTile * kGP) * static_cast<int>(sizeof(float));

// Floats of a (batch, chunk, group, slice) part: G_S's sum over the slice
// in the causal 64 x 64 tiles (it, jt <= it, tile it (it + 1) / 2 + jt),
// then the state term's [n_tiles * 64, N].
__host__ __device__ __forceinline__ int n_pairs_of(int Q) {
  const int n_tiles = (Q + kTile - 1) / kTile;
  return n_tiles * (n_tiles + 1) / 2;
}

long long part_floats(int N, int Q) {
  return static_cast<long long>(n_pairs_of(Q)) * kTile * kTile +
         static_cast<long long>((Q + kTile - 1) / kTile) * kTile * N;
}

__device__ __forceinline__ uint32_t bits(float a) { return __float_as_uint(a); }

__device__ __forceinline__ void split_f(float a, float& hi, float& lo) {
  uint32_t h, l;
  split_tf32(a, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// A 64 x 64 tile at t (row pitch `pitch`, a multiple of 4) into the tf32
// high parts of its values, in place, and their low parts at lo; row r's
// values are first taken times scale(r).x, then times scale(r).y, each
// product rounded (no FMA).
template <class Scale>
__device__ __forceinline__ void split_tile(float* t, float* lo, int pitch, int tid, Scale scale) {
  for (int idx = tid; idx < kTile * kTile / 4; idx += kThreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    const float2 f = scale(r);
    float4* tp = reinterpret_cast<float4*>(t + r * pitch + c);
    const float4 v = *tp;
    float4 hi, lw;
    split_f(__fmul_rn(__fmul_rn(v.x, f.x), f.y), hi.x, lw.x);
    split_f(__fmul_rn(__fmul_rn(v.y, f.x), f.y), hi.y, lw.y);
    split_f(__fmul_rn(__fmul_rn(v.z, f.x), f.y), hi.z, lw.z);
    split_f(__fmul_rn(__fmul_rn(v.w, f.x), f.y), hi.w, lw.w);
    *tp = hi;
    *reinterpret_cast<float4*>(lo + r * pitch + c) = lw;
  }
}

__device__ __forceinline__ float2 unit_scale(int) { return make_float2(1.f, 1.f); }

// grid (H, nc, b); heads vary fastest, so the blocks that read one chunk's
// S run together and find it in L2
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ gy, const float* __restrict__ gstate,
                    const float* __restrict__ gdecay, const float* __restrict__ scores,
                    const float* __restrict__ seg, const float* __restrict__ seg_lo,
                    float* __restrict__ gx, float* __restrict__ gdt, float* __restrict__ gA_part,
                    int s, int H, int P, int G, int N, int Q, Strides st, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  float* sRaw = smem;                    // [2][kTile][kGP]  the ring (gy or gstate rows), then high
  float* sLo = sRaw + 2 * kTile * kGP;   // [kTile][kGP]  the current item's low part
  float* sM = sLo + kTile * kGP;         // [kTile][kGP]  M = S o L of the current pair, rows i
  float* sU = sM + kTile * kGP;          // [kTile][kGP]  x of the key tile, then u's high part
  float* sULo = sU + kTile * kGP;        // [kTile][kGP]  u's low part
  float* sSeg = sULo + kTile * kGP;      // [kMaxQ]  seg, high part (0 past Q)
  float* sSegLo = sSeg + kMaxQ;          // [kMaxQ]  its low part
  float* sDt = sSegLo + kMaxQ;           // [kMaxQ]  dt
  float* sW = sDt + kMaxQ;               // [kMaxQ]  w = exp(total - seg)
  float* sCs = sW + kMaxQ;               // [kMaxQ]  cs_m = sum_{i > m} R_im
  float* sRs = sCs + kMaxQ;              // [kMaxQ]  rs_m = sum_{j < m} R_mj
  float* sR = sRs + kMaxQ;               // [kMaxQ]  r_m = w_m u_m . v_m
  float* sXg = sR + kMaxQ;               // [kMaxQ]  sum_p gu_mp x_mp
  float* sPart = sXg + kMaxQ;            // [6][kTile]  the warps' partial sums

  const int h = blockIdx.x, c = blockIdx.y, bb = blockIdx.z, nc = gridDim.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int w4 = warp & 3, w2 = warp >> 2;
  const long long t0 = static_cast<long long>(c) * Q;
  const long long bc = static_cast<long long>(bb) * nc + c;
  const float* xp = x + bb * st.xb + t0 * st.xs + h * st.xh;
  const float* bp = B + bb * st.bb + t0 * st.bs + g * st.bg;
  const float* gyp = gy + ((bb * static_cast<long long>(s) + t0) * H + h) * P;
  const float* gsp = gstate + (bc * H + h) * N * P;
  const int nt = (Q + kTile - 1) / kTile, ngs = (N + kTile - 1) / kTile;
  const int r16 = (Q + 15) / 16, k8 = (Q + 7) / 8, Pk = (P + 7) / 8 * 8;
  const float4* sf = reinterpret_cast<const float4*>(scores) + (bc * G + g) * r16 * k8 * 32 + lane;

  // the ring's items: for each key tile jt, gy's row tiles k = jt .. nt - 1,
  // then gstate's 64-row pieces k = nt .. nt + ngs - 1; x of key tile jt
  // comes with its first item
  auto issue = [&](int jt, int k, int stage) {
    float* dst = sRaw + stage * kTile * kGP;
    if (k < nt)
      load_tile<kThreads>(dst, kGP, gyp, static_cast<long long>(H) * P, k * kTile, Q, P, kTile, 1,
                          tid);
    else
      load_tile<kThreads>(dst, kGP, gsp, P, (k - nt) * kTile, N, P, kTile, 1, tid);
    if (k == jt) load_tile<kThreads>(sU, kGP, xp, st.xs, jt * kTile, Q, P, kTile, vec_x, tid);
  };
  issue(0, 0, 0);
  cp_async_commit();

  const long long so = bc * Q * H + h;
  const float* dp = dt + bb * st.db + t0 * st.ds + h * st.dh;
  for (int i = tid; i < kMaxQ; i += kThreads) {
    sSeg[i] = i < Q ? seg[so + static_cast<long long>(i) * H] : 0.f;
    sSegLo[i] = i < Q ? seg_lo[so + static_cast<long long>(i) * H] : 0.f;
    sDt[i] = i < Q ? dp[i * st.ds] : 0.f;
    sCs[i] = sRs[i] = sR[i] = sXg[i] = 0.f;
  }
  __syncthreads();
  {
    const float total = sSeg[Q - 1], total_lo = sSegLo[Q - 1];
    for (int i = tid; i < kMaxQ; i += kThreads)
      sW[i] = i < Q ? expf((total - sSeg[i]) + (total_lo - sSegLo[i])) : 0.f;
  }

  // the ring, item after item: stage `cur` holds the current one, the next
  // loads into the other while the block works
  int cur = 0;
  auto next = [&](int jt, int k) {     // issue item (jt, k) if it exists, then wait for the current
    if (jt < nt) issue(jt, k, cur ^ 1);
    cp_async_commit();                 // an empty group after the last item
    cp_async_wait<1>();
    __syncthreads();
  };
#pragma unroll 1
  for (int jt = 0; jt < nt; ++jt) {
    const int J0 = jt * kTile;
    // gu: rows j 16 w4 + g (+8) of the key tile, columns p 32 w2 + 8n + 2t (+1)
    float gu[4][4] = {};
#pragma unroll 1
    for (int it = jt; it < nt; ++it) {
      const int I0 = it * kTile;
      next(jt, it + 1);
      float* raw = sRaw + cur * kTile * kGP;
      split_tile(raw, sLo, kGP, tid, unit_scale);
      if (it == jt)
        split_tile(sU, sULo, kGP, tid, [&](int r) { return make_float2(sDt[J0 + r], 1.f); });
      __syncthreads();

      // gM = gy u^T: rows i 16 w4 .., keys 32 w2 ..; B's column g is key 8n +
      // sig(g), so that the C fragment's columns 2t and 2t + 1 are keys t and
      // t + 4, as in S's A fragment
      float gm[4][4] = {};
      {
        const int sig = (gq >> 1) + 4 * (gq & 1);
        const float* ah = raw + (16 * w4 + gq) * kGP + tq;
        const float* al = sLo + (16 * w4 + gq) * kGP + tq;
        const float* uh = sU + (32 * w2 + sig) * kGP + tq;
        const float* ul = sULo + (32 * w2 + sig) * kGP + tq;
#pragma unroll 2
        for (int kk = 0; kk < Pk; kk += 8) {
          const uint32_t a_h[4] = {bits(ah[kk]), bits(ah[kk + 8 * kGP]), bits(ah[kk + 4]),
                                   bits(ah[kk + 8 * kGP + 4])};
          const uint32_t a_l[4] = {bits(al[kk]), bits(al[kk + 8 * kGP]), bits(al[kk + 4]),
                                   bits(al[kk + 8 * kGP + 4])};
          uint32_t b_h[4][2], b_l[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            b_h[n][0] = bits(uh[n * 8 * kGP + kk]);
            b_h[n][1] = bits(uh[n * 8 * kGP + kk + 4]);
            b_l[n][0] = bits(ul[n * 8 * kGP + kk]);
            b_l[n][1] = bits(ul[n * 8 * kGP + kk + 4]);
          }
          mma3_chain(gm, a_h, a_l, b_h, b_l);
        }
      }
      // S of these rows and keys in A-fragment order, from the scores
      // scratch (fragments wholly above the diagonal are not there), one
      // fragment at a time; M = S o L, masked before exp, to sM; R = gM o M
      // off its diagonal (which cancels in cs - rs) summed along its rows
      // (over t, then the two key halves) and columns (over g, then the four
      // row strips)
      float rsum[2] = {0.f, 0.f};
      const int r = I0 / 16 + w4;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int ks = J0 / 8 + 4 * w2 + n;
        const float4 sv = r < r16 && ks < k8 && ks <= 2 * r + 1
                              ? __ldcg(sf + (static_cast<long long>(r) * k8 + ks) * 32)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        float csum[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int il = 16 * w4 + gq + 8 * hr, i = I0 + il;
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {
            const int jl = 32 * w2 + 8 * n + tq + 4 * hc, j = J0 + jl;
            const float sij = hr ? (hc ? sv.w : sv.y) : (hc ? sv.z : sv.x);
            const float m = j <= i && i < Q
                                ? sij * exp_fast((sSeg[i] - sSeg[j]) + (sSegLo[i] - sSegLo[j]))
                                : 0.f;
            const float rr = j < i ? gm[n][2 * hr + hc] * m : 0.f;
            sM[il * kGP + jl] = m;
            rsum[hr] += rr;
            csum[hc] += rr;
          }
        }
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          csum[hc] += __shfl_xor_sync(kFull, csum[hc], 4);
          csum[hc] += __shfl_xor_sync(kFull, csum[hc], 8);
          csum[hc] += __shfl_xor_sync(kFull, csum[hc], 16);
          if (gq == 0) sPart[w4 * kTile + 32 * w2 + 8 * n + tq + 4 * hc] = csum[hc];
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rsum[hr] += __shfl_xor_sync(kFull, rsum[hr], 1);
        rsum[hr] += __shfl_xor_sync(kFull, rsum[hr], 2);
        if (tq == 0) sPart[(4 + w2) * kTile + 16 * w4 + gq + 8 * hr] = rsum[hr];
      }
      __syncthreads();
      if (tid < kTile) {
        const float* pp = sPart + tid;
        sCs[J0 + tid] += ((pp[0] + pp[kTile]) + pp[2 * kTile]) + pp[3 * kTile];
      } else if (tid < 2 * kTile) {
        const float* pp = sPart + 4 * kTile + tid - kTile;
        sRs[I0 + tid - kTile] += pp[0] + pp[kTile];
      }
      // gu += M^T gy: k = i, lane t taking rows 2t and 2t + 1 of each 8
      {
        const float* ma = sM + 2 * tq * kGP + 16 * w4 + gq;
        const float* bh = raw + 2 * tq * kGP + 32 * w2 + gq;
        const float* bl = sLo + 2 * tq * kGP + 32 * w2 + gq;
        const int ke = min(kTile, (Q - I0 + 7) / 8 * 8);
#pragma unroll 1
        for (int kk = 0; kk < ke; kk += 8) {
          const float* m0 = ma + kk * kGP;
          const float a[4] = {m0[0], m0[8], m0[kGP], m0[kGP + 8]};
          uint32_t b_h[4][2], b_l[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            b_h[n][0] = bits(bh[kk * kGP + 8 * n]);
            b_h[n][1] = bits(bh[(kk + 1) * kGP + 8 * n]);
            b_l[n][0] = bits(bl[kk * kGP + 8 * n]);
            b_l[n][1] = bits(bl[(kk + 1) * kGP + 8 * n]);
          }
          mma3_chain(gu, a, b_h, b_l);
        }
      }
      __syncthreads();     // every warp is done with this item's buffers
      cur ^= 1;
    }

    // v = B[J] gstate over gstate's 64-row pieces n0 ..: k = n, lane t taking
    // states 2t and 2t + 1 of each 8, B[J]'s A fragments from device memory
    float v[4][4] = {};
    const int j0 = J0 + 16 * w4 + gq;
    const bool ok0 = j0 < Q, ok1 = j0 + 8 < Q;
#pragma unroll 1
    for (int hs = 0; hs < ngs; ++hs) {
      const int n0 = hs * kTile;
      if (hs + 1 < ngs) next(jt, nt + hs + 1);
      else next(jt + 1, jt + 1);
      float* raw = sRaw + cur * kTile * kGP;
      split_tile(raw, sLo, kGP, tid, unit_scale);
      __syncthreads();
      const int ke = min(kTile, (N - n0 + 7) / 8 * 8);
      const float* b0 = bp + static_cast<long long>(j0) * st.bs + n0 + 2 * tq;
      const float* b1 = b0 + 8 * st.bs;
      const float* bh = raw + 2 * tq * kGP + 32 * w2 + gq;
      const float* bl = sLo + 2 * tq * kGP + 32 * w2 + gq;
#pragma unroll 2
      for (int kk = 0; kk < ke; kk += 8) {
        const int n = n0 + kk + 2 * tq;
        const bool c0 = n < N, c1 = n + 1 < N;
        const float a[4] = {ok0 && c0 ? b0[kk] : 0.f, ok1 && c0 ? b1[kk] : 0.f,
                            ok0 && c1 ? b0[kk + 1] : 0.f, ok1 && c1 ? b1[kk + 1] : 0.f};
        uint32_t b_h[4][2], b_l[4][2];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          b_h[nf][0] = bits(bh[kk * kGP + 8 * nf]);
          b_h[nf][1] = bits(bh[(kk + 1) * kGP + 8 * nf]);
          b_l[nf][0] = bits(bl[kk * kGP + 8 * nf]);
          b_l[nf][1] = bits(bl[(kk + 1) * kGP + 8 * nf]);
        }
        mma3_chain(v, a, b_h, b_l);
      }
      __syncthreads();     // every warp is done with this piece's buffers
      cur ^= 1;
    }

    // the key tile's end: gu += w v, gx = gu dt, and the row sums r_j = w_j
    // u_j . v_j and sum_p gu x (shuffles, then the two column halves)
    float xs[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int jl = 16 * w4 + gq + 8 * hr, j = J0 + jl;
      const float w = sW[j], d = sDt[j];
      const float* xr = xp + static_cast<long long>(j) * st.xs;
      float* gxr = gx + ((bb * static_cast<long long>(s) + t0 + j) * H + h) * P;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int p = 32 * w2 + 8 * n + 2 * tq;
        const bool ok = j < Q && p < P;              // P % 4 == 0: p + 1 < P too
        const float x0 = ok ? xr[p] : 0.f, x1 = ok ? xr[p + 1] : 0.f;
        const float v0 = v[n][2 * hr], v1 = v[n][2 * hr + 1];
        const float g0 = gu[n][2 * hr] + w * v0, g1 = gu[n][2 * hr + 1] + w * v1;
        if (ok) *reinterpret_cast<float2*>(gxr + p) = make_float2(g0 * d, g1 * d);
        xs[hr] += g0 * x0;
        xs[hr] += g1 * x1;
        rs[hr] += __fmul_rn(x0, d) * v0;
        rs[hr] += __fmul_rn(x1, d) * v1;
      }
      rs[hr] += __shfl_xor_sync(kFull, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(kFull, rs[hr], 2);
      xs[hr] += __shfl_xor_sync(kFull, xs[hr], 1);
      xs[hr] += __shfl_xor_sync(kFull, xs[hr], 2);
      if (tq == 0) {
        sPart[w2 * kTile + jl] = rs[hr];
        sPart[(2 + w2) * kTile + jl] = xs[hr];
      }
    }
    __syncthreads();
    if (tid < kTile && J0 + tid < Q) {
      sR[J0 + tid] = sW[J0 + tid] * (sPart[tid] + sPart[kTile + tid]);
      sXg[J0 + tid] = sPart[2 * kTile + tid] + sPart[3 * kTile + tid];
    }
    __syncthreads();       // sPart is read before the next key tile's first pair
  }

  // g(dA_k) = sum_{m < k} (cs_m - rs_m + r_m) + gdecay: the pairs j < k <= i
  // are those of the columns m < k less those of the rows m < k, neither
  // holding R's diagonal. An
  // exclusive scan over the chunk, one position a thread: shuffles within
  // each warp, then the warps' totals in order.
  const int kq = tid;
  float inc = kq < Q ? (sCs[kq] - sRs[kq]) + sR[kq] : 0.f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  float exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0.f;
  if (lane == 31) sPart[warp] = inc;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += sPart[w];
  const float gdA = (off + exc) + gdecay[bc * H + h];
  if (kq < Q) gdt[(bb * static_cast<long long>(s) + t0 + kq) * H + h] = gdA * A[h] + sXg[kq];
  // the block's share of gA: sum_k g(dA_k) dt_k, by shuffles, then the warps in order
  float ga = kq < Q ? gdA * sDt[kq] : 0.f;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) ga += __shfl_xor_sync(kFull, ga, d);
  __syncthreads();         // every thread has read the totals
  if (lane == 0) sPart[warp] = ga;
  __syncthreads();
  if (tid == 0) {
    float a = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) a += sPart[w];
    gA_part[bc * H + h] = a;
  }
}

// ---- Hopper's warpgroup products (wgmma), for the pair and state kernels -- //
// An operand tile of 64 rows and 64 fp32 columns (k) sits in shared memory in
// wgmma's K-major layout without swizzle: 8 x 16 "core matrices" of 8 rows
// and 16 bytes, element (r, c) at ((r / 8) * 16 + c / 4) * 32 + (r % 8) * 4
// + c % 4 floats: core matrices 128 bytes apart along k (LBO) and 2048 along
// the rows (SBO). A k-step of 8 columns starts 256 bytes further on, and
// rows 8q .. at 2048 q bytes.
constexpr int kCore = kTile * kTile;   // floats of such a tile
constexpr int kWG = 128;               // a warpgroup

// the matrix descriptor of a tile at p (16-byte aligned), k-step 0
__device__ __forceinline__ uint64_t gmma_desc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{128 >> 4} << 16) |
         (uint64_t{2048 >> 4} << 32);
}

// d (+)= A B^T for one k-step, A 64 x 8 and B n x 8 (both K-major); d in
// the accumulator layout (warp w of the warpgroup: rows 16 w + g and + 8,
// columns 8 j + 2t and + 1 in d[4 j ..]); `acc` 0 starts d from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence_operand(float (&d)[16]) {
  asm volatile(""
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               :
               : "memory");
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence_operand(float (&d)[32]) {
  asm volatile(""
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                 "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                 "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
               :
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory stores by threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issues d = A B^T over k-steps 0 .. ks - 1 (ks <= 8) in 3xTF32 from A's and
// B's high and low tiles, as one chain on the tensor cores (per k-step the
// two small products first), and returns: the caller works on, then waits
// with wgmma_wait_all and wgmma_fence_operand(d). Every thread of the
// warpgroup calls it.
template <int NR>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[NR], const float* ah, const float* al,
                                             const float* bh, const float* bl, int ks) {
  const uint64_t dah = gmma_desc(ah), dal = gmma_desc(al), dbh = gmma_desc(bh),
                 dbl = gmma_desc(bl);
  wgmma_fence();
  wgmma_fence_operand(d);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s < ks) {
      wgmma_tf32(d, dal + 16 * s, dbh + 16 * s, s > 0);
      wgmma_tf32(d, dah + 16 * s, dbl + 16 * s, 1);
      wgmma_tf32(d, dah + 16 * s, dbh + 16 * s, 1);
    }
  }
  wgmma_commit();
}

// Rows row0 .. row0 + 63 and columns 0 .. 63 of a row-major fp32 matrix (rows
// rs apart) into a tile in core-matrix order; rows at or past nrows and
// columns at or past ncols are zero-filled. 16-byte pieces when `vec`
// (pointer, stride and ncols multiples of 4 floats), else 4-byte ones.
template <int NT>
__device__ __forceinline__ void load_core(float* dst, const float* src, long long rs, int row0,
                                          int nrows, int ncols, bool vec, int tid) {
  if (vec) {
    for (int q = tid; q < kCore / 4; q += NT) {
      const int r = (q >> 7) * 8 + (q & 7), c = ((q >> 3) & 15) * 4;
      const bool ok = row0 + r < nrows && c < ncols;
      cp_async_16(smem_u32(dst + q * 4), ok ? src + (row0 + r) * rs + c : src, ok);
    }
  } else {
    for (int f = tid; f < kCore; f += NT) {
      const int q = f >> 2, r = (q >> 7) * 8 + (q & 7), c = ((q >> 3) & 15) * 4 + (f & 3);
      const bool ok = row0 + r < nrows && c < ncols;
      cp_async_4(smem_u32(dst + f), ok ? src + (row0 + r) * rs + c : src, ok);
    }
  }
}

// A tile in core-matrix order into the tf32 high parts of its values, in
// place, and their low parts at lo; row r's values first taken times
// scale(r).x, then times scale(r).y, each product rounded
template <int NT, class Scale>
__device__ __forceinline__ void split_core(float* t, float* lo, int tid, Scale scale) {
  for (int q = tid; q < kCore / 4; q += NT) {
    const float2 f = scale((q >> 7) * 8 + (q & 7));
    float4* tp = reinterpret_cast<float4*>(t) + q;
    const float4 v = *tp;
    float4 hi, lw;
    split_f(__fmul_rn(__fmul_rn(v.x, f.x), f.y), hi.x, lw.x);
    split_f(__fmul_rn(__fmul_rn(v.y, f.x), f.y), hi.y, lw.y);
    split_f(__fmul_rn(__fmul_rn(v.z, f.x), f.y), hi.z, lw.z);
    split_f(__fmul_rn(__fmul_rn(v.w, f.x), f.y), hi.w, lw.w);
    *tp = hi;
    reinterpret_cast<float4*>(lo)[q] = lw;
  }
}

constexpr int kPairSmem = (8 * kCore + 10 * kTile) * static_cast<int>(sizeof(float));
constexpr int kStateSmem = (12 * kCore + 10 * kTile) * static_cast<int>(sizeof(float));

// seg hi and lo of rows r0 .. r0 + 63 (or of position Q - 1 when r0 < 0),
// seg hi and lo and dt of keys J0 .. J0 + 63, of head h, into vec [5][64]
// (0 past Q)
__device__ __forceinline__ void load_vec(float* vec, const float* dt, const float* seg,
                                         const float* seg_lo, int bb, long long t0,
                                         long long bc, int h, int H, int Q, int r0, int J0,
                                         const Strides& st, int tid) {
  for (int idx = tid; idx < 5 * kTile; idx += 2 * kWG) {
    const int v = idx / kTile, r = idx % kTile;
    const int pos = v < 2 ? (r0 < 0 ? Q - 1 : r0 + r) : J0 + r;
    const bool ok = pos < Q;
    const float* src = v == 4 ? dt + bb * st.db + (t0 + pos) * st.ds + h * st.dh
                              : (v & 1 ? seg_lo : seg) + (bc * Q + pos) * H + h;
    cp_async_4(smem_u32(vec + idx), ok ? src : seg, ok);
  }
}
// grid (ns pairs, nc, b G), blockIdx.x = pair ns + slice: G_S's causal tile
// (it, jt <= it), pair it (it + 1) / 2 + jt, summed over the slice's heads
// [sl hpg / ns, (sl + 1) hpg / ns) of group g in order. Two warpgroups, one
// block an SM: warpgroup wg takes keys 32 wg ..; per head its gM = gy u^T
// runs on the tensor cores while the block computes that head's L and
// splits the next head's tiles, then gM o L is added.
__global__ void __launch_bounds__(2 * kWG, 1)
ssd_bwd_pair_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ gy, const float* __restrict__ seg,
                    const float* __restrict__ seg_lo, float* __restrict__ part, int s, int H,
                    int P, int G, int Q, int ns, long long F, Strides st, int vec_x) {
  extern __shared__ __align__(128) float smem[];
  float* sA = smem;                      // [2][kCore]  gy of the row tile, then its high part
  float* sB = sA + 2 * kCore;            // [2][kCore]  x of the key tile, then u's high part
  float* sALo = sB + 2 * kCore;          // [2][kCore]  gy's low part
  float* sBLo = sALo + 2 * kCore;        // [2][kCore]  u's low part
  float* sVec = sBLo + 2 * kCore;        // [2][5][kTile]  seg of the rows, seg and dt of the keys
  const int p = blockIdx.x / ns, sl = blockIdx.x % ns;
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z / G, g = blockIdx.z % G;
  const int tid = threadIdx.x, wg = tid / kWG, warp = tid % kWG / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int hpg = H / G, h0 = g * hpg + sl * hpg / ns, h1 = g * hpg + (sl + 1) * hpg / ns;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  const int jt = p - it * (it + 1) / 2, I0 = it * kTile, J0 = jt * kTile, ks = (P + 7) / 8;
  const long long t0 = static_cast<long long>(c) * Q;
  const long long bc = static_cast<long long>(bb) * nc + c;

  auto issue = [&](int h, int stage) {
    load_core<2 * kWG>(sA + stage * kCore,
                       gy + ((bb * static_cast<long long>(s) + t0) * H + h) * P,
                       static_cast<long long>(H) * P, I0, Q, P, true, tid);
    load_core<2 * kWG>(sB + stage * kCore, x + bb * st.xb + t0 * st.xs + h * st.xh, st.xs, J0, Q,
                       P, vec_x, tid);
    load_vec(sVec + stage * 5 * kTile, dt, seg, seg_lo, bb, t0, bc, h, H, Q, I0, J0, st, tid);
  };
  // Off the diagonal (it > jt) L[i, j] = a_i b_j with a_i = exp(seg_i - ref)
  // and b_j = exp(ref - seg_j), ref = seg at key tile jt's last position: both
  // at most 1, so gy's rows are split times a and u's times b, and gM comes
  // out times L. A diagonal tile takes L element by element.
  const bool diag = it == jt;
  auto split = [&](int stage) {
    const float* vec = sVec + stage * 5 * kTile;
    const float ref = vec[3 * kTile - 1], ref_lo = vec[4 * kTile - 1];
    split_core<2 * kWG>(sA + stage * kCore, sALo + stage * kCore, tid, [&](int r) {
      return make_float2(diag           ? 1.f
                         : I0 + r < Q ? exp_fast((vec[r] - ref) + (vec[kTile + r] - ref_lo))
                                      : 0.f,   // past Q seg is 0 there, and gy too
                         1.f);
    });
    split_core<2 * kWG>(sB + stage * kCore, sBLo + stage * kCore, tid, [&](int r) {
      return make_float2(vec[4 * kTile + r],
                         diag ? 1.f
                              : exp_fast((ref - vec[2 * kTile + r]) +
                                         (ref_lo - vec[3 * kTile + r])));
    });
    fence_async_smem();
  };
  issue(h0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split(0);
  if (h0 + 1 < h1) issue(h0 + 1, 1);
  cp_async_commit();
  __syncthreads();

  // G_S's tile: rows i 16 warp + g (+8), keys 32 wg + 8j + 2t (+1)
  float acc[16] = {};
#pragma unroll 1
  for (int h = h0; h < h1; ++h) {
    const int cur = (h - h0) & 1;
    float gm[16];
    wgmma_3xtf32(gm, sA + cur * kCore, sALo + cur * kCore, sB + cur * kCore + 2048 * wg,
                 sBLo + cur * kCore + 2048 * wg, ks);
    // a diagonal tile's L, then the next head's split, while the tensor cores
    // work
    const float* vec = sVec + cur * 5 * kTile;
    float L[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 16 * warp + gq + 8 * (e >> 1), jl = 32 * wg + 8 * j + 2 * tq + (e & 1);
        L[4 * j + e] = !diag ? 1.f
                       : jl <= il && I0 + il < Q
                           ? exp_fast((vec[il] - vec[2 * kTile + jl]) +
                                      (vec[kTile + il] - vec[3 * kTile + jl]))
                           : 0.f;
      }
    if (h + 1 < h1) {
      cp_async_wait<0>();
      __syncthreads();
      split(cur ^ 1);
    }
    wgmma_wait_all();
    wgmma_fence_operand(gm);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += gm[e] * L[e];
    __syncthreads();       // the next head's split is done; this stage is free
    if (h + 2 < h1) issue(h + 2, cur);
    cp_async_commit();
  }
  float* out = part + (bc * G + g) * ns * F + sl * F + static_cast<long long>(p) * kTile * kTile;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(out + (16 * warp + gq + 8 * hr) * kTile + 32 * wg + 8 * j +
                                 2 * tq) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
}

// grid (ns n_tiles, nc, b G), blockIdx.x = jt ns + slice: key tile jt's part
// of gB's state term, sum over the slice's heads of (w o u) gstate^T. Two
// warpgroups, one block an SM: warpgroup wg takes the states 64 wg .. 64 wg
// + 63; per head its product runs on the tensor cores while the block splits
// the next head's tiles.
__global__ void __launch_bounds__(2 * kWG, 1)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ gstate, const float* __restrict__ seg,
                     const float* __restrict__ seg_lo, float* __restrict__ part, int H, int P,
                     int G, int N, int Q, int ns, long long F, Strides st, int vec_x) {
  extern __shared__ __align__(128) float smem[];
  float* sX = smem;                      // [2][kCore]  x of the key tile, then w o u's high part
  float* sS = sX + 2 * kCore;            // [2][2][kCore]  gstate's states 0 .., 64 .., then high
  float* sXLo = sS + 4 * kCore;          // [2][kCore]  w o u's low part
  float* sSLo = sXLo + 2 * kCore;        // [2][2][kCore]  gstate's low part
  float* sVec = sSLo + 4 * kCore;        // [2][5][kTile]  seg at Q - 1, seg and dt of the keys
  const int jt = blockIdx.x / ns, sl = blockIdx.x % ns;
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z / G, g = blockIdx.z % G;
  const int tid = threadIdx.x, wg = tid / kWG, warp = tid % kWG / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int hpg = H / G, h0 = g * hpg + sl * hpg / ns, h1 = g * hpg + (sl + 1) * hpg / ns;
  const int J0 = jt * kTile, nh = (N + kTile - 1) / kTile, ks = (P + 7) / 8;
  const long long t0 = static_cast<long long>(c) * Q;
  const long long bc = static_cast<long long>(bb) * nc + c;

  auto issue = [&](int h, int stage) {
    load_core<2 * kWG>(sX + stage * kCore, x + bb * st.xb + t0 * st.xs + h * st.xh, st.xs, J0, Q,
                       P, vec_x, tid);
    for (int k = 0; k < nh; ++k)
      load_core<2 * kWG>(sS + (2 * stage + k) * kCore, gstate + (bc * H + h) * N * P, P,
                         k * kTile, N, P, true, tid);
    load_vec(sVec + stage * 5 * kTile, dt, seg, seg_lo, bb, t0, bc, h, H, Q, -1, J0, st, tid);
  };
  auto split = [&](int stage) {
    const float* vec = sVec + stage * 5 * kTile;
    split_core<2 * kWG>(sX + stage * kCore, sXLo + stage * kCore, tid, [&](int r) {
      return make_float2(vec[4 * kTile + r],
                         expf((vec[0] - vec[2 * kTile + r]) + (vec[kTile] - vec[3 * kTile + r])));
    });
    for (int k = 0; k < nh; ++k)
      split_core<2 * kWG>(sS + (2 * stage + k) * kCore, sSLo + (2 * stage + k) * kCore, tid,
                          unit_scale);
    fence_async_smem();
  };
  issue(h0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split(0);
  if (h0 + 1 < h1) issue(h0 + 1, 1);
  cp_async_commit();
  __syncthreads();

  // rows j 16 warp + g (+8), states 64 wg + 8j + 2t (+1); each head's
  // product added in fp32
  float acc[32] = {};
  const bool mine = wg < nh;
#pragma unroll 1
  for (int h = h0; h < h1; ++h) {
    const int cur = (h - h0) & 1;
    float d[32];
    if (mine)
      wgmma_3xtf32(d, sX + cur * kCore, sXLo + cur * kCore, sS + (2 * cur + wg) * kCore,
                   sSLo + (2 * cur + wg) * kCore, ks);
    if (h + 1 < h1) {
      cp_async_wait<0>();
      __syncthreads();
      split(cur ^ 1);
    }
    if (mine) {
      wgmma_wait_all();
      wgmma_fence_operand(d);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += d[e];
    }
    __syncthreads();       // the next head's split is done; this stage is free
    if (h + 2 < h1) issue(h + 2, cur);
    cp_async_commit();
  }
  if (!mine) return;
  float* out = part + (bc * G + g) * ns * F + sl * F +
               static_cast<long long>(n_pairs_of(Q)) * kTile * kTile +
               static_cast<long long>(J0) * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + gq + 8 * (e >> 1), col = kTile * wg + 8 * j + 2 * tq + (e & 1);
      if (col < N) out[row * N + col] = acc[4 * j + e];
    }
}

// grid (2 n_tiles nh, nc, b G), nh = ceil(N / 64): blockIdx.x = (role
// n_tiles + t) nh + ch; role 0 forms gC of row tile t, role 1 gB of key
// tile t, in columns 64 ch .. 64 ch + 63
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_kernel(const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ part, float* __restrict__ gB,
                     float* __restrict__ gC, int s, int G, int N, int Q, int ns, long long F,
                     Strides st, int vec_b, int vec_c) {
  extern __shared__ __align__(16) float smem[];
  float* sT = smem;                      // [kTile][kFP]  G_S's tile (role 1 transposed), high part
  float* sTLo = sT + kTile * kFP;        // [kTile][kFP]  its low part
  float* sV = sTLo + kTile * kFP;        // [kTile][kGP]  B rows (role 0) or C rows (role 1), high
  float* sVLo = sV + kTile * kGP;        // [kTile][kGP]  their low part
  const int nt = (Q + kTile - 1) / kTile, nh = (N + kTile - 1) / kTile;
  const int ch = blockIdx.x % nh, role = blockIdx.x / nh / nt, t = blockIdx.x / nh % nt;
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z / G, g = blockIdx.z % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int w4 = warp & 3, w2 = warp >> 2;
  const long long t0 = static_cast<long long>(c) * Q;
  const float* rp = part + ((static_cast<long long>(bb) * nc + c) * G + g) * ns * F;
  const int c0 = ch * kTile;             // the block's first column
  const float* vp = (role == 0 ? B + bb * st.bb + t0 * st.bs + g * st.bg
                               : C + bb * st.cb + t0 * st.cs + g * st.cg) + c0;
  const long long vs = role == 0 ? st.bs : st.cs;
  const int vec = role == 0 ? vec_b : vec_c;
  float acc[4][4] = {};
  const int o0 = role == 0 ? 0 : t, o1 = role == 0 ? t : nt - 1;
#pragma unroll 1
  for (int o = o0; o <= o1; ++o) {
    const int it = role == 0 ? t : o, jt = role == 0 ? o : t;
    __syncthreads();       // the last tiles are read
    load_tile<kThreads>(sV, kGP, vp, vs, o * kTile, Q, N - c0, kTile, vec, tid);
    cp_async_commit();
    // G_S's tile: the slices' parts summed in order, then split
    const float* tp = rp + static_cast<long long>(it * (it + 1) / 2 + jt) * kTile * kTile;
    for (int idx = tid; idx < kTile * kTile / 4; idx += kThreads) {
      const int r = role == 0 ? idx >> 4 : idx & 63, c4 = (role == 0 ? idx & 15 : idx >> 6) * 4;
      float4 a = __ldcg(reinterpret_cast<const float4*>(tp + r * kTile + c4));
      for (int q = 1; q < ns; ++q) {
        const float4 b = __ldcg(reinterpret_cast<const float4*>(tp + q * F + r * kTile + c4));
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      float hi[4], lo[4];
      split_f(a.x, hi[0], lo[0]);
      split_f(a.y, hi[1], lo[1]);
      split_f(a.z, hi[2], lo[2]);
      split_f(a.w, hi[3], lo[3]);
      if (role == 0) {
        *reinterpret_cast<float4*>(sT + r * kFP + c4) = make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(sTLo + r * kFP + c4) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sT[(c4 + q) * kFP + r] = hi[q];
          sTLo[(c4 + q) * kFP + r] = lo[q];
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    split_tile(sV, sVLo, kGP, tid, unit_scale);
    __syncthreads();
    if (c0 + 32 * w2 >= N) continue;
    // role 0: gC[i] += sum_j G_S[i, j] B[j]; role 1: gB[j] += sum_i G_S[i, j]
    // C[i]; k = the tile's keys or rows, lane t taking 2t and 2t + 1 of each 8
    const float* ah = sT + (16 * w4 + gq) * kFP + 2 * tq;
    const float* al = sTLo + (16 * w4 + gq) * kFP + 2 * tq;
    const float* bh = sV + 2 * tq * kGP + 32 * w2 + gq;
    const float* bl = sVLo + 2 * tq * kGP + 32 * w2 + gq;
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 8) {
      const float2 a0 = *reinterpret_cast<const float2*>(ah + kk);
      const float2 a1 = *reinterpret_cast<const float2*>(ah + 8 * kFP + kk);
      const float2 l0 = *reinterpret_cast<const float2*>(al + kk);
      const float2 l1 = *reinterpret_cast<const float2*>(al + 8 * kFP + kk);
      const uint32_t a_h[4] = {bits(a0.x), bits(a1.x), bits(a0.y), bits(a1.y)};
      const uint32_t a_l[4] = {bits(l0.x), bits(l1.x), bits(l0.y), bits(l1.y)};
      uint32_t b_h[4][2], b_l[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        b_h[n][0] = bits(bh[kk * kGP + 8 * n]);
        b_h[n][1] = bits(bh[(kk + 1) * kGP + 8 * n]);
        b_l[n][0] = bits(bl[kk * kGP + 8 * n]);
        b_l[n][1] = bits(bl[(kk + 1) * kGP + 8 * n]);
      }
      mma3(acc, a_h, a_l, b_h, b_l);
    }
  }
  if (c0 + 32 * w2 >= N) return;
  float* out = role == 0 ? gC : gB;
  const float* state = rp + static_cast<long long>(nt * (nt + 1) / 2) * kTile * kTile;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = t * kTile + 16 * w4 + gq + 8 * (e >> 1);
      const int col = c0 + 32 * w2 + 8 * n + 2 * tq + (e & 1);
      if (row >= Q || col >= N) continue;
      float v = acc[n][e];
      if (role == 1) {     // gB's state term, the slices summed in order
        const float* sp = state + static_cast<long long>(row) * N + col;
        float a = sp[0];
        for (int q = 1; q < ns; ++q) a += sp[q * F];
        v += a;
      }
      out[((bb * static_cast<long long>(s) + t0 + row) * G + g) * N + col] = v;
    }
}

// grid (ceil(H / kThreads)): gA[h] = the sum of gA_part[b, c, h] over (b, c), in order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_gA_kernel(const float* __restrict__ gA_part, float* __restrict__ gA, int H, int nbc) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float a = 0.f;
  for (int i = 0; i < nbc; ++i) a += gA_part[static_cast<long long>(i) * H + h];
  gA[h] = a;
}

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Floats of the scores scratch: [b, nc, G, ceil(Q/16), ceil(Q/8), 32, 4]
long long scores_floats(int b, int nc, int G, int Q) {
  return static_cast<long long>(b) * nc * G * ((Q + 15) / 16) * ((Q + 7) / 8) * 128;
}

// The kernels' shared-memory opt-in, once per device (every call past device 63)
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kScoreSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChunkSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kHeadSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPairSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStateSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGroupSmem);
  // two blocks of the head kernel an SM: all of the SM's shared memory
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_head_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" {

// Floats of the scratch: the scores in fragment order, then seg's high
// and low parts, [b, nc, Q, H] each.
long long ssd_chunk_scratch_floats(int b, int s, int H, int G, int Q) {
  const int nc = s / Q;
  return scores_floats(b, nc, G, Q) + 2LL * b * nc * Q * H;
}

// All tensors fp32. y [b, s, H, P], states [b, s/Q, H, N, P] and decay
// [b, s/Q, H] are contiguous outputs; A [H] contiguous; scratch holds
// ssd_chunk_scratch_floats() floats, 16-byte aligned. strides (in
// elements), 12 values: x (b, s, h), dt (b, s, h), B (b, s, g), C (b, s, g);
// the last axis of x, B and C is contiguous. The wrapper checks Q <= 256,
// N <= 128, P <= 64 with P % 4 == 0, G | H and Q | s.
int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* states, void* decay, void* scratch, int b, int s, int H, int P,
                  int G, int N, int Q, const long long* strides, void* stream) {
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const int nc = s / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  float* scores = static_cast<float*>(scratch);
  float* seg = scores + scores_floats(b, nc, G, Q);
  float* seg_lo = seg + static_cast<long long>(b) * nc * Q * H;
  const int vec_x = aligned16(x, st.xb, st.xs, st.xh);       // P % 4 == 0
  const int vec_b = N % 4 == 0 && aligned16(B, st.bb, st.bs, st.bg);
  const int vec_c = N % 4 == 0 && aligned16(C, st.cb, st.cs, st.cg);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  ssd_scores_kernel<<<dim3(G * (n_tiles * (n_tiles + 1) / 2 + 1), nc, b), kScoreThreads,
                      kScoreSmem, strm>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), scores, seg, seg_lo, static_cast<float*>(decay), H, G, N,
      Q, st, vec_b, vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<dim3(H, nc, b), kThreads, kChunkSmem, strm>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(B),
      scores, seg, seg_lo, static_cast<float*>(y), static_cast<float*>(states), s, H, P, G, N,
      Q, st, vec_x, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the backward's scratch: the forward's scores and seg pairs,
// decay [b, nc, H], the blocks' shares of gA [b, nc, H], and the head
// slices' parts [b, nc, G, ns, F] (F = part_floats), each piece on a
// 16-byte boundary. ns, the slices a group's heads are cut into, is at
// most H / G.
long long ssd_chunk_bwd_scratch_floats(int b, int s, int H, int G, int N, int Q, int ns) {
  const long long nc = s / Q;
  return scores_floats(b, nc, G, Q) + 2 * round4(b * nc * Q * H) + 2 * round4(b * nc * H) +
         b * nc * G * ns * part_floats(N, Q);
}

// Gradients of ssd_chunk_fwd's inputs. gy [b, s, H, P], gstate [b, s/Q, H,
// N, P] and gdecay [b, s/Q, H] contiguous; gx [b, s, H, P], gdt [b, s, H],
// gA [H], gB and gC [b, s, G, N] contiguous outputs; scratch holds
// ssd_chunk_bwd_scratch_floats() floats, 16-byte aligned; ns head slices a
// group (1 <= ns <= H / G); the inputs and their strides as ssd_chunk_fwd
// takes them.
int ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  const void* gy, const void* gstate, const void* gdecay, void* gx, void* gdt,
                  void* gA, void* gB, void* gC, void* scratch, int b, int s, int H, int P, int G,
                  int N, int Q, int ns, const long long* strides, void* stream) {
  if (ns < 1 || ns > H / G) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const int nc = s / Q;
  const int n_tiles = (Q + kTile - 1) / kTile, pairs = n_tiles * (n_tiles + 1) / 2;
  const long long F = part_floats(N, Q);
  float* scores = static_cast<float*>(scratch);
  float* seg = scores + scores_floats(b, nc, G, Q);
  float* seg_lo = seg + round4(static_cast<long long>(b) * nc * Q * H);
  float* decay = seg_lo + round4(static_cast<long long>(b) * nc * Q * H);
  float* gA_part = decay + round4(static_cast<long long>(b) * nc * H);
  float* part = gA_part + round4(static_cast<long long>(b) * nc * H);
  const int vec_x = aligned16(x, st.xb, st.xs, st.xh);
  const int vec_b = N % 4 == 0 && aligned16(B, st.bb, st.bs, st.bg);
  const int vec_c = N % 4 == 0 && aligned16(C, st.cb, st.cs, st.cg);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fdt = static_cast<const float*>(dt);
  const float* fA = static_cast<const float*>(A);
  const float* fB = static_cast<const float*>(B);
  const float* fC = static_cast<const float*>(C);
  const float* fgy = static_cast<const float*>(gy);
  const float* fgs = static_cast<const float*>(gstate);
  ssd_scores_kernel<<<dim3(G * (pairs + 1), nc, b), kScoreThreads, kScoreSmem, strm>>>(
      fdt, fA, fB, fC, scores, seg, seg_lo, decay, H, G, N, Q, st, vec_b, vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_kernel<<<dim3(H, nc, b), kThreads, kHeadSmem, strm>>>(
      fx, fdt, fA, fB, fgy, fgs, static_cast<const float*>(gdecay), scores, seg, seg_lo,
      static_cast<float*>(gx), static_cast<float*>(gdt), gA_part, s, H, P, G, N, Q, st, vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_kernel<<<dim3(ns * n_tiles, nc, b * G), 2 * kWG, kStateSmem, strm>>>(
      fx, fdt, fgs, seg, seg_lo, part, H, P, G, N, Q, ns, F, st, vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pair_kernel<<<dim3(ns * pairs, nc, b * G), 2 * kWG, kPairSmem, strm>>>(
      fx, fdt, fgy, seg, seg_lo, part, s, H, P, G, Q, ns, F, st, vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_group_kernel<<<dim3(2 * n_tiles * ((N + kTile - 1) / kTile), nc, b * G), kThreads,
                         kGroupSmem, strm>>>(fB, fC, part, static_cast<float*>(gB),
                                             static_cast<float*>(gC), s, G, N, Q, ns, F, st,
                                             vec_b, vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_gA_kernel<<<dim3((H + kThreads - 1) / kThreads), kThreads, 0, strm>>>(
      gA_part, static_cast<float*>(gA), H, b * nc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
