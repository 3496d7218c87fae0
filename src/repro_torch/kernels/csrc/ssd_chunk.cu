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

// acc[n] += A B_n for the 8 column fragments n of one k-step, in 3xTF32.
// The tensor cores add with truncation, so a long chain of mma.sync into
// one accumulator drifts by up to an ulp of the running sum per step: each
// k-step's three products are summed from zero on the tensor cores (the
// two small ones first), and the k-steps are summed by fp32 adds, rounded
// to nearest, as a CUDA-core loop would.
template <int NF>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NF][4], const float (&a)[4],
                                           const uint32_t (&bh)[NF][2],
                                           const uint32_t (&bl)[NF][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
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

// acc[NF][4] += A B for one warp over k in [0, K), K a multiple of 8, in
// 3xTF32: A (16 x K) has element (r, k) = a(r, k), B (K x 8 NF) element
// (k, n) = b(k, n); both are read from shared memory through the functors,
// which place the tiles and any transpose. acc is in C-fragment order.
template <int NF, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NF][4], int K, FA a, FB b) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll 1
  for (int k = 0; k < K; k += 8) {
    const float af[4] = {a(gq, k + tq), a(gq + 8, k + tq), a(gq, k + tq + 4),
                         a(gq + 8, k + tq + 4)};
    uint32_t bh[NF][2], bl[NF][2];
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      split_tf32(b(k + tq, 8 * n + gq), bh[n][0], bl[n][0]);
      split_tf32(b(k + tq + 4, 8 * n + gq), bh[n][1], bl[n][1]);
    }
    mma_3xtf32(acc, af, bh, bl);
  }
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
// and decay (kernels/ref.py::ref_ssd_chunk_bwd has the formulas). Four
// launches after ssd_scores_kernel, which recomputes S and the seg pairs:
//
//  ssd_bwd_head_kernel, one block per (head, chunk, batch), 256 threads:
//   - for each 64-key tile J (x, B and u = dt x in shared memory), for each
//     64-row tile I >= J (gy in shared memory, S decoded from the scores
//     scratch): gM = gy u^T by 3xTF32 mma.sync; L = exp((hi_i - hi_j) +
//     (lo_i - lo_j)) formed only where j <= i < Q (above the diagonal exp
//     may overflow, and 0 * inf would be NaN); M = S o L and R = gM o M
//     staged in shared memory; gM o L, this head's share of G_S, to a
//     scratch tile; gu[J] += M^T gy[I] in registers;
//   - g(dA_k) = sum_{j < k <= i} R_ij over the pair ranges: per tile, from
//     R's column sums (k at or before the tile's rows), row sums (k past its
//     keys) or, in a diagonal tile, each row's sums over j < k; one thread a
//     position k, so each sum has a fixed order;
//   - per key tile, v = B gstate; gu += w o v; gx = gu dt; the row sums
//     r_j = w_j u_j . v_j and sum_p gu x; gB's state term (w o u) gstate^T
//     of this head to the scratch;
//   - then g(dA_k) += sum_{j < k} r_j + gdecay, gdt = g(dA) A + sum_p gu x,
//     and the block's share of gA, sum_k g(dA_k) dt_k;
//  ssd_bwd_head_sum_kernel: the heads' shares summed per group, in head
//   order (no atomics: two runs agree bit for bit);
//  ssd_bwd_group_kernel, one block per (tile, role, chunk, batch x group):
//   gC[I] = sum_J G_S[I, J] B[J] and gB[J] = sum_I G_S[I, J]^T C[I] plus
//   the summed state term, by 3xTF32 mma.sync;
//  ssd_bwd_gA_kernel: gA[h], the blocks' shares summed over (batch, chunk)
//   in order.
//
// What bounds it: operations (the causal half of gM, gu, C's and B's
// products and the state terms at 3xTF32, about 10.9 GFLOP at the mamba2
// training shape: 0.066 ms), against about 152 MB of inputs and outputs
// (0.045 ms). This first version is simple before it is fast: the heads'
// shares of G_S and of gB's state term go through a scratch in device
// memory (about 190 MB at that shape, written once and read once), and
// the loads are not overlapped with the products.
constexpr int kHeadSmem = (6 * kMaxQ + 6 * kTile + 3 * kTile * kXP + 2 * kTile * kSP +
                           kTile * kBP + kMaxN * kXP) * static_cast<int>(sizeof(float));
constexpr int kGroupSmem = (kTile * kSP + kTile * kBP) * static_cast<int>(sizeof(float));

// Floats a head leaves in the scratch: its gM o L in the causal 64 x 64
// tiles (it, jt <= it, tile it (it + 1) / 2 + jt), then gB's state term
// [n_tiles * 64, N].
long long part_floats(int N, int Q) {
  const int n_tiles = (Q + kTile - 1) / kTile;
  return static_cast<long long>(n_tiles * (n_tiles + 1) / 2) * kTile * kTile +
         static_cast<long long>(n_tiles) * kTile * N;
}

// grid (H, nc, b)
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ gy, const float* __restrict__ gstate,
                    const float* __restrict__ gdecay, const float* __restrict__ scores,
                    const float* __restrict__ seg, const float* __restrict__ seg_lo,
                    float* __restrict__ gx, float* __restrict__ gdt, float* __restrict__ part,
                    float* __restrict__ gA_part, int s, int H, int P, int G, int N, int Q,
                    long long F, Strides st, int vec_x, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  float* sSeg = smem;                   // [kMaxQ]  seg, high part (0 past Q)
  float* sSegLo = sSeg + kMaxQ;         // [kMaxQ]  its low part
  float* sDt = sSegLo + kMaxQ;          // [kMaxQ]  dt
  float* sW = sDt + kMaxQ;              // [kMaxQ]  w = exp(total - seg)
  float* sRw = sW + kMaxQ;              // [kMaxQ]  r_j = w_j u_j . v_j
  float* sGdx = sRw + kMaxQ;            // [kMaxQ]  sum_p gu_jp x_jp
  float* sCol = sGdx + kMaxQ;           // [kTile]  column sums of an R tile
  float* sRow = sCol + kTile;           // [kTile]  its row sums
  float* sHalf = sRow + kTile;          // [4][kTile]  row sums of the two column halves
  float* sX = sHalf + 4 * kTile;        // [kTile][kXP]  x of the key tile
  float* sU = sX + kTile * kXP;         // [kTile][kXP]  u = dt x of the key tile
  float* sGy = sU + kTile * kXP;        // [kTile][kXP]  gy of the row tile
  float* sS = sGy + kTile * kXP;        // [kTile][kSP]  S of the (row, key) tile, then R
  float* sM = sS + kTile * kSP;         // [kTile][kSP]  M = S o L
  float* sB = sM + kTile * kSP;         // [kTile][kBP]  B of the key tile
  float* sGs = sB + kTile * kBP;        // [kMaxN][kXP]  this head's gstate [N, P]

  const int h = blockIdx.x, c = blockIdx.y, bb = blockIdx.z, nc = gridDim.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int wr = warp & 3, wc = warp >> 2;      // a 16-row strip, a 32-column half of a tile
  const long long t0 = static_cast<long long>(c) * Q;
  const long long bc = static_cast<long long>(bb) * nc + c;
  const float* xp = x + bb * st.xb + t0 * st.xs + h * st.xh;
  const float* bp = B + bb * st.bb + t0 * st.bs + g * st.bg;
  const float* gyp = gy + ((bb * static_cast<long long>(s) + t0) * H + h) * P;
  const float* gsp = gstate + (bc * H + h) * N * P;
  const int n_tiles = (Q + kTile - 1) / kTile, r16 = (Q + 15) / 16, k8 = (Q + 7) / 8;
  const int Pk = (P + 7) / 8 * 8, Nk = (N + 7) / 8 * 8;
  float* hp = part + (bc * H + h) * F;
  const float* sc = scores + (bc * G + g) * r16 * k8 * 128;

  load_tile<kThreads>(sGs, kXP, gsp, P, 0, N, P, kMaxP, 1, tid);
  load_tile<kThreads>(sGs + kTile * kXP, kXP, gsp, P, kTile, N, P, kMaxP, 1, tid);
  cp_async_commit();
  const long long so = bc * Q * H + h;
  const float* dp = dt + bb * st.db + t0 * st.ds + h * st.dh;
  for (int i = tid; i < kMaxQ; i += kThreads) {
    sSeg[i] = i < Q ? seg[so + static_cast<long long>(i) * H] : 0.f;
    sSegLo[i] = i < Q ? seg_lo[so + static_cast<long long>(i) * H] : 0.f;
    sDt[i] = i < Q ? dp[i * st.ds] : 0.f;
    sRw[i] = 0.f;
    sGdx[i] = 0.f;
  }
  __syncthreads();
  const float total = sSeg[Q - 1], total_lo = sSegLo[Q - 1];
  for (int i = tid; i < kMaxQ; i += kThreads)
    sW[i] = i < Q ? expf((total - sSeg[i]) + (total_lo - sSegLo[i])) : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  float fk = 0.f;   // R's pairs j < k <= i, k = tid
#pragma unroll 1
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int J0 = jt * kTile;
    load_tile<kThreads>(sX, kXP, xp, st.xs, J0, Q, P, kMaxP, vec_x, tid);
    load_tile<kThreads>(sB, kBP, bp, st.bs, J0, Q, N, Nk, vec_b, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int idx = tid; idx < kTile * kMaxP; idx += kThreads) {
      const int j = idx / kMaxP, p = idx % kMaxP;
      sU[j * kXP + p] = __fmul_rn(sX[j * kXP + p], sDt[J0 + j]);
    }
    float gu[4][4] = {};   // rows 16 wr.. of the key tile, columns 32 wc..
#pragma unroll 1
    for (int it = jt; it < n_tiles; ++it) {
      const int I0 = it * kTile;
      __syncthreads();     // sU is written; the last tile's sGy, sS, sM, sCol, sRow are read
      load_tile<kThreads>(sGy, kXP, gyp, static_cast<long long>(H) * P, I0, Q, P, kMaxP, 1, tid);
      cp_async_commit();
      // S of the tile from the scratch: its 4 x 8 fragments (rows 16 rl.., keys
      // 8 kl..), one 16-byte piece a lane, written to shared memory with 0
      // where j > i or i >= Q (fragments wholly above the diagonal are not in
      // the scratch)
      for (int idx = tid; idx < 32 * 32; idx += kThreads) {
        const int l = idx % 32, rl = idx / 256, kl = idx / 32 % 8;
        const int r = it * 4 + rl, ks = jt * 8 + kl;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < r16 && ks < k8 && ks <= 2 * r + 1)
          v = __ldcg(reinterpret_cast<const float4*>(sc) + (static_cast<long long>(r) * k8 + ks) * 32 + l);
        const int il = rl * 16 + l / 4, jl = kl * 8 + l % 4, i = I0 + il, j = J0 + jl;
        float* o = sS + il * kSP + jl;
        o[0] = i < Q && j <= i ? v.x : 0.f;
        o[8 * kSP] = i + 8 < Q && j <= i + 8 ? v.y : 0.f;
        o[4] = i < Q && j + 4 <= i ? v.z : 0.f;
        o[8 * kSP + 4] = i + 8 < Q && j + 4 <= i + 8 ? v.w : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // gM = gy u^T: rows 16 wr.. of the row tile, keys 32 wc..
      float gm[4][4] = {};
      warp_mma<4>(gm, Pk, [&](int r, int k) { return sGy[(16 * wr + r) * kXP + k]; },
                  [&](int k, int n) { return sU[(32 * wc + n) * kXP + k]; });
      float m[4][4], rr[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = I0 + 16 * wr + gq + e / 2 * 8, j = J0 + 32 * wc + 8 * n + 2 * tq + e % 2;
          const float L =
              i < Q && j <= i ? expf((sSeg[i] - sSeg[j]) + (sSegLo[i] - sSegLo[j])) : 0.f;
          m[n][e] = sS[(i - I0) * kSP + j - J0] * L;
          rr[n][e] = gm[n][e] * m[n][e];
          gm[n][e] *= L;
        }
      // this head's gM o L to the scratch
      float* gp = hp + static_cast<long long>(it * (it + 1) / 2 + jt) * kTile * kTile;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float* o = gp + (16 * wr + gq) * kTile + 32 * wc + 8 * n + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2(gm[n][0], gm[n][1]);
        *reinterpret_cast<float2*>(o + 8 * kTile) = make_float2(gm[n][2], gm[n][3]);
      }
      __syncthreads();     // every warp has read S
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (16 * wr + gq + e / 2 * 8) * kSP + 32 * wc + 8 * n + 2 * tq + e % 2;
          sM[o] = m[n][e];
          sS[o] = rr[n][e];
        }
      __syncthreads();
      // gu += M^T gy: rows j of the key tile, summed over the rows i of this tile
      warp_mma<4>(gu, kTile, [&](int r, int k) { return sM[k * kSP + 16 * wr + r]; },
                  [&](int k, int n) { return sGy[k * kXP + 32 * wc + n]; });
      if (tid < kTile) {
        float a = 0.f;
        for (int i = 0; i < kTile; ++i) a += sS[i * kSP + tid];
        sCol[tid] = a;
      } else if (tid < 2 * kTile) {
        float a = 0.f;
        for (int j = 0; j < kTile; ++j) a += sS[(tid - kTile) * kSP + j];
        sRow[tid - kTile] = a;
      }
      __syncthreads();
      if (it == jt) {                    // a diagonal tile: R's rows to their sums over j < jl
        if (tid < kTile) {
          float a = 0.f;
          for (int jl = 0; jl < kTile; ++jl) {
            const float v = sS[tid * kSP + jl];
            sS[tid * kSP + jl] = a;
            a += v;
          }
        }
        __syncthreads();
      }
      // this tile's pairs j < k <= i, for k = tid
      const int k = tid;
      if (k > J0 && k < I0 + kTile && k < Q) {
        float a = 0.f;
        if (k <= I0) {                   // every row of the tile is at or past k
          for (int jl = 0; jl < min(k - J0, kTile); ++jl) a += sCol[jl];
        } else if (k >= J0 + kTile) {    // every key of the tile is before k
          for (int il = k - I0; il < kTile; ++il) a += sRow[il];
        } else {                         // k inside a diagonal tile: rows i >= k of keys j < k
          for (int il = k - I0; il < kTile; ++il) a += sS[il * kSP + k - J0];
        }
        fk += a;
      }
    }

    // the state's terms of the key tile: v = B gstate, rows j, columns p
    float v[4][4] = {};
    warp_mma<4>(v, Nk, [&](int r, int k) { return sB[(16 * wr + r) * kBP + k]; },
                [&](int k, int n) { return sGs[k * kXP + 32 * wc + n]; });
    float rsum[2] = {0.f, 0.f}, xsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 16 * wr + gq + e / 2 * 8, p = 32 * wc + 8 * n + 2 * tq + e % 2;
        const float gu_j = gu[n][e] + sW[J0 + jl] * v[n][e];
        rsum[e / 2] += sU[jl * kXP + p] * v[n][e];
        xsum[e / 2] += gu_j * sX[jl * kXP + p];
        if (J0 + jl < Q && p < P)
          gx[((bb * static_cast<long long>(s) + t0 + J0 + jl) * H + h) * P + p] =
              gu_j * sDt[J0 + jl];
      }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      rsum[q] += __shfl_xor_sync(0xffffffffu, rsum[q], 1);
      rsum[q] += __shfl_xor_sync(0xffffffffu, rsum[q], 2);
      xsum[q] += __shfl_xor_sync(0xffffffffu, xsum[q], 1);
      xsum[q] += __shfl_xor_sync(0xffffffffu, xsum[q], 2);
      if (tq == 0) {
        sHalf[wc * kTile + 16 * wr + gq + 8 * q] = rsum[q];
        sHalf[(2 + wc) * kTile + 16 * wr + gq + 8 * q] = xsum[q];
      }
    }
    // this head's share of gB's state term: (w o u) gstate^T, rows j, columns n
    if (64 * wc < N) {
      float gbs[8][4] = {};
      warp_mma<8>(gbs, Pk,
                  [&](int r, int k) { return sW[J0 + 16 * wr + r] * sU[(16 * wr + r) * kXP + k]; },
                  [&](int k, int n) { return sGs[(64 * wc + n) * kXP + k]; });
      float* o = hp + static_cast<long long>(n_tiles * (n_tiles + 1) / 2) * kTile * kTile +
                 static_cast<long long>(J0) * N;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * wc + 8 * n + 2 * tq + e % 2;
          if (col < N) o[(16 * wr + gq + e / 2 * 8) * N + col] = gbs[n][e];
        }
    }
    __syncthreads();
    if (tid < kTile && J0 + tid < Q) {
      sRw[J0 + tid] = sW[J0 + tid] * (sHalf[tid] + sHalf[kTile + tid]);
      sGdx[J0 + tid] = sHalf[2 * kTile + tid] + sHalf[3 * kTile + tid];
    }
    __syncthreads();       // before the next key tile refills sX, sU and sB
  }

  // g(dA_k) = fk + sum_{j < k} r_j + gdecay; gdt; the block's share of gA
  const int k = tid;
  float gdA = 0.f;
  if (k < Q) {
    float rw = 0.f;
    for (int j = 0; j < k; ++j) rw += sRw[j];
    gdA = fk + rw + gdecay[bc * H + h];
    gdt[(bb * static_cast<long long>(s) + t0 + k) * H + h] = gdA * A[h] + sGdx[k];
  }
  sS[k] = k < Q ? gdA * sDt[k] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float a = 0.f;
    for (int i = 0; i < Q; ++i) a += sS[i];
    gA_part[bc * H + h] = a;
  }
}

// grid (ceil(F / 4 / kThreads), nc, b G): red[b, c, g] = the sum of part[b, c, h]
// over the group's heads, in head order (F % 4 == 0)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_sum_kernel(const float* __restrict__ part, float* __restrict__ red, int H, int G,
                        long long F) {
  const long long f = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (f >= F) return;
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z / G, g = blockIdx.z % G;
  const int hpg = H / G;
  const long long bc = static_cast<long long>(bb) * nc + c;
  const float* src = part + (bc * H + static_cast<long long>(g) * hpg) * F + f;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < hpg; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(src + k * F);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  *reinterpret_cast<float4*>(red + (bc * G + g) * F + f) = a;
}

// grid (2 n_tiles, nc, b G): blockIdx.x = role * n_tiles + t; role 0 forms gC
// of row tile t, role 1 gB of key tile t
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_group_kernel(const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ red, float* __restrict__ gB,
                     float* __restrict__ gC, int s, int G, int N, int Q, long long F,
                     Strides st, int vec_b, int vec_c) {
  extern __shared__ __align__(16) float smem[];
  float* sT = smem;                     // [kTile][kSP]  a tile of G_S
  float* sV = sT + kTile * kSP;         // [kTile][kBP]  B rows (role 0) or C rows (role 1)
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int role = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const int c = blockIdx.y, nc = gridDim.y, bb = blockIdx.z / G, g = blockIdx.z % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int wr = warp & 3, wc = warp >> 2;      // a 16-row strip, a 64-column half of N
  const long long t0 = static_cast<long long>(c) * Q;
  const float* rp = red + ((static_cast<long long>(bb) * nc + c) * G + g) * F;
  const float* vp = role == 0 ? B + bb * st.bb + t0 * st.bs + g * st.bg
                              : C + bb * st.cb + t0 * st.cs + g * st.cg;
  const long long vs = role == 0 ? st.bs : st.cs;
  const int vec = role == 0 ? vec_b : vec_c;
  const int width = (N + kTile - 1) / kTile * kTile;    // the columns the warps read
  float acc[8][4] = {};
  const int o0 = role == 0 ? 0 : t, o1 = role == 0 ? t : n_tiles - 1;
#pragma unroll 1
  for (int o = o0; o <= o1; ++o) {
    const int it = role == 0 ? t : o, jt = role == 0 ? o : t;
    __syncthreads();       // the last tile is read
    load_tile<kThreads>(sT, kSP, rp + static_cast<long long>(it * (it + 1) / 2 + jt) * kTile * kTile,
                        kTile, 0, kTile, kTile, kTile, 1, tid);
    load_tile<kThreads>(sV, kBP, vp, vs, o * kTile, Q, N, width, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (64 * wc >= N) continue;
    if (role == 0)         // gC[i] += sum_j G_S[i, j] B[j]
      warp_mma<8>(acc, kTile, [&](int r, int k) { return sT[(16 * wr + r) * kSP + k]; },
                  [&](int k, int n) { return sV[k * kBP + 64 * wc + n]; });
    else                   // gB[j] += sum_i G_S[i, j] C[i]
      warp_mma<8>(acc, kTile, [&](int r, int k) { return sT[k * kSP + 16 * wr + r]; },
                  [&](int k, int n) { return sV[k * kBP + 64 * wc + n]; });
  }
  if (64 * wc >= N) return;
  float* out = role == 0 ? gC : gB;
  const float* state = rp + static_cast<long long>(n_tiles * (n_tiles + 1) / 2) * kTile * kTile;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = t * kTile + 16 * wr + gq + e / 2 * 8, col = 64 * wc + 8 * n + 2 * tq + e % 2;
      if (row >= Q || col >= N) continue;
      float v = acc[n][e];
      if (role == 1) v += state[static_cast<long long>(row) * N + col];   // gB's state term
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
    err = cudaFuncSetAttribute(ssd_bwd_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGroupSmem);
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
// decay [b, nc, H], the blocks' shares of gA [b, nc, H], the heads' parts
// [b, nc, H, F] and their group sums [b, nc, G, F] (F = part_floats), each
// piece on a 16-byte boundary.
long long ssd_chunk_bwd_scratch_floats(int b, int s, int H, int G, int N, int Q) {
  const long long nc = s / Q;
  return scores_floats(b, nc, G, Q) + 2 * round4(b * nc * Q * H) + 2 * round4(b * nc * H) +
         b * nc * (H + G) * part_floats(N, Q);
}

// Gradients of ssd_chunk_fwd's inputs. gy [b, s, H, P], gstate [b, s/Q, H,
// N, P] and gdecay [b, s/Q, H] contiguous; gx [b, s, H, P], gdt [b, s, H],
// gA [H], gB and gC [b, s, G, N] contiguous outputs; scratch holds
// ssd_chunk_bwd_scratch_floats() floats, 16-byte aligned; the inputs and
// their strides as ssd_chunk_fwd takes them.
int ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  const void* gy, const void* gstate, const void* gdecay, void* gx, void* gdt,
                  void* gA, void* gB, void* gC, void* scratch, int b, int s, int H, int P, int G,
                  int N, int Q, const long long* strides, void* stream) {
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const int nc = s / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const long long F = part_floats(N, Q);
  float* scores = static_cast<float*>(scratch);
  float* seg = scores + scores_floats(b, nc, G, Q);
  float* seg_lo = seg + round4(static_cast<long long>(b) * nc * Q * H);
  float* decay = seg_lo + round4(static_cast<long long>(b) * nc * Q * H);
  float* gA_part = decay + round4(static_cast<long long>(b) * nc * H);
  float* part = gA_part + round4(static_cast<long long>(b) * nc * H);
  float* red = part + static_cast<long long>(b) * nc * H * F;
  const int vec_x = aligned16(x, st.xb, st.xs, st.xh);
  const int vec_b = N % 4 == 0 && aligned16(B, st.bb, st.bs, st.bg);
  const int vec_c = N % 4 == 0 && aligned16(C, st.cb, st.cs, st.cg);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fdt = static_cast<const float*>(dt);
  const float* fA = static_cast<const float*>(A);
  const float* fB = static_cast<const float*>(B);
  const float* fC = static_cast<const float*>(C);
  ssd_scores_kernel<<<dim3(G * (n_tiles * (n_tiles + 1) / 2 + 1), nc, b), kScoreThreads,
                      kScoreSmem, strm>>>(fdt, fA, fB, fC, scores, seg, seg_lo, decay, H, G, N,
                                          Q, st, vec_b, vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_kernel<<<dim3(H, nc, b), kThreads, kHeadSmem, strm>>>(
      fx, fdt, fA, fB, static_cast<const float*>(gy), static_cast<const float*>(gstate),
      static_cast<const float*>(gdecay), scores, seg, seg_lo, static_cast<float*>(gx),
      static_cast<float*>(gdt), part, gA_part, s, H, P, G, N, Q, F, st, vec_x, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_sum_kernel<<<dim3(static_cast<unsigned>((F / 4 + kThreads - 1) / kThreads), nc,
                                 b * G), kThreads, 0, strm>>>(part, red, H, G, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_group_kernel<<<dim3(2 * n_tiles, nc, b * G), kThreads, kGroupSmem, strm>>>(
      fB, fC, red, static_cast<float*>(gB), static_cast<float*>(gC), s, G, N, Q, F, st, vec_b,
      vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_gA_kernel<<<dim3((H + kThreads - 1) / kThreads), kThreads, 0, strm>>>(
      gA_part, static_cast<float*>(gA), H, b * nc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
