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
// Plain C interface for ctypes. The kernels launch on the caller's stream,
// allocate nothing and the entry point returns cudaGetLastError().
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
__device__ __forceinline__ void mma_3xtf32(float (&acc)[8][4], const float (&a)[4],
                                           const uint32_t (&bh)[8][2],
                                           const uint32_t (&bl)[8][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
  float d[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) mma_tf32_zero(d[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += d[n][r];
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

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
}

// Floats of the scores scratch: [b, nc, G, ceil(Q/16), ceil(Q/8), 32, 4]
long long scores_floats(int b, int nc, int G, int Q) {
  return static_cast<long long>(b) * nc * G * ((Q + 15) / 16) * ((Q + 7) / 8) * 128;
}

// Both kernels' shared-memory opt-in, once per device (every call past device 63)
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

}  // extern "C"
