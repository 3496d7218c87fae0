// Flash attention (prefill) and split-KV flash decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_fwd_mma_kernel (bf16), flash_fwd_kernel (fp32)
//                             <- flash_attention / _flash_kernel
//   flash_decode_kernel       <- flash_decode / _decode_kernel (its splits of
//     the cache meet in a thread block cluster: the cross-split combine that
//     the TPU kernel did not need, its kv loop being one sequential grid axis).
// and adds the backward of flash_attention, which has no Pallas counterpart
// (flash_attention_bwd: flash_bwd_delta_kernel, then flash_bwd_dkdv_mma_kernel
// and flash_bwd_dq_mma_kernel in bf16, flash_bwd_dkdv_kernel and
// flash_bwd_dq_kernel in fp32; see the section "Backward" below). The forward
// kernels write each row's logsumexp for it when given a buffer.
//
// Plain C interface, loaded with ctypes (kernels/build.py). Kernels allocate
// nothing: the Python wrapper allocates outputs and scratch on the current
// stream. Each entry point returns cudaGetLastError() after its launches.
// Inputs are fp32 or bf16 (templates); every sum is fp32.
//
// flash_attention: at the serving prefill shape (b=8, h=24, s=512, d=128,
// bf16) the card's bound is close to balanced: 67 MB of q/k/v/o at 3.35 TB/s
// (20 us) against ~2*b*h*sq*skv*d = 12.9 GFLOP of causal work at 989 TFLOP/s
// (13 us). So it is bound by bytes at s 512 and by operations at longer
// prompts. Two kernels:
//   flash_fwd_mma_kernel (bf16): FlashAttention-2's structure on the tensor
//     cores. Each warp owns 16 query rows, held in registers as mma.sync
//     m16n8k16 A-fragments; K/V tiles of 64 keys stream through a
//     double-buffered ring in shared memory filled by cp.async, so tile j+1
//     loads while tile j is computed; S = Q K^T and O += P V run on the
//     tensor cores with fp32 sums, and the online softmax stays in registers
//     (P goes from the S accumulators to the P.V A-fragments without a trip
//     through shared memory, rounded to bf16 as FlashAttention does). Against
//     the bytes bound it reads each K/V tile once per 64 query rows and
//     orders the grid so that the query heads of one KV head run together
//     and share K/V in L2; against the operations bound it skips the k-tiles
//     past the diagonal and before the window (each warp also skips its
//     softmax steps of 16 or 32 keys that lie wholly past its own diagonal),
//     and masks only the steps that straddle an edge. Three blocks share an
//     SM (12 warps) to hide the latency of mma.sync and ldmatrix: that caps
//     a thread at 168 registers, which sets the softmax step.
//   flash_fwd_kernel (fp32): fp32 FMAs on the CUDA cores, where fp32 inputs
//     keep the 2e-5 tolerance that TF32 or bf16 tensor cores cannot meet.
//     Same tile skipping; each K/V tile is staged once in shared memory for
//     all 64 query rows of the block.
//
// flash_decode: one query row per head against the whole cache, so the
// kernel is bound by the K/V bytes it reads (2*b*kvh*len*d*sizeof(T), each
// once): 12-13 MB at the llama decode shape (b 8, kvh 8, d 128, bf16,
// ragged lengths), 3.7 us at 3.35 TB/s, against 43 MFLOP of work (0.04 us on
// the tensor cores, so it does not use them). HBM delivers its rate only
// with about 3.35 TB/s x ~1 us = 3 MB of loads in flight, ~25 KB per SM. So:
//   - one block per (row, kv head, split) serves all g = h/kvh query heads
//     of that kv head: each K/V element is read from device memory once,
//     through the strides given (the model's [b, S, kvh, d] cache in place),
//     and keys before starts[b] (a sliding window, or a rank's block of a
//     sequence-split cache) or at or past lengths[b] are never read: a split
//     whose range lies wholly outside [starts, lengths) issues no loads, and
//     a row with no key gives 0 (its logsumexp, written on request from the
//     join's m and l, is -inf);
//   - every K/V read is one 16-byte cp.async (8 bf16 or 4 fp32 dims of a key
//     row) into a 4-stage ring in shared memory, 16 KB a stage, 3 stages in
//     flight: 48 KB a block, and an SM holds 3 blocks (64 KB each);
//   - D and the group G (1, 2, 3, 4, or 8 for 5-8) are template parameters,
//     so every loop unrolls and q, the scores, the running max and sum and
//     the accumulators stay in registers; no block barrier runs inside the
//     key loop (a thread reads back only what it copied), two run after it,
//     where the 4 warps merge their states;
//   - every lane of every warp reads keys at g = 1 as at g = 8: the heads
//     share a lane's loads, they do not divide the lanes;
//   - the cache is split along the sequence, in whole tiles of 64 keys, into
//     as many splits (at most 8) as let all blocks be resident at once
//     (kernels/flash_attention.py::decode_plan): 5 at the llama shape, 320
//     blocks; 1 at zamba2's, 256 blocks. The splits of one (row, kv
//     head) are one thread block cluster, which joins their partials through
//     distributed shared memory: one launch, no scratch in device memory,
//     nothing for the host to reset, so it can be captured in a CUDA graph.
//     (A second kernel for the join would add its launch, which costs about
//     as much device time as a split kernel with no keys to read.)

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;   // masked score, as in the Pallas kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// Prefill. Grid (ceil(sq/64), h, b); 256 threads. Each query row is owned by
// a group of 4 neighbouring threads; thread `part` of the group holds the
// head-dim elements part, part+4, part+8, ... of q and of the accumulator, so
// the 4 threads read neighbouring shared-memory words (no bank conflicts).
// A q.k dot product is 4 partial sums joined by two shuffles.
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kTPR = 4;
constexpr int kFwdThreads = kBQ * kTPR;

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int h, int kvh, int sq, int skv,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 float scale, int causal, int window, float* __restrict__ lse) {
  constexpr int DP = D / kTPR;
  __shared__ float Ks[kBK][D];
  __shared__ float Vs[kBK][D];

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / kvh);
  const int tid = threadIdx.x;
  const int row = tid / kTPR, part = tid % kTPR;
  const int qi = qt * kBQ + row;
  const bool row_ok = qi < sq;
  const int off = skv - sq;
  const int qpos = qi + off;

  float qr[DP], acc[DP];
  const T* qp = q + bb * qsb + hh * qsh + (long long)qi * qss;
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    qr[j] = row_ok ? to_f(qp[part + kTPR * j]) : 0.f;
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // k-tiles this block needs: none past the last row's diagonal, none wholly
  // before the first row's window (the wrapper guarantees skv >= sq when
  // causal, so every row has a valid key and skipped tiles contribute 0).
  int k_begin = 0, k_end = skv;
  if (causal) {
    const int q_lo = qt * kBQ + off;
    const int q_hi = min(qt * kBQ + kBQ, sq) - 1 + off;
    k_end = min(skv, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / kBK) * kBK;

  const T* kb = k + bb * ksb + kh * ksh;
  const T* vb = v + bb * vsb + kh * vsh;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kFwdThreads) {
      const int kk = idx / D, dd = idx % D, kpos = k0 + kk;
      const bool ok = kpos < skv;
      Ks[kk][dd] = ok ? to_f(kb[(long long)kpos * kss + dd]) : 0.f;
      Vs[kk][dd] = ok ? to_f(vb[(long long)kpos * vss + dd]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float tmax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) dot = fmaf(qr[j], Ks[kk][part + kTPR * j], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float sc = dot * scale;
      const int kpos = k0 + kk;
      if (kpos >= skv) {
        sc = -INFINITY;                      // past the ragged edge: weight 0
      } else if (causal && (kpos > qpos || (window > 0 && kpos <= qpos - window))) {
        sc = kNegInf;
      }
      s[kk] = sc;
      tmax = fmaxf(tmax, sc);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      s[kk] = expf(s[kk] - m_new);
      psum += s[kk];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int j = 0; j < DP; ++j) acc[j] *= alpha;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = fmaf(s[kk], Vs[kk][part + kTPR * j], acc[j]);
    }
    m = m_new;
  }

  if (row_ok) {
    T* op = o + bb * osb + hh * osh + (long long)qi * oss;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DP; ++j) store_f(op + part + kTPR * j, acc[j] * inv);
    // the row's logsumexp, for the backward (natural log units)
    if (lse != nullptr && part == 0) lse[((long long)bb * h + hh) * sq + qi] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Prefill on the tensor cores (bf16). Grid (h, b, ceil(sq/64)); 128 threads,
// 4 warps of 16 query rows each. blockIdx.x runs over the query heads, so the
// h/kvh heads of one KV head are neighbours and read one K/V from L2;
// blockIdx.z runs over the q tiles from the last (the heaviest under the
// causal mask) to the first. Each 64-key tile is taken in online-softmax
// steps of KH keys. Dynamic shared memory: a two-stage ring of K
// and V tiles (68 KB at D 128, so three blocks fit on an SM); the Q tile is
// staged in the second K stage and moves to registers before that stage's
// first fill. Each row is padded by 8 bf16 (16 bytes) so that the 8 row
// addresses of an ldmatrix land on 8 distinct 16-byte bank groups for every
// supported D (row pitches of 48, 80, 144, 176, 272 bytes).
//
// mma.sync.m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16x16): a0 (row g, cols 2t..2t+1), a1 (row g+8), a2 (row g, cols
//              2t+8..2t+9), a3 (row g+8, cols 2t+8..)
//   B (16x8):  b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g)
//   C (16x8):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// Q's A-fragments come from ldmatrix.x4; K's B-fragments from ldmatrix (K is
// [key][d], so a key row is a column of K^T); V's from ldmatrix.trans. P's
// A-fragment for keys 16j..16j+15 is {pack(c0,c1), pack(c2,c3)} of S n-tile
// 2j, then the same of n-tile 2j+1.
// ---------------------------------------------------------------------------
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;
constexpr int kMmaThreads = 128;
constexpr int kMmaPad = 8;            // bf16 per shared-memory row
constexpr int kMmaMinBlocks = 3;      // per SM (68 KB each at D 128): <= 168 registers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * kMmaBK * (D + kMmaPad);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src-size 0 zero-fills (rows past
// the ragged edge), with src still a valid address.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a b on the tensor cores: bf16 inputs, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx: 2 ulp; -inf -> +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int h, int kvh, int sq, int skv,
                     long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss,
                     long long osb, long long osh, long long oss,
                     float scale_log2, int causal, int window, float* __restrict__ lse) {
  constexpr int P = D + kMmaPad;            // shared-memory row pitch (elements)
  constexpr int KS = D / 16;                // k-steps of Q K^T
  constexpr int NT = D / 8;                 // n-tiles of the output
  // keys per online-softmax step: 16 at D 128 keeps the step's S and P in
  // the registers that three blocks an SM leave beside Q and O (ptxas: no
  // spills); 32 elsewhere
  constexpr int KH = D == 128 ? 16 : 32;
  constexpr int SN = KH / 8;                // n-tiles of S per step
  constexpr int ROW_CHUNKS = D / 8;         // 16-byte copies per row
  constexpr int TILE_CHUNKS = kMmaBK * ROW_CHUNKS;
  static_assert(D % 16 == 0 && kMmaBQ == kMmaBK && kMmaBQ == 16 * (kMmaThreads / 32),
                "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][BK][P]
  __nv_bfloat16* Vs = Ks + 2 * kMmaBK * P;                           // [2][BK][P]
  __nv_bfloat16* Qs = Ks + kMmaBK * P;                               // [BQ][P]: K stage 1

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int kh = hh / (h / kvh);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = skv - sq;
  const int q0 = qt * kMmaBQ;

  // k-tiles this block needs, as in flash_fwd_kernel
  int k_begin = 0, k_end = skv;
  if (causal) {
    const int q_lo = q0 + off;
    const int q_hi = min(q0 + kMmaBQ, sq) - 1 + off;
    k_end = min(skv, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / kMmaBK) * kMmaBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kMmaBK - 1) / kMmaBK : 0;

  // rows [row0, row0 + 64) of a [rows, D] matrix with row stride `stride`
  // into a shared tile; rows at or past `rows` are zero-filled
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long stride,
                       int row0, int rows) {
#pragma unroll
    for (int c = tid; c < TILE_CHUNKS; c += kMmaThreads) {
      const int r = c / ROW_CHUNKS, col = (c % ROW_CHUNKS) * 8;
      const bool ok = row0 + r < rows;
      const __nv_bfloat16* s = ok ? src + (long long)(row0 + r) * stride + col : src;
      cp_async_16(smem_u32(dst + r * P + col), s, ok);
    }
  };

  const __nv_bfloat16* qb = q + bb * qsb + hh * qsh;
  const __nv_bfloat16* kb = k + bb * ksb + kh * ksh;
  const __nv_bfloat16* vb = v + bb * vsb + kh * vsh;
  load_tile(Qs, qb, qss, q0, sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile(Ks, kb, kss, k_begin, skv);
    load_tile(Vs, vb, vss, k_begin, skv);
  }
  cp_async_commit();
  cp_async_wait<1>();                       // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A-fragments, one per k-step
  uint32_t qf[KS][4];
  {
    const int r = warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qf[ks], smem_u32(Qs + r * P + ks * 16 + (lane / 16) * 8));
  }
  __syncthreads();                          // K stage 1 is free for tile 1

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // rows g and g+8 of the warp: running max (log2 units) and this thread's
  // share of the row sum (the quad's shares are joined at the end)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;     // query row of c0, c1; c2, c3 at row_a + 8
  const int wq_lo = q0 + warp * 16 + off;   // this warp's first and last query position
  const int wq_hi = wq_lo + 15;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kMmaBK;
    const int buf = j & 1;
    if (j + 1 < n_tiles) {                  // prefetch tile j+1 into the other stage
      load_tile(Ks + (buf ^ 1) * kMmaBK * P, kb, kss, k0 + kMmaBK, skv);
      load_tile(Vs + (buf ^ 1) * kMmaBK * P, vb, vss, k0 + kMmaBK, skv);
    }
    cp_async_commit();                      // an empty group on the last tile
    cp_async_wait<1>();                     // tile j has landed
    __syncthreads();

    const __nv_bfloat16* Kt = Ks + buf * kMmaBK * P;
    const __nv_bfloat16* Vt = Vs + buf * kMmaBK * P;
    // the tile in steps of KH keys, each an online-softmax update
#pragma unroll
    for (int h0 = 0; h0 < kMmaBK; h0 += KH) {
      const int kb0 = k0 + h0;
      // a step wholly past the ragged edge, past this warp's diagonal or
      // before its window adds 0
      if (kb0 >= skv ||
          (causal && (kb0 > wq_hi || (window > 0 && kb0 + KH - 1 <= wq_lo - window))))
        continue;

      // S = Q K^T: 16 x KH per warp, fp32
      float s[SN][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t kf[4];
          const int key = h0 + np * 16 + (lane / 16) * 8 + lane % 8;
          ldmatrix_x4(kf, smem_u32(Kt + key * P + ks * 16 + (lane / 8 % 2) * 8));
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }

      // scale into log2 units; mask only a step that straddles an edge
      const bool edge = kb0 + KH > skv ||
                        (causal && (kb0 + KH - 1 > wq_lo ||
                                    (window > 0 && kb0 <= wq_hi - window)));
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sc = s[nt][e] * scale_log2;
          if (edge) {
            const int kpos = kb0 + nt * 8 + 2 * t + (e & 1);
            const int qpos = row_a + (e >> 1) * 8 + off;
            if (kpos >= skv) {
              sc = -INFINITY;                 // past the ragged edge: weight 0
            } else if (causal && (kpos > qpos || (window > 0 && kpos <= qpos - window))) {
              sc = kNegInf;
            }
          }
          s[nt][e] = sc;
        }
      }

      // online softmax: rows g (r = 0) and g+8 (r = 1), max over the quad
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = fast_exp2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][2 * r] *= alpha;
          acc[nt][2 * r + 1] *= alpha;
        }
      }
      uint32_t pf[SN / 2][4];                // P as A-fragments, 16 keys each
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        const float p0 = fast_exp2(s[nt][0] - m_r[0]), p1 = fast_exp2(s[nt][1] - m_r[0]);
        const float p2 = fast_exp2(s[nt][2] - m_r[1]), p3 = fast_exp2(s[nt][3] - m_r[1]);
        l_r[0] += p0 + p1;
        l_r[1] += p2 + p3;
        pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < SN / 2; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          const int key = h0 + kk * 16 + (lane / 8 % 2) * 8 + lane % 8;
          ldmatrix_x4_trans(vf, smem_u32(Vt + key * P + np * 16 + (lane / 16) * 8));
          mma_bf16(acc[2 * np], pf[kk], vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pf[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                        // the stage is free for tile j+2
  }

  __nv_bfloat16* ob = o + bb * osb + hh * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qi = row_a + 8 * r;
    if (qi < sq) {
      uint32_t* op = reinterpret_cast<uint32_t*>(ob + (long long)qi * oss + 2 * t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        op[nt * 4] = pack_bf16(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
      // the row's logsumexp in natural log units (m_r is in log2 units)
      if (lse != nullptr && t == 0)
        lse[((long long)bb * h + hh) * sq + qi] = (m_r[r] + log2f(l)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// Decode. Grid (n_splits, kvh, b); 4 warps. Each thread owns kVec contiguous
// dims of one key row, copied as one 16-byte cp.async: kLanesPerRow lanes
// cover a row and a warp covers kRowsPerWarp rows at once (lanes past the
// last whole row sit out: 2 of 32 at d 80 in bf16). A stage is kKeys keys
// per row group (key k0 + j * groups + group of the block's stage of
// groups * kKeys keys), K and V; a ring of kStages stages in shared memory
// keeps kStages - 1 of them in flight while one is computed. Each thread
// reads back only the bytes it copied itself, so the ring needs no block
// barrier: a thread waits on its own copies (cp.async.wait_group) and
// refills the slot it has just read. Per stage a row group takes its keys'
// scores for all g heads against its q slice (a shuffle sum over the row's
// lanes) and folds them into its warp's online softmax: m is the warp's (a
// warp-wide max), l and the accumulator slice are the row group's, all in
// registers. Scores are in log2 units (q is scaled by scale * log2 e), so
// every exponential is exp2. After the split's keys the warps' states meet
// in shared memory (over the ring) into the split's partial (acc, m, l) per
// head, and the cluster's blocks join the partials of all splits.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecMaxSplits = 8;      // the largest portable cluster

template <typename TKV, int D, int G>
struct DecodeGeometry {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));   // elements per copy
  static constexpr int kLanesPerRow = D / kVec;
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  static constexpr int kGroups = kDecWarps * kRowsPerWarp;          // rows read at once
  static constexpr int kKeys = 4;                                   // per row group and stage
  static constexpr int kStages = 4;
  // one stage of K and V: 2 * 4 keys * 16 bytes per thread, 16 KB per block
  // at every D and dtype (2 of 32 lanes idle at d 80: 15 KB)
  static constexpr int kStageBytes = 2 * kKeys * kGroups * D * static_cast<int>(sizeof(TKV));
  static constexpr int kMergeBytes = sizeof(float) * kGroups * G * D;
  static constexpr int kRingBytes = kStages * kStageBytes > kMergeBytes
                                        ? kStages * kStageBytes : kMergeBytes;
  // after the ring: the warps' m [4][G] and the row groups' l [groups][G];
  // then this split's partial, read by the cluster: acc [G][D], (m, l) [G][2]
  static constexpr int kSmemBytes =
      kRingBytes + sizeof(float) * (kDecWarps * G + kGroups * G + G * D + 2 * G);
  static_assert(D % kVec == 0 && kLanesPerRow <= 32, "head dim");
};

__device__ __forceinline__ void widen16(const uint4& u, float (&f)[8]) {   // 8 bf16
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen16(const uint4& u, float (&f)[4]) {   // 4 fp32
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// sum over the kLanesPerRow lanes that hold one key row, left in all of them
template <int LPR>
__device__ __forceinline__ float row_sum(float x, int lane, int sub) {
  if constexpr ((LPR & (LPR - 1)) == 0) {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  } else {     // rows not aligned to a power of two (d 80): a tree to the row's lane 0
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (sub + o < LPR) x += y;
    }
    return __shfl_sync(0xffffffffu, x, lane - sub);
  }
}

// max over the warp of a value that is uniform within each row
template <int LPR>
__device__ __forceinline__ float warp_max(float x) {
  constexpr int first = (LPR & (LPR - 1)) == 0 ? LPR : 1;
#pragma unroll
  for (int o = first; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ lengths,
                    const int* __restrict__ starts, TQ* __restrict__ o,
                    float* __restrict__ lse, int h, int kvh, int S, int split_len, int n_splits,
                    long long qsb, long long qsh,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    long long osb, long long osh, float scale_log2) {
  using Geo = DecodeGeometry<TKV, D, G>;
  constexpr int VEC = Geo::kVec, LPR = Geo::kLanesPerRow, RPW = Geo::kRowsPerWarp;
  constexpr int GROUPS = Geo::kGroups, N = Geo::kKeys, STAGES = Geo::kStages;
  constexpr int STEP = GROUPS * N;                       // keys per stage
  extern __shared__ __align__(16) unsigned char dec_smem[];
  // ring[stage][K or V][key j][group][D]; after the keys, the merge's
  // acc[group][G][D] over it
  TKV* ring = reinterpret_cast<TKV*>(dec_smem);
  float* sm_m = reinterpret_cast<float*>(dec_smem + Geo::kRingBytes);   // [warps][G]
  float* sm_l = sm_m + kDecWarps * G;                                   // [groups][G]
  float* part_acc = sm_l + GROUPS * G;                                  // [G][D]
  float* part_ml = part_acc + G * D;                                    // [G][2]

  const int g = h / kvh;             // <= G: heads past g are zeros, never written
  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPR;        // this lane's dims: sub * VEC ...
  const int row = lane / LPR;        // this lane's row of the warp (RPW: sits out)
  const bool active = row < RPW;
  const int grp = warp * RPW + row;
  // the row attends [start, len): this split its part of it, none where the
  // split's range lies wholly outside (no loads, m = -inf, l = 0)
  const int len = min(lengths[bb], S);
  const int start = starts == nullptr ? 0 : max(starts[bb], 0);
  const int s0 = max(split * split_len, start);
  const int s1 = min(split * split_len + split_len, len);
  const int n_steps = s1 > s0 ? (s1 - s0 + STEP - 1) / STEP : 0;

  const TKV* kb = k + bb * ksb + kh * ksh + sub * VEC;
  const TKV* vb = v + bb * vsb + kh * vsh + sub * VEC;
  const uint4 kZero16 = make_uint4(0u, 0u, 0u, 0u);   // what an idle lane reads
  // this thread's 16 bytes of key j, K or V, in ring stage st
  auto slot = [&](int st, int kv, int j) {
    return ring + (((st * 2 + kv) * N + j) * GROUPS + grp) * D + sub * VEC;
  };
  // stage i of the split: keys s0 + i * STEP + j * GROUPS + grp; past s1 the
  // copy zero-fills (from a valid address), so a masked key's V is 0, not junk
  auto fetch = [&](int i) {
    if (i < n_steps && active) {
      const int st = i % STAGES;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int key = s0 + i * STEP + j * GROUPS + grp;
        const bool ok = key < s1;
        const long long row_k = ok ? key * kss : 0, row_v = ok ? key * vss : 0;
        cp_async_16(smem_u32(slot(st, 0, j)), kb + row_k, ok);
        cp_async_16(smem_u32(slot(st, 1, j)), vb + row_v, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  float qr[G][VEC], acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const TQ* qp = q + bb * qsb + (long long)(kh * g + gi) * qsh + sub * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[gi][e] = active && gi < g ? to_f(qp[e]) * scale_log2 : 0.f;
      acc[gi][e] = 0.f;
    }
    m[gi] = -INFINITY;
    l[gi] = 0.f;
  }

  for (int i = 0; i < n_steps; ++i) {
    fetch(i + STAGES - 1);            // refills the slot this thread read at step i - 1
    cp_async_wait<STAGES - 1>();      // this thread's copies of step i have landed
    const int st = i % STAGES;
    const int k0 = s0 + i * STEP;
    float s[N][G];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float kf[VEC];
      widen16(active ? *reinterpret_cast<const uint4*>(slot(st, 0, j)) : kZero16, kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[gi][e], kf[e], dot);
        s[j][gi] = dot;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool ok = active && k0 + j * GROUPS + grp < s1;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float dot = row_sum<LPR>(s[j][gi], lane, sub);
        s[j][gi] = ok ? dot : -INFINITY;
      }
    }
    // the warp's running max; masked keys (-inf) weigh 0
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float cm = s[0][gi];
#pragma unroll
      for (int j = 1; j < N; ++j) cm = fmaxf(cm, s[j][gi]);
      const float m_new = fmaxf(m[gi], warp_max<LPR>(cm));
      if (m_new == -INFINITY) continue;           // uniform: no key of this warp yet
      const float alpha = exp2f(m[gi] - m_new);   // 0 at the warp's first keys
      m[gi] = m_new;
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float vf[VEC];
      widen16(active ? *reinterpret_cast<const uint4*>(slot(st, 1, j)) : kZero16, vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = s[j][gi] == -INFINITY ? 0.f : exp2f(s[j][gi] - m[gi]);
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
      }
    }
  }
  cp_async_wait<0>();                 // no copy may land in the merge's memory

  // the warps meet once: M = max_w m_w, L = sum l_r 2^(m_w - M), A likewise
  float* sm_acc = reinterpret_cast<float*>(dec_smem);   // [GROUPS][G][D], over the ring
  __syncthreads();                    // every thread is done with the ring
  if (active) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(&sm_acc[(grp * G + gi) * D + sub * VEC + e]) =
            make_float4(acc[gi][e], acc[gi][e + 1], acc[gi][e + 2], acc[gi][e + 3]);
      if (sub == 0) sm_l[grp * G + gi] = l[gi];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) sm_m[warp * G + gi] = m[gi];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * D; idx += kDecThreads) {
    const int gi = idx / D, dd = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sm_m[w * G + gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float mw = sm_m[w * G + gi];
      if (mw == -INFINITY) continue;
      const float f = exp2f(mw - M);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        L = fmaf(f, sm_l[(w * RPW + r) * G + gi], L);
        A = fmaf(f, sm_acc[((w * RPW + r) * G + gi) * D + dd], A);
      }
    }
    part_acc[gi * D + dd] = A;
    if (dd == 0) {
      part_ml[2 * gi] = M;
      part_ml[2 * gi + 1] = L;
    }
  }

  // The splits of this (row, kv head) are one cluster, block rank = split.
  // Each block joins a share of the outputs from all the splits' partials,
  // read from their shared memory, in split order with a running max as the
  // online softmax: M' = max(M, m_s), L' = L 2^(M - M') + l_s 2^(m_s - M'),
  // acc likewise; a split past the row's length (m_s = -inf) weighs 0.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                     // every split's partial is written
  for (int idx = split * kDecThreads + threadIdx.x; idx < g * D;
       idx += n_splits * kDecThreads) {
    const int gi = idx / D, dd = idx % D;
    float M = -INFINITY, L = 0.f, a = 0.f;
    for (int r = 0; r < n_splits; ++r) {
      const float* ml = cluster.map_shared_rank(part_ml, r);
      const float ms = ml[2 * gi], ls = ml[2 * gi + 1];
      const float as = cluster.map_shared_rank(part_acc, r)[gi * D + dd];
      const float m_new = fmaxf(M, ms);
      const float c = M == m_new ? 1.f : exp2f(M - m_new);
      const float w = ms == -INFINITY ? 0.f : exp2f(ms - m_new);
      L = fmaf(L, c, w * ls);
      a = fmaf(a, c, w * as);
      M = m_new;
    }
    // an empty row (L = 0) gives 0 and a logsumexp of -inf
    store_f(o + bb * osb + (long long)(kh * g + gi) * osh + dd, a / fmaxf(L, 1e-30f));
    if (lse != nullptr && dd == 0)
      lse[(long long)bb * h + kh * g + gi] = L > 0.f ? (M + log2f(L)) * kLn2 : -INFINITY;
  }
  cluster.sync();                     // no block leaves while its partial is read
}

// bf16 on the tensor cores. At D 80 and 128 the kernel takes more than the
// 48 KB of shared memory a block gets without opting in; it also asks for
// the largest shared-memory carveout, so that three blocks fit. Both are set
// before every launch, so they hold on whichever device is current.
template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int h, int kvh, int sq, int skv, const long long* st, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(h, b, (sq + kMmaBQ - 1) / kMmaBQ);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), h, kvh, sq, skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * kLog2e, causal, window, lse);
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the CUDA cores (flash_fwd_kernel), bf16 on the tensor cores
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h,
               int kvh, int sq, int skv, const long long* st, float scale,
               int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_fwd_mma<D>(q, k, v, o, lse, b, h, kvh, sq, skv, st, scale, causal, window,
                             stream);
  } else {
    dim3 grid((sq + kBQ - 1) / kBQ, h, b);
    flash_fwd_kernel<T, D><<<grid, kFwdThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), h, kvh, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window, lse);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_fwd_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                 int b, int h, int kvh, int sq, int skv, const long long* st, float scale,
                 int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_fwd<T, 16>(q, k, v, o, lse, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 32: return launch_fwd<T, 32>(q, k, v, o, lse, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 64: return launch_fwd<T, 64>(q, k, v, o, lse, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 80: return launch_fwd<T, 80>(q, k, v, o, lse, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 128: return launch_fwd<T, 128>(q, k, v, o, lse, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const int *lengths, *starts;
  void* o;
  float* lse;
  int b, h, kvh, S, split_len, n_splits;
  const long long* st;
  float scale;
  cudaStream_t stream;
};

// One cluster of n_splits blocks per (row, kv head). The ring takes 64 KB of
// dynamic shared memory, more than a block gets without opting in; the
// largest carveout lets three blocks share an SM. Both are set before every
// launch, so they hold on whichever device is current.
template <typename TQ, typename TKV, int D, int G>
int launch_decode(const DecodeArgs& a) {
  if (a.n_splits < 1 || a.n_splits > kDecMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_decode_kernel<TQ, TKV, D, G>;
  constexpr int smem = DecodeGeometry<TKV, D, G>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.n_splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.kvh, a.b);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const long long* st = a.st;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
                           static_cast<const TKV*>(a.v), a.lengths, a.starts,
                           static_cast<TQ*>(a.o), a.lse, a.h,
                           a.kvh, a.S, a.split_len, a.n_splits, st[0], st[1], st[2], st[3],
                           st[4], st[5], st[6], st[7], st[8], st[9], a.scale * kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// g query heads per kv head, padded to G in {1, 2, 3, 4, 8}
template <typename TQ, typename TKV, int D>
int launch_decode_g(const DecodeArgs& a) {
  switch (a.h / a.kvh) {
    case 1: return launch_decode<TQ, TKV, D, 1>(a);
    case 2: return launch_decode<TQ, TKV, D, 2>(a);
    case 3: return launch_decode<TQ, TKV, D, 3>(a);
    case 4: return launch_decode<TQ, TKV, D, 4>(a);
    case 5: case 6: case 7: case 8: return launch_decode<TQ, TKV, D, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TKV>
int launch_decode_d(int d, const DecodeArgs& a) {
  switch (d) {
    case 16: return launch_decode_g<TQ, TKV, 16>(a);
    case 32: return launch_decode_g<TQ, TKV, 32>(a);
    case 64: return launch_decode_g<TQ, TKV, 64>(a);
    case 80: return launch_decode_g<TQ, TKV, 80>(a);
    case 128: return launch_decode_g<TQ, TKV, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Backward (flash_attention_bwd). The Pallas kernel has no backward: the JAX
// package trains through XLA's autodiff of its einsum attention
// (src/repro/models/layers.py:210-217). This is FlashAttention-2's backward,
// fp32 sums for fp32 and bf16 inputs alike, with P recomputed from the
// logsumexp the forward saved (no [sq, skv] matrix in device memory). Three
// launches:
//   flash_bwd_delta_kernel  D = rowsum(dO o O), one warp a row;
//   dK, dV                  per (key tile, kv head, batch): loops over the
//     query heads of its group and the query tiles that see its keys, so
//     the GQA sum of dK and dV needs no atomics;
//   dQ                      per (query tile, head, batch): loops over the
//     key tiles its rows see (the forward's tile range).
// Both main kernels recompute S = Q K^T and dP = dO V^T for their tile pair
// (7 products where a kernel with atomics would do 5), so every gradient is
// the same from run to run. At the training shape (b 2, h 24, kvh 8, s 1024,
// d 128, causal) the 5 products are 32 GFLOP, 0.033 ms at 989 TFLOP/s, and
// the inputs and outputs 67 MB (0.020 ms at 3.35 TB/s): the backward is bound
// by operations.
//
// bf16 (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel): all 7 products
// on the tensor cores as mma.sync m16n8k16 (bf16 in, fp32 sums), 4 warps of
// 16 rows, tiles arriving through cp.async rings as in flash_fwd_mma_kernel.
// The dK/dV kernel forms the products transposed, S^T = K Q^T and dP^T =
// V dO^T, so that P^T and dS^T leave the accumulators already in the
// A-fragment layout of dV += P^T dO and dK += dS^T Q (rounded to bf16 there,
// as FlashAttention-2 rounds them); K and V stay in shared memory and are
// read by ldmatrix (one warp's dK and dV sums take 128 registers a thread at
// d 128, which leaves no room for K and V fragments), while Q, dO and their
// rows' lse and D stream through a two-stage ring. The dQ kernel holds its
// rows of Q and dO as A-fragments in registers, as the forward holds Q, and
// streams K and V through the forward's ring. Only steps that straddle the
// diagonal, the window edge or a ragged edge are masked; steps wholly masked
// are skipped. What is left on the table is Hopper's own path: wgmma fed by
// TMA with warp-specialised producers, and 8 warps a block so that a
// larger tile halves the reloads of Q and dO (later work).
//
// fp32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): fp32 FMAs on the CUDA
// cores, where fp32 inputs keep a 1e-4 tolerance that bf16 or TF32 tensor
// cores cannot meet. Tiles of 32 query rows x 32 keys, 256 threads, all
// staged in shared memory as fp32 (rows padded by 4 floats: 16-byte aligned,
// and the 8 rows of a quarter-warp's 16-byte loads fall in distinct bank
// groups). S/dP step: thread (i = tid / 8, kq = tid % 8) takes row i against
// keys kq + 8j, j < 4. Accumulation step: thread (c = tid / 8, kq = tid % 8)
// owns dims 4c..4c+3 of keys (or rows) kq + 8j; threads with 4c >= D sit it
// out. Bound by the rate of shared-memory loads (5 16-byte loads for 16 FMAs
// in the S/dP step).
// ---------------------------------------------------------------------------
constexpr int kBwdT = 32;             // query rows and keys per tile
constexpr int kBwdThreads = 256;

template <int D>
__host__ __device__ constexpr int bwd_pitch() { return D + 4; }

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * kBwdT * bwd_pitch<D>() + 2 * kBwdT * (kBwdT + 1) + 2 * kBwdT);
}

// rows [row0, row0 + 32) of a [rows, D] matrix with row stride `stride` into
// a padded fp32 tile; rows at or past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void bwd_load_tile(float* dst, const T* __restrict__ src,
                                              long long stride, int row0, int rows) {
  for (int idx = threadIdx.x; idx < kBwdT * D; idx += kBwdThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * bwd_pitch<D>() + c] = row0 + r < rows ? to_f(src[(long long)(row0 + r) * stride + c]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, const float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// P and dS of one (query tile, key tile) pair into Ps, dSs [32][33]: S and dP
// from the staged Q, dO, K, V; P = exp(S scale - lse), 0 where masked (as the
// forward masks: the causal diagonal with the query offset skv - sq, the
// window, the ragged edges); dS = P (dP - D).
template <int D>
__device__ __forceinline__ void bwd_p_ds(const float* Qs, const float* dOs, const float* Ks,
                                         const float* Vs, const float* lse_s,
                                         const float* del_s, float* Ps, float* dSs, int q0,
                                         int k0, int sq, int skv, float scale, int causal,
                                         int window) {
  constexpr int P = bwd_pitch<D>();
  const int i = threadIdx.x / 8, kq = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(Qs + i * P + c);
    const float4 ov = *reinterpret_cast<const float4*>(dOs + i * P + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = dot4(qv, *reinterpret_cast<const float4*>(Ks + (kq + 8 * j) * P + c), s[j]);
      dp[j] = dot4(ov, *reinterpret_cast<const float4*>(Vs + (kq + 8 * j) * P + c), dp[j]);
    }
  }
  const int qi = q0 + i, qpos = qi + skv - sq;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = kq + 8 * j, kpos = k0 + kk;
    const bool ok = qi < sq && kpos < skv &&
                    !(causal && (kpos > qpos || (window > 0 && kpos <= qpos - window)));
    const float p = ok ? expf(s[j] * scale - lse_s[i]) : 0.f;
    Ps[i * (kBwdT + 1) + kk] = p;
    dSs[i * (kBwdT + 1) + kk] = p * (dp[j] - del_s[i]);
  }
}

// D[b, h, i] = sum_d dO[i, d] O[i, d], fp32 [b, h, sq]. Grid (ceil(sq/8), h, b).
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, int h, int sq,
                       long long osb, long long osh, long long oss,
                       long long dsb, long long dsh, long long dss) {
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int qi = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (qi >= sq) return;
  const T* op = o + bb * osb + hh * osh + (long long)qi * oss;
  const T* dp = dO + bb * dsb + hh * dsh + (long long)qi * dss;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[((long long)bb * h + hh) * sq + qi] = acc;
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, h, kvh, sq, skv;
  // in elements: q, k, v, o, dO, dq, dk, dv, each (b, head, s)
  const long long* st;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

// dK, dV of 32 keys of one kv head. Grid (ceil(skv/32), kvh, b).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int h, int kvh, int sq, int skv,
                      long long qsb, long long qsh, long long qss,
                      long long ksb, long long ksh, long long kss,
                      long long vsb, long long vsh, long long vss,
                      long long dosb, long long dosh, long long doss,
                      long long dksb, long long dksh, long long dkss,
                      long long dvsb, long long dvsh, long long dvss,
                      float scale, int causal, int window) {
  constexpr int P = bwd_pitch<D>();
  extern __shared__ __align__(16) float bsm[];
  float* Qs = bsm;
  float* dOs = Qs + kBwdT * P;
  float* Ks = dOs + kBwdT * P;
  float* Vs = Ks + kBwdT * P;
  float* Ps = Vs + kBwdT * P;
  float* dSs = Ps + kBwdT * (kBwdT + 1);
  float* lse_s = dSs + kBwdT * (kBwdT + 1);
  float* del_s = lse_s + kBwdT;

  const int kt = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int G = h / kvh;
  const int k0 = kt * kBwdT;
  const int off = skv - sq;
  const int tid = threadIdx.x;
  bwd_load_tile<T, D>(Ks, k + bb * ksb + kh * ksh, kss, k0, skv);
  bwd_load_tile<T, D>(Vs, v + bb * vsb + kh * vsh, vss, k0, skv);

  // query tiles whose rows see a key of this tile: none wholly before the
  // tile's first key (causal), none wholly past its last key's window
  int q_begin = 0, q_end = sq;
  if (causal) {
    q_begin = max(0, k0 - off);
    if (window > 0) q_end = min(sq, k0 + kBwdT - 1 + window - off);
  }
  q_begin = (q_begin / kBwdT) * kBwdT;

  const int c = tid / 8, kq = tid % 8;
  const bool owner = 4 * c < D;
  float4 dka[4], dva[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dka[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int g = 0; g < G; ++g) {
    const int hh = kh * G + g;
    const T* qb = q + bb * qsb + hh * qsh;
    const T* ob = dO + bb * dosb + hh * dosh;
    const float* lb = lse + ((long long)bb * h + hh) * sq;
    const float* db = delta + ((long long)bb * h + hh) * sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBwdT) {
      __syncthreads();                   // the previous tile's Q, dO, P, dS are read
      bwd_load_tile<T, D>(Qs, qb, qss, q0, sq);
      bwd_load_tile<T, D>(dOs, ob, doss, q0, sq);
      if (tid < kBwdT) {
        const bool ok = q0 + tid < sq;
        lse_s[tid] = ok ? lb[q0 + tid] : 0.f;
        del_s[tid] = ok ? db[q0 + tid] : 0.f;
      }
      __syncthreads();
      bwd_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, del_s, Ps, dSs, q0, k0, sq, skv, scale, causal,
                  window);
      __syncthreads();
      if (owner) {
#pragma unroll 4
        for (int i = 0; i < kBwdT; ++i) {
          const float4 ov = *reinterpret_cast<const float4*>(dOs + i * P + 4 * c);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + i * P + 4 * c);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            axpy4(dva[j], Ps[i * (kBwdT + 1) + kq + 8 * j], ov);
            axpy4(dka[j], dSs[i * (kBwdT + 1) + kq + 8 * j], qv);
          }
        }
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + kq + 8 * j;
      if (kpos >= skv) continue;
      T* kp = dk + bb * dksb + kh * dksh + (long long)kpos * dkss + 4 * c;
      T* vp = dv + bb * dvsb + kh * dvsh + (long long)kpos * dvss + 4 * c;
      store_f(kp + 0, dka[j].x * scale);
      store_f(kp + 1, dka[j].y * scale);
      store_f(kp + 2, dka[j].z * scale);
      store_f(kp + 3, dka[j].w * scale);
      store_f(vp + 0, dva[j].x);
      store_f(vp + 1, dva[j].y);
      store_f(vp + 2, dva[j].z);
      store_f(vp + 3, dva[j].w);
    }
  }
}

// dQ of 32 query rows of one head. Grid (ceil(sq/32), h, b).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int h, int kvh, int sq, int skv,
                    long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    long long dosb, long long dosh, long long doss,
                    long long dqsb, long long dqsh, long long dqss,
                    float scale, int causal, int window) {
  constexpr int P = bwd_pitch<D>();
  extern __shared__ __align__(16) float bsm[];
  float* Qs = bsm;
  float* dOs = Qs + kBwdT * P;
  float* Ks = dOs + kBwdT * P;
  float* Vs = Ks + kBwdT * P;
  float* Ps = Vs + kBwdT * P;
  float* dSs = Ps + kBwdT * (kBwdT + 1);
  float* lse_s = dSs + kBwdT * (kBwdT + 1);
  float* del_s = lse_s + kBwdT;

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / kvh);
  const int q0 = qt * kBwdT;
  const int off = skv - sq;
  const int tid = threadIdx.x;
  bwd_load_tile<T, D>(Qs, q + bb * qsb + hh * qsh, qss, q0, sq);
  bwd_load_tile<T, D>(dOs, dO + bb * dosb + hh * dosh, doss, q0, sq);
  if (tid < kBwdT) {
    const bool ok = q0 + tid < sq;
    const long long row = ((long long)bb * h + hh) * sq + q0 + tid;
    lse_s[tid] = ok ? lse[row] : 0.f;
    del_s[tid] = ok ? delta[row] : 0.f;
  }

  // key tiles, as the forward takes them
  int k_begin = 0, k_end = skv;
  if (causal) {
    const int q_lo = q0 + off;
    const int q_hi = min(q0 + kBwdT, sq) - 1 + off;
    k_end = min(skv, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / kBwdT) * kBwdT;

  const int c = tid / 8, iq = tid % 8;
  const bool owner = 4 * c < D;
  float4 dqa[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) dqa[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const T* kb = k + bb * ksb + kh * ksh;
  const T* vb = v + bb * vsb + kh * vsh;
  for (int k0 = k_begin; k0 < k_end; k0 += kBwdT) {
    __syncthreads();                     // the previous tile's K and dS are read
    bwd_load_tile<T, D>(Ks, kb, kss, k0, skv);
    bwd_load_tile<T, D>(Vs, vb, vss, k0, skv);
    __syncthreads();
    bwd_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, del_s, Ps, dSs, q0, k0, sq, skv, scale, causal, window);
    __syncthreads();
    if (owner) {
#pragma unroll 4
      for (int kk = 0; kk < kBwdT; ++kk) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + kk * P + 4 * c);
#pragma unroll
        for (int j = 0; j < 4; ++j) axpy4(dqa[j], dSs[(iq + 8 * j) * (kBwdT + 1) + kk], kv);
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = q0 + iq + 8 * j;
      if (qi >= sq) continue;
      T* qp = dq + bb * dqsb + hh * dqsh + (long long)qi * dqss + 4 * c;
      store_f(qp + 0, dqa[j].x * scale);
      store_f(qp + 1, dqa[j].y * scale);
      store_f(qp + 2, dqa[j].z * scale);
      store_f(qp + 3, dqa[j].w * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward on the tensor cores (bf16). 128 threads, 4 warps of 16 rows; the
// fragment layouts, ldmatrix patterns and row padding are the forward's
// (see flash_fwd_mma_kernel). Tiles of 64 query rows and 64 keys.
// ---------------------------------------------------------------------------
constexpr int kBwdMmaMinBlocks = 2;   // per SM: <= 255 registers a thread

// K and V tiles, then two ring stages of Q and dO tiles with their rows'
// lse and D (fp32): 103 KB at D 128, so two blocks share an SM
template <int D>
constexpr size_t bwd_dkdv_smem_bytes() {
  return sizeof(__nv_bfloat16) * 6 * kMmaBK * (D + kMmaPad) + sizeof(float) * 2 * 2 * kMmaBQ;
}

// 4 bytes global -> shared (one fp32); src-size 0 zero-fills
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// rows [row0, row0 + 64) of a [rows, D] bf16 matrix with row stride
// `stride` into a shared tile of pitch D + kMmaPad, 16 bytes a cp.async;
// rows at or past `rows` are zero-filled
template <int D>
__device__ __forceinline__ void bwd_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long stride, int row0, int rows) {
  constexpr int ROW_CHUNKS = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < kMmaBQ * ROW_CHUNKS; c += kMmaThreads) {
    const int r = c / ROW_CHUNKS, col = (c % ROW_CHUNKS) * 8;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* s = ok ? src + (long long)(row0 + r) * stride + col : src;
    cp_async_16(smem_u32(dst + r * (D + kMmaPad) + col), s, ok);
  }
}

// dK, dV of 64 keys of one kv head. Grid (kvh, b, ceil(skv/64)): the first
// key tiles, which the most query rows see under the causal mask, go first.
// Warp w owns keys k0 + 16w .. + 15. Each query tile of each head of the
// group is taken in steps of QH rows: S^T (16 x QH) = K_w Q^T and dP^T =
// V_w dO^T, then P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T =
// P^T o (dP^T - D) in registers, packed to bf16 A-fragments (a C-fragment
// row is a key, its columns query rows), then dV += P^T dO and dK += dS^T Q
// with dO and Q read by ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBwdMmaMinBlocks)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int h, int kvh, int sq, int skv,
                          long long qsb, long long qsh, long long qss,
                          long long ksb, long long ksh, long long kss,
                          long long vsb, long long vsh, long long vss,
                          long long dosb, long long dosh, long long doss,
                          long long dksb, long long dksh, long long dkss,
                          long long dvsb, long long dvsh, long long dvss,
                          float scale, float scale_log2, int causal, int window) {
  constexpr int P = D + kMmaPad;
  constexpr int KS = D / 16;                // k-steps of S^T and dP^T
  constexpr int NT = D / 8;                 // n-tiles of dK and dV
  // query rows per step: 32 at D 128 keeps the step's S^T and dP^T beside
  // the 128 registers of the dK and dV sums; 64 elsewhere
  constexpr int QH = D == 128 ? 32 : 64;
  constexpr int SN = QH / 8;                // n-tiles of S^T per step
  static_assert(D % 16 == 0 && kMmaBK == 16 * (kMmaThreads / 32), "tile shapes");

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);   // [BK][P]
  __nv_bfloat16* Vs = Ks + kMmaBK * P;                                // [BK][P]
  __nv_bfloat16* Qs = Vs + kMmaBK * P;                                // [2][BQ][P]
  __nv_bfloat16* dOs = Qs + 2 * kMmaBQ * P;                           // [2][BQ][P]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kMmaBQ * P);         // [2][BQ] lse
  float* Ds = Ls + 2 * kMmaBQ;                                        // [2][BQ] D

  const int kh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * kMmaBK;
  const int G = h / kvh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = skv - sq;
  const int kw0 = k0 + warp * 16;           // this warp's first key

  // query rows that see a key of this tile: none before the tile's first
  // key (causal), none past its last key's window
  int q_begin = 0, q_end = sq;
  if (causal) {
    q_begin = max(0, k0 - off);
    if (window > 0) q_end = min(sq, k0 + kMmaBK - 1 + window - off);
  }
  const int nq = q_end > q_begin ? (q_end - q_begin + kMmaBQ - 1) / kMmaBQ : 0;
  const int n_tiles = G * nq;               // (head of the group, query tile) pairs

  // ring stage i % 2 <- query tile i % nq of head kh * G + i / nq
  auto fetch = [&](int i) {
    if (i < n_tiles) {
      const int hh = kh * G + i / nq, q0 = q_begin + (i % nq) * kMmaBQ, st = i & 1;
      bwd_tile_async<D>(Qs + st * kMmaBQ * P, q + bb * qsb + hh * qsh, qss, q0, sq);
      bwd_tile_async<D>(dOs + st * kMmaBQ * P, dO + bb * dosb + hh * dosh, doss, q0, sq);
      if (tid < kMmaBQ) {
        const bool ok = q0 + tid < sq;
        const long long row = ((long long)bb * h + hh) * sq + (ok ? q0 + tid : 0);
        cp_async_4(smem_u32(Ls + st * kMmaBQ + tid), lse + row, ok);
        cp_async_4(smem_u32(Ds + st * kMmaBQ + tid), delta + row, ok);
      }
    }
    cp_async_commit();                      // an empty group past the last tile
  };
  bwd_tile_async<D>(Ks, k + bb * ksb + kh * ksh, kss, k0, skv);
  bwd_tile_async<D>(Vs, v + bb * vsb + kh * vsh, vss, k0, skv);
  fetch(0);                                 // one group: K, V and query tile 0

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
  }
  // A-fragment rows of K_w and V_w; the keys of C-fragment rows g and g + 8
  const int a_row = warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
  const int a_col = (lane / 16) * 8;

  for (int i = 0; i < n_tiles; ++i) {
    fetch(i + 1);                           // into the stage tile i - 1 has left
    cp_async_wait<1>();                     // tile i (and K, V) have landed
    __syncthreads();
    const int st = i & 1;
    const int q0 = q_begin + (i % nq) * kMmaBQ;
    const __nv_bfloat16* Qt = Qs + st * kMmaBQ * P;
    const __nv_bfloat16* dOt = dOs + st * kMmaBQ * P;
    const float* Lt = Ls + st * kMmaBQ;
    const float* Dt = Ds + st * kMmaBQ;

#pragma unroll
    for (int qh = 0; qh < kMmaBQ; qh += QH) {
      const int qs0 = q0 + qh;              // first query row of the step
      const int qs_last = min(qs0 + QH, sq) - 1;
      const int qp_lo = qs0 + off, qp_hi = qs_last + off;
      // a step past sq, past the ragged edge of the keys, or wholly masked
      // for this warp's keys adds 0
      if (qs0 >= sq || kw0 >= skv ||
          (causal && (kw0 > qp_hi || (window > 0 && kw0 + 15 <= qp_lo - window))))
        continue;

      // S^T = K_w Q^T and dP^T = V_w dO^T: 16 keys x QH rows, fp32
      float s[SN][4], dp[SN][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, smem_u32(Ks + a_row * P + ks * 16 + a_col));
        ldmatrix_x4(vf, smem_u32(Vs + a_row * P + ks * 16 + a_col));
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t qf[4], of[4];
          const int row = qh + np * 16 + (lane / 16) * 8 + lane % 8;
          ldmatrix_x4(qf, smem_u32(Qt + row * P + ks * 16 + (lane / 8 % 2) * 8));
          ldmatrix_x4(of, smem_u32(dOt + row * P + ks * 16 + (lane / 8 % 2) * 8));
          mma_bf16(s[2 * np], kf, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], kf, qf[2], qf[3]);
          mma_bf16(dp[2 * np], vf, of[0], of[1]);
          mma_bf16(dp[2 * np + 1], vf, of[2], of[3]);
        }
      }

      // P^T and dS^T, masked only in a step that straddles an edge, as
      // bf16 A-fragments of 16 query rows each
      const bool edge = kw0 + 15 >= skv || qs0 + QH > sq ||
                        (causal && (kw0 + 15 > qp_lo || (window > 0 && kw0 <= qp_hi - window)));
      uint32_t pf[SN / 2][4], sf[SN / 2][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        const int qc = qh + nt * 8 + 2 * t;   // tile row of c0 and c2; c1, c3 at qc + 1
        const float2 lr = *reinterpret_cast<const float2*>(Lt + qc);
        const float2 dr = *reinterpret_cast<const float2*>(Dt + qc);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = (e & 1 ? lr.y : lr.x) * kLog2e;
          float pe = fast_exp2(fmaf(s[nt][e], scale_log2, -l2));
          if (edge) {
            const int kpos = kw0 + g + (e >> 1) * 8;
            const int qi = q0 + qc + (e & 1), qpos = qi + off;
            if (kpos >= skv || qi >= sq ||
                (causal && (kpos > qpos || (window > 0 && kpos <= qpos - window))))
              pe = 0.f;
          }
          p[e] = pe;
          ds[e] = pe * (dp[nt][e] - (e & 1 ? dr.y : dr.x));
        }
        pf[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        sf[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < SN / 2; ++kk) {
        const int row = qh + kk * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t of[4], qf[4];
          ldmatrix_x4_trans(of, smem_u32(dOt + row * P + np * 16 + a_col));
          ldmatrix_x4_trans(qf, smem_u32(Qt + row * P + np * 16 + a_col));
          mma_bf16(dva[2 * np], pf[kk], of[0], of[1]);
          mma_bf16(dva[2 * np + 1], pf[kk], of[2], of[3]);
          mma_bf16(dka[2 * np], sf[kk], qf[0], qf[1]);
          mma_bf16(dka[2 * np + 1], sf[kk], qf[2], qf[3]);
        }
      }
    }
    __syncthreads();                        // the stage is free for tile i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kw0 + g + 8 * r;
    if (kpos >= skv) continue;
    uint32_t* kp = reinterpret_cast<uint32_t*>(dk + bb * dksb + kh * dksh + kpos * dkss + 2 * t);
    uint32_t* vp = reinterpret_cast<uint32_t*>(dv + bb * dvsb + kh * dvsh + kpos * dvss + 2 * t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      kp[nt * 4] = pack_bf16(dka[nt][2 * r] * scale, dka[nt][2 * r + 1] * scale);
      vp[nt * 4] = pack_bf16(dva[nt][2 * r], dva[nt][2 * r + 1]);
    }
  }
}

// dQ of 64 query rows of one head. Grid (h, b, ceil(sq/64)), the last query
// tiles (the heaviest under the causal mask) first, as the forward. Warp w
// owns rows q0 + 16w .. + 15 and holds them of Q and dO as A-fragments;
// K and V stream through the forward's two-stage ring over the forward's key
// range. Each key tile in steps of KH keys: S = Q K^T and dP = dO V^T,
// P = exp2(S scale log2 e - lse log2 e) and dS = P o (dP - D) in registers,
// packed to bf16 A-fragments, then dQ += dS K with K read by ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBwdMmaMinBlocks)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int h, int kvh, int sq, int skv,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long dosb, long long dosh, long long doss,
                        long long dqsb, long long dqsh, long long dqss,
                        float scale, float scale_log2, int causal, int window) {
  constexpr int P = D + kMmaPad;
  constexpr int KS = D / 16;                // k-steps of S and dP
  constexpr int NT = D / 8;                 // n-tiles of dQ
  // keys per step: 32 at D 128 keeps the step's S and dP (32 registers a
  // thread) beside Q, dO and dQ (128); 64 elsewhere
  constexpr int KH = D == 128 ? 32 : 64;
  constexpr int SN = KH / 8;
  static_assert(D % 16 == 0 && kMmaBQ == 16 * (kMmaThreads / 32), "tile shapes");

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);   // [2][BK][P]
  __nv_bfloat16* Vs = Ks + 2 * kMmaBK * P;                            // [2][BK][P]
  __nv_bfloat16* Qs = Ks + kMmaBK * P;      // [BQ][P]: K stage 1
  __nv_bfloat16* dOs = Vs + kMmaBK * P;     // [BQ][P]: V stage 1

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int kh = hh / (h / kvh);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = skv - sq;
  const int q0 = qt * kMmaBQ;

  // key tiles, as the forward takes them
  int k_begin = 0, k_end = skv;
  if (causal) {
    const int q_lo = q0 + off;
    const int q_hi = min(q0 + kMmaBQ, sq) - 1 + off;
    k_end = min(skv, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / kMmaBK) * kMmaBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kMmaBK - 1) / kMmaBK : 0;

  const __nv_bfloat16* kb = k + bb * ksb + kh * ksh;
  const __nv_bfloat16* vb = v + bb * vsb + kh * vsh;
  bwd_tile_async<D>(Qs, q + bb * qsb + hh * qsh, qss, q0, sq);
  bwd_tile_async<D>(dOs, dO + bb * dosb + hh * dosh, doss, q0, sq);
  cp_async_commit();
  if (n_tiles > 0) {
    bwd_tile_async<D>(Ks, kb, kss, k_begin, skv);
    bwd_tile_async<D>(Vs, vb, vss, k_begin, skv);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp: lse in log2 units and D (0 past sq, where
  // nothing is stored)
  const int row_a = q0 + warp * 16 + g;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    const long long row = ((long long)bb * h + hh) * sq + qi;
    l2[r] = qi < sq ? lse[row] * kLog2e : 0.f;
    dl[r] = qi < sq ? delta[row] : 0.f;
  }

  cp_async_wait<1>();                       // Q and dO have landed
  __syncthreads();
  uint32_t qf[KS][4], of[KS][4];
  {
    const int r = warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qf[ks], smem_u32(Qs + r * P + ks * 16 + (lane / 16) * 8));
      ldmatrix_x4(of[ks], smem_u32(dOs + r * P + ks * 16 + (lane / 16) * 8));
    }
  }
  __syncthreads();                          // stage 1 is free for tile 1

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int wq_lo = q0 + warp * 16 + off;   // this warp's first and last query position
  const int wq_hi = wq_lo + 15;
  const bool warp_rows = q0 + warp * 16 < sq;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kMmaBK;
    const int buf = j & 1;
    if (j + 1 < n_tiles) {                  // prefetch tile j+1 into the other stage
      bwd_tile_async<D>(Ks + (buf ^ 1) * kMmaBK * P, kb, kss, k0 + kMmaBK, skv);
      bwd_tile_async<D>(Vs + (buf ^ 1) * kMmaBK * P, vb, vss, k0 + kMmaBK, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();                     // tile j has landed
    __syncthreads();

    const __nv_bfloat16* Kt = Ks + buf * kMmaBK * P;
    const __nv_bfloat16* Vt = Vs + buf * kMmaBK * P;
#pragma unroll
    for (int h0 = 0; h0 < kMmaBK; h0 += KH) {
      const int kb0 = k0 + h0;
      // a step past the ragged edge, past this warp's diagonal or before its
      // window, or for a warp whose rows all lie past sq, adds 0
      if (!warp_rows || kb0 >= skv ||
          (causal && (kb0 > wq_hi || (window > 0 && kb0 + KH - 1 <= wq_lo - window))))
        continue;

      // S = Q K^T and dP = dO V^T: 16 x KH per warp, fp32
      float s[SN][4], dp[SN][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t kf[4], vf[4];
          const int key = h0 + np * 16 + (lane / 16) * 8 + lane % 8;
          ldmatrix_x4(kf, smem_u32(Kt + key * P + ks * 16 + (lane / 8 % 2) * 8));
          ldmatrix_x4(vf, smem_u32(Vt + key * P + ks * 16 + (lane / 8 % 2) * 8));
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
          mma_bf16(dp[2 * np], of[ks], vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], of[ks], vf[2], vf[3]);
        }
      }

      // dS as bf16 A-fragments of 16 keys each; masked only in a step that
      // straddles an edge
      const bool edge = kb0 + KH > skv ||
                        (causal && (kb0 + KH - 1 > wq_lo ||
                                    (window > 0 && kb0 <= wq_hi - window)));
      uint32_t sf[SN / 2][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = fast_exp2(fmaf(s[nt][e], scale_log2, -l2[e >> 1]));
          if (edge) {
            const int kpos = kb0 + nt * 8 + 2 * t + (e & 1);
            const int qpos = row_a + (e >> 1) * 8 + off;
            if (kpos >= skv ||
                (causal && (kpos > qpos || (window > 0 && kpos <= qpos - window))))
              pe = 0.f;
          }
          ds[e] = pe * (dp[nt][e] - dl[e >> 1]);
        }
        sf[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < SN / 2; ++kk) {
        const int key = h0 + kk * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, smem_u32(Kt + key * P + np * 16 + (lane / 16) * 8));
          mma_bf16(acc[2 * np], sf[kk], kf[0], kf[1]);
          mma_bf16(acc[2 * np + 1], sf[kk], kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                        // the stage is free for tile j+2
  }

  __nv_bfloat16* qb = dq + bb * dqsb + hh * dqsh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    if (qi >= sq) continue;
    uint32_t* qp = reinterpret_cast<uint32_t*>(qb + (long long)qi * dqss + 2 * t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      qp[nt * 4] = pack_bf16(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

// bf16: the dK/dV and dQ kernels on the tensor cores, each opting into its
// shared memory and the largest carveout before its launch, so that both
// hold on whichever device is current
template <int D>
int launch_bwd_mma(const BwdArgs& a) {
  const long long* st = a.st;
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dO = static_cast<const bf16*>(a.dO);
  constexpr size_t smem_kv = bwd_dkdv_smem_bytes<D>(), smem_q = mma_smem_bytes<D>();
  const auto dkdv_kernel = flash_bwd_dkdv_mma_kernel<D>;
  const auto dq_kernel = flash_bwd_dq_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = a.scale * kLog2e;
  dkdv_kernel<<<dim3(a.kvh, a.b, (a.skv + kMmaBK - 1) / kMmaBK), kMmaThreads, smem_kv, a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.h,
      a.kvh, a.sq, a.skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[12], st[13], st[14], st[18], st[19], st[20], st[21], st[22], st[23], a.scale,
      scale_log2, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3(a.h, a.b, (a.sq + kMmaBQ - 1) / kMmaBQ), kMmaThreads, smem_q, a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dq), a.h, a.kvh, a.sq, a.skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], st[15],
      st[16], st[17], a.scale, scale_log2, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the dK/dV and dQ kernels on the CUDA cores
template <typename T, int D>
int launch_bwd_scalar(const BwdArgs& a) {
  const long long* st = a.st;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dO = static_cast<const T*>(a.dO);
  constexpr size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, D><<<dim3((a.skv + kBwdT - 1) / kBwdT, a.kvh, a.b), kBwdThreads,
                                smem, a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.kvh,
      a.sq, a.skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12],
      st[13], st[14], st[18], st[19], st[20], st[21], st[22], st[23], a.scale, a.causal,
      a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<dim3((a.sq + kBwdT - 1) / kBwdT, a.h, a.b), kBwdThreads, smem,
                              a.stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dq), a.h, a.kvh, a.sq, a.skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], st[15],
      st[16], st[17], a.scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

// The three launches of one backward: the row sums, then dK and dV, then
// dQ, on the tensor cores in bf16 and on the CUDA cores in fp32
template <typename T, int D>
int launch_bwd(const BwdArgs& a) {
  const long long* st = a.st;
  flash_bwd_delta_kernel<T, D><<<dim3((a.sq + 7) / 8, a.h, a.b), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.delta, a.h, a.sq, st[9],
      st[10], st[11], st[12], st[13], st[14]);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_bwd_mma<D>(a);
  } else {
    return launch_bwd_scalar<T, D>(a);
  }
}

template <typename T>
int launch_bwd_d(int d, const BwdArgs& a) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(a);
    case 32: return launch_bwd<T, 32>(a);
    case 64: return launch_bwd<T, 64>(a);
    case 80: return launch_bwd<T, 80>(a);
    case 128: return launch_bwd<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_fwd_kernel), 1 = bfloat16 (flash_fwd_mma_kernel).
// strides (in elements), 12 values: q (b, h, s), k (b, kvh, s), v (b, kvh, s),
// o (b, h, s); the head dim is contiguous in all four. In bf16 every pointer
// is 16-byte aligned and every stride a multiple of 8 (the wrapper checks).
// lse: null, or fp32 [b, h, sq] contiguous, where each row's logsumexp
// m + log(l) (natural log units) is written for the backward.
int flash_attention_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                        void* o, int b, int h, int kvh, int sq, int skv,
                        const long long* strides, float scale, int causal, int window,
                        float* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_d<float>(d, q, k, v, o, lse, b, h, kvh, sq, skv, strides, scale, causal,
                               window, st);
  if (dtype == 1)
    return launch_fwd_d<__nv_bfloat16>(d, q, k, v, o, lse, b, h, kvh, sq, skv, strides, scale,
                                       causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_dtype / kv_dtype as above (the output takes q's): the cache is bf16 even
// when the model computes in fp32, and bf16 -> fp32 is exact, as the JAX model's
// read of the cache as its compute dtype. strides (in elements), 10 values:
// q (b, h), k (b, kvh, s), v (b, kvh, s), o (b, h). K and V are read 16 bytes
// at a time: both pointers 16-byte aligned, their strides multiples of 16
// bytes (the wrapper checks). 1 <= n_splits <= 8, splits of split_len keys.
// Row i attends cache positions starts[i] <= t < lengths[i] (starts may be
// null: 0); lse, if not null, gets each (row, head)'s logsumexp of the scaled
// scores, fp32 [b, h] contiguous (-inf for an empty row, whose output is 0).
int flash_decode_fwd(int q_dtype, int kv_dtype, int d, const void* q, const void* k,
                     const void* v, const int* lengths, const int* starts, void* o, float* lse,
                     int b, int h, int kvh, int S, int split_len, int n_splits,
                     const long long* strides, float scale, void* stream) {
  const DecodeArgs a{q, k, v, lengths, starts, o, lse, b, h, kvh, S, split_len, n_splits,
                     strides, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return launch_decode_d<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1) return launch_decode_d<__nv_bfloat16, __nv_bfloat16>(d, a);
  if (q_dtype == 0 && kv_dtype == 1) return launch_decode_d<float, __nv_bfloat16>(d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of flash_attention_fwd: dq, dk, dv (in the inputs' dtype) of
// q, k, v given o, dO and the forward's lse. dtype as above. strides (in
// elements), 24 values: q, k, v, o, dO, dq, dk, dv, each (b, head, s); the
// head dim is contiguous in all eight. delta: fp32 [b, h, sq] scratch
// (contiguous); lse: fp32 [b, h, sq] (contiguous). In bf16 every pointer
// but lse's and delta's is 16-byte aligned and every stride a multiple of 8
// (the wrapper checks). Three launches on `stream`: delta, then dk and dv,
// then dq.
int flash_attention_bwd(int dtype, int d, const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const float* lse, float* delta,
                        void* dq, void* dk, void* dv, int b, int h, int kvh, int sq, int skv,
                        const long long* strides, float scale, int causal, int window,
                        void* stream) {
  const BwdArgs a{q, k, v, o, dO, lse, delta, dq, dk, dv, b, h, kvh, sq, skv, strides,
                  scale, causal, window, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_bwd_d<float>(d, a);
  if (dtype == 1) return launch_bwd_d<__nv_bfloat16>(d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
