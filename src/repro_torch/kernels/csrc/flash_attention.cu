// Flash attention (prefill) and split-KV flash decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_fwd_mma_kernel (bf16), flash_fwd_kernel (fp32)
//                             <- flash_attention / _flash_kernel
//   flash_decode_split_kernel <- flash_decode / _decode_kernel
//   + flash_decode_combine_kernel (the cross-split softmax combine that the
//     TPU kernel did not need: its kv loop was one sequential grid axis).
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
// kernel is bound by the K/V bytes it reads (2*b*kvh*len*d*sizeof(T)). Its
// design: one block per (row, kv head, split) serves all h/kvh query heads
// of that kv head, so each K/V element is read from device memory once;
// keys at or past lengths[b] are never read; the cache is split along the
// sequence so that enough blocks fill the 132 SMs at small batch; and K/V
// are read through the strides given, so the model's [b, S, kvh, d] cache
// is read in place, with no transposed copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
                 float scale, int causal, int window) {
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
                     float scale_log2, int causal, int window) {
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
    }
  }
}

// ---------------------------------------------------------------------------
// Decode, pass 1. Grid (n_splits, kvh, b); 128 threads; dynamic shared memory
// (decode_smem_floats). Keys [s0, min(s0 + split_len, lengths[b])) are
// staged in tiles of 32; each tile's scores for the g query heads go through
// shared memory, one warp per head does the online-softmax bookkeeping, and
// the accumulators [g, D] stay in shared memory. Writes one partial
// (m, l, acc) per (row, head, split) to fp32 scratch.
// ---------------------------------------------------------------------------
constexpr int kDecBK = 32;
constexpr int kDecThreads = 128;

inline int decode_smem_floats(int g, int D) {
  return kDecBK * (D + 1) + kDecBK * D + g * D + g * kDecBK + g * D + 3 * g;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v, const int* __restrict__ lengths,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc,
                          int h, int kvh, int S, int D, int split_len, int n_splits,
                          long long qsb, long long qsh,
                          long long ksb, long long ksh, long long kss,
                          long long vsb, long long vsh, long long vss,
                          float scale) {
  extern __shared__ float smem[];
  const int g = h / kvh;
  float* Ks = smem;                        // [BK][D+1] (padded: no bank conflicts)
  float* Vs = Ks + kDecBK * (D + 1);       // [BK][D]
  float* Qs = Vs + kDecBK * D;             // [g][D]
  float* Ss = Qs + g * D;                  // [g][BK] scores, then probabilities
  float* Acc = Ss + g * kDecBK;            // [g][D]
  float* Ms = Acc + g * D;                 // [g]
  float* Ls = Ms + g;                      // [g]
  float* Al = Ls + g;                      // [g]

  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = min(lengths[bb], S);
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, len);
  const long long head0 = (long long)bb * h + kh * g;   // flat (row, head) of head 0

  if (s0 >= s1) {                          // split wholly past this row's length
    for (int idx = tid; idx < g * D; idx += kDecThreads) {
      const int gi = idx / D, dd = idx % D;
      part_acc[((head0 + gi) * n_splits + split) * D + dd] = 0.f;
    }
    if (tid < g) {
      part_m[(head0 + tid) * n_splits + split] = -INFINITY;
      part_l[(head0 + tid) * n_splits + split] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < g * D; idx += kDecThreads) {
    const int gi = idx / D, dd = idx % D;
    Qs[idx] = to_f(q[bb * qsb + (kh * g + gi) * qsh + dd]);
    Acc[idx] = 0.f;
  }
  if (tid < g) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const TKV* kb = k + bb * ksb + kh * ksh;
  const TKV* vb = v + bb * vsb + kh * vsh;
  for (int k0 = s0; k0 < s1; k0 += kDecBK) {
    __syncthreads();
    for (int idx = tid; idx < kDecBK * D; idx += kDecThreads) {
      const int kk = idx / D, dd = idx % D, pos = k0 + kk;
      const bool ok = pos < s1;
      Ks[kk * (D + 1) + dd] = ok ? to_f(kb[(long long)pos * kss + dd]) : 0.f;
      Vs[kk * D + dd] = ok ? to_f(vb[(long long)pos * vss + dd]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < g * kDecBK; idx += kDecThreads) {
      const int gi = idx / kDecBK, kk = idx % kDecBK;
      float sc = -INFINITY;                // keys past the split or the length
      if (k0 + kk < s1) {
        const float* qr = Qs + gi * D;
        const float* kr = Ks + kk * (D + 1);
        float dot = 0.f;
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        sc = dot * scale;
      }
      Ss[idx] = sc;
    }
    __syncthreads();
    // every tile holds at least one valid key (k0 < s1), so tmax is finite
    for (int gi = warp; gi < g; gi += kDecThreads / 32) {
      const float sc = Ss[gi * kDecBK + lane];
      float tmax = sc;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = Ms[gi];
      const float m_new = fmaxf(m_old, tmax);
      const float p = expf(sc - m_new);
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      Ss[gi * kDecBK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Al[gi] = alpha;
        Ls[gi] = Ls[gi] * alpha + psum;
        Ms[gi] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * D; idx += kDecThreads) {
      const int gi = idx / D, dd = idx % D;
      float a = Acc[idx] * Al[gi];
      const float* pr = Ss + gi * kDecBK;
#pragma unroll 8
      for (int kk = 0; kk < kDecBK; ++kk) a = fmaf(pr[kk], Vs[kk * D + dd], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kDecThreads) {
    const int gi = idx / D, dd = idx % D;
    part_acc[((head0 + gi) * n_splits + split) * D + dd] = Acc[idx];
  }
  if (tid < g) {
    part_m[(head0 + tid) * n_splits + split] = Ms[tid];
    part_l[(head0 + tid) * n_splits + split] = Ls[tid];
  }
}

// Decode, pass 2. Grid (h, b); 128 threads. Joins the splits' partial softmax:
// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_combine_kernel(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc, T* __restrict__ o,
                            int h, int D, int n_splits, long long osb, long long osh) {
  const int hh = blockIdx.x, bb = blockIdx.y;
  const long long rowh = (long long)bb * h + hh;
  const float* pm = part_m + rowh * n_splits;
  const float* pl = part_l + rowh * n_splits;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, pm[s]);
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) l += pm[s] == -INFINITY ? 0.f : pl[s] * expf(pm[s] - M);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int dd = threadIdx.x; dd < D; dd += kDecThreads) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      if (pm[s] == -INFINITY) continue;
      a += part_acc[(rowh * n_splits + s) * D + dd] * expf(pm[s] - M);
    }
    store_f(o + bb * osb + hh * osh + dd, a * inv);
  }
}

// bf16 on the tensor cores. At D 80 and 128 the kernel takes more than the
// 48 KB of shared memory a block gets without opting in; it also asks for
// the largest shared-memory carveout, so that three blocks fit. Both are set
// before every launch, so they hold on whichever device is current.
template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, int b, int h,
                   int kvh, int sq, int skv, const long long* st, float scale,
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
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the CUDA cores (flash_fwd_kernel), bf16 on the tensor cores
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int b, int h,
               int kvh, int sq, int skv, const long long* st, float scale,
               int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_fwd_mma<D>(q, k, v, o, b, h, kvh, sq, skv, st, scale, causal, window, stream);
  } else {
    dim3 grid((sq + kBQ - 1) / kBQ, h, b);
    flash_fwd_kernel<T, D><<<grid, kFwdThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), h, kvh, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_fwd_d(int d, const void* q, const void* k, const void* v, void* o, int b,
                 int h, int kvh, int sq, int skv, const long long* st, float scale,
                 int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_fwd<T, 16>(q, k, v, o, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 32: return launch_fwd<T, 32>(q, k, v, o, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 64: return launch_fwd<T, 64>(q, k, v, o, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 80: return launch_fwd<T, 80>(q, k, v, o, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    case 128: return launch_fwd<T, 128>(q, k, v, o, b, h, kvh, sq, skv, st, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TKV>
int launch_decode(const void* q, const void* k, const void* v, const int* lengths,
                  void* o, float* part_m, float* part_l, float* part_acc, int b,
                  int h, int kvh, int S, int d, int split_len, int n_splits,
                  const long long* st, float scale, cudaStream_t stream) {
  // g <= 8 and d <= 128 (checked by the wrapper) keep this within the 48 KB
  // a block may take without opting in
  const size_t smem = sizeof(float) * decode_smem_floats(h / kvh, d);
  flash_decode_split_kernel<TQ, TKV><<<dim3(n_splits, kvh, b), kDecThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      lengths, part_m, part_l, part_acc, h, kvh, S, d, split_len, n_splits,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<TQ><<<dim3(h, b), kDecThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<TQ*>(o), h, d, n_splits, st[8], st[9]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_fwd_kernel), 1 = bfloat16 (flash_fwd_mma_kernel).
// strides (in elements), 12 values: q (b, h, s), k (b, kvh, s), v (b, kvh, s),
// o (b, h, s); the head dim is contiguous in all four. In bf16 every pointer
// is 16-byte aligned and every stride a multiple of 8 (the wrapper checks).
int flash_attention_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                        void* o, int b, int h, int kvh, int sq, int skv,
                        const long long* strides, float scale, int causal, int window,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_d<float>(d, q, k, v, o, b, h, kvh, sq, skv, strides, scale, causal, window, st);
  if (dtype == 1)
    return launch_fwd_d<__nv_bfloat16>(d, q, k, v, o, b, h, kvh, sq, skv, strides, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_dtype / kv_dtype as above (the output takes q's): the cache is bf16 even
// when the model computes in fp32, and bf16 -> fp32 is exact, as the JAX model's
// read of the cache as its compute dtype. strides (in elements), 10 values:
// q (b, h), k (b, kvh, s), v (b, kvh, s), o (b, h).
// Scratch: part_m, part_l [b*h*n_splits]; part_acc [b*h*n_splits*d].
int flash_decode_fwd(int q_dtype, int kv_dtype, int d, const void* q, const void* k,
                     const void* v,
                     const int* lengths, void* o, float* part_m, float* part_l,
                     float* part_acc, int b, int h, int kvh, int S, int split_len,
                     int n_splits, const long long* strides, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_decode<float, float>(q, k, v, lengths, o, part_m, part_l, part_acc, b, h,
                                       kvh, S, d, split_len, n_splits, strides, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, k, v, lengths, o, part_m, part_l,
                                                       part_acc, b, h, kvh, S, d, split_len,
                                                       n_splits, strides, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_decode<float, __nv_bfloat16>(q, k, v, lengths, o, part_m, part_l, part_acc,
                                               b, h, kvh, S, d, split_len, n_splits, strides,
                                               scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
