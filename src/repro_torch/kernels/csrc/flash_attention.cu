// Flash attention (prefill) and split-KV flash decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel          <- flash_attention / _flash_kernel
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
// (13 us); longer prompts make it bound by operations. This first version
// stays on the CUDA cores (fp32 FMAs, no wgmma/TMA), where the operations
// dominate (12.9 GFLOP at 67 TFLOP/s is 0.19 ms). What it does about that:
// it skips whole k-tiles past the causal diagonal and before the window (the
// Pallas grid visits and masks every block, twice the work at sq == skv),
// and it loads each K/V tile once into shared memory for all 64 query rows
// of the block, so device memory is read about sq/64 times less than the
// FLOPs would need. Tensor cores are later work.
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

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int b, int h,
               int kvh, int sq, int skv, const long long* st, float scale,
               int causal, int window, cudaStream_t stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_kernel<T, D><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, kvh, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
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

// dtype: 0 = float32, 1 = bfloat16. strides (in elements), 12 values:
// q (b, h, s), k (b, kvh, s), v (b, kvh, s), o (b, h, s); the head dim is
// contiguous in all four.
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
