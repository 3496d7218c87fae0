// Mamba2's depthwise causal conv and its SiLU, forward and backward, for
// Hopper (sm_90a); bf16 or fp32 in and out, fp32 arithmetic.
//
// Replaces no TPU kernel. The JAX package's conv is plain jnp
// (src/repro/models/mamba2.py, `_conv1d`: K shifted products, their sum,
// the bias, silu), which XLA fuses into one loop on a TPU; in eager PyTorch
// the same arithmetic (kernels/causal_conv.py::ref_causal_conv) is a dozen
// passes over [b, s, c] and autograd's backward about as many again. Per
// channel c and position t, with K = 4 taps w [K, c] and a bias [c]:
//
//   pre[t] = bias + sum_{i < K} w[i] u[t - K + 1 + i]
//   y[t]   = silu(pre[t])
//
// u[t] for t < 0 is halo[t + K - 1] where a halo [b, K - 1, c] is given
// (the positions before a rank's block of the sequence), else zero.
//
// What bounds it on an H100: bytes. The forward reads u once and writes y
// once: at [2, 4096, 5376] bf16, 2 x 88.1 MB, 0.0526 ms at 3.35 TB/s. The
// backward reads u and gy and writes gu (0.079 ms there), plus the taps'
// and the bias's per-run partial sums (3.4 MB of fp32 at that shape).
// What the design does about it:
//
//  - a thread owns V consecutive channels (one 8-byte word of a row: 4 bf16
//    or 2 fp32) and a run of positions of one sequence (64 forward, 256
//    backward); kThreads threads of a block sit side by side along the
//    channels; the grid is (channel words / kThreads, s / run, b);
//  - the K - 1 rows before the current one stay in registers, so each row
//    of u is read from device memory once, plus K - 1 rows before each run
//    (and, in the backward, K - 1 after it);
//  - rows are loaded in batches, the next batch issued before the current
//    one is used, so each thread keeps several loads in flight; a run that
//    ends before s tests no position;
//  - the taps and the bias sit in fp32 registers; the sum and SiLU are
//    taken in fp32 and y rounded once (the plain version rounds each tap's
//    product and partial sum in the input type);
//  - u and gy are read through their batch and row strides (the channel
//    stride is one), so the conv reads its input where in_proj wrote it;
//  - kVec = false, where a pointer, a stride or c is not a multiple of a
//    word: the same kernel with element loads, each channel masked.
//
// At [2, 4096, 5376] bf16 on an H100 the forward takes 0.072 ms, 1.4x its
// bound (a plain copy of the same bytes through the same loads takes
// 0.068), the backward 0.130 ms, 1.65x its bound (PERF.md).
//
// The backward (causal_conv_bwd_kernel, tiled the same way) recomputes pre in
// fp32 over its run and K - 1 positions after it, and forms
//
//   gpre[t] = gy[t] silu'(pre[t])
//   gu[p]   = sum_i w[i] gpre[p + K - 1 - i]
//   gw[i]   = sum_t gpre[t] u[t - K + 1 + i],   gb = sum_t gpre[t]
//
// gu (and the halo's gradient, from the first run) are written in the input
// type; each run's gw and gb go to a partial [b * runs, K + 1, c] in fp32,
// which causal_conv_reduce_kernel sums in a fixed order: no atomics, so two
// calls agree bit for bit.
//
// Plain C interface for ctypes. The kernels launch on the caller's stream,
// allocate nothing and each entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 4;          // taps (models/mamba2.py's CONV_K)
// A thread's channels take kBytes of a row, its run kRun positions, loaded
// kRows at a time (the next batch loads while one is used). Wider words
// hold more state a thread than the registers keep at full occupancy; a
// longer backward run recomputes fewer positions around it and writes
// fewer partials, until too few blocks fill the card (PERF.md times the
// alternatives).
constexpr int kFwdBytes = 8;   // 4 bf16 or 2 fp32
constexpr int kBwdBytes = 8;
constexpr int kFwdRun = 64;
constexpr int kBwdRun = 256;
constexpr int kFwdRows = 8;    // divides kFwdRun
constexpr int kBwdRows = 4;    // divides kBwdRun
constexpr int kThreads = 128;  // threads a block, along the channels
constexpr int kReduceThreads = 256;
constexpr int kMaxGrid = 65535;  // blocks along a grid's second and third axes

template <typename T, int kBytes>
constexpr int kLanes = kBytes / static_cast<int>(sizeof(T));

template <int kBytes>
struct Word;
template <>
struct Word<8> { using type = uint2; };

// one row's V channels as loaded: one 8-byte word
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// SiLU and its slope in fp32 with the fast exponential and division (a few
// ulps of fp32, far below the bf16 rounding that follows; at x < -88 the
// quotient is 0, as silu(x) rounds to there)
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }
__device__ __forceinline__ float dsilu(float x) {
  const float sig = sigmoid(x);
  return sig * (1.f + x * (1.f - sig));
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> zeros() {
  using W = typename Word<sizeof(T) * V>::type;
  Pack<T, V> p;
  *reinterpret_cast<W*>(p.e) = W{};
  return p;
}

template <typename T, int V, bool kVec>
__device__ __forceinline__ Pack<T, V> load(const T* row, int c0, int c) {
  using W = typename Word<sizeof(T) * V>::type;
  Pack<T, V> p = zeros<T, V>();
  if constexpr (kVec) {
    *reinterpret_cast<W*>(p.e) = __ldg(reinterpret_cast<const W*>(row + c0));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (c0 + j < c) p.e[j] = row[c0 + j];
  }
  return p;
}

// u at position t of this sequence: the halo's row t + K - 1 before the
// sequence (zero without a halo), zero from s on
template <typename T, int V, bool kVec>
__device__ __forceinline__ Pack<T, V> row_at(const T* u, long long us, const T* halo,
                                             long long hs, int t, int s, int c0, int c) {
  if (t >= s) return zeros<T, V>();
  if (t >= 0) return load<T, V, kVec>(u + t * us, c0, c);
  if (halo == nullptr) return zeros<T, V>();
  return load<T, V, kVec>(halo + (t + kK - 1) * hs, c0, c);
}

// R rows from position tb on; with kEdge, zero from s on (a run that
// reaches the end of the sequence), else no test at all
template <typename T, int V, bool kVec, bool kEdge, int R>
__device__ __forceinline__ void load_rows(Pack<T, V> (&rows)[R], const T* u, long long us,
                                          int tb, int s, int c0, int c) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    rows[r] = (!kEdge || tb + r < s) ? load<T, V, kVec>(u + (tb + r) * us, c0, c)
                                     : zeros<T, V>();
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Pack<T, V>& p, float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f(p.e[j]);
}

template <typename T, int V, bool kVec>
__device__ __forceinline__ void store(T* row, int c0, int c, const float (&v)[V]) {
  using W = typename Word<sizeof(T) * V>::type;
  Pack<T, V> p;
#pragma unroll
  for (int j = 0; j < V; ++j) p.e[j] = from_f<T>(v[j]);
  if constexpr (kVec) {
    *reinterpret_cast<W*>(row + c0) = *reinterpret_cast<const W*>(p.e);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (c0 + j < c) row[c0 + j] = p.e[j];
  }
}

// one run's partial sum of V channels, in fp32
template <bool kVec, int V>
__device__ __forceinline__ void put(float* row, int c0, int c, const float (&v)[V]) {
  if constexpr (kVec && V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(row + c0 + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (kVec && V % 2 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 2)
      *reinterpret_cast<float2*>(row + c0 + j) = make_float2(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (c0 + j < c) row[c0 + j] = v[j];
  }
}

// the taps and the bias of channels c0 .. c0 + V - 1 (zero past c)
template <typename T, int V>
__device__ __forceinline__ void load_taps(const T* w, const T* bias, int c0, int c,
                                          float (&wr)[kK][V], float (&br)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool in = c0 + j < c;
#pragma unroll
    for (int i = 0; i < kK; ++i) wr[i][j] = in ? to_f(w[i * c + c0 + j]) : 0.f;
    br[j] = in ? to_f(bias[c0 + j]) : 0.f;
  }
}

// pre[t] from the K - 1 rows before t (win) and row t (x)
template <int V>
__device__ __forceinline__ float pre_at(const float (&wr)[kK][V], const float (&br)[V],
                                        const float (&win)[kK - 1][V], const float (&x)[V],
                                        int j) {
  float a = br[j];
#pragma unroll
  for (int i = 0; i < kK - 1; ++i) a = fmaf(wr[i][j], win[i][j], a);
  return fmaf(wr[kK - 1][j], x[j], a);
}

// the window of the K - 1 values before the next position
template <int V>
__device__ __forceinline__ void shift(float (&win)[kK - 1][V], const float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int i = 0; i < kK - 2; ++i) win[i][j] = win[i + 1][j];
    win[kK - 2][j] = x[j];
  }
}

// The forward over positions [t0, tend) of one sequence, win holding u at
// t0 - K + 1 .. t0 - 1; y [s, c] contiguous.
template <typename T, int V, bool kVec, bool kEdge>
__device__ __forceinline__ void fwd_run(const T* u, long long us, T* y, int t0, int tend, int s,
                                        int c0, int c, const float (&wr)[kK][V],
                                        const float (&br)[V], float (&win)[kK - 1][V]) {
  Pack<T, V> cur[kFwdRows], nxt[kFwdRows];
  load_rows<T, V, kVec, kEdge>(cur, u, us, t0, s, c0, c);
  for (int tb = t0;; tb += kFwdRows) {
    const bool more = tb + kFwdRows < tend;
    if (more) load_rows<T, V, kVec, kEdge>(nxt, u, us, tb + kFwdRows, s, c0, c);
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      float x[V], out[V];
      unpack(cur[r], x);
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = silu(pre_at(wr, br, win, x, j));
      if (!kEdge || tb + r < tend)
        store<T, V, kVec>(y + static_cast<long long>(tb + r) * c, c0, c, out);
      shift(win, x);
    }
    if (!more) break;
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) cur[r] = nxt[r];
  }
}

// u, halo: [b, s, c] and [b, K - 1, c] through their strides (channel stride
// 1); y [b, s, c] contiguous
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    causal_conv_fwd_kernel(const T* __restrict__ u, const T* __restrict__ w,
                           const T* __restrict__ bias, const T* __restrict__ halo,
                           T* __restrict__ y, int s, int c, long long u_b, long long u_s,
                           long long h_b, long long h_s) {
  constexpr int V = kLanes<T, kFwdBytes>;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= c) return;
  const int t0 = blockIdx.y * kFwdRun;
  const int tend = min(t0 + kFwdRun, s);
  u += blockIdx.z * u_b;
  if (halo != nullptr) halo += blockIdx.z * h_b;
  y += static_cast<long long>(blockIdx.z) * s * c;
  float wr[kK][V], br[V];
  load_taps(w, bias, c0, c, wr, br);
  float win[kK - 1][V];  // u at t - K + 1 .. t - 1
#pragma unroll
  for (int i = 0; i < kK - 1; ++i)
    unpack(row_at<T, V, kVec>(u, u_s, halo, h_s, t0 - (kK - 1) + i, s, c0, c), win[i]);
  if (t0 + kFwdRun <= s)
    fwd_run<T, V, kVec, false>(u, u_s, y, t0, tend, s, c0, c, wr, br, win);
  else
    fwd_run<T, V, kVec, true>(u, u_s, y, t0, tend, s, c0, c, wr, br, win);
}

// One thread of the backward: the taps and bias, the K - 1 values of u and
// of gpre before the current position, and the run's sums of gw and gb.
template <int V>
struct BwdState {
  float wr[kK][V], br[V];
  float xw[kK - 1][V], gw[kK - 1][V];
  float sw[kK][V], sb[V];
};

// One position t of the backward: gpre[t] from u[t] (x) and gy[t] (g), added
// to the run's sums when `sums`; the input gradient at p = t - K + 1 written
// when first <= p < tend (gu's row p, or the halo's row p + K - 1); then the
// windows move on.
template <typename T, int V, bool kVec>
__device__ __forceinline__ void bwd_step(int t, const float (&x)[V], const float (&g)[V],
                                         bool sums, int first, int tend, int c0, int c,
                                         BwdState<V>& st, T* gu, T* ghalo) {
  float gp[V], gx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gp[j] = g[j] * dsilu(pre_at(st.wr, st.br, st.xw, x, j));
    if (sums) {
      st.sb[j] += gp[j];
#pragma unroll
      for (int i = 0; i < kK - 1; ++i) st.sw[i][j] = fmaf(gp[j], st.xw[i][j], st.sw[i][j]);
      st.sw[kK - 1][j] = fmaf(gp[j], x[j], st.sw[kK - 1][j]);
    }
    // gw[i] holds gpre[t - K + 1 + i]: tap K - 1 - i meets it at p = t - K + 1
    float a = st.wr[0][j] * gp[j];
#pragma unroll
    for (int i = 0; i < kK - 1; ++i) a = fmaf(st.wr[kK - 1 - i][j], st.gw[i][j], a);
    gx[j] = a;
  }
  shift(st.xw, x);
  shift(st.gw, gp);
  const int p = t - (kK - 1);
  if (p >= first && p < tend) {
    if (p >= 0)
      store<T, V, kVec>(gu + static_cast<long long>(p) * c, c0, c, gx);
    else
      store<T, V, kVec>(ghalo + static_cast<long long>(p + kK - 1) * c, c0, c, gx);
  }
}

// The backward over the run [t0, tend) of one sequence (the positions whose
// gpre enters the run's sums), its rows of u and gy kBwdRows at a time, the next
// batch loading while one is used.
template <typename T, int V, bool kVec, bool kEdge>
__device__ __forceinline__ void bwd_run(const T* u, long long us, const T* gy, long long gs,
                                        int t0, int tend, int first, int s, int c0, int c,
                                        BwdState<V>& st, T* gu, T* ghalo) {
  Pack<T, V> xc[kBwdRows], gc[kBwdRows], xn[kBwdRows], gn[kBwdRows];
  load_rows<T, V, kVec, kEdge>(xc, u, us, t0, s, c0, c);
  load_rows<T, V, kVec, kEdge>(gc, gy, gs, t0, s, c0, c);
  for (int tb = t0;; tb += kBwdRows) {
    const bool more = tb + kBwdRows < tend;
    if (more) {
      load_rows<T, V, kVec, kEdge>(xn, u, us, tb + kBwdRows, s, c0, c);
      load_rows<T, V, kVec, kEdge>(gn, gy, gs, tb + kBwdRows, s, c0, c);
    }
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      float x[V], g[V];
      unpack(xc[r], x);
      unpack(gc[r], g);
      bwd_step<T, V, kVec>(tb + r, x, g, !kEdge || tb + r < tend, first, tend, c0, c, st, gu,
                           ghalo);
    }
    if (!more) break;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      xc[r] = xn[r];
      gc[r] = gn[r];
    }
  }
}

// gy [b, s, c] through its strides; gu [b, s, c], ghalo [b, K - 1, c] (with
// a halo) and part [b, runs, K + 1, c] contiguous
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    causal_conv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ w,
                           const T* __restrict__ bias, const T* __restrict__ halo,
                           const T* __restrict__ gy, T* __restrict__ gu, T* __restrict__ ghalo,
                           float* __restrict__ part, int s, int c, long long u_b, long long u_s,
                           long long h_b, long long h_s, long long g_b, long long g_s) {
  constexpr int V = kLanes<T, kBwdBytes>;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= c) return;
  const int t0 = blockIdx.y * kBwdRun;
  const int tend = min(t0 + kBwdRun, s);
  // the first run also writes the halo's gradient (positions -K + 1 .. -1)
  const int first = (t0 == 0 && halo != nullptr) ? -(kK - 1) : t0;
  u += blockIdx.z * u_b;
  gy += blockIdx.z * g_b;
  if (halo != nullptr) {
    halo += blockIdx.z * h_b;
    ghalo += static_cast<long long>(blockIdx.z) * (kK - 1) * c;
  }
  gu += static_cast<long long>(blockIdx.z) * s * c;
  BwdState<V> st;
  load_taps(w, bias, c0, c, st.wr, st.br);
#pragma unroll
  for (int i = 0; i < kK - 1; ++i)
    unpack(row_at<T, V, kVec>(u, u_s, halo, h_s, t0 - (kK - 1) + i, s, c0, c), st.xw[i]);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    st.sb[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kK - 1; ++i) st.gw[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kK; ++i) st.sw[i][j] = 0.f;
  }
  if (t0 + kBwdRun <= s)
    bwd_run<T, V, kVec, false>(u, u_s, gy, g_s, t0, tend, first, s, c0, c, st, gu, ghalo);
  else
    bwd_run<T, V, kVec, true>(u, u_s, gy, g_s, t0, tend, first, s, c0, c, st, gu, ghalo);
  // K - 1 positions after those the loop took (at least up to tend + K - 2):
  // their gpre reaches the run's last inputs (zero from s on)
  const int after = t0 + (tend - t0 + kBwdRows - 1) / kBwdRows * kBwdRows;
#pragma unroll
  for (int r = 0; r < kK - 1; ++r) {
    float x[V], g[V];
    unpack(row_at<T, V, kVec>(u, u_s, nullptr, 0, after + r, s, c0, c), x);
    unpack(row_at<T, V, kVec>(gy, g_s, nullptr, 0, after + r, s, c0, c), g);
    bwd_step<T, V, kVec>(after + r, x, g, false, first, tend, c0, c, st, gu, ghalo);
  }
  float* pp = part + (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * (kK + 1) * c;
#pragma unroll
  for (int i = 0; i < kK; ++i) put<kVec>(pp + static_cast<long long>(i) * c, c0, c, st.sw[i]);
  put<kVec>(pp + static_cast<long long>(kK) * c, c0, c, st.sb);
}

// gw [K, c] and gb [c]: the n runs' partials [n, K + 1, c] summed in order
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    causal_conv_reduce_kernel(const float* __restrict__ part, T* __restrict__ gw,
                              T* __restrict__ gb, int n, int c) {
  const long long per = static_cast<long long>(kK + 1) * c;
  const long long idx = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (idx >= per) return;
  float a = 0.f;
#pragma unroll 8
  for (int r = 0; r < n; ++r) a += part[r * per + idx];
  if (idx < static_cast<long long>(kK) * c)
    gw[idx] = from_f<T>(a);
  else
    gb[idx - static_cast<long long>(kK) * c] = from_f<T>(a);
}

// whether p and the strides s0, s1 allow words of V elements of T
template <typename T>
bool vec_ok(const void* p, long long s0, long long s1, int V) {
  return reinterpret_cast<uintptr_t>(p) % (sizeof(T) * V) == 0 && s0 % V == 0 && s1 % V == 0;
}

template <typename T, bool kVec>
cudaError_t launch_fwd(const void* u, const void* w, const void* bias, const void* halo, void* y,
                       int b, int s, int c, long long u_b, long long u_s, long long h_b,
                       long long h_s, cudaStream_t strm) {
  constexpr int V = kLanes<T, kFwdBytes>;
  const dim3 grid((c + V * kThreads - 1) / (V * kThreads), (s + kFwdRun - 1) / kFwdRun, b);
  causal_conv_fwd_kernel<T, kVec><<<grid, kThreads, 0, strm>>>(
      static_cast<const T*>(u), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(halo), static_cast<T*>(y), s, c, u_b, u_s, h_b, h_s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* u, const void* w, const void* bias, const void* halo, void* y, int b,
                int s, int c, long long u_b, long long u_s, long long h_b, long long h_s,
                cudaStream_t strm) {
  constexpr int V = kLanes<T, kFwdBytes>;
  const bool vec = c % V == 0 && vec_ok<T>(u, u_b, u_s, V) && vec_ok<T>(y, 0, 0, V) &&
                   (halo == nullptr || vec_ok<T>(halo, h_b, h_s, V));
  return vec ? launch_fwd<T, true>(u, w, bias, halo, y, b, s, c, u_b, u_s, h_b, h_s, strm)
             : launch_fwd<T, false>(u, w, bias, halo, y, b, s, c, u_b, u_s, h_b, h_s, strm);
}

template <typename T, bool kVec>
cudaError_t launch_bwd(const void* u, const void* w, const void* bias, const void* halo,
                       const void* gy, void* gu, void* ghalo, float* part, int b, int s, int c,
                       const long long* st, cudaStream_t strm) {
  constexpr int V = kLanes<T, kBwdBytes>;
  const dim3 grid((c + V * kThreads - 1) / (V * kThreads), (s + kBwdRun - 1) / kBwdRun, b);
  causal_conv_bwd_kernel<T, kVec><<<grid, kThreads, 0, strm>>>(
      static_cast<const T*>(u), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(halo), static_cast<const T*>(gy), static_cast<T*>(gu),
      static_cast<T*>(ghalo), part, s, c, st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* u, const void* w, const void* bias, const void* halo, const void* gy,
                void* gu, void* gw, void* gb, void* ghalo, float* part, int b, int s, int c,
                const long long* st, cudaStream_t strm) {
  constexpr int V = kLanes<T, kBwdBytes>;
  const bool vec = c % V == 0 && vec_ok<T>(u, st[0], st[1], V) &&
                   vec_ok<T>(gy, st[4], st[5], V) && vec_ok<T>(gu, 0, 0, V) &&
                   (halo == nullptr ||
                    (vec_ok<T>(halo, st[2], st[3], V) && vec_ok<T>(ghalo, 0, 0, V)));
  cudaError_t err = vec ? launch_bwd<T, true>(u, w, bias, halo, gy, gu, ghalo, part, b, s, c, st,
                                              strm)
                        : launch_bwd<T, false>(u, w, bias, halo, gy, gu, ghalo, part, b, s, c,
                                               st, strm);
  if (err != cudaSuccess) return err;
  const long long per = static_cast<long long>(kK + 1) * c;
  causal_conv_reduce_kernel<T>
      <<<static_cast<unsigned>((per + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
         strm>>>(part, static_cast<T*>(gw), static_cast<T*>(gb), b * ((s + kBwdRun - 1) / kBwdRun),
                 c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the backward's partial sums: [b, ceil(s / kBwdRun), K + 1, c].
long long causal_conv_partial_floats(int b, int s, int c) {
  return static_cast<long long>(b) * ((s + kBwdRun - 1) / kBwdRun) * (kK + 1) * c;
}

// y [b, s, c] = silu(causal conv(u) + bias), contiguous. u [b, s, c] and
// the halo [b, K - 1, c] (null: zeros) are read through their strides (in
// elements: u_b, u_s, h_b, h_s; channel stride 1); w [K, c] and bias [c]
// contiguous; every tensor bf16 (bf16 != 0) or fp32. b, s, c >= 1;
// cudaErrorInvalidConfiguration, nothing launched, where b or the runs of
// s exceed the grid.
int causal_conv_fwd(const void* u, const void* w, const void* bias, const void* halo, void* y,
                    int b, int s, int c, long long u_b, long long u_s, long long h_b,
                    long long h_s, int bf16, void* stream) {
  if (b > kMaxGrid || (s + kFwdRun - 1) / kFwdRun > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? fwd<__nv_bfloat16>(u, w, bias, halo, y, b, s, c, u_b, u_s, h_b, h_s, strm)
           : fwd<float>(u, w, bias, halo, y, b, s, c, u_b, u_s, h_b, h_s, strm));
}

// The gradients of causal_conv_fwd's inputs from gy [b, s, c] (strides
// st[4], st[5]): gu [b, s, c], gw [K, c], gb [c] and, with a halo, ghalo
// [b, K - 1, c], all contiguous, in the inputs' type; st = u_b, u_s, h_b,
// h_s, g_b, g_s; part holds causal_conv_partial_floats() floats, 16-byte
// aligned. cudaErrorInvalidConfiguration, nothing launched, where b or the
// runs of s exceed the grid.
int causal_conv_bwd(const void* u, const void* w, const void* bias, const void* halo,
                    const void* gy, void* gu, void* gw, void* gb, void* ghalo, void* part, int b,
                    int s, int c, const long long* st, int bf16, void* stream) {
  if (b > kMaxGrid || (s + kBwdRun - 1) / kBwdRun > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  float* fp = static_cast<float*>(part);
  return static_cast<int>(
      bf16 ? bwd<__nv_bfloat16>(u, w, bias, halo, gy, gu, gw, gb, ghalo, fp, b, s, c, st, strm)
           : bwd<float>(u, w, bias, halo, gy, gu, gw, gb, ghalo, fp, b, s, c, st, strm));
}

}  // extern "C"
