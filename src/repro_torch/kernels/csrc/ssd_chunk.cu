// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a), fp32 throughout.
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
// What bounds it on an H100: operations. At the mamba2-2.7b serving shape
// (b 8, s 512, Q 256, H 80, P 64, N 128) the causal half of the three
// products is 2*Q(Q+1)/2*(N+P) + 2*Q*N*P = 16.8 MFLOP per block, 21.5 GFLOP
// in all: 0.32 ms at the 67 TFLOP/s of fp32 outside the tensor cores, against
// 0.064 ms for its 215 MB of inputs and outputs. The contract is fp32 (the
// Pallas body and the model keep it so), so no TF32 or bf16 tensor cores.
// What the design does about it:
//
//  - one block per (head, chunk, batch), as the Pallas grid; heads vary
//    fastest, so the blocks that read one chunk's B and C (shared by the H/G
//    heads of a group) run together and find them in L2;
//  - the chunk is cut into 64-row tiles; a (query tile, key tile) pair above
//    the diagonal is never visited, and exp is taken only where j <= i (above
//    it seg_i - seg_j > 0 and exp may overflow);
//  - each thread computes a 4x4 register tile of C B^T and of y, reading
//    float4 rows of C^T and B^T in shared memory (8 floats per 16 FMAs); the
//    masked, decayed scores go through shared memory once into the second
//    product; the chunk state is summed in the last query tile's pass, which
//    visits every key tile, so B and dt*x are loaded once for both;
//  - seg is summed sequentially by one thread, with dt*A rounded before each
//    add: the same fp32 operations in the same order as torch.cumsum along
//    the sequence, so exp(seg_i - seg_j) matches the plain version's;
//  - x, dt, B and C are read through their strides (unit stride only on the
//    last axis), so views into the model's projections need no copy.
//
// 101 KB of dynamic shared memory per block (opted in above the default
// 48 KB), 256 threads, two blocks per SM.
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows i, and key rows j, per tile
constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kSmemFloats = 3 * kMaxQ + 2 * kMaxN * kTile + kTile * kMaxP + kTile * kTile;

struct Strides {
  long long xb, xs, xh;   // x  [b, s, H, P]
  long long db, ds, dh;   // dt [b, s, H]
  long long bb, bs, bg;   // B  [b, s, G, N]
  long long cb, cs, cg;   // C  [b, s, G, N]
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay,
                 int s, int H, int P, int G, int N, int Q, Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* sDt = smem;                    // [kMaxQ]  dt of the chunk
  float* sSeg = sDt + kMaxQ;            // [kMaxQ]  cumsum(dt * A)
  float* sW = sSeg + kMaxQ;             // [kMaxQ]  exp(total - seg)
  float* sCt = sW + kMaxQ;              // [kMaxN][kTile]  C of the query tile, transposed
  float* sBt = sCt + kMaxN * kTile;     // [kMaxN][kTile]  B of the key tile, transposed
  float* sX = sBt + kMaxN * kTile;      // [kTile][kMaxP]  dt * x of the key tile
  float* sS = sX + kTile * kMaxP;       // [kTile j][kTile i]  masked, decayed scores

  const int h = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long t0 = static_cast<long long>(c) * Q;    // the chunk's first position
  const float* xp = x + bb * st.xb + t0 * st.xs + h * st.xh;
  const float* dp = dt + bb * st.db + t0 * st.ds + h * st.dh;
  const float* bp = B + bb * st.bb + t0 * st.bs + g * st.bg;
  const float* cp = C + bb * st.cb + t0 * st.cs + g * st.cg;
  const float a_h = A[h];

  for (int i = tid; i < Q; i += kThreads) sDt[i] = dp[i * st.ds];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = 0; i < Q; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(sDt[i], a_h));     // no FMA contraction
      sSeg[i] = acc;
    }
    decay[(static_cast<long long>(bb) * nc + c) * H + h] = acc;
  }
  __syncthreads();
  const float total = sSeg[Q - 1];
  for (int i = tid; i < Q; i += kThreads) sW[i] = expf(total - sSeg[i]);

  const int n_tiles = (Q + kTile - 1) / kTile;
  float sacc_state[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) sacc_state[r][q] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    const bool last = it == n_tiles - 1;
    float yacc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[r][q] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      const int jn = min(kTile, Q - j0);
      __syncthreads();   // every reader of the previous tiles is done
      if (jt == 0) {
        for (int idx = tid; idx < N * kTile; idx += kThreads) {
          const int i = idx % kTile, n = idx / kTile;
          sCt[idx] = i0 + i < Q ? cp[(i0 + i) * st.cs + n] : 0.f;
        }
      }
      for (int idx = tid; idx < N * kTile; idx += kThreads) {
        const int j = idx % kTile, n = idx / kTile;
        sBt[idx] = j < jn ? bp[(j0 + j) * st.bs + n] : 0.f;
      }
      for (int idx = tid; idx < kTile * kMaxP; idx += kThreads) {
        const int j = idx / kMaxP, p = idx % kMaxP;
        sX[idx] = j < jn && p < P ? __fmul_rn(xp[(j0 + j) * st.xs + p], sDt[j0 + j]) : 0.f;
      }
      __syncthreads();

      // scores = C B^T on this thread's 4x4 tile (rows ty*4.., keys tx*4..)
      float sc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = ld4(sCt + n * kTile + ty * 4);
        const float4 bv = ld4(sBt + n * kTile + tx * 4);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(cr[r], br[q], sc[r][q]);
      }
      // L = exp(seg_i - seg_j) where j <= i, else 0; stored transposed [j][i]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx * 4 + q;
        float o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          o[r] = j <= i && i < Q ? sc[r][q] * expf(sSeg[i] - sSeg[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(sS + (tx * 4 + q) * kTile + ty * 4) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
      __syncthreads();

      // y[i, p] += sum_j S[i, j] (dt x)[j, p] on rows ty*4.., columns tx*4..
      for (int j = 0; j < jn; ++j) {
        const float4 sv = ld4(sS + j * kTile + ty * 4);
        const float4 xv = ld4(sX + j * kMaxP + tx * 4);
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] = fmaf(sr[r], xr[q], yacc[r][q]);
      }
      // state[n, p] += B[j, n] exp(total - seg_j) (dt x)[j, p], on states
      // ty*8.. and columns tx*4.., in the pass that visits every key tile
      if (last) {
        for (int j = 0; j < jn; ++j) {
          const float w = sW[j0 + j];
          const float4 xv = ld4(sX + j * kMaxP + tx * 4);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int n = ty * 8 + r;
            const float bw = n < N ? sBt[n * kTile + j] * w : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) sacc_state[r][q] = fmaf(bw, xr[q], sacc_state[r][q]);
          }
        }
      }
    }

    if (tx * 4 < P) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i < Q)
          *reinterpret_cast<float4*>(y + ((bb * static_cast<long long>(s) + t0 + i) * H + h) * P +
                                     tx * 4) =
              make_float4(yacc[r][0], yacc[r][1], yacc[r][2], yacc[r][3]);
      }
    }
  }

  if (tx * 4 < P) {
    float* out = states + ((static_cast<long long>(bb) * nc + c) * H + h) * N * P + tx * 4;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = ty * 8 + r;
      if (n < N)
        *reinterpret_cast<float4*>(out + static_cast<long long>(n) * P) =
            make_float4(sacc_state[r][0], sacc_state[r][1], sacc_state[r][2], sacc_state[r][3]);
    }
  }
}

}  // namespace

extern "C" {

// All tensors fp32. y [b, s, H, P], states [b, s/Q, H, N, P] and decay
// [b, s/Q, H] are contiguous outputs; A [H] contiguous. strides (in elements),
// 12 values: x (b, s, h), dt (b, s, h), B (b, s, g), C (b, s, g); the last
// axis of x, B and C is contiguous. The wrapper checks Q <= 256, N <= 128,
// P <= 64 with P % 4 == 0, G | H and Q | s.
int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* states, void* decay, int b, int s, int H, int P, int G,
                  int N, int Q, const long long* strides, void* stream) {
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const dim3 grid(H, s / Q, b);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), s, H, P, G, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
