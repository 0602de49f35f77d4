// Flash attention, backward (causal or not, grouped-query), for Hopper
// (sm_90a); plain C interface for ctypes.
//
// The gradient of the function flash_attention.cu computes.  The Pallas
// kernel kernels/flash_attention/flash_attention.py::flash_attention has
// no backward (pallas_call has no transpose); this kernel follows the
// decomposition ref.attention_bwd_ref writes out in plain PyTorch.  With
// the scores s = (q * scale) . k, the forward's row log-sum-exp lse and the
// upstream gradient dO:
//     P = exp(s - lse),  D = rowsum(dO o O),  dP = dO V^T,
//     dS = P o (dP - D),  dV = P^T dO,  dK = dS^T (Q * scale),
//     dQ = dS K * scale,
// where the causal mask (k <= q + Sk - Sq) and the ragged tiles give P = 0.
//
// Three kernels, each deterministic (no atomics):
//   1. dot: D = rowsum(dO o O) in fp32, one warp per (batch, row, head);
//   2. dkv: one block per (batch, KV head, 64-row K tile).  It keeps its K
//      and V tiles in shared memory and loops over the G = H / KV query
//      heads of its group and over the query tiles that see its keys,
//      accumulating dK and dV in registers: GQA's sum over the group needs
//      no atomics;
//   3. dq: one block per (batch, head, 64-row Q tile), looping over the K
//      tiles its rows see, as the forward does.
// Both tile kernels recompute S and dP for their (64 x 64) tile with the
// forward's 16 x 16 thread grid (thread (ty, tx) owns rows ty + 16 r and
// columns tx + 16 c), pass P or dS through shared memory to the products
// that contract over the other index, and keep fp32 throughout; the
// gradients are written in the input dtype.  At head size 128 a block needs
// 149 KB of shared memory (four fp32 row tiles and one 64 x 64 tile), so
// it is dynamic, set on every launch.
//
// Bound: operations.  Five products of the unmasked (q, k) pairs (S, dP,
// dV, dK, dQ), 2 hd flops each per pair and head: 85.9 GFLOP at jamba's
// attention shape (B 1, S 2048, 32 heads of 128, causal), against the bf16
// tensor-core rate; these kernels use fp32 FMAs, no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <int HD>
constexpr int bwd_smem_bytes() {
  // four row tiles (BK or BQ x HD+1), one 64 x 64 tile (BQ x BK+1) and two
  // per-row vectors, fp32
  return ((2 * BK + 2 * BQ) * (HD + 1) + BQ * (BK + 1) + 2 * BQ) * 4;
}

template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ out,
                                     const T* __restrict__ dout,
                                     float* __restrict__ D, int rows, int Sq,
                                     int H, int hd) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + (size_t)row * hd;
  const T* g = dout + (size_t)row * hd;
  float s = 0.0f;
  for (int d = lane; d < hd; d += 32) s += to_f32(o[d]) * to_f32(g[d]);
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {  // row = (b * Sq + i) * H + h  ->  D[(b * H + h) * Sq + i]
    const int h = row % H, i = (row / H) % Sq, b = row / (H * Sq);
    D[((size_t)b * H + h) * Sq + i] = s;
  }
}

// Rows r0.. of a (S, heads, hd) tensor's head hh into a BQ x (HD+1) fp32
// tile, times mul; rows past S and columns past hd are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int S, int heads, int hh, int hd,
                                          float mul) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    dst[r * QS + d] = s < S && d < hd
                          ? to_f32(src[((size_t)s * heads + hh) * hd + d]) * mul
                          : 0.0f;
  }
}

// S = sq . sk^T and dP = sdo . sv^T for the thread's 4 x 4 cells, then
// P = exp(S - lse) and dS = P (dP - D) with the masked cells 0
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* sq, const float* sdo, const float* sk, const float* sv,
    const float* slse, const float* sD, int q0, int k0, int Sq, int Sk,
    int off, int causal, float (&p)[RQ][CK], float (&ds)[RQ][CK]) {
  constexpr int QS = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < CK; ++c) sc[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RQ], o[RQ], bk[CK], bv[CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      a[r] = sq[(ty + 16 * r) * QS + d];
      o[r] = sdo[(ty + 16 * r) * QS + d];
    }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      bk[c] = sk[(tx + 16 * c) * QS + d];
      bv[c] = sv[(tx + 16 * c) * QS + d];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        sc[r][c] = fmaf(a[r], bk[c], sc[r][c]);
        dp[r][c] = fmaf(o[r], bv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + ty + 16 * r;
    const float lse = slse[ty + 16 * r], Dr = sD[ty + 16 * r];
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int kj = k0 + tx + 16 * c;
      const bool masked = qi >= Sq || kj >= Sk || (causal && kj > qi + off);
      p[r][c] = masked ? 0.0f : expf(sc[r][c] - lse);
      ds[r][c] = p[r][c] * (dp[r][c] - Dr);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV,
    int hd, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1, PS = BK + 1, NC = HD / 16;
  float* sk = smem;
  float* sv = sk + BK * QS;
  float* sq = sv + BK * QS;
  float* sdo = sq + BQ * QS;
  float* sp = sdo + BQ * QS;
  float* slse = sp + BQ * PS;
  float* sD = slse + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, off = Sk - Sq;

  load_rows<T, HD>(sk, k + (size_t)b * Sk * KV * hd, k0, Sk, KV, kvh, hd,
                   1.0f);
  load_rows<T, HD>(sv, v + (size_t)b * Sk * KV * hd, k0, Sk, KV, kvh, hd,
                   1.0f);
  float dK[RQ][NC], dV[RQ][NC];  // key rows ty + 16 r, columns tx + 16 c
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dK[r][c] = dV[r][c] = 0.0f;

  // query rows i see this tile's keys where i + off >= k0
  const int q_begin = causal ? max(0, k0 - off) / BQ * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = (size_t)b * Sq * H * hd;
    const float* lh = lse + ((size_t)b * H + h) * Sq;
    const float* Dh = D + ((size_t)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's sq, sdo and sp are consumed
      load_rows<T, HD>(sq, q + qoff, q0, Sq, H, h, hd, scale);
      load_rows<T, HD>(sdo, dout + qoff, q0, Sq, H, h, hd, 1.0f);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        slse[tid] = in ? lh[q0 + tid] : 0.0f;
        sD[tid] = in ? Dh[q0 + tid] : 0.0f;
      }
      __syncthreads();
      float p[RQ][CK], ds[RQ][CK];
      tile_p_ds<HD>(sq, sdo, sk, sv, slse, sD, q0, k0, Sq, Sk, off, causal,
                    p, ds);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c)
          sp[(ty + 16 * r) * PS + tx + 16 * c] = p[r][c];
      __syncthreads();
      // dV[j, :] += sum_i P[i, j] dO[i, :]
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pc[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) pc[r] = sp[i * PS + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float o = sdo[i * QS + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RQ; ++r) dV[r][c] = fmaf(pc[r], o, dV[r][c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c)
          sp[(ty + 16 * r) * PS + tx + 16 * c] = ds[r][c];
      __syncthreads();
      // dK[j, :] += sum_i dS[i, j] (q_i * scale)
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float dc[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) dc[r] = sp[i * PS + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float qq = sq[i * QS + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RQ; ++r) dK[r][c] = fmaf(dc[r], qq, dK[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int s = k0 + ty + 16 * r;
    if (s >= Sk) continue;
    const size_t o = (((size_t)b * Sk + s) * KV + kvh) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < hd) {
        store(dk + o + tx + 16 * c, dK[r][c]);
        store(dv + o + tx + 16 * c, dV[r][c]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd, float scale,
    int causal) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1, PS = BK + 1, NC = HD / 16;
  float* sq = smem;
  float* sdo = sq + BQ * QS;
  float* sk = sdo + BQ * QS;
  float* sv = sk + BK * QS;
  float* sp = sv + BK * QS;
  float* slse = sp + BQ * PS;
  float* sD = slse + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), off = Sk - Sq;
  const size_t qoff = (size_t)b * Sq * H * hd;
  const size_t koff = (size_t)b * Sk * KV * hd;

  load_rows<T, HD>(sq, q + qoff, q0, Sq, H, h, hd, scale);
  load_rows<T, HD>(sdo, dout + qoff, q0, Sq, H, h, hd, 1.0f);
  if (tid < BQ) {
    const bool in = q0 + tid < Sq;
    const size_t rowv = ((size_t)b * H + h) * Sq + q0 + tid;
    slse[tid] = in ? lse[rowv] : 0.0f;
    sD[tid] = in ? D[rowv] : 0.0f;
  }
  float dQ[RQ][NC];  // query rows ty + 16 r, columns tx + 16 c
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dQ[r][c] = 0.0f;

  const int k_end = causal ? min(Sk, min(q0 + BQ, Sq) + off) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sk, sv and sp are consumed
    load_rows<T, HD>(sk, k + koff, k0, Sk, KV, kvh, hd, 1.0f);
    load_rows<T, HD>(sv, v + koff, k0, Sk, KV, kvh, hd, 1.0f);
    __syncthreads();
    float p[RQ][CK], ds[RQ][CK];
    tile_p_ds<HD>(sq, sdo, sk, sv, slse, sD, q0, k0, Sq, Sk, off, causal, p,
                  ds);
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c)
        sp[(ty + 16 * r) * PS + tx + 16 * c] = ds[r][c];
    __syncthreads();
    // dQ[i, :] += sum_j dS[i, j] k_j
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dr[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dr[r] = sp[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = sk[j * QS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r) dQ[r][c] = fmaf(dr[r], kk, dQ[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int s = q0 + ty + 16 * r;
    if (s >= Sq) continue;
    T* o = dq + (((size_t)b * Sq + s) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < hd) store(o + tx + 16 * c, dQ[r][c] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const T* q, const T* k, const T* v, const T* out,
               const T* dout, const float* lse, float* D, T* dq, T* dk,
               T* dv, int B, int Sq, int Sk, int H, int KV, int hd,
               float scale, int causal, cudaStream_t st) {
  constexpr int bytes = bwd_smem_bytes<HD>();
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  flash_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(out, dout, D, rows,
                                                          Sq, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, HD><<<dim3((Sk + BK - 1) / BK, KV, B), NTHREADS,
                                bytes, st>>>(q, k, v, dout, lse, D, dk, dv,
                                             Sq, Sk, H, KV, hd, scale,
                                             causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD><<<dim3((Sq + BQ - 1) / BQ, H, B), NTHREADS,
                               bytes, st>>>(q, k, v, dout, lse, D, dq, Sq,
                                            Sk, H, KV, hd, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, void* D, void* dq,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                 int hd, float scale, int causal, cudaStream_t st) {
  FLASH_DISPATCH_HD(hd, return launch_bwd<T, HDT>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(D), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), B, Sq, Sk, H, KV, hd, scale, causal, st))
}

}  // namespace

extern "C" {

// q, out, dout and dq (B, Sq, H, hd), k, v, dk and dv (B, Sk, KV, hd), all
// fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), contiguous; lse (B, H, Sq)
// fp32 from the forward; D scratch of B * H * Sq floats.  The shapes and
// scale the forward took.  Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* D, void* dq, void* dk, void* dv, int B, int Sq,
                        int Sk, int H, int KV, int hd, float scale,
                        int is_bf16, int causal, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, lse, D, dq,
                                           dk, dv, B, Sq, Sk, H, KV, hd,
                                           scale, causal, st)
             : dispatch_bwd<float>(q, k, v, out, dout, lse, D, dq, dk, dv, B,
                                   Sq, Sk, H, KV, hd, scale, causal, st);
}

// dynamic shared memory of one backward block at head size hd (-1:
// unsupported)
int flash_attention_bwd_smem_bytes(int hd) {
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  FLASH_DISPATCH_HD(hd, return bwd_smem_bytes<HDT>())
}

}  // extern "C"
