// Chunkwise stabilized mLSTM, backward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// The gradient (dq, dk, dv, dlogi, dlogf) of the function mlstm_chunk.cu
// computes, for an upstream gradient G = dL/dh.  The Pallas kernel has no
// backward (pallas_call has no transpose), so the JAX package trains
// through its jnp chunked form; this kernel computes the gradient of the
// same chunkwise function, in the decomposition ref.mlstm_chunkwise_bwd
// writes out in plain PyTorch:
//   1. the forward's stages again: gate terms (kept from the forward), the
//      chunk-boundary states C_c, n_c (scan kernel) into the workspace;
//   2. per chunk (intra kernel): S, 1/den, g.h, alpha (the denominator's
//      gradient where the clamp e^{-m} does not win, 0 where it does),
//      dA = dS o P and the row and column sums of dD = dS o S, with
//      dS = (G V^T) / den + alpha;
//   3. the reverse scan of dC and dn (scan kernel, reverse): the gradient of
//      each chunk-boundary state, one 64 x 64 tile per block in registers,
//      and the partial sums of dL/dwstate per tile;
//   4. per (chunk, 64-column tile of dk): dq and dk (dqk kernel), which
//      stream C_c G/den and dC_{c+1} V over dv, add the intra products dA K
//      and dA^T Q, and leave partial sums of dL/dw and dL/du per tile;
//   5. per (chunk, 64-column tile of dv): dv = S^T (G/den) + u (K dC_{c+1});
//   6. per head (dgates kernel): the partial sums reduced, the gradient of
//      the cumulative log forget gates b summed back onto logf, and dlogi.
// The stabilizers m cancel from h, so the backward holds them constant;
// autograd of the plain version sends terms through them that sum to zero.
//
// Memory: the workspace (two sets of chunk-boundary states, BH x nC x dh x
// dh fp32 each: 1 GiB at B 2, S 1024, 4 heads of 1024) lives only for the
// call; nothing per chunk is kept from the forward but the gate terms.
// Reductions over dh that a tile cannot finish alone (dL/dw, dL/du,
// dL/dwstate) go through per-tile partial sums, not atomics, so a run is
// deterministic.  Bound: about twice the forward's flops (the recomputed
// states, the reverse scan, C_c G and dC V, K dC); fp32 FMAs, no tensor
// cores.
#include <cuda_runtime.h>
#include <math.h>

#include "mlstm_chunk.cuh"

namespace mlstm {
namespace {

constexpr int DQK_SMEM = 4 * L * P * (int)sizeof(float);

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (chunk, 64-column tile I of dk, batch-head).  Rows t (for
// dq) and s (for dk) are tokens of the chunk, columns i of the tile.
__global__ void __launch_bounds__(NTH) dqk_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ Cst, const float* __restrict__ nst,
    const float* __restrict__ dCa, const float* __restrict__ dna,
    const float* __restrict__ dAmat, const float* __restrict__ gw,
    const float* __restrict__ gu, const float* __restrict__ invden,
    const float* __restrict__ alpha, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dwp, float* __restrict__ dup,
    int S, int dh, int nC, int nT) {
  extern __shared__ float smem[];
  float* ta = smem;
  float* tb = ta + L * P;
  float* tc = tb + L * P;
  float* td = tc + L * P;
  __shared__ float sw[L], su[L], sal[L], sn[T], sdn[T];
  const int c = blockIdx.x, it = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, Lc = min(L, S - t0), i0 = it * T;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;
  const size_t st = ((size_t)bh * nC + c) * dh;  // row of n_c / dn_{c+1}
  if (tid < L) {
    const bool ok = tid < Lc;
    sw[tid] = ok ? gw[gbase + tid] : 0.f;
    su[tid] = ok ? gu[gbase + tid] : 0.f;
    sal[tid] = ok ? alpha[gbase + tid] : 0.f;
    sn[tid] = nst[st + i0 + tid];
    sdn[tid] = dna[st + i0 + tid];
  }
  const float* Cc = Cst + st * dh + (size_t)i0 * dh;
  const float* dC = dCa + st * dh + (size_t)i0 * dh;
  // X[t, i] = sum_j (g_t / den_t)[j] C_c[i, j],  Z[s, i] = sum_j v_s[j] dC[i, j]
  float X[4][4] = {}, Z[4][4] = {};
  for (int j0 = 0; j0 < dh; j0 += T) {
    __syncthreads();
    load_tile(ta, P, g + rows + j0, dh, Lc, invden + gbase);
    load_tile(tb, P, Cc + j0, dh, T, nullptr);
    load_tile(tc, P, v + rows + j0, dh, Lc, nullptr);
    load_tile(td, P, dC + j0, dh, T, nullptr);
    __syncthreads();
    for (int j = 0; j < T; ++j) {
      float ga[4], va[4], cb[4], db[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ga[r] = ta[(ty + 16 * r) * P + j];
        va[r] = tc[(ty + 16 * r) * P + j];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cb[u] = tb[(tx + 16 * u) * P + j];
        db[u] = td[(tx + 16 * u) * P + j];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          X[r][u] = fmaf(ga[r], cb[u], X[r][u]);
          Z[r][u] = fmaf(va[r], db[u], Z[r][u]);
        }
    }
  }
  // Y = X + alpha_t n_c,  Z' = Z + dn_{c+1}
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      X[r][u] = fmaf(sal[ty + 16 * r], sn[tx + 16 * u], X[r][u]);
      Z[r][u] += sdn[tx + 16 * u];
    }
  __syncthreads();
  load_tile(ta, P, dAmat + ((size_t)bh * nC + c) * L * L, L, L, nullptr);
  load_tile(tb, P, k + rows + i0, dh, Lc, nullptr);
  load_tile(tc, P, q + rows + i0, dh, Lc, nullptr);
  __syncthreads();
  float aq[4][4] = {}, ak[4][4] = {};
  for (int s = 0; s < L; ++s) {  // dA K
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ta[(ty + 16 * r) * P + s];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = tb[s * P + tx + 16 * u];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) aq[r][u] = fmaf(x[r], y[u], aq[r][u]);
  }
  for (int t = 0; t < L; ++t) {  // dA^T Q
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ta[t * P + ty + 16 * r];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = tc[t * P + tx + 16 * u];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) ak[r][u] = fmaf(x[r], y[u], ak[r][u]);
  }
  const size_t part = (((size_t)bh * nC + c) * nT + it) * L;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    float pw = 0.f, pu = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tx + 16 * u;
      pw = fmaf(tc[row * P + i], X[r][u], pw);
      pu = fmaf(tb[row * P + i], Z[r][u], pu);
      if (row < Lc) {
        dq[rows + (size_t)row * dh + i0 + i] = fmaf(sw[row], X[r][u], aq[r][u]);
        dk[rows + (size_t)row * dh + i0 + i] = fmaf(su[row], Z[r][u], ak[r][u]);
      }
    }
    pw = half_warp_sum(pw);
    pu = half_warp_sum(pu);
    if (tx == 0) {
      dwp[part + row] = pw;
      dup[part + row] = pu;
    }
  }
}

// One block per (chunk, 64-column tile J of dv, batch-head):
// dv[s, J] = sum_t S[t, s] (g_t / den_t)[J] + u_s (k_s^T dC_{c+1})[J].
__global__ void __launch_bounds__(NTH) dv_kernel(
    const float* __restrict__ k, const float* __restrict__ g,
    const float* __restrict__ dCa, const float* __restrict__ Smat,
    const float* __restrict__ gu, const float* __restrict__ invden,
    float* __restrict__ dv, int S, int dh, int nC) {
  __shared__ float ta[L * P], tb[L * P];
  const int c = blockIdx.x, jt = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, Lc = min(L, S - t0), j0 = jt * T;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;
  const float* dC = dCa + ((size_t)bh * nC + c) * dh * dh;
  float W[4][4] = {};
  for (int i0 = 0; i0 < dh; i0 += T) {
    __syncthreads();
    load_tile(ta, P, k + rows + i0, dh, Lc, nullptr);
    load_tile(tb, P, dC + (size_t)i0 * dh + j0, dh, T, nullptr);
    __syncthreads();
    for (int i = 0; i < T; ++i) {
      float x[4], y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = ta[(ty + 16 * r) * P + i];
#pragma unroll
      for (int u = 0; u < 4; ++u) y[u] = tb[i * P + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) W[r][u] = fmaf(x[r], y[u], W[r][u]);
    }
  }
  __syncthreads();
  load_tile(ta, P, Smat + ((size_t)bh * nC + c) * L * L, L, L, nullptr);
  load_tile(tb, P, g + rows + j0, dh, Lc, invden + gbase);
  __syncthreads();
  float acc[4][4] = {};
  for (int t = 0; t < L; ++t) {
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ta[t * P + ty + 16 * r];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = tb[t * P + tx + 16 * u];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(x[r], y[u], acc[r][u]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = ty + 16 * r;
    if (s >= Lc) continue;
    const float us = gu[gbase + s];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      dv[rows + (size_t)s * dh + j0 + tx + 16 * u] = fmaf(us, W[r][u], acc[r][u]);
  }
}

// One block of L threads per (batch, head); thread t is token t of each
// chunk.  db_t = rowD_t - colD_t + w_t dL/dw_t - u_t dL/du_t, the chunk's
// last token also taking sum_s u_s dL/du_s + wstate dL/dwstate; dlogf is the
// reverse cumulative sum of db within the chunk, dlogi_s = colD_s +
// u_s dL/du_s.
__global__ void dgates_kernel(const float* __restrict__ gw,
                              const float* __restrict__ gu,
                              const float* __restrict__ wstate,
                              const float* __restrict__ rowD,
                              const float* __restrict__ colD,
                              const float* __restrict__ dwp,
                              const float* __restrict__ dup,
                              const float* __restrict__ dwsp,
                              float* __restrict__ dli,
                              float* __restrict__ dlf, int S, int nC,
                              int nT) {
  __shared__ float sdb[L], red[NTH / 32];
  const int bh = blockIdx.x, t = threadIdx.x;
  for (int c = 0; c < nC; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const bool ok = t < Lc;
    const size_t ch = (size_t)bh * nC + c;
    float dw = 0.f, du = 0.f, dws = 0.f;
    for (int it = 0; it < nT; ++it) {
      dw += dwp[(ch * nT + it) * L + t];
      du += dup[(ch * nT + it) * L + t];
    }
    for (int e = t; e < nT * nT; e += L) dws += dwsp[ch * nT * nT + e];
    dws = block_sum(dws, red);
    const size_t o = (size_t)bh * S + t0 + t;
    const float ddec = ok ? du * gu[o] : 0.f;
    float db = ok ? (rowD[o] - colD[o]) + dw * gw[o] - ddec : 0.f;
    const float sdd = block_sum(ddec, red);
    if (t == Lc - 1) db += sdd + dws * wstate[ch];
    sdb[t] = db;
    __syncthreads();
    if (ok) {
      float acc = 0.f;
      for (int s = Lc - 1; s >= t; --s) acc += sdb[s];
      dlf[o] = acc;
      dli[o] = colD[o] + ddec;
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace mlstm

using mlstm::Dims;

extern "C" {

// q, k, v, h, dh (BH, S, dh), logi, logf (BH, S): contiguous fp32 on one
// card, as the forward call took and gave them; gates as the forward wrote
// them; ws holds mlstm_chunk_workspace_floats(.., 1) floats.  Writes dq, dk,
// dv (BH, S, dh) and dlogi, dlogf (BH, S).  Returns a cudaError_t.
int mlstm_chunk_bwd(const void* q, const void* k, const void* v,
                    const void* logi, const void* h, const void* dh_,
                    const void* gates, void* ws, void* dq, void* dk, void* dv,
                    void* dlogi, void* dlogf, int BH, int S, int dh,
                    void* stream) {
  using mlstm::L;
  if (dh <= 0 || dh % mlstm::T || S <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims d = mlstm::make_dims(BH, S, dh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fli = static_cast<const float*>(logi),
              *fh = static_cast<const float*>(h),
              *fg = static_cast<const float*>(dh_),
              *gt = static_cast<const float*>(gates);
  const size_t n = (size_t)BH * S, ch = (size_t)BH * d.nC;
  const float *gw = gt + 2 * n, *gu = gt + 3 * n, *wst = gt + 4 * n;
  float* Cst = static_cast<float*>(ws);
  float* nst = Cst + ch * dh * dh;
  float* Smat = nst + ch * dh;
  float* invden = Smat + ch * L * L;
  float* dAmat = invden + n;
  float* alpha = dAmat + ch * L * L;
  float* rowD = alpha + n;
  float* colD = rowD + n;
  float* dCa = colD + n;
  float* dna = dCa + ch * dh * dh;
  float* dwsp = dna + ch * dh;
  float* dwp = dwsp + ch * d.nT * d.nT;
  float* dup = dwp + ch * d.nT * L;
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  const cudaError_t attr = cudaFuncSetAttribute(
      mlstm::dqk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mlstm::DQK_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int err = mlstm::launch_scan(0, fk, fv, gu, nullptr, nullptr, wst, Cst, nst,
                               nullptr, nullptr, nullptr, d, st);
  if (err) return err;
  err = mlstm::launch_intra(1, fq, fk, fv, fg, fh, fli, gt, nst, Smat, dAmat,
                            invden, alpha, rowD, colD, d, st);
  if (err) return err;
  err = mlstm::launch_scan(1, fq, fg, gw, invden, alpha, wst, dCa, dna, Cst,
                           nst, dwsp, d, st);
  if (err) return err;
  const dim3 tiles(d.nC, d.nT, BH);
  mlstm::dqk_kernel<<<tiles, mlstm::NTH, mlstm::DQK_SMEM, st>>>(
      fq, fk, fv, fg, Cst, nst, dCa, dna, dAmat, gw, gu, invden, alpha,
      static_cast<float*>(dq), static_cast<float*>(dk), dwp, dup, S, dh,
      d.nC, d.nT);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlstm::dv_kernel<<<tiles, mlstm::NTH, 0, st>>>(
      fk, fg, dCa, Smat, gu, invden, static_cast<float*>(dv), S, dh, d.nC);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlstm::dgates_kernel<<<BH, L, 0, st>>>(
      gw, gu, wst, rowD, colD, dwp, dup, dwsp, static_cast<float*>(dlogi),
      static_cast<float*>(dlogf), S, d.nC, d.nT);
  return (int)cudaGetLastError();
}

}  // extern "C"
