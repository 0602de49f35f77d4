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
//   6. per (chunk, batch-head) (dgates kernel): the partial sums reduced,
//      the gradient of the cumulative log forget gates b summed back onto
//      logf, and dlogi.
// The stabilizers m cancel from h, so the backward holds them constant;
// autograd of the plain version sends terms through them that sum to zero.
//
// Memory: the workspace (two sets of chunk-boundary states, BH x nC x dh x
// dh fp32 each: 1 GiB at B 2, S 1024, 4 heads of 1024) lives only for the
// call; nothing per chunk is kept from the forward but the gate terms.
// Reductions over dh that a tile cannot finish alone (dL/dw, dL/du,
// dL/dwstate) go through per-tile partial sums, not atomics, so a run is
// deterministic.
//
// Arithmetic: twice the forward's flops (66.6 GFLOP at xlstm's training
// shape: the recomputed states, the reverse scan, C_c G, dC V, K dC and the
// intra products), each product of two tiles on the tensor cores in split
// TF32 as in the forward (mlstm_chunk.cuh), at least 0.40 ms at 495 / 3
// TFLOP/s.  The state workspace adds at least 0.96 ms at 3.35 TB/s: C_c
// written once and read twice (reverse scan, dqk), dC_{c+1} written once
// and read twice (dqk, dv), 3.2 GB.  As in the forward, the products'
// issue rate, not the workspace, sets the time as the kernels stand.
#include <cuda_runtime.h>
#include <math.h>

#include "mlstm_chunk.cuh"

namespace mlstm {
namespace {

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
  extern __shared__ float ring[];
  __shared__ float sw[L], su[L], sal[L], sinv[L], sn[T], sdn[T];
  __shared__ float part[2 * L], rsum[L];
  const int it = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, Lc = min(L, S - t0), i0 = it * T;
  const int tid = threadIdx.x;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;
  const size_t st = ((size_t)bh * nC + c) * dh;  // row of n_c / dn_{c+1}
  if (tid < L) {
    const bool ok = tid < Lc;
    sw[tid] = ok ? gw[gbase + tid] : 0.f;
    su[tid] = ok ? gu[gbase + tid] : 0.f;
    sal[tid] = ok ? alpha[gbase + tid] : 0.f;
    sinv[tid] = ok ? invden[gbase + tid] : 0.f;
    sn[tid] = nst[st + i0 + tid];
    sdn[tid] = dna[st + i0 + tid];
  }
  const float* Cc = Cst + st * dh + (size_t)i0 * dh;
  const float* dC = dCa + st * dh + (size_t)i0 * dh;
  // X[t, i] = sum_j g_t[j] C_c[i, j] (C_0 = 0), Z[s, i] = sum_j v_s[j]
  // dC[i, j] (dC after the last chunk is 0)
  Acc X, Z;
  zero(X);
  zero(Z);
  mma_ring<true, true>(X, ring, c > 0 ? dh / T : 0, LDK, LDK,
                       [&](int kt, float* ta, float* tb) {
                         copy_tile(ta, LDK, g + rows + kt * T, dh, Lc);
                         copy_tile(tb, LDK, Cc + kt * T, dh, T);
                       });
  mma_ring<true, true>(Z, ring, c < nC - 1 ? dh / T : 0, LDK, LDK,
                       [&](int kt, float* ta, float* tb) {
                         copy_tile(ta, LDK, v + rows + kt * T, dh, Lc);
                         copy_tile(tb, LDK, dC + kt * T, dh, T);
                       });
  // the chunk's dA, and K and Q at the tile's columns
  float* tA = ring;
  float* tK = ring + SLOT;
  float* tQ = ring + 2 * SLOT;
  copy_tile(tA, LDR, dAmat + ((size_t)bh * nC + c) * L * L, L, L);
  copy_tile(tK, LDR, k + rows + i0, dh, Lc);
  copy_tile(tQ, LDR, q + rows + i0, dh, Lc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Y = X / den_t + alpha_t n_c,  Z' = Z + dn_{c+1}
  pairs([&](int mt, int nt, int e, int t, int i) {
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      X[mt][nt][e + q2] = fmaf(sal[t], sn[i + q2], X[mt][nt][e + q2] * sinv[t]);
      Z[mt][nt][e + q2] += sdn[i + q2];
    }
  });
  // partial sums over the tile of dL/dw_t = q_t.Y_t and dL/du_s = k_s.Z'_s
  const size_t pidx = (((size_t)bh * nC + c) * nT + it) * L;
  row_sums([&](int mt, int nt, int e, int t, int i) {
    return tQ[t * LDR + i] * X[mt][nt][e] + tQ[t * LDR + i + 1] * X[mt][nt][e + 1];
  }, part, rsum);
  if (tid < L) dwp[pidx + tid] = rsum[tid];
  row_sums([&](int mt, int nt, int e, int s, int i) {
    return tK[s * LDR + i] * Z[mt][nt][e] + tK[s * LDR + i + 1] * Z[mt][nt][e + 1];
  }, part, rsum);
  if (tid < L) dup[pidx + tid] = rsum[tid];
  // dq = w_t Y + dA K,  dk = u_s Z' + dA^T Q
  pairs([&](int mt, int nt, int e, int r, int) {
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      X[mt][nt][e + q2] *= sw[r];
      Z[mt][nt][e + q2] *= su[r];
    }
  });
  mma_slab<true, false>(X, tA, LDR, tK, LDR, nullptr, nullptr);
  mma_slab<false, false>(Z, tA, LDR, tQ, LDR, nullptr, nullptr);
  store_rows(dq + rows + i0, dh, Lc, [&](int mt, int nt, int e, int, int) {
    return make_float2(X[mt][nt][e], X[mt][nt][e + 1]);
  });
  store_rows(dk + rows + i0, dh, Lc, [&](int mt, int nt, int e, int, int) {
    return make_float2(Z[mt][nt][e], Z[mt][nt][e + 1]);
  });
}

// One block per (chunk, 64-column tile J of dv, batch-head):
// dv[s, J] = u_s (k_s^T dC_{c+1})[J] + sum_t S[t, s] (g_t / den_t)[J].
__global__ void __launch_bounds__(NTH) dv_kernel(
    const float* __restrict__ k, const float* __restrict__ g,
    const float* __restrict__ dCa, const float* __restrict__ Smat,
    const float* __restrict__ gu, const float* __restrict__ invden,
    float* __restrict__ dv, int S, int dh, int nC) {
  extern __shared__ float ring[];
  __shared__ float su[L], sinv[L];
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, Lc = min(L, S - t0), j0 = jt * T;
  const int tid = threadIdx.x;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;
  if (tid < L) {
    const bool ok = tid < Lc;
    su[tid] = ok ? gu[gbase + tid] : 0.f;
    sinv[tid] = ok ? invden[gbase + tid] : 0.f;
  }
  const float* dC = dCa + ((size_t)bh * nC + c) * dh * dh;
  Acc W;  // K dC[:, J] over i (dC after the last chunk is 0)
  zero(W);
  mma_ring<true, false>(W, ring, c < nC - 1 ? dh / T : 0, LDK, LDR,
                        [&](int kt, float* ta, float* tb) {
                          copy_tile(ta, LDK, k + rows + kt * T, dh, Lc);
                          copy_tile(tb, LDR, dC + (size_t)kt * T * dh + j0,
                                    dh, T);
                        });
  float* tS = ring;
  float* tG = ring + SLOT;
  copy_tile(tS, LDR, Smat + ((size_t)bh * nC + c) * L * L, L, L);
  copy_tile(tG, LDR, g + rows + j0, dh, Lc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  pairs([&](int mt, int nt, int e, int s, int) {
    W[mt][nt][e] *= su[s];
    W[mt][nt][e + 1] *= su[s];
  });
  // + S^T (G / den): A = S^T (contracted over its rows t), B = G with row t
  // scaled by 1/den_t
  mma_slab<false, false>(W, tS, LDR, tG, LDR, nullptr, sinv);
  store_rows(dv + rows + j0, dh, Lc, [&](int mt, int nt, int e, int, int) {
    return make_float2(W[mt][nt][e], W[mt][nt][e + 1]);
  });
}

// One block of L threads per (chunk, batch-head): no term crosses a chunk;
// thread t is token t.  db_t = rowD_t - colD_t + w_t dL/dw_t - u_t dL/du_t,
// the chunk's last token also taking sum_s u_s dL/du_s + wstate dL/dwstate;
// dlogf is the reverse cumulative sum of db within the chunk, dlogi_s =
// colD_s + u_s dL/du_s.
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
  const int c = blockIdx.x, bh = blockIdx.y, t = threadIdx.x;
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
}

}  // namespace

int bwd_stage_attrs(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = which == 0 ? cudaFuncGetAttributes(&a, dqk_kernel)
                                     : cudaFuncGetAttributes(&a, dv_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes + RING_SMEM;
  return 0;
}

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
  cudaError_t attr = cudaFuncSetAttribute(
      mlstm::dqk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mlstm::RING_SMEM);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(mlstm::dv_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                mlstm::RING_SMEM);
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
  const dim3 tiles(d.nT, d.nC, BH);
  mlstm::dqk_kernel<<<tiles, mlstm::NTH, mlstm::RING_SMEM, st>>>(
      fq, fk, fv, fg, Cst, nst, dCa, dna, dAmat, gw, gu, invden, alpha,
      static_cast<float*>(dq), static_cast<float*>(dk), dwp, dup, S, dh,
      d.nC, d.nT);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlstm::dv_kernel<<<tiles, mlstm::NTH, mlstm::RING_SMEM, st>>>(
      fk, fg, dCa, Smat, gu, invden, static_cast<float*>(dv), S, dh, d.nC);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlstm::dgates_kernel<<<dim3(d.nC, BH), L, 0, st>>>(
      gw, gu, wst, rowD, colD, dwp, dup, dwsp, static_cast<float*>(dlogi),
      static_cast<float*>(dlogf), S, d.nC, d.nT);
  return (int)cudaGetLastError();
}

}  // extern "C"
