// Chunkwise stabilized mLSTM (xLSTM matrix memory), forward, for Hopper
// (sm_90a); plain C interface for ctypes.
//
// Replaces kernels/mlstm_chunk/mlstm_chunk.py::mlstm_chunk (the TPU kernel
// _mlstm_kernel).  Per (batch, head) and chunk of L = 64 tokens with
// inclusive cumulative log forget gates b, as ref.mlstm_chunkwise computes:
//     D[t, s] = b_t - b_s + i_s (s <= t),  m_t = max(max_s D[t, s], b_t + m_in)
//     h_t = (sum_s (q_t.k_s) e^{D-m_t} v_s + e^{b_t+m_in-m_t} C^T q_t)
//           / max(|sum_s (q_t.k_s) e^{D-m_t} + e^{b_t+m_in-m_t} q_t.n|,
//                 e^{-m_t})
// carrying the (dh, dh) matrix memory C, the normalizer n and the
// stabilizer m from chunk to chunk.
//
// Design.  The Pallas kernel walks the chunks of one head in order and
// keeps C whole in VMEM; at xlstm-1.3b's head size (dh 1024) C is 4 MiB,
// which no block's shared memory holds, and one block per head would leave
// most of the card idle.  The carry splits instead: the stabilizers and
// gate weights depend on the gates alone (a scalar scan per head, the gate
// kernel), and every 64 x 64 tile of C evolves on its own,
//     C_{c+1}[I, J] = wstate_c C_c[I, J] + sum_s (u_s k_s[I]) v_s[J],
// so the scan kernel gives each tile of C its own block, which keeps the
// tile in registers while it walks the chunks and writes the state at
// every chunk boundary to a workspace (BH x nC x dh x dh fp32: 512 MiB at
// B 2, S 1024, 4 heads of 1024, freed when the call returns).  With the
// states known every chunk is independent: the intra kernel forms the
// chunk's decay-masked scores S = (Q K^T) o e^{D - m} and denominators
// (streaming Q and K over dh), and the output kernel gives each (chunk,
// 64-column slice of h) a block that adds S V to w_t C_c^T q_t.  The ragged
// last chunk is masked (rows past S load as zero and are never stored).
//
// Bound: 4 L dh + 4 dh^2 flops per token per head (the two products of
// the intra term, q.C, and the state update), about 37 GFLOP at xlstm's
// training shape, against ~134 MB of inputs and outputs: the fp32 FMA rate
// bounds it.  Plain fp32 FMAs, accurate expf, no tensor cores: the
// rounding of the chunked jnp form, the order of the sums aside.
#include <cuda_runtime.h>
#include <math.h>

#include "mlstm_chunk.cuh"

namespace mlstm {
namespace {

// One block of L threads per (batch, head); thread t is token t of each
// chunk.  The chunks are walked in order, carrying m_in.
__global__ void gates_kernel(const float* __restrict__ logi,
                             const float* __restrict__ logf,
                             float* __restrict__ gb, float* __restrict__ gm,
                             float* __restrict__ gw, float* __restrict__ gu,
                             float* __restrict__ wstate, int S, int nC) {
  __shared__ float slf[L], sb[L], sli[L], red[NTH / 32];
  const int bh = blockIdx.x, t = threadIdx.x;
  const size_t base = (size_t)bh * S;
  float m_in = NEG;
  for (int c = 0; c < nC; ++c) {
    const int t0 = c * L, Lc = min(L, S - t0);
    const bool ok = t < Lc;
    const float li = ok ? logi[base + t0 + t] : 0.f;
    sli[t] = li;
    slf[t] = ok ? logf[base + t0 + t] : 0.f;
    __syncthreads();
    float b = 0.f;  // inclusive cumulative sum, in token order
    for (int s = 0; s <= t; ++s) b += slf[s];
    sb[t] = b;
    __syncthreads();
    float mi = NEG;
    for (int s = 0; s <= t && s < Lc; ++s) mi = fmaxf(mi, (b - sb[s]) + sli[s]);
    const float m = fmaxf(fmaxf(mi, b + m_in), NEG);
    const float bL = sb[Lc - 1];
    const float dec = ok ? (bL - b) + li : NEG;
    float mx = dec;
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if ((t & 31) == 0) red[t >> 5] = mx;
    __syncthreads();
    for (int w = 0; w < L / 32; ++w) mx = fmaxf(mx, red[w]);
    const float m_next = fmaxf(bL + m_in, mx);
    if (ok) {
      gb[base + t0 + t] = b;
      gm[base + t0 + t] = m;
      gw[base + t0 + t] = expf(b + m_in - m);
      gu[base + t0 + t] = expf(dec - m_next);
    }
    if (t == 0) wstate[(size_t)bh * nC + c] = expf(bL + m_in - m_next);
    m_in = m_next;
    __syncthreads();
  }
}

// One block per (64-row tile I of dk, 64-column tile J of dv, batch-head):
// acc = C[I, J] (or dC in reverse) in registers, walked over the chunks.
template <bool REV>
__global__ void __launch_bounds__(NTH) scan_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cn, const float* __restrict__ wstate,
    float* __restrict__ snap, float* __restrict__ nsnap,
    const float* __restrict__ Cst, const float* __restrict__ nst,
    float* __restrict__ dwsp, int S, int dh, int nC, int nT) {
  __shared__ float xs[L * T], ys[L * T], cns[L], red[NTH / 32];
  const int it = blockIdx.x, jt = blockIdx.y, bh = blockIdx.z;
  const int i0 = it * T, j0 = jt * T;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool ncol = jt == 0 && tid < T;  // owns n[i0 + tid]
  const float* Xb = X + (size_t)bh * S * dh;
  const float* Yb = Y + (size_t)bh * S * dh;
  const size_t gbase = (size_t)bh * S;
  float acc[4][4] = {};
  float nacc = 0.f;
  for (int step = 0; step < nC; ++step) {
    const int c = REV ? nC - 1 - step : step;
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t tile = (((size_t)bh * nC + c) * dh + i0) * dh + j0;
    const size_t nidx = ((size_t)bh * nC + c) * dh + i0 + tid;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        snap[tile + (size_t)(ty + 16 * r) * dh + tx + 16 * q] = acc[r][q];
    if (ncol) nsnap[nidx] = nacc;
    if (REV) {
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          part += acc[r][q] * Cst[tile + (size_t)(ty + 16 * r) * dh + tx + 16 * q];
      if (ncol) part += nacc * nst[nidx];
      part = block_sum(part, red);
      if (tid == 0)
        dwsp[(((size_t)bh * nC + c) * nT + it) * nT + jt] = part;
    }
    if (step == nC - 1) break;  // the update after the last chunk is unused
    __syncthreads();
    for (int e = tid; e < L * T; e += NTH) {
      const int s = e >> 6, col = e & 63;
      float xv = 0.f, yv = 0.f;
      if (s < Lc) {
        const size_t row = (size_t)(t0 + s) * dh;
        xv = Xb[row + i0 + col] * cx[gbase + t0 + s];
        yv = Yb[row + j0 + col];
        if (cy != nullptr) yv *= cy[gbase + t0 + s];
      }
      xs[e] = xv;
      ys[e] = yv;
    }
    if (tid < L)
      cns[tid] = tid < Lc ? (cn != nullptr ? cn[gbase + t0 + tid] : 1.f) : 0.f;
    __syncthreads();
    const float ws = wstate[(size_t)bh * nC + c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= ws;
    for (int s = 0; s < L; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = xs[s * T + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ys[s * T + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
    if (ncol) {
      nacc *= ws;
      for (int s = 0; s < L; ++s) nacc = fmaf(xs[s * T + tid], cns[s], nacc);
    }
  }
}

// One block per (chunk, batch-head).  A = Q K^T and q.n_c streamed over dk;
// then P = e^{D - m} on s <= t, S = A o P and the denominators.  In the
// backward also G V^T and g.h (G = dh), alpha, dA = dS o P and dD = dS o S
// with dS = (G V^T)/den + alpha.
template <bool BWD>
__global__ void __launch_bounds__(NTH) intra_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ h, const float* __restrict__ logi,
    const float* __restrict__ gb, const float* __restrict__ gm,
    const float* __restrict__ gw, const float* __restrict__ nst,
    float* __restrict__ Smat, float* __restrict__ dAmat,
    float* __restrict__ den_out, float* __restrict__ alpha_out,
    float* __restrict__ rowD, float* __restrict__ colD, int S, int dh,
    int nC) {
  __shared__ float ta[L * P], tb[L * P];
  __shared__ float sb[L], sli[L], smm[L], sw[L], sinv[L], sal[L];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;  // first row of the chunk
  if (tid < L) {
    const bool ok = tid < Lc;
    sb[tid] = ok ? gb[gbase + tid] : 0.f;
    sli[tid] = ok ? logi[gbase + tid] : 0.f;
    smm[tid] = ok ? gm[gbase + tid] : 0.f;
    sw[tid] = ok ? gw[gbase + tid] : 0.f;
  }
  const float* nc = nst + ((size_t)bh * nC + c) * dh;
  float a[4][4] = {};
  float qn = 0.f;
  for (int i0 = 0; i0 < dh; i0 += T) {
    __syncthreads();
    load_tile(ta, P, q + rows + i0, dh, Lc, nullptr);
    load_tile(tb, P, k + rows + i0, dh, Lc, nullptr);
    __syncthreads();
    for (int i = 0; i < T; ++i) {
      float x[4], y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = ta[(ty + 16 * r) * P + i];
#pragma unroll
      for (int u = 0; u < 4; ++u) y[u] = tb[(tx + 16 * u) * P + i];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[r][u] = fmaf(x[r], y[u], a[r][u]);
    }
    if (tid < L)
      for (int i = 0; i < T; ++i) qn = fmaf(ta[tid * P + i], nc[i0 + i], qn);
  }
  float gv[4][4] = {};
  float gh = 0.f;
  if (BWD) {
    for (int j0 = 0; j0 < dh; j0 += T) {
      __syncthreads();
      load_tile(ta, P, g + rows + j0, dh, Lc, nullptr);
      load_tile(tb, P, v + rows + j0, dh, Lc, nullptr);
      __syncthreads();
      for (int j = 0; j < T; ++j) {
        float x[4], y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = ta[(ty + 16 * r) * P + j];
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = tb[(tx + 16 * u) * P + j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) gv[r][u] = fmaf(x[r], y[u], gv[r][u]);
      }
      __syncthreads();
      load_tile(tb, P, h + rows + j0, dh, Lc, nullptr);
      __syncthreads();
      if (tid < L)
        for (int j = 0; j < T; ++j)
          gh = fmaf(ta[tid * P + j], tb[tid * P + j], gh);
    }
  }
  __syncthreads();
  float pv[4][4], sv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = ty + 16 * r, s = tx + 16 * u;
      const bool on = s <= t && t < Lc;
      pv[r][u] = on ? expf(((sb[t] - sb[s]) + sli[s]) - smm[t]) : 0.f;
      sv[r][u] = a[r][u] * pv[r][u];
      ta[t * P + s] = sv[r][u];
    }
  __syncthreads();
  if (tid < L) {
    float rs = 0.f;
    for (int s = 0; s < L; ++s) rs += ta[tid * P + s];
    const float dr = rs + sw[tid] * qn;
    const float floor_ = expf(-smm[tid]);
    const float den = fmaxf(fabsf(dr), floor_);
    if (!BWD) {
      if (tid < Lc) den_out[gbase + tid] = den;
    } else {
      const float inv = 1.f / den;
      const float sgn = (dr > 0.f) - (dr < 0.f);
      const float al = fabsf(dr) > floor_ ? -gh * inv * sgn : 0.f;
      sinv[tid] = inv;
      sal[tid] = al;
      if (tid < Lc) {
        den_out[gbase + tid] = inv;
        alpha_out[gbase + tid] = al;
      }
    }
  }
  const size_t mat = ((size_t)bh * nC + c) * L * L;
  for (int e = tid; e < L * L; e += NTH) Smat[mat + e] = ta[(e >> 6) * P + (e & 63)];
  if (BWD) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = ty + 16 * r, s = tx + 16 * u;
        const bool on = s <= t && t < Lc;
        const float ds = on ? fmaf(gv[r][u], sinv[t], sal[t]) : 0.f;
        dAmat[mat + t * L + s] = ds * pv[r][u];
        tb[t * P + s] = ds * sv[r][u];
      }
    __syncthreads();
    if (tid < L) {
      float rsum = 0.f, csum = 0.f;
      for (int s = 0; s < L; ++s) rsum += tb[tid * P + s];
      for (int t = 0; t < L; ++t) csum += tb[t * P + tid];
      if (tid < Lc) {
        rowD[gbase + tid] = rsum;
        colD[gbase + tid] = csum;
      }
    }
  }
}

// One block per (chunk, 64-column slice J of h, batch-head):
// h[t, J] = (sum_s S[t, s] v_s[J] + w_t (q_t^T C_c)[J]) / den_t.
__global__ void __launch_bounds__(NTH) out_kernel(
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ Cst, const float* __restrict__ Smat,
    const float* __restrict__ gw, const float* __restrict__ den,
    float* __restrict__ h, int S, int dh, int nC) {
  __shared__ float ta[L * P], tb[L * P];
  const int c = blockIdx.x, jt = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, Lc = min(L, S - t0), j0 = jt * T;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;
  const float* Cc = Cst + ((size_t)bh * nC + c) * dh * dh;
  float qc[4][4] = {};
  for (int i0 = 0; i0 < dh; i0 += T) {
    __syncthreads();
    load_tile(ta, P, q + rows + i0, dh, Lc, nullptr);
    load_tile(tb, P, Cc + (size_t)i0 * dh + j0, dh, T, nullptr);
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
        for (int u = 0; u < 4; ++u) qc[r][u] = fmaf(x[r], y[u], qc[r][u]);
    }
  }
  __syncthreads();
  load_tile(ta, P, Smat + ((size_t)bh * nC + c) * L * L, L, L, nullptr);
  load_tile(tb, P, v + rows + j0, dh, Lc, nullptr);
  __syncthreads();
  float sv[4][4] = {};
  for (int s = 0; s < L; ++s) {
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ta[(ty + 16 * r) * P + s];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = tb[s * P + tx + 16 * u];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sv[r][u] = fmaf(x[r], y[u], sv[r][u]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = ty + 16 * r;
    if (t >= Lc) continue;
    const float w = gw[gbase + t], dn = den[gbase + t];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      h[rows + (size_t)t * dh + j0 + tx + 16 * u] = (sv[r][u] + w * qc[r][u]) / dn;
  }
}

}  // namespace

int launch_gates(const float* logi, const float* logf, float* gates, Dims d,
                 cudaStream_t st) {
  const size_t n = (size_t)d.BH * d.S;
  gates_kernel<<<d.BH, L, 0, st>>>(logi, logf, gates, gates + n,
                                   gates + 2 * n, gates + 3 * n,
                                   gates + 4 * n, d.S, d.nC);
  return (int)cudaGetLastError();
}

int launch_scan(int reverse, const float* X, const float* Y, const float* cx,
                const float* cy, const float* cn, const float* wstate,
                float* snap, float* nsnap, const float* Cst, const float* nst,
                float* dwsp, Dims d, cudaStream_t st) {
  const dim3 grid(d.nT, d.nT, d.BH);
  if (reverse)
    scan_kernel<true><<<grid, NTH, 0, st>>>(X, Y, cx, cy, cn, wstate, snap,
                                            nsnap, Cst, nst, dwsp, d.S, d.dh,
                                            d.nC, d.nT);
  else
    scan_kernel<false><<<grid, NTH, 0, st>>>(X, Y, cx, cy, cn, wstate, snap,
                                             nsnap, Cst, nst, dwsp, d.S,
                                             d.dh, d.nC, d.nT);
  return (int)cudaGetLastError();
}

int launch_intra(int bwd, const float* q, const float* k, const float* v,
                 const float* g, const float* h, const float* logi,
                 const float* gates, const float* nst, float* Smat,
                 float* dAmat, float* den, float* alpha, float* rowD,
                 float* colD, Dims d, cudaStream_t st) {
  const size_t n = (size_t)d.BH * d.S;
  const dim3 grid(d.nC, d.BH);
  if (bwd)
    intra_kernel<true><<<grid, NTH, 0, st>>>(
        q, k, v, g, h, logi, gates, gates + n, gates + 2 * n, nst, Smat,
        dAmat, den, alpha, rowD, colD, d.S, d.dh, d.nC);
  else
    intra_kernel<false><<<grid, NTH, 0, st>>>(
        q, k, v, g, h, logi, gates, gates + n, gates + 2 * n, nst, Smat,
        dAmat, den, alpha, rowD, colD, d.S, d.dh, d.nC);
  return (int)cudaGetLastError();
}

}  // namespace mlstm

using mlstm::Dims;

extern "C" {

// Floats of the workspace one call needs: forward (bwd = 0) the states C_c
// and n_c, the chunks' S and den; backward (bwd = 1) also dA, the per-token
// terms, the reverse states and the partial sums (see mlstm_chunk_bwd).
long long mlstm_chunk_workspace_floats(int BH, int S, int dh, int bwd) {
  const Dims d = mlstm::make_dims(BH, S, dh);
  const long long ch = (long long)BH * d.nC;
  const long long L2 = (long long)mlstm::L * mlstm::L;
  long long n = ch * dh * dh + ch * dh + ch * L2 + (long long)BH * S;
  if (bwd)
    n += ch * L2 + 3LL * BH * S + ch * dh * dh + ch * dh +
         ch * d.nT * d.nT + 2 * ch * d.nT * mlstm::L;
  return n;
}

// Floats of the gate terms a forward call writes and its backward reads:
// (4 x BH x S) + BH x nC.
long long mlstm_chunk_gates_floats(int BH, int S) {
  return 4LL * BH * S + (long long)BH * ((S + mlstm::L - 1) / mlstm::L);
}

// q, k, v, h (BH, S, dh), logi, logf (BH, S): contiguous fp32 on one card;
// dh a multiple of 64; S >= 1.  gates and ws hold mlstm_chunk_gates_floats
// and mlstm_chunk_workspace_floats(.., 0) floats.  Returns a cudaError_t.
int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const void* logi, const void* logf, void* h, void* gates,
                    void* ws, int BH, int S, int dh, void* stream) {
  if (dh <= 0 || dh % mlstm::T || S <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims d = mlstm::make_dims(BH, S, dh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fli = static_cast<const float*>(logi),
              *flf = static_cast<const float*>(logf);
  float* g = static_cast<float*>(gates);
  const size_t n = (size_t)BH * S, ch = (size_t)BH * d.nC;
  float* Cst = static_cast<float*>(ws);
  float* nst = Cst + ch * dh * dh;
  float* Smat = nst + ch * dh;
  float* den = Smat + ch * mlstm::L * mlstm::L;
  int err = mlstm::launch_gates(fli, flf, g, d, st);
  if (err) return err;
  err = mlstm::launch_scan(0, fk, fv, g + 3 * n, nullptr, nullptr, g + 4 * n,
                           Cst, nst, nullptr, nullptr, nullptr, d, st);
  if (err) return err;
  err = mlstm::launch_intra(0, fq, fk, fv, nullptr, nullptr, fli, g, nst,
                            Smat, nullptr, den, nullptr, nullptr, nullptr, d,
                            st);
  if (err) return err;
  mlstm::out_kernel<<<dim3(d.nC, d.nT, BH), mlstm::NTH, 0, st>>>(
      fq, fv, Cst, Smat, g + 2 * n, den, static_cast<float*>(h), S, dh, d.nC);
  return (int)cudaGetLastError();
}

const char* mlstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
