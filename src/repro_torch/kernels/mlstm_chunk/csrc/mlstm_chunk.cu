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
// Arithmetic: 4 L dh + 4 dh^2 flops per token per head (the two products
// of the intra term, q.C and the state update), 33.3 GFLOP at xlstm's
// training shape against 134 MB of inputs and outputs, 96.7% of it the dh^2
// products.  Every product of two tiles (the state update, Q C_c, Q K^T,
// S V) runs on the tensor cores by mma.sync in split TF32, three products
// for each (mlstm_chunk.cuh): near fp32, where one TF32 pass misses the
// kernels' 5e-5 tolerance at dh 1024 several times over
// (tests/test_torch_mlstm_numerics.py).  At 495 / 3 TFLOP/s the products
// take at least 0.20 ms; the state workspace (C_c written by the scan and
// read by the output kernel: 1.07 GB) at least 0.32 ms at 3.35 TB/s.  What
// bounds the kernels as they stand is the products' issue rate: mma.sync
// beside the fragment loads and splits (the output kernel barely sped up
// without its C_c copies in a development build).  Per-token dot products
// (q.n, the n update, the row sums) stay fp32 FMAs; accurate expf.
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
// Step `step` multiplies the X and Y rows of its chunk, which the ring
// stage step % 2 holds; the copy of the next chunk's rows runs meanwhile.
template <bool REV>
__global__ void __launch_bounds__(NTH) scan_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cn, const float* __restrict__ wstate,
    float* __restrict__ snap, float* __restrict__ nsnap,
    const float* __restrict__ Cst, const float* __restrict__ nst,
    float* __restrict__ dwsp, int S, int dh, int nC, int nT) {
  extern __shared__ float ring[];
  __shared__ float sx[2][L], sy[2][L], sn[2][L], red[NTH / 32];
  const int it = blockIdx.x, jt = blockIdx.y, bh = blockIdx.z;
  const int i0 = it * T, j0 = jt * T;
  const int tid = threadIdx.x;
  const bool ncol = jt == 0 && tid < T;  // owns n[i0 + tid]
  const float* Xb = X + (size_t)bh * S * dh;
  const float* Yb = Y + (size_t)bh * S * dh;
  const size_t gbase = (size_t)bh * S;
  // the rows of step `step`'s chunk into ring stage s: X[:, I] (read as
  // the A operand X^T, contracted over rows), Y[:, J], and the scales
  auto load = [&](int step, int s) {
    const int c = REV ? nC - 1 - step : step;
    const int t0 = c * L, Lc = min(L, S - t0);
    const size_t row = (size_t)t0 * dh;
    copy_tile(ring + 2 * s * SLOT, LDR, Xb + row + i0, dh, Lc);
    copy_tile(ring + (2 * s + 1) * SLOT, LDR, Yb + row + j0, dh, Lc);
    copy_vec(sx[s], cx + gbase + t0, Lc);
    if (cy != nullptr) copy_vec(sy[s], cy + gbase + t0, Lc);
    if (cn != nullptr) copy_vec(sn[s], cn + gbase + t0, Lc);
  };
  auto tile_at = [&](int step) {
    const int c = REV ? nC - 1 - step : step;
    return (((size_t)bh * nC + c) * dh + i0) * dh + j0;
  };
  // reverse: the entries of C_c the thread holds, loaded a step ahead so
  // that the loads run while the warps multiply
  float2 cpre[2][4][2];
  auto fetch = [&](int step) {
    const size_t tile = tile_at(step);
    pairs([&](int mt, int nt, int e, int r, int col) {
      cpre[mt][nt][e >> 1] =
          *reinterpret_cast<const float2*>(Cst + tile + (size_t)r * dh + col);
    });
  };
  Acc acc;
  zero(acc);
  float nacc = 0.f;
  if (nC > 1) load(0, 0);
  cp_async_commit();
  if (REV) fetch(0);
  for (int step = 0; step < nC; ++step) {
    const int c = REV ? nC - 1 - step : step;
    const size_t tile = tile_at(step);
    const size_t nidx = ((size_t)bh * nC + c) * dh + i0 + tid;
    store_rows(snap + tile, dh, T, [&](int mt, int nt, int e, int, int) {
      return make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
    });
    if (ncol) nsnap[nidx] = nacc;
    if (REV) {
      float part = 0.f;
      pairs([&](int mt, int nt, int e, int, int) {
        const float2 cs = cpre[mt][nt][e >> 1];
        part = fmaf(acc[mt][nt][e], cs.x, part);
        part = fmaf(acc[mt][nt][e + 1], cs.y, part);
      });
      if (ncol) part = fmaf(nacc, nst[nidx], part);
      part = block_sum(part, red);
      if (tid == 0)
        dwsp[(((size_t)bh * nC + c) * nT + it) * nT + jt] = part;
    }
    if (step == nC - 1) break;  // the update after the last chunk is unused
    if (step + 1 < nC - 1) load(step + 1, (step + 1) & 1);
    cp_async_commit();
    if (REV) fetch(step + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int s = step & 1;
    const float ws = wstate[(size_t)bh * nC + c];
    pairs([&](int mt, int nt, int e, int, int) {
      acc[mt][nt][e] *= ws;
      acc[mt][nt][e + 1] *= ws;
    });
    const float* xs = ring + 2 * s * SLOT;
    mma_slab<false, false>(acc, xs, LDR, xs + SLOT, LDR, sx[s],
                           cy != nullptr ? sy[s] : nullptr);
    if (ncol) {
      nacc *= ws;
      for (int t = 0; t < L; ++t)
        nacc = fmaf(xs[t * LDR + tid] * sx[s][t],
                    cn != nullptr ? sn[s][t] : 1.f, nacc);
    }
    __syncthreads();
  }
}

// One block per (chunk, batch-head).  A = Q K^T over dk (tensor cores) and
// q.n_c; then P = e^{D - m} on s <= t, S = A o P and the denominators.  In
// the backward also G V^T and g.h (G = dh), alpha, dA = dS o P and dD =
// dS o S with dS = (G V^T)/den + alpha.
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
  extern __shared__ float ring[];
  __shared__ float sb[L], sli[L], smm[L], sw[L], sinv[L], sal[L];
  __shared__ float sqn[L], sgh[L], srs[L], part[2 * L];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int tid = threadIdx.x;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;  // first row of the chunk
  if (tid < L) {
    const bool ok = tid < Lc;
    sb[tid] = ok ? gb[gbase + tid] : 0.f;
    sli[tid] = ok ? logi[gbase + tid] : 0.f;
    smm[tid] = ok ? gm[gbase + tid] : 0.f;
    sw[tid] = ok ? gw[gbase + tid] : 0.f;
  }
  {  // q.n_c (and g.h): threads 2t and 2t + 1 take row t
    const int t = tid >> 1;
    const float* nc = nst + ((size_t)bh * nC + c) * dh;
    float qn = 0.f, gh = 0.f;
    if (t < Lc) {
      const size_t r = rows + (size_t)t * dh;
      for (int i = (tid & 1) * 4; i < dh; i += 8) {
        const float4 x = *reinterpret_cast<const float4*>(q + r + i);
        const float4 y = *reinterpret_cast<const float4*>(nc + i);
        qn = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, qn))));
        if (BWD) {
          const float4 a = *reinterpret_cast<const float4*>(g + r + i);
          const float4 b = *reinterpret_cast<const float4*>(h + r + i);
          gh = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, gh))));
        }
      }
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    gh += __shfl_xor_sync(0xffffffffu, gh, 1);
    if ((tid & 1) == 0) {
      sqn[t] = qn;
      sgh[t] = gh;
    }
  }
  Acc a;
  zero(a);
  mma_ring<true, true>(a, ring, dh / T, LDK, LDK,
                       [&](int kt, float* ta, float* tb) {
                         copy_tile(ta, LDK, q + rows + kt * T, dh, Lc);
                         copy_tile(tb, LDK, k + rows + kt * T, dh, Lc);
                       });
  Acc gv;
  zero(gv);
  if (BWD)
    mma_ring<true, true>(gv, ring, dh / T, LDK, LDK,
                         [&](int kt, float* ta, float* tb) {
                           copy_tile(ta, LDK, g + rows + kt * T, dh, Lc);
                           copy_tile(tb, LDK, v + rows + kt * T, dh, Lc);
                         });
  auto pval = [&](int t, int s) {
    return s <= t && t < Lc ? expf(((sb[t] - sb[s]) + sli[s]) - smm[t]) : 0.f;
  };
  pairs([&](int mt, int nt, int e, int t, int s) {
    a[mt][nt][e] *= pval(t, s);
    a[mt][nt][e + 1] *= pval(t, s + 1);
  });
  row_sums([&](int mt, int nt, int e, int, int) {
    return a[mt][nt][e] + a[mt][nt][e + 1];
  }, part, srs);
  if (tid < L) {
    const float dr = srs[tid] + sw[tid] * sqn[tid];
    const float floor_ = expf(-smm[tid]);
    const float den = fmaxf(fabsf(dr), floor_);
    if (!BWD) {
      if (tid < Lc) den_out[gbase + tid] = den;
    } else {
      const float inv = 1.f / den;
      const float sgn = (dr > 0.f) - (dr < 0.f);
      const float al = fabsf(dr) > floor_ ? -sgh[tid] * inv * sgn : 0.f;
      sinv[tid] = inv;
      sal[tid] = al;
      if (tid < Lc) {
        den_out[gbase + tid] = inv;
        alpha_out[gbase + tid] = al;
      }
    }
  }
  const size_t mat = ((size_t)bh * nC + c) * L * L;
  store_rows(Smat + mat, L, L, [&](int mt, int nt, int e, int, int) {
    return make_float2(a[mt][nt][e], a[mt][nt][e + 1]);
  });
  if (BWD) {
    __syncthreads();
    constexpr int PD = L + 1;  // dD's row stride: rows and columns summed
    float* tdd = ring;
    pairs([&](int mt, int nt, int e, int t, int s) {
      float ds[2];
#pragma unroll
      for (int q2 = 0; q2 < 2; ++q2) {
        const bool on = s + q2 <= t && t < Lc;
        ds[q2] = on ? fmaf(gv[mt][nt][e + q2], sinv[t], sal[t]) : 0.f;
        tdd[t * PD + s + q2] = ds[q2] * a[mt][nt][e + q2];
      }
      *reinterpret_cast<float2*>(dAmat + mat + t * L + s) =
          make_float2(ds[0] * pval(t, s), ds[1] * pval(t, s + 1));
    });
    __syncthreads();
    if (tid < L) {
      float rsum = 0.f, csum = 0.f;
      for (int s = 0; s < L; ++s) rsum += tdd[tid * PD + s];
      for (int t = 0; t < L; ++t) csum += tdd[t * PD + tid];
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
  extern __shared__ float ring[];
  __shared__ float sw[L], sdn[L];
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * L, Lc = min(L, S - t0), j0 = jt * T;
  const int tid = threadIdx.x;
  const size_t gbase = (size_t)bh * S + t0;
  const size_t rows = gbase * dh;
  if (tid < L) {
    const bool ok = tid < Lc;
    sw[tid] = ok ? gw[gbase + tid] : 0.f;
    sdn[tid] = ok ? den[gbase + tid] : 1.f;
  }
  const float* Cc = Cst + ((size_t)bh * nC + c) * dh * dh;
  Acc qc;  // Q C_c[:, J], over i (C_0 = 0: the first chunk has none)
  zero(qc);
  mma_ring<true, false>(qc, ring, c > 0 ? dh / T : 0, LDK, LDR,
                        [&](int kt, float* ta, float* tb) {
                          copy_tile(ta, LDK, q + rows + kt * T, dh, Lc);
                          copy_tile(tb, LDR, Cc + (size_t)kt * T * dh + j0,
                                    dh, T);
                        });
  Acc sv;  // S V[:, J]
  zero(sv);
  mma_ring<true, false>(sv, ring, 1, LDK, LDR, [&](int, float* ta, float* tb) {
    copy_tile(ta, LDK, Smat + ((size_t)bh * nC + c) * L * L, L, L);
    copy_tile(tb, LDR, v + rows + j0, dh, Lc);
  });
  store_rows(h + rows + j0, dh, Lc, [&](int mt, int nt, int e, int t, int) {
    return make_float2(
        (sv[mt][nt][e] + sw[t] * qc[mt][nt][e]) / sdn[t],
        (sv[mt][nt][e + 1] + sw[t] * qc[mt][nt][e + 1]) / sdn[t]);
  });
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
  auto kern = reverse ? scan_kernel<true> : scan_kernel<false>;
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NTH, RING_SMEM, st>>>(X, Y, cx, cy, cn, wstate, snap, nsnap,
                                     Cst, nst, dwsp, d.S, d.dh, d.nC, d.nT);
  return (int)cudaGetLastError();
}

int launch_intra(int bwd, const float* q, const float* k, const float* v,
                 const float* g, const float* h, const float* logi,
                 const float* gates, const float* nst, float* Smat,
                 float* dAmat, float* den, float* alpha, float* rowD,
                 float* colD, Dims d, cudaStream_t st) {
  const size_t n = (size_t)d.BH * d.S;
  const dim3 grid(d.nC, d.BH);
  auto kern = bwd ? intra_kernel<true> : intra_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NTH, RING_SMEM, st>>>(q, k, v, g, h, logi, gates, gates + n,
                                     gates + 2 * n, nst, Smat, dAmat, den,
                                     alpha, rowD, colD, d.S, d.dh, d.nC);
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
  err = (int)cudaFuncSetAttribute(mlstm::out_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  mlstm::RING_SMEM);
  if (err) return err;
  mlstm::out_kernel<<<dim3(d.nT, d.nC, BH), mlstm::NTH, mlstm::RING_SMEM,
                      st>>>(fq, fv, Cst, Smat, g + 2 * n, den,
                            static_cast<float*>(h), S, dh, d.nC);
  return (int)cudaGetLastError();
}

// What each stage kernel takes on the card: registers per thread, local
// (spill) bytes per thread and shared bytes per block (static + the ring)
// into out[0..2], for the scan (which = 0), the reverse scan (1), the intra
// kernel forward (2) and backward (3), out (4), dqk (5) and dv (6).
// Returns a cudaError_t.
int mlstm_chunk_attrs(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (which) {
    case 0: err = cudaFuncGetAttributes(&a, mlstm::scan_kernel<false>); break;
    case 1: err = cudaFuncGetAttributes(&a, mlstm::scan_kernel<true>); break;
    case 2: err = cudaFuncGetAttributes(&a, mlstm::intra_kernel<false>); break;
    case 3: err = cudaFuncGetAttributes(&a, mlstm::intra_kernel<true>); break;
    case 4: err = cudaFuncGetAttributes(&a, mlstm::out_kernel); break;
    case 5: case 6: return mlstm::bwd_stage_attrs(which - 5, out);
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes + mlstm::RING_SMEM;
  return 0;
}

const char* mlstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
