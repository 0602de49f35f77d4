// Shared pieces of the chunkwise mLSTM kernels (forward in mlstm_chunk.cu,
// backward in mlstm_chunk_bwd.cu): tile constants, the split-TF32
// tensor-core product of a block's 64 x 64 tile, cp.async tile copies, block
// reductions, and the launchers of the three stages that both directions
// run (gates, the state scan, the per-chunk intra terms).
//
// Layout: q, k, v, h and their gradients are (BH, S, dh) fp32 row-major
// (BH = batch x heads), logi and logf (BH, S).  A chunk is L = 64 tokens
// (the last one may be shorter); dh is cut into tiles of T = 64.
//
// Products.  Every block runs 128 threads, four warps in a 2 x 2 grid, and
// owns a 64 x 64 output tile; warp w holds rows 32 (w / 2) .. + 31 and
// columns 32 (w % 2) .. + 31 in registers as 2 x 4 accumulators of
// mma.sync.m16n8k8 (TF32 operands, fp32 sums).  One TF32 pass keeps 10
// mantissa bits of each operand (2^-11 relative at best), which the fp32
// tolerance of the kernels does not allow at dh 1024, so each fp32 operand
// x is split into hi = x with its 13 low bits cleared and lo = x - hi
// (exact), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first
// ("3xTF32").  The tensor cores drop lo's 13 low bits in turn, so hi + lo
// holds x to within 2^-20 of it and the dropped a_lo b_lo is below 2^-20 of
// a b: near fp32, for two integer and float operations an operand (cvt.rna
// for hi and for lo, tried in development, cost more issue slots and
// bought no accuracy the tolerance needs).  Operand fragments are 32-bit
// loads from shared memory; a tile whose columns run along the contraction
// index has rows LDK = 68 floats apart, one whose rows do LDR = 72, so that
// the 32 lanes of each load hit 32 different banks.  Tiles arrive by cp.async (16
// bytes a thread, rows past the data zero-filled) into a two-stage ring:
// the copy of k-tile kt + 1 runs while the warps multiply k-tile kt.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mlstm {

constexpr int L = 64;        // chunk length in tokens
constexpr int T = 64;        // tile width over dh
constexpr int NTH = 128;     // threads per block: four warps
constexpr int LDK = T + 4;   // row stride: the contraction runs along a row
constexpr int LDR = T + 8;   // row stride: the contraction runs down a column
constexpr int SLOT = L * LDR;            // floats of one ring slot
constexpr int RING_SMEM = 4 * SLOT * 4;  // bytes: four slots (two stages)
constexpr float NEG = -1e30f;

struct Dims {
  int BH, S, dh, nC, nT;
};

inline Dims make_dims(int BH, int S, int dh) {
  return Dims{BH, S, dh, (S + L - 1) / L, dh / T};
}

// ------------------------------------------------------------------------
// cp.async
// ------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (4) bytes global -> shared without waiting; zeros when !valid (src is
// then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest `N` has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a 64 x 64 tile of a row-major matrix (row stride ld floats, rows
// past nrows zero) into shared memory with row stride `stride`.
__device__ __forceinline__ void copy_tile(float* sm, int stride,
                                          const float* __restrict__ g,
                                          size_t ld, int nrows) {
  for (int e = threadIdx.x; e < L * (T / 4); e += NTH) {
    const int r = e >> 4, c = (e & 15) * 4;
    const bool ok = r < nrows;
    cp_async_16(sm + r * stride + c, g + (size_t)(ok ? r : 0) * ld + c, ok);
  }
}

// Copy 64 per-token floats (entries past n zero) into shared memory.
__device__ __forceinline__ void copy_vec(float* sm, const float* __restrict__ g,
                                         int n) {
  if (threadIdx.x < L) {
    const bool ok = (int)threadIdx.x < n;
    cp_async_4(sm + threadIdx.x, g + (ok ? threadIdx.x : 0), ok);
  }
}

// ------------------------------------------------------------------------
// split-TF32 products
// ------------------------------------------------------------------------
// hi: x with its 13 low bits cleared (TF32, truncated); lo = x - hi,
// exact in fp32, whose 13 low bits the tensor cores drop in turn
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile, TF32 operands, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b for one m16n8k8 tile, no accumulator in
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The warp's 32 x 32 accumulator: acc[mt][nt][e] is the entry at row
// wrow() + 16 mt + g + 8 (e / 2), column wcol() + 8 nt + 2 c + e % 2, with
// g = lane / 4, c = lane % 4 (the m16n8 accumulator layout).
using Acc = float[2][4][4];

__device__ __forceinline__ int wrow() { return (threadIdx.x >> 6) * 32; }
__device__ __forceinline__ int wcol() { return ((threadIdx.x >> 5) & 1) * 32; }

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// f(mt, nt, e, row, col) for each pair of neighbouring entries the thread
// holds: acc[mt][nt][e] at (row, col) and acc[mt][nt][e + 1] at (row,
// col + 1), e in {0, 2}
template <typename F>
__device__ __forceinline__ void pairs(F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mt, nt, 2 * h, wrow() + 16 * mt + g + 8 * h,
          wcol() + 8 * nt + 2 * c);
}

// acc += A B over one 64-deep slab: the block's 64 x 64 product, each warp
// its 32 x 32 part.  A (64 x 64, m x k) lies at a[m * lda + k] when AK (its
// rows run along k) and at a[k * lda + m] otherwise; B (k x n) at
// b[n * ldb + k] when BK and at b[k * ldb + n] otherwise.  ka / kb, where
// given, scale A's column k / B's row k before the split.  The tensor
// cores sum into their accumulator with truncation, which over a long
// chain biases the sum toward zero, so each 8-deep k-step's three products
// go into a fresh accumulator that is then added to acc in fp32, rounded
// to nearest (one accumulator over a 64-deep slab failed phase 11's AdamW
// parity on the card).
template <bool AK, bool BK>
__device__ __forceinline__ void mma_slab(Acc& acc, const float* a, int lda,
                                         const float* b, int ldb,
                                         const float* ka, const float* kb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int m0 = wrow(), n0 = wcol();
#pragma unroll
  for (int k0 = 0; k0 < T; k0 += 8) {
    const float sa0 = ka ? ka[k0 + c] : 1.f, sa1 = ka ? ka[k0 + c + 4] : 1.f;
    const float sb0 = kb ? kb[k0 + c] : 1.f, sb1 = kb ? kb[k0 + c + 4] : 1.f;
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * mt + g + 8 * (e & 1);
        const int k = k0 + c + 4 * (e >> 1);
        const float x = AK ? a[m * lda + k] : a[k * lda + m];
        split(x * ((e >> 1) ? sa1 : sa0), ah[mt][e], al[mt][e]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * nt + g, k = k0 + c + 4 * e;
        const float x = BK ? b[n * ldb + k] : b[k * ldb + n];
        split(x * (e ? sb1 : sb0), bh[nt][e], bl[nt][e]);
      }
    Acc t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32_fresh(t[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(t[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(t[mt][nt], ah[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[mt][nt][e];
  }
}

// acc += sum over k-tiles kt < nk of A_kt B_kt through the two-stage ring
// (four slots of SLOT floats at ring): load(kt, a, b) issues the cp.async
// copies of k-tile kt's operands into slots a and b; A is read with row
// stride lda and B with ldb, as mma_slab takes them.  Every thread calls
// it; it ends with a barrier, so the ring may be refilled at once.
template <bool AK, bool BK, typename Load>
__device__ __forceinline__ void mma_ring(Acc& acc, float* ring, int nk,
                                         int lda, int ldb, Load load) {
  if (nk <= 0) return;
  load(0, ring, ring + SLOT);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    float* a = ring + (kt & 1) * 2 * SLOT;
    if (kt + 1 < nk) {
      float* na = ring + ((kt + 1) & 1) * 2 * SLOT;
      load(kt + 1, na, na + SLOT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mma_slab<AK, BK>(acc, a, lda, a + SLOT, ldb, nullptr, nullptr);
    __syncthreads();
  }
}

// ------------------------------------------------------------------------
// reductions
// ------------------------------------------------------------------------
// Sum of v over the block; every thread gets it.  red holds NTH / 32
// floats; the trailing barrier lets the caller reuse it at once.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int nw = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Row sums over the block's 64 x 64 tile of f(mt, nt, e, row, col), the
// contribution of one pair of entries as ``pairs`` visits them: rows[r]
// for r < 64 (shared; part is 2 x 64 floats of shared scratch).  Every
// thread calls it; it ends with a barrier.
template <typename F>
__device__ __forceinline__ void row_sums(F f, float* part, float* rows) {
  float s[2][2] = {};
  pairs([&](int mt, int nt, int e, int r, int col) {
    s[mt][e >> 1] += f(mt, nt, e, r, col);
  });
  const int lane = threadIdx.x & 31, g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = s[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0)
        part[(wcol() >> 5) * L + wrow() + 16 * mt + g + 8 * h] = v;
    }
  __syncthreads();
  if (threadIdx.x < L)
    rows[threadIdx.x] = part[threadIdx.x] + part[L + threadIdx.x];
  __syncthreads();
}

// Stores the pairs of the block's tile at rows < nrows into the row-major
// matrix at out (row stride ld): out[row][col] = f(mt, nt, e, row, col).
template <typename F>
__device__ __forceinline__ void store_rows(float* __restrict__ out, size_t ld,
                                           int nrows, F f) {
  pairs([&](int mt, int nt, int e, int r, int col) {
    if (r < nrows)
      *reinterpret_cast<float2*>(out + (size_t)r * ld + col) =
          f(mt, nt, e, r, col);
  });
}

// Scalar gate terms of every token and chunk (see ref.chunk_gates):
// gates = [b | m | w | u], each (BH, S), then wstate (BH, nC).
int launch_gates(const float* logi, const float* logf, float* gates, Dims d,
                 cudaStream_t st);

// Snapshots of the carried state before each chunk's update, in scan order
// (see ref._state_scan).  reverse = 0: C_c and n_c (X = k, Y = v, cx = u,
// cy = cn = 1, passed as nullptr).  reverse = 1: dL/dC_{c+1}, dL/dn_{c+1}
// (X = q, Y = dh, cx = w, cy = 1/den, cn = alpha), and the partial sums of
// <dC_{c+1}, C_c> + <dn_{c+1}, n_c> per tile into dwsp (BH, nC, nT, nT).
int launch_scan(int reverse, const float* X, const float* Y, const float* cx,
                const float* cy, const float* cn, const float* wstate,
                float* snap, float* nsnap, const float* Cst, const float* nst,
                float* dwsp, Dims d, cudaStream_t st);

// Per chunk: S = (Q K^T) o P and the denominators.  Forward (bwd = 0):
// writes S (BH, nC, L, L) and den (BH, S).  Backward (bwd = 1): also dA and
// 1/den, alpha, and the row and column sums of dD (see
// ref.mlstm_chunkwise_bwd).
int launch_intra(int bwd, const float* q, const float* k, const float* v,
                 const float* g, const float* h, const float* logi,
                 const float* gates, const float* nst, float* Smat,
                 float* dAmat, float* den, float* alpha, float* rowD,
                 float* colD, Dims d, cudaStream_t st);

// Registers, local (spill) bytes and static shared bytes of the backward's
// own stage kernels dqk (0) and dv (1) into out[0..2] (cudaFuncGetAttributes).
int bwd_stage_attrs(int which, int* out);

}  // namespace mlstm
