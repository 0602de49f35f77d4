// Flash attention, backward (causal or not, grouped-query), for Hopper
// (sm_90a); plain C interface for ctypes.
//
// The gradient of the function flash_attention.cu computes.  The Pallas
// kernel kernels/flash_attention/flash_attention.py::flash_attention has
// no backward (pallas_call has no transpose); these kernels follow the
// decomposition ref.attention_bwd_ref writes out in plain PyTorch.  With
// the scores s = (q * scale) . k, the forward's row log-sum-exp lse and the
// upstream gradient dO:
//     P = exp(s - lse),  D = rowsum(dO o O),  dP = dO V^T,
//     dS = P o (dP - D),  dV = P^T dO,  dK = dS^T (Q * scale),
//     dQ = dS K * scale,
// where the causal mask (k <= q + off, the diagonal offset the forward
// took) and the ragged tiles give P = 0.
//
// Three kernels, each deterministic (no atomics: every gradient element is
// summed by one thread in a fixed order):
//   1. dot: D = rowsum(dO o O) in fp32, one warp per (batch, row, head);
//   2. dkv: dK and dV of one KV head's key tile.  It keeps its K and V
//      tiles in shared memory and loops over the G = H / KV query heads of
//      its group and over the query tiles that see its keys, accumulating
//      dK and dV in registers: GQA's sum over the group needs no atomics;
//   3. dq: one block per (batch, head, query tile), looping over the K
//      tiles its rows see, as the forward does.
// flash_attention_bwd picks the kernels by dtype.
//
// Bound: operations.  Five products of the unmasked (q, k) pairs (S, dP,
// dV, dK, dQ), 2 hd flops each per pair and head: 85.9 GFLOP at jamba's
// attention shape (B 1, S 2048, 32 heads of 128, causal), 0.087 ms at the
// dense bf16 tensor rate (989 TFLOP/s).  Keeping dQ free of atomics costs
// two more (dq recomputes S and dP): the kernels do 7/5 of the bound's
// products.
//
// bf16 (bf16 training): flash_bwd_dkv_tc_kernel and flash_bwd_dq_tc_kernel,
// FlashAttention-2's decomposition on the tensor cores.  Every product is an
// mma.sync m16n8k16 (bf16 operands, fp32 sums) whose fragments ldmatrix
// loads from shared memory; the products that contract over rows (P^T dO,
// dS^T Q, dS K) read their B operand with ldmatrix.trans, so no tile is
// ever copied transposed.  Tiles are bf16, rows hd + 8 elements apart (no
// bank conflicts, see flash_attention.cuh), copied by cp.async into two
// stages so the next tile lands while this one is used.  P and dS go from
// the accumulators of S and dP to the A operands of the next products in
// registers, rounded to bf16 (P from exp2f of log2(e)-scaled scores); D,
// lse, P before rounding and every sum stay fp32, and the scale multiplies
// the fp32 sums.
//   * dkv: 64 keys per block, two warpgroups of 4 warps; warp w of each
//     owns keys 16 w .. 16 w + 15 and computes S^T = K Q^T and dP^T = V dO^T
//     for 16 queries at a time.  The block's (query head, 64-row query
//     tile) items alternate between the groups, each with its own two
//     q / dO stages and its own named barrier; at the end group 1 hands
//     its dK and dV to group 0 through shared memory in a fixed order.
//     Load balance: under a causal mask K tile i sees n - i query tiles;
//     blocks are numbered K tile first, so the heaviest tiles of every
//     head start first and the light ones fill in behind them (longest
//     first), one 8-warp block per SM.
//   * dq: 64 query rows per block, 4 warps of 16; q and dO stay in
//     registers as A operands; S and dP for 16 keys at a time, then
//     dQ += dS K.
//
// fp32 (the parity phases, whose 1e-4 tolerance rules out TF32):
// flash_bwd_dkv_kernel and flash_bwd_dq_kernel, fp32 FMAs.  Both recompute
// S and dP for their (64 x 64) tile with the forward's 16 x 16 thread grid
// (thread (ty, tx) owns rows ty + 16 r and columns tx + 16 c), pass P or dS
// through shared memory to the products that contract over the other
// index, and keep fp32 throughout; the gradients are written in the input
// dtype.  At head size 128 a block needs 149 KB of shared memory (four
// fp32 row tiles and one 64 x 64 tile), so it is dynamic, set on every
// launch.  Bounded by the fp32 rate (67 TFLOP/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int S, int heads, int hh, int hd,
                                          float mul) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    dst[r * QS + d] = s < S && d < hd
                          ? src[((size_t)s * heads + hh) * hd + d] * mul
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

template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int hd, float scale, int causal, int off) {
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
  const int G = H / KV;

  load_rows<HD>(sk, k + (size_t)b * Sk * KV * hd, k0, Sk, KV, kvh, hd,
                   1.0f);
  load_rows<HD>(sv, v + (size_t)b * Sk * KV * hd, k0, Sk, KV, kvh, hd,
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
      load_rows<HD>(sq, q + qoff, q0, Sq, H, h, hd, scale);
      load_rows<HD>(sdo, dout + qoff, q0, Sq, H, h, hd, 1.0f);
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
        dk[o + tx + 16 * c] = dK[r][c];
        dv[o + tx + 16 * c] = dV[r][c];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd, float scale,
    int causal, int off) {
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
  const int kvh = h / (H / KV);
  const size_t qoff = (size_t)b * Sq * H * hd;
  const size_t koff = (size_t)b * Sk * KV * hd;

  load_rows<HD>(sq, q + qoff, q0, Sq, H, h, hd, scale);
  load_rows<HD>(sdo, dout + qoff, q0, Sq, H, h, hd, 1.0f);
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
    load_rows<HD>(sk, k + koff, k0, Sk, KV, kvh, hd, 1.0f);
    load_rows<HD>(sv, v + koff, k0, Sk, KV, kvh, hd, 1.0f);
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
    float* o = dq + (((size_t)b * Sq + s) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < hd) o[tx + 16 * c] = dQ[r][c] * scale;
  }
}

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------
constexpr int UK = 64;   // keys per dkv block: 4 warps of 16 in each group
constexpr int UQ = 64;   // query rows per tile (dq: 4 warps of 16)

template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return UQ * (HD + 8) * 2;
}
// one stage of a dkv warpgroup: q and dO tiles, lse and D of their rows
template <int HD>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * tile_bytes<HD>() + 2 * UQ * 4;
}
template <int HD>
constexpr int dkv_tc_smem_bytes() {
  // k and v tiles, then two stages for each of the two warpgroups
  return 2 * tile_bytes<HD>() + 4 * stage_bytes<HD>();
}
template <int HD>
constexpr int dq_tc_smem_bytes() {
  // q and dO tiles, lse and D, then two stages of k and v tiles
  return 2 * tile_bytes<HD>() + 2 * UQ * 4 + 4 * tile_bytes<HD>();
}

// dK and dV of 64 keys of one KV head.  Two warpgroups of 4 warps; warp w
// of each owns keys 16 w .. 16 w + 15 of the tile.  The (query head,
// query tile) items of the block alternate between the two groups, each
// with its own double-buffered q / dO stages; at the end group 1 hands its
// sums to group 0 through shared memory, in a fixed order.  Blocks are
// numbered K tile first, so under a causal mask the K tiles that see the
// most queries start first and the short ones fill in behind them.
template <int HD>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq, int Sk,
    int H, int KV, int hd, float scale, float scale_log2, int causal,
    int off) {
  constexpr int SR = HD + 8, NKD = HD / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + UK * SR;
  unsigned char* stages = smem_raw + 2 * tile_bytes<HD>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w = warp & 3, tg = tid & 127;
  const int kt = blockIdx.x / (KV * B), rest = blockIdx.x % (KV * B);
  const int kvh = rest % KV, b = rest / KV;
  const int k0 = kt * UK, G = H / KV;
  // query rows i see this tile's keys where i + off >= k0
  const int qt0 = causal ? max(0, k0 - off) / UQ : 0;
  const int per_head = max(0, (Sq + UQ - 1) / UQ - qt0);
  const int n_items = G * per_head;
  const size_t qrow = (size_t)H * hd;

  auto stage = [&](int s) { return stages + (2 * wg + s) * stage_bytes<HD>(); };
  auto load_item = [&](int it, int s) {
    const int hh = kvh * G + it / per_head, q0 = (qt0 + it % per_head) * UQ;
    unsigned char* st = stage(s);
    const size_t base = ((size_t)b * Sq * H + hh) * hd;
    load_tile_async<UQ, HD, 128>(reinterpret_cast<bf16*>(st), q + base, q0,
                                 Sq, qrow, hd, tg);
    load_tile_async<UQ, HD, 128>(
        reinterpret_cast<bf16*>(st + tile_bytes<HD>()), dout + base, q0, Sq,
        qrow, hd, tg);
    if (tg < UQ) {
      float* sl = reinterpret_cast<float*>(st + 2 * tile_bytes<HD>());
      const bool in = q0 + tg < Sq;
      const size_t i = ((size_t)b * H + hh) * Sq + q0 + tg;
      cp_async_4(sl + tg, in ? lse + i : lse, in);
      cp_async_4(sl + UQ + tg, in ? D + i : D, in);
    }
  };

  const size_t kbase = ((size_t)b * Sk * KV + kvh) * hd;
  load_tile_async<UK, HD, 256>(sk, k + kbase, k0, Sk, (size_t)KV * hd, hd,
                               tid);
  load_tile_async<UK, HD, 256>(sv, v + kbase, k0, Sk, (size_t)KV * hd, hd,
                               tid);
  if (wg < n_items) load_item(wg, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int key0 = k0 + w * 16 + (lane >> 2);  // keys key0, key0 + 8
  float dK[NO][4], dV[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[j][e] = dV[j][e] = 0.0f;

  int s = 0;
  for (int it = wg; it < n_items; it += 2, s ^= 1) {
    const bool more = it + 2 < n_items;
    if (more) {  // the group's next item streams in under this one
      load_item(it + 2, s ^ 1);
      cp_async_commit();
    }
    const int q0 = (qt0 + it % per_head) * UQ;
    const unsigned char* st = stage(s);
    const bf16* sq = reinterpret_cast<const bf16*>(st);
    const bf16* sdo = reinterpret_cast<const bf16*>(st + tile_bytes<HD>());
    const float* slse =
        reinterpret_cast<const float*>(st + 2 * tile_bytes<HD>());
    const float* sD = slse + UQ;
#pragma unroll
    for (int sub = 0; sub < UQ / 16; ++sub) {
      const int qs = q0 + sub * 16;
      if (qs >= Sq) break;
      // every key of this warp comes after every query of this sub-tile
      if (causal && k0 + w * 16 > qs + 15 + off) continue;
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 16 queries
      float sT[2][4] = {}, dpT[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        uint32_t ak[4], av[4], bq[4], bo[4];
        ldsm_x4(ak, sk + ldsm_a(SR, w * 16, kk * 16, lane));
        ldsm_x4(av, sv + ldsm_a(SR, w * 16, kk * 16, lane));
        ldsm_x4(bq, sq + ldsm_b_rows(SR, sub * 16, kk * 16, lane));
        ldsm_x4(bo, sdo + ldsm_b_rows(SR, sub * 16, kk * 16, lane));
        mma_bf16(sT[0], ak, bq[0], bq[1]);
        mma_bf16(sT[1], ak, bq[2], bq[3]);
        mma_bf16(dpT[0], av, bo[0], bo[1]);
        mma_bf16(dpT[1], av, bo[2], bo[3]);
      }
      // P^T = exp(S^T scale - lse), dS^T = P^T o (dP^T - D); columns are
      // queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ci = sub * 16 + 8 * j + 2 * (lane & 3);
        const float2 L = *reinterpret_cast<const float2*>(slse + ci);
        const float2 Dd = *reinterpret_cast<const float2*>(sD + ci);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8, qq = q0 + ci + (e & 1);
          const bool masked =
              qq >= Sq || key >= Sk || (causal && key > qq + off);
          const float lq = e & 1 ? L.y : L.x, Dq = e & 1 ? Dd.y : Dd.x;
          const float p =
              masked ? 0.0f : exp2f(sT[j][e] * scale_log2 - lq * LOG2E);
          dpT[j][e] = p * (dpT[j][e] - Dq);
          sT[j][e] = p;
        }
      }
      // dV += P^T dO, dK += dS^T Q: the A operands from registers, dO and
      // Q by ldmatrix.trans
      uint32_t ap[4], ads[4];
      acc_to_a(ap, sT[0], sT[1]);
      acc_to_a(ads, dpT[0], dpT[1]);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, sdo + ldsm_b_cols(SR, sub * 16, nn * 16, lane));
        mma_bf16(dV[2 * nn], ap, bo[0], bo[1]);
        mma_bf16(dV[2 * nn + 1], ap, bo[2], bo[3]);
        ldsm_x4_t(bq, sq + ldsm_b_cols(SR, sub * 16, nn * 16, lane));
        mma_bf16(dK[2 * nn], ads, bq[0], bq[1]);
        mma_bf16(dK[2 * nn + 1], ads, bq[2], bq[3]);
      }
    }
    if (more) cp_async_wait_all();
    warpgroup_barrier(1 + wg);  // stage s consumed, stage s ^ 1 in place
  }

  // group 1's sums to group 0, thread by thread, then the store
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(j * 4 + e) * 128 + tg] = dK[j][e];
        red[((NO + j) * 4 + e) * 128 + tg] = dV[j][e];
      }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const size_t o = (((size_t)b * Sk + key) * KV + kvh) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= hd) continue;
      const int e = 2 * r;
      const float* rk = red + (j * 4 + e) * 128 + tg;
      const float* rv = red + ((NO + j) * 4 + e) * 128 + tg;
      const float k0v = (dK[j][e] + rk[0]) * scale;
      const float k1v = (dK[j][e + 1] + rk[128]) * scale;
      const float v0 = dV[j][e] + rv[0];
      const float v1 = dV[j][e + 1] + rv[128];
      *reinterpret_cast<__nv_bfloat162*>(dk + o + col) =
          __floats2bfloat162_rn(k0v, k1v);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// dQ of 64 query rows of one head: 4 warps of 16 rows, looping over the K
// tiles those rows see (two stages of k and v tiles), the last query tiles
// first.  q and dO stay in registers as A operands.
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd,
    float scale, float scale_log2, int causal, int off) {
  constexpr int SR = HD + 8, NKD = HD / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + UQ * SR;
  float* slse = reinterpret_cast<float*>(sdo + UQ * SR);
  float* sD = slse + UQ;
  bf16* sk = reinterpret_cast<bf16*>(sD + UQ);   // two stages
  bf16* sv = sk + 2 * UK * SR;                   // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // query tiles vary slowest, the last (which see the most keys under a
  // causal mask) first: the heaviest blocks of every head start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * UQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const size_t qbase = ((size_t)b * Sq * H + h) * hd;
  const size_t kbase = ((size_t)b * Sk * KV + kvh) * hd;
  const size_t kstride = (size_t)KV * hd;
  const int k_end = causal ? min(Sk, min(q0 + UQ, Sq) + off) : Sk;
  const int nk = k_end > 0 ? (k_end + UK - 1) / UK : 0;

  load_tile_async<UQ, HD, 128>(sq, q + qbase, q0, Sq, (size_t)H * hd, hd, tid);
  load_tile_async<UQ, HD, 128>(sdo, dout + qbase, q0, Sq, (size_t)H * hd, hd,
                               tid);
  if (tid < UQ) {
    const bool in = q0 + tid < Sq;
    const size_t i = ((size_t)b * H + h) * Sq + q0 + tid;
    cp_async_4(slse + tid, in ? lse + i : lse, in);
    cp_async_4(sD + tid, in ? D + i : D, in);
  }
  load_tile_async<UK, HD, 128>(sk, k + kbase, 0, Sk, kstride, hd, tid);
  load_tile_async<UK, HD, 128>(sv, v + kbase, 0, Sk, kstride, hd, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int wq0 = q0 + warp * 16;
  const int row0 = wq0 + (lane >> 2);  // rows row0, row0 + 8
  uint32_t aq[NKD][4], ado[NKD][4];
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk) {
    ldsm_x4(aq[kk], sq + ldsm_a(SR, warp * 16, kk * 16, lane));
    ldsm_x4(ado[kk], sdo + ldsm_a(SR, warp * 16, kk * 16, lane));
  }
  float L[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    L[r] = slse[warp * 16 + (lane >> 2) + 8 * r] * LOG2E;
    Dr[r] = sD[warp * 16 + (lane >> 2) + 8 * r];
  }
  float dQ[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dQ[j][0] = dQ[j][1] = dQ[j][2] = dQ[j][3] = 0.0f;

  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    if (t + 1 < nk) {
      load_tile_async<UK, HD, 128>(sk + (st ^ 1) * UK * SR, k + kbase,
                                   (t + 1) * UK, Sk, kstride, hd, tid);
      load_tile_async<UK, HD, 128>(sv + (st ^ 1) * UK * SR, v + kbase,
                                   (t + 1) * UK, Sk, kstride, hd, tid);
      cp_async_commit();
    }
    const bf16* ks = sk + st * UK * SR;
    const bf16* vs = sv + st * UK * SR;
    const int k0 = t * UK;
#pragma unroll
    for (int sub = 0; sub < UK / 16; ++sub) {
      const int kc = k0 + sub * 16;
      // this and the later sub-tiles come after every row of the warp
      if (kc >= Sk || (causal && kc > wq0 + 15 + off)) break;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, ks + ldsm_b_rows(SR, sub * 16, kk * 16, lane));
        ldsm_x4(bv, vs + ldsm_b_rows(SR, sub * 16, kk * 16, lane));
        mma_bf16(s[0], aq[kk], bk[0], bk[1]);
        mma_bf16(s[1], aq[kk], bk[2], bk[3]);
        mma_bf16(dp[0], ado[kk], bv[0], bv[1]);
        mma_bf16(dp[1], ado[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int key = kc + 8 * j + 2 * (lane & 3) + (e & 1);
          const bool masked =
              row >= Sq || key >= Sk || (causal && key > row + off);
          const float p =
              masked ? 0.0f : exp2f(s[j][e] * scale_log2 - L[e >> 1]);
          dp[j][e] = p * (dp[j][e] - Dr[e >> 1]);
        }
      // dQ += dS K: dS in registers, K by ldmatrix.trans
      uint32_t ads[4];
      acc_to_a(ads, dp[0], dp[1]);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t bk[4];
        ldsm_x4_t(bk, ks + ldsm_b_cols(SR, sub * 16, nn * 16, lane));
        mma_bf16(dQ[2 * nn], ads, bk[0], bk[1]);
        mma_bf16(dQ[2 * nn + 1], ads, bk[2], bk[3]);
      }
    }
    if (t + 1 < nk) cp_async_wait_all();
    __syncthreads();  // tile t consumed, tile t + 1 in place
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* orow = dq + (((size_t)b * Sq + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            dQ[j][2 * r] * scale, dQ[j][2 * r + 1] * scale);
    }
  }
}

template <int HD>
int launch_bwd_tc(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* out, const bf16* dout, const float* lse,
                  float* D, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
                  int Sk, int H, int KV, int hd, float scale, int causal,
                  int off, cudaStream_t st) {
  constexpr int dkv_bytes = dkv_tc_smem_bytes<HD>();
  constexpr int dq_bytes = dq_tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  flash_bwd_dot_kernel<bf16><<<(rows + 7) / 8, 256, 0, st>>>(
      out, dout, D, rows, Sq, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dkv_tc_kernel<HD><<<((Sk + UK - 1) / UK) * KV * B, 256,
                                dkv_bytes, st>>>(
      q, k, v, dout, lse, D, dk, dv, B, Sq, Sk, H, KV, hd, scale, scale_log2,
      causal, off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 qgrid(H, B, (Sq + UQ - 1) / UQ);
  flash_bwd_dq_tc_kernel<HD><<<qgrid, 128, dq_bytes,
                               st>>>(q, k, v, dout, lse, D, dq, Sq, Sk, H, KV,
                                     hd, scale, scale_log2, causal, off);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* out, const float* dout, const float* lse,
               float* D, float* dq, float* dk, float* dv, int B, int Sq,
               int Sk, int H, int KV, int hd, float scale, int causal,
               int off, cudaStream_t st) {
  constexpr int bytes = bwd_smem_bytes<HD>();
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  flash_bwd_dot_kernel<float><<<(rows + 7) / 8, 256, 0, st>>>(
      out, dout, D, rows, Sq, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<HD><<<dim3((Sk + BK - 1) / BK, KV, B), NTHREADS, bytes,
                             st>>>(q, k, v, dout, lse, D, dk, dv, Sq, Sk, H,
                                   KV, hd, scale, causal, off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD><<<dim3((Sq + BQ - 1) / BQ, H, B), NTHREADS, bytes,
                            st>>>(q, k, v, dout, lse, D, dq, Sq, Sk, H, KV,
                                  hd, scale, causal, off);
  return (int)cudaGetLastError();
}

int dispatch_bwd(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, void* D, void* dq,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                 int hd, float scale, int causal, int off, cudaStream_t st) {
  FLASH_DISPATCH_HD(hd, return launch_bwd<HDT>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(D), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, Sq, Sk, H, KV, hd, scale, causal, off,
      st))
}

}  // namespace

extern "C" {

// q, out, dout and dq (B, Sq, H, hd), k, v, dk and dv (B, Sk, KV, hd), all
// fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), contiguous; lse (B, H, Sq)
// fp32 from the forward; D scratch of B * H * Sq floats.  The shapes,
// scale and diagonal offset the forward took.  Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* D, void* dq, void* dk, void* dv, int B, int Sq,
                        int Sk, int H, int KV, int hd, float scale,
                        int is_bf16, int causal, int off, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return dispatch_bwd(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Sk, H,
                        KV, hd, scale, causal, off, st);
  // the bf16 kernels copy 16-byte chunks
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  FLASH_DISPATCH_HD(hd, return launch_bwd_tc<HDT>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(D), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, Sq, Sk, H, KV, hd, scale, causal, off, st))
}

// dynamic shared memory of one block of the backward's dkv (which = 0) or
// dq (which = 1) kernel at head size hd, fp32 or bf16 (-1: unsupported)
int flash_attention_bwd_smem_bytes(int hd, int is_bf16, int which) {
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  FLASH_DISPATCH_HD(hd, return !is_bf16 ? bwd_smem_bytes<HDT>()
                               : which ? dq_tc_smem_bytes<HDT>()
                                       : dkv_tc_smem_bytes<HDT>())
}

// registers per thread, local memory (spills) and static shared memory of
// the backward's dkv (which = 0) or dq (which = 1) kernel at head size hd,
// fp32 or bf16, into out[0..2] (cudaFuncGetAttributes).  Returns a
// cudaError_t.
int flash_attention_bwd_attrs(int hd, int is_bf16, int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  FLASH_DISPATCH_HD(
      hd, err = !is_bf16 ? (which ? cudaFuncGetAttributes(
                                        &a, flash_bwd_dq_kernel<HDT>)
                                  : cudaFuncGetAttributes(
                                        &a, flash_bwd_dkv_kernel<HDT>))
                : which ? cudaFuncGetAttributes(&a, flash_bwd_dq_tc_kernel<HDT>)
                        : cudaFuncGetAttributes(&a,
                                                flash_bwd_dkv_tc_kernel<HDT>);
      if (err == cudaSuccess) {
        out[0] = a.numRegs;
        out[1] = (int)a.localSizeBytes;
        out[2] = (int)a.sharedSizeBytes;
      } return (int)err)
}

}  // extern "C"
