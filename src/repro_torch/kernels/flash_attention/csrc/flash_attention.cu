// Flash attention (causal or not, grouped-query) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces kernels/flash_attention/flash_attention.py::flash_attention (the
// TPU kernel _flash_kernel): for every batch row b, query head h and query
// position i,
//     out[b, i, h] = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j
// over the keys j of KV head h / G (G = H / KV) that the mask lets through,
// with the running max m, the running sum l and the accumulator in fp32, and
// the output written in the input dtype.  The KV head is read in place,
// never copied out to H heads.  The causal mask lets key j through to
// query i where j <= i + off, for the diagonal offset off the caller gives:
// Sk - Sq (bottom-right, as the plain version (ref.py) and the JAX
// package's oracle align it; the Pallas kernel masks j <= i, which is the
// same thing on every unsharded call the model makes, Sq == Sk) or, for
// one rank's shard of the rows or the keys, that offset moved by the
// shard's start (models/attention.py).  An offset may leave a row no key:
// its output is 0 and its log-sum-exp +inf.  q, k, v and out stay in the
// model's (B, S, heads, hd) layout, so the wrapper transposes nothing.
// Given a pointer for it, a kernel also writes each row's log-sum-exp of
// the scaled scores, lse = m + log l (B, H, Sq) fp32, which the backward
// (flash_attention_bwd.cu) reads to recompute P; serving passes none.
// flash_attention_fwd picks the kernel by dtype:
//
// bf16 (serving, bf16 training): flash_wg_kernel, on the tensor cores.
// Bound: operations, 4 hd flops per unmasked (q, k) pair and head at the
// dense bf16 tensor rate (989 TFLOP/s): 0.104 ms at phi3-mini's prefill
// shape.  Every product is a wgmma (bf16 operands, fp32 sums) fed by TMA,
// and the block is split by role.  One block of 288 threads takes one
// (batch row, query head, 128-row query tile), the last tiles first:
//   * a producer warp, one of whose threads issues the copies: the q tile
//     once, then 64-key K and V tiles into two-stage rings, each a TMA copy
//     (cp.async.bulk.tensor through a 4-d tensor map over (hd, heads, S, B),
//     built on the host by cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint so nothing links libcuda) that completes on a
//     "full" mbarrier, and refills a stage when both consumers have
//     arrived on its "empty" mbarrier;
//   * two consumer warpgroups of 64 query rows.  Each computes S = Q K^T
//     with wgmma m64n64k16 from shared memory (both operands K-major, in
//     the 128-byte swizzle TMA writes: a 128-byte row holds 64 columns, so
//     hd > 64 takes two boxes per tile), then the online softmax in the
//     accumulator registers (exp2f of scores scaled by log2(e) / sqrt(hd),
//     m and l in fp32, l summed from the fp32 P), rounds P to bf16 in
//     registers and feeds it as wgmma's A operand for O += P V (m64 n=hd
//     k16), V read MN-major through the transpose bit that 16-bit types
//     allow.  P never touches shared memory.  A group skips the K tiles
//     whose keys all follow its rows (it still releases them).
// Rows and keys past the tensor's ends, and the columns of a 64-column box
// past hd, load as zeros (TMA's out-of-bounds fill), so any length and any
// head size that is a multiple of 8 up to 128 runs the same code, the
// product's depth padded to 16 with zeros; ragged keys are masked to
// -inf.  A wait on an mbarrier traps after ~10 s, so a copy that never
// lands is a launch error, not a hang.  Measured on an H100 at 700 W
// (chip_smoke.py phase 2): ~280 TFLOP/s at phi3's shape, ~355 at
// yi-34b's; what keeps it from the bound is that each group waits for its
// S product before the softmax and for P V before the next S (no overlap
// of the softmax with the tensor cores inside a group; the two groups of
// a block and the producer's copies do overlap).
//
// fp32 (the parity phases, whose 2e-5 tolerance rules out TF32):
// flash_kernel, fp32 FMAs on a 16 x 16 thread grid.  One block of 256
// threads takes one (batch row, query head, 64-row query tile) and stages
// its q tile (pre-scaled by 1/sqrt(hd), as the Pallas kernel does) and
// then one 64-row K/V tile after another in shared memory.  Thread (ty, tx)
// owns query rows ty + 16 r (r < 4) and key columns tx + 16 c (c < 4) of the
// score tile, and output columns tx + 16 c (c < hd / 16) of its four rows,
// so a row's max and sum reduce over 16 lanes of one half-warp with
// shuffles and its m and l stay in registers.  P goes through shared
// memory in fp32 to the P.V product.  Key tiles wholly above the causal
// diagonal are never loaded; the ragged last q and k tiles are masked.
// Row strides of q and k in shared memory are padded to hd + 1 floats, so
// the column reads of k and the row reads of q hit distinct banks.  It is
// bounded by the fp32 rate (67 TFLOP/s) and uses accurate expf: the
// numerics of the Pallas kernel.
//
// Head sizes: both kernels are templated on the tile width HD in {32, 64,
// 96, 128} and take any head size hd <= HD that is a multiple of 8 (the
// model's full configs use 64, 96 and 128; reduced test configs 8 to 24):
// columns past hd load as zeros, which leaves every dot product as it is,
// and are not stored.
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <int HD>
constexpr int smem_bytes() {
  // q (BQ x HD+1), k (BK x HD+1), v (BK x HD), p (BQ x BK+1), all fp32
  return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) * 4;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse,
    int Sq, int Sk, int H, int KV, int hd, float scale, int causal,
    int off) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1, PS = BK + 1, NC = HD / 16;
  float* sq = smem;
  float* sk = sq + BQ * QS;
  float* sv = sk + BK * QS;
  float* sp = sv + BK * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  const size_t qstride = (size_t)H * hd, kstride = (size_t)KV * hd;
  const float* qb = q + ((size_t)b * Sq * H + h) * hd;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * hd;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * hd;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    sq[r * QS + d] = s < Sq && d < hd
                         ? qb[(size_t)s * qstride + d] * scale
                         : 0.0f;
  }

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  // keys past k_end are masked for every row of this tile
  const int k_end = causal ? min(Sk, min(q0 + BQ, Sq) + off) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD, d = i % HD;
      const int s = k0 + r;
      const bool in = s < Sk && d < hd;
      sk[r * QS + d] = in ? kb[(size_t)s * kstride + d] : 0.0f;
      sv[r * HD + d] = in ? vb[(size_t)s * kstride + d] : 0.0f;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) sc[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[RQ], bk[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) a[r] = sq[(ty + 16 * r) * QS + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) bk[c] = sk[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) sc[r][c] = fmaf(a[r], bk[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kj = k0 + tx + 16 * c;
        if (kj >= Sk || (causal && kj > qi + off)) sc[r][c] = -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      // a row with no key let through so far keeps l = 0 and acc = 0
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[r] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(sc[r][c] - m_use);
        sp[(ty + 16 * r) * PS + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[r] = corr * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();  // p complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) p[r] = sp[(ty + 16 * r) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sv[kk * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int s = q0 + ty + 16 * r;
    if (s >= Sq) continue;
    if (lse != nullptr && tx == 0)  // a row that saw no key: P = 0
      lse[((size_t)b * H + h) * Sq + s] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : INFINITY;
    const float lm = fmaxf(l[r], 1e-30f);
    float* o = out + (((size_t)b * Sq + s) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < hd) o[tx + 16 * c] = acc[r][c] / lm;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
           float scale, int causal, int off, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk,
      H, KV, hd, scale, causal, off);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// waits for the phase of parity `parity` to complete; traps after ~10 s
// (a lost copy), so a fault surfaces as a launch error, never as a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// one (64 columns x rows) box of a 4-d tensor map at coordinates (c0 .. c3)
// into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// descriptor of a wgmma operand in a 128-byte-swizzled tile (rows of 128
// bytes, 8-row groups of 1024 bytes): start address, leading and stride
// byte offsets
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits for every committed group of this warpgroup
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of d across a wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps A operands in their registers until the wgmma reading them is done
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (m64 n64, fp32) (+)= A B with A and B read from shared memory through
// their descriptors, both K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (m64 n32, fp32) += A B with A (m64 k16, bf16) from registers, each
// warp's 16 rows in the mma.sync A-fragment layout, and B from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 n64, fp32) += A B with A (m64 k16, bf16) from registers, each
// warp's 16 rows in the mma.sync A-fragment layout, and B from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 n96, fp32) += A B with A (m64 k16, bf16) from registers, each
// warp's 16 rows in the mma.sync A-fragment layout, and B from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 n128, fp32) += A B with A (m64 k16, bf16) from registers, each
// warp's 16 rows in the mma.sync A-fragment layout, and B from shared memory,
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, db);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  if constexpr (HD == 96) wgmma_rs_n96(d, a, db);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
}

constexpr int WQ = 128;   // query rows per block: two consumer warpgroups
constexpr int WK = 64;    // keys per stage
constexpr int WST = 2;    // stages of the k and v rings
constexpr int WNT = 288;  // two consumer warpgroups and one producer warp

template <int HD>
struct WgTile {
  static constexpr int NA = (HD + 63) / 64;  // 128-byte column atoms
  static constexpr int Q_BYTES = NA * WQ * 128;
  static constexpr int KV_BYTES = NA * WK * 128;
  // 1024 bytes of slack to align the swizzled tiles, the tiles, the
  // barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * WST * KV_BYTES + 128;
};

template <int HD>
__global__ void __launch_bounds__(WNT, 1) flash_wg_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int hd,
    float scale_log2, int causal, int off) {
  using C = WgTile<HD>;
  constexpr int NO = HD / 8, NS = WK / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + C::Q_BYTES;        // WST stages
  unsigned char* sV = sK + WST * C::KV_BYTES; // WST stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + WST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + WST;
  uint64_t* k_empty = v_full + WST;
  uint64_t* v_empty = k_empty + WST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // query tiles vary slowest, the last (which see the most keys under a
  // causal mask) first: the heaviest blocks of every head start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int k_end = causal ? min(Sk, min(q0 + WQ, Sq) + off) : Sk;
  const int nk = k_end > 0 ? (k_end + WK - 1) / WK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 256);
      mbar_init(v_empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread keeps the rings full
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int a = 0; a < C::NA; ++a)
        tma_load_4d(sQ + a * WQ * 128, &tq, q_full, 64 * a, h, q0, b);
      for (int t = 0; t < nk; ++t) {
        const int s = t % WST;
        const uint32_t par = ((t / WST) & 1) ^ 1;
        if (t >= WST) mbar_wait(k_empty + s, par);
        mbar_expect_tx(k_full + s, C::KV_BYTES);
        for (int a = 0; a < C::NA; ++a)
          tma_load_4d(sK + s * C::KV_BYTES + a * WK * 128, &tk, k_full + s,
                      64 * a, kvh, t * WK, b);
        if (t >= WST) mbar_wait(v_empty + s, par);
        mbar_expect_tx(v_full + s, C::KV_BYTES);
        for (int a = 0; a < C::NA; ++a)
          tma_load_4d(sV + s * C::KV_BYTES + a * WK * 128, &tv, v_full + s,
                      64 * a, kvh, t * WK, b);
      }
    }
    return;
  }

  // consumer warpgroup w takes rows q0 + 64 w .. q0 + 64 w + 63
  const int w = warp >> 2, wi = warp & 3;
  const int rq0 = q0 + 64 * w;
  const int row0 = rq0 + 16 * wi + (lane >> 2);  // rows row0, row0 + 8
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const unsigned char* qa = sQ + w * 64 * 128;

  // S = Q K_t^T, issued: both operands K-major; a k16 step is 32 bytes into
  // the swizzled 128-byte rows, 4 steps to an atom
  auto issue_qk = [&](int t, float (&sc)[WK / 2]) {
    const unsigned char* ks = sK + (t % WST) * C::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc,
                   wg_desc(qa + (kk / 4) * WQ * 128 + (kk % 4) * 32, 16, 1024),
                   wg_desc(ks + (kk / 4) * WK * 128 + (kk % 4) * 32, 16, 1024),
                   kk > 0);
    wg_commit();
  };
  // O += P V_t, issued: P from registers, V MN-major (hd contiguous): its
  // 64-column atoms are WK * 128 bytes apart, its 8-key groups 1024
  auto issue_pv = [&](int t, const uint32_t (&pa)[WK / 16][4]) {
    const unsigned char* vs = sV + (t % WST) * C::KV_BYTES;
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_rs<HD>(o, pa[kk], wg_desc(vs + kk * 16 * 128, WK * 128, 1024));
    wg_commit();
  };
  // the online softmax of tile t's scores: masks them, moves m and l on, and
  // leaves P rounded to bf16 A operands in pa and O's rescale in corr
  auto softmax = [&](int t, float (&sc)[WK / 2], uint32_t (&pa)[WK / 16][4],
                     float (&corr)[2]) {
    const int k0 = t * WK;
    const bool edge =
        k0 + WK > Sk || (causal && k0 + WK - 1 > rq0 + 16 * wi + off);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= Sk || (causal && col > row + off)) x = -INFINITY;
        }
        sc[4 * j + e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no key let through so far keeps l = 0 and o = 0
      const float mu = mx == -INFINITY ? 0.0f : mx;
      corr[r] = exp2f(m[r] - mu);
      m[r] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[4 * j + 2 * r] = exp2f(sc[4 * j + 2 * r] - mu);
        sc[4 * j + 2 * r + 1] = exp2f(sc[4 * j + 2 * r + 1] - mu);
        rs += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      }
      l[r] = l[r] * corr[r] + rs;  // the fp32 P, before rounding
    }
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  // tiles from nk_w on hold only keys after every row of this group: they
  // are waited for and released, not computed (all of them where the
  // group's last row sees no key)
  const int last = rq0 + 63 + off;
  const int nk_w = !causal ? nk : last < 0 ? 0 : min(nk, last / WK + 1);
  float sc[WK / 2], corr[2];
  uint32_t pa[WK / 16][4];
  mbar_wait(q_full, 0);
  for (int t = 0; t < nk_w; ++t) {
    mbar_wait(k_full + t % WST, (t / WST) & 1);
    issue_qk(t, sc);
    wg_wait();
    reg_fence(sc);
    mbar_arrive(k_empty + t % WST);
    softmax(t, sc, pa, corr);
    rescale(corr);
    mbar_wait(v_full + t % WST, (t / WST) & 1);
    issue_pv(t, pa);
    wg_wait();
    reg_fence(o);
    reg_fence(pa);
    mbar_arrive(v_empty + t % WST);
  }
  for (int t = nk_w; t < nk; ++t) {
    mbar_wait(k_full + t % WST, (t / WST) & 1);
    mbar_arrive(k_empty + t % WST);
    mbar_wait(v_full + t % WST, (t / WST) & 1);
    mbar_arrive(v_empty + t % WST);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * Sq + row] =
          lr > 0.0f ? (m[r] + log2f(lr)) * LN2 : INFINITY;
    const float inv = lr > 0.0f ? 1.0f / lr : 0.0f;
    bf16* orow = out + (((size_t)b * Sq + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing links
// libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (B, S, heads, hd) bf16 tensor at p as a 4-d map of 64-column x rows
// boxes, 128-byte swizzled, zeros outside
int tensor_map(CUtensorMap* map, const void* p, int hd, int heads, int S,
               int B, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
              float scale, int causal, int off, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, hd, H, Sq, B, WQ);
  if (!err) err = tensor_map(&tk, k, hd, KV, Sk, B, WK);
  if (!err) err = tensor_map(&tv, v, hd, KV, Sk, B, WK);
  if (err) return err;
  constexpr int bytes = WgTile<HD>::SMEM;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wg_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(H, B, (Sq + WQ - 1) / WQ);
  flash_wg_kernel<HD><<<grid, WNT, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, Sq, Sk, H, KV, hd,
      scale * LOG2E, causal, off);
  return (int)cudaGetLastError();
}

int dispatch_wg(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                float scale, int causal, int off, cudaStream_t stream) {
  FLASH_DISPATCH_HD(hd, return launch_wg<HDT>(q, k, v, out, lse, B, Sq, Sk,
                                              H, KV, hd, scale, causal, off,
                                              stream))
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
             float scale, int causal, int off, cudaStream_t stream) {
  FLASH_DISPATCH_HD(hd, return launch<HDT>(q, k, v, out, lse, B, Sq, Sk,
                                              H, KV, hd, scale, causal, off,
                                              stream))
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), contiguous,
// all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); hd a multiple of 8 in
// [8, 128]; H % KV == 0; 1 <= Sk; scale = hd^-1/2; when causal, key j is
// seen by query i where j <= i + off (any sign; Sk - Sq aligns the mask
// bottom-right).  lse (B, H, Sq) fp32 may be null.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Sk, int H,
                        int KV, int hd, float scale, int is_bf16, int causal,
                        int off, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (!is_bf16)
    return dispatch(q, k, v, out, ls, B, Sq, Sk, H, KV, hd, scale, causal,
                    off, st);
  // the bf16 kernels copy 16-byte chunks
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  return dispatch_wg(q, k, v, out, ls, B, Sq, Sk, H, KV, hd, scale, causal,
                     off, st);
}

// dynamic shared memory of one block at head size hd, fp32 (is_bf16 = 0) or
// bf16 (-1: unsupported)
int flash_attention_smem_bytes(int hd, int is_bf16) {
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  FLASH_DISPATCH_HD(hd, return is_bf16 ? WgTile<HDT>::SMEM
                                       : smem_bytes<HDT>())
}

// registers per thread, local memory (spills) and static shared memory per
// thread block of the forward kernel at head size hd, fp32 or bf16, into
// out[0..2] (cudaFuncGetAttributes).  Returns a cudaError_t.
int flash_attention_fwd_attrs(int hd, int is_bf16, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  FLASH_DISPATCH_HD(hd,
                    err = is_bf16 ? cudaFuncGetAttributes(
                                        &a, flash_wg_kernel<HDT>)
                                  : cudaFuncGetAttributes(
                                        &a, flash_kernel<HDT>);
                    if (err == cudaSuccess) {
                      out[0] = a.numRegs;
                      out[1] = (int)a.localSizeBytes;
                      out[2] = (int)a.sharedSizeBytes;
                    } return (int)err)
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
