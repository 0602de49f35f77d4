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
// never copied out to H heads.  The causal mask is aligned bottom-right,
// j <= i + (Sk - Sq), as the plain version (ref.py) and the JAX package's
// oracle have it; the Pallas kernel masks j <= i, which is the same thing
// on every call the model makes (Sq == Sk).
//
// Layout and design.  One block of 256 threads takes one (batch row, query
// head, 64-row query tile); q, k, v and out stay in the model's
// (B, S, heads, hd) layout, so the wrapper transposes nothing.  The block
// stages its q tile (pre-scaled by 1/sqrt(hd), as the Pallas kernel does)
// and then one 64-row K/V tile after another in shared memory as fp32.
// Thread (ty, tx) of the 16 x 16 grid owns query rows ty + 16 r (r < 4) and
// key columns tx + 16 c (c < 4) of the score tile, and output columns
// tx + 16 c (c < hd / 16) of its four rows, so a row's max and sum reduce
// over 16 lanes of one half-warp with shuffles and its m and l stay in
// registers.  P goes through shared memory in fp32 to the P.V product.  Key
// tiles wholly above the causal diagonal are never loaded; the ragged last
// q and k tiles are masked (rows past Sq are computed and not stored, keys
// past Sk load as zeros and get probability 0).  Row strides of q and k in
// shared memory are padded to hd + 1 floats, so the column reads of k and
// the row reads of q hit distinct banks.
//
// Head sizes: the kernel is templated on the tile width HD in {32, 64, 96,
// 128} and takes any head size hd <= HD that is a multiple of 8 (the
// model's full configs use 64, 96 and 128; reduced test configs 8 to 24):
// columns past hd load as zeros, which leaves every dot product as it is,
// and are not stored.
//
// Training: given a pointer for it, the kernel also writes each row's
// log-sum-exp of the scaled scores, lse = m + log l (B, H, Sq) fp32, which
// the backward (flash_attention_bwd.cu) reads to recompute P; serving passes
// none.
//
// Arithmetic: fp32 FMAs on bf16 or fp32 operands, accurate expf, P in fp32,
// the numerics of the Pallas kernel.  No tensor cores: on this card that
// bounds the kernel by the fp32 rate (67 TFLOP/s), far above the bf16
// tensor-core bound (989 TFLOP/s) that a flash kernel can reach.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <int HD>
constexpr int smem_bytes() {
  // q (BQ x HD+1), k (BK x HD+1), v (BK x HD), p (BQ x BK+1), all fp32
  return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Sk, int H, int KV, int hd, float scale, int causal) {
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
  const int off = Sk - Sq;

  const size_t qstride = (size_t)H * hd, kstride = (size_t)KV * hd;
  const T* qb = q + ((size_t)b * Sq * H + h) * hd;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * hd;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * hd;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    sq[r * QS + d] = s < Sq && d < hd
                         ? to_f32(qb[(size_t)s * qstride + d]) * scale
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
      sk[r * QS + d] = in ? to_f32(kb[(size_t)s * kstride + d]) : 0.0f;
      sv[r * HD + d] = in ? to_f32(vb[(size_t)s * kstride + d]) : 0.0f;
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
    T* o = out + (((size_t)b * Sq + s) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < hd) store(o + tx + 16 * c, acc[r][c] / lm);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
           float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, KV,
      hd, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
             float scale, int causal, cudaStream_t stream) {
  FLASH_DISPATCH_HD(hd, return launch<T, HDT>(q, k, v, out, lse, B, Sq, Sk,
                                              H, KV, hd, scale, causal,
                                              stream))
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), contiguous,
// all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); hd a multiple of 8 in
// [8, 128]; H % KV == 0; 1 <= Sk, and Sq <= Sk when causal; scale =
// hd^-1/2.  lse (B, H, Sq) fp32 may be null.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Sq, int Sk, int H,
                        int KV, int hd, float scale, int is_bf16, int causal,
                        void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, ls, B, Sq, Sk, H,
                                           KV, hd, scale, causal, st)
                 : dispatch<float>(q, k, v, out, ls, B, Sq, Sk, H, KV, hd,
                                   scale, causal, st);
}

// dynamic shared memory of one block at head size hd (-1: unsupported)
int flash_attention_smem_bytes(int hd) {
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  FLASH_DISPATCH_HD(hd, return smem_bytes<HDT>())
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
