// Shared pieces of the chunkwise mLSTM kernels (forward in mlstm_chunk.cu,
// backward in mlstm_chunk_bwd.cu): tile constants, shared-memory tile
// loaders, block reductions, and the launchers of the three stages that
// both directions run (gates, the state scan, the per-chunk intra terms).
//
// Layout: q, k, v, h and their gradients are (BH, S, dh) fp32 row-major
// (BH = batch x heads), logi and logf (BH, S).  A chunk is L = 64 tokens
// (the last one may be shorter); dh is cut into tiles of T = 64.  Every
// block runs 256 threads as a 16 x 16 grid (ty, tx) and owns a 64 x 64
// output tile, rows ty + 16 r and columns tx + 16 c (r, c < 4).
#pragma once

#include <cuda_runtime.h>

namespace mlstm {

constexpr int L = 64;        // chunk length in tokens
constexpr int T = 64;        // tile width over dh
constexpr int NTH = 256;     // threads per block
constexpr int P = T + 1;     // padded row stride of a shared tile
constexpr float NEG = -1e30f;

struct Dims {
  int BH, S, dh, nC, nT;
};

inline Dims make_dims(int BH, int S, int dh) {
  return Dims{BH, S, dh, (S + L - 1) / L, dh / T};
}

// Copy a 64 x 64 tile of a row-major matrix (row stride ld, rows past
// nrows read as zero) into shared memory with row stride `stride`,
// multiplying row r by rowscale[r] where rowscale is given.  Neighbouring
// threads read neighbouring columns.
__device__ __forceinline__ void load_tile(float* sm, int stride,
                                          const float* __restrict__ g,
                                          size_t ld, int nrows,
                                          const float* __restrict__ rowscale) {
  for (int e = threadIdx.x; e < L * T; e += NTH) {
    const int r = e >> 6, c = e & 63;
    float x = 0.f;
    if (r < nrows) {
      x = g[(size_t)r * ld + c];
      if (rowscale != nullptr) x *= rowscale[r];
    }
    sm[r * stride + c] = x;
  }
}

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

}  // namespace mlstm
