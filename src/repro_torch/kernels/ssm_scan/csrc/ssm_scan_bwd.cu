// Mamba selective scan, backward, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// The gradient of the function ssm_scan.cu computes.  The Pallas kernel
// kernels/ssm_scan/ssm_scan.py::ssm_scan has none (pallas_call has no
// transpose), so the JAX package trains through its jnp scan; this kernel
// computes the gradient of the same recurrence, in the decomposition
// ref.ssm_scan_bwd_ref writes out in plain PyTorch.  For dy = dL/dy (B, S,
// di) and, where the final state is an output too, dh_S = dL/dh_S:
//     dh_t = dh_{t+1} * Abar_{t+1} + dy_t[i] C_t[n]   (dh_{S-1} adds dh_S)
//     dBx_t = dh_t,  dAbar_t = dh_t * h_{t-1},  dC_t[n] = sum_i dy_t[i] h_t[i, n]
//
// Design.  The thread layout of the forward (ssm_scan.cuh), walking the
// 64-step chunks in reverse.  Per chunk a thread recomputes its states
// h_{t0..t1-1} from the chunk-boundary state the forward kept (the same
// fmaf sequence, so the same values) into shared memory, then runs the
// reverse recurrence with the carry dh_{t+1} * Abar_{t+1} in a register.
// It never steps back in time by dividing by Abar, which can be tiny.
//
// dC sums over every channel i, across blocks.  Each warp reduces its
// channels with shuffles; the block sums its warps through shared memory at
// the end of each chunk and writes one partial per (block, t, n); a last
// small kernel sums the partials over blocks in a fixed order.  No atomics,
// so two runs give the same bits.  Partials: (B, blocks, S, N) fp32, 64 MiB
// at B 1, S 2048, di 8192, N 16.
//
// Bound: bytes.  Abar, Bx, C and dy are read once, dAbar, dBx and dC
// written once (4.36 GB at jamba's training shape); the kernel reads Abar a
// second time in the reverse walk (mostly from L2: a chunk of Abar over all
// blocks is 32 MiB) and the partials once more.
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace ssm {
namespace {

template <int N>
constexpr int bwd_smem_bytes() {
  // the chunk's states (CHUNK x NTH) and the per-warp dC sums
  // (CHUNK x NWARP x N)
  return (CHUNK * NTH + CHUNK * NWARP * N) * (int)sizeof(float);
}

template <int N>
__global__ void __launch_bounds__(NTH) ssm_bwd_kernel(
    const float* __restrict__ A, const float* __restrict__ X,
    const float* __restrict__ C, const float* __restrict__ dy,
    const float* __restrict__ dhS, const float* __restrict__ hck,
    float* __restrict__ dA, float* __restrict__ dX,
    float* __restrict__ dCp, int S, int di) {
  extern __shared__ float smem[];
  float* hs = smem;                   // hs[j * NTH + tid] = h_{t0 + j}
  float* red = smem + CHUNK * NTH;    // red[(j * NWARP + warp) * N + n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int e = blk * NTH + tid;
  const int i = e / N, n = e % N;
  const bool live = i < di;
  const int nK = (S + CHUNK - 1) / CHUNK;
  const size_t plane = (size_t)di * N;
  const size_t off = (size_t)b * S * plane + e;
  const float* a = A + off;
  const float* x = X + off;
  float* da = dA + off;
  float* dx = dX + off;
  const float* c = C + (size_t)b * S * N + n;
  const float* g_in = dy + (size_t)b * S * di + i;
  const float* hk = hck + (size_t)b * nK * plane + e;
  float* part = dCp + ((size_t)b * nblk + blk) * S * N;

  float g = dhS != nullptr && live ? dhS[(size_t)b * plane + e] : 0.f;
  for (int k = nK - 1; k >= 0; --k) {
    const int t0 = k * CHUNK, len = min(CHUNK, S - t0);
    const float h0 = live ? hk[(size_t)k * plane] : 0.f;
    // the chunk's states, recomputed as the forward computed them
    float h = h0;
    for (int j = 0; j < len; j += U) {
      float av[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = live && j + u < len;
        av[u] = in ? __ldg(a + (size_t)(t0 + j + u) * plane) : 0.f;
        xv[u] = in ? __ldg(x + (size_t)(t0 + j + u) * plane) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u >= len) break;
        h = fmaf(av[u], h, xv[u]);
        hs[(j + u) * NTH + tid] = h;
      }
    }
    // the reverse recurrence over the chunk
    for (int j = len - 1; j >= 0; j -= U) {
      float av[U], gv[U], cv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = j - u;
        const bool in = jj >= 0;
        const size_t t = (size_t)(t0 + jj);
        av[u] = in && live ? __ldg(a + t * plane) : 0.f;
        gv[u] = in && live ? __ldg(g_in + t * di) : 0.f;
        cv[u] = in ? __ldg(c + t * N) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = j - u;
        if (jj < 0) break;  // the same for every thread
        const size_t t = (size_t)(t0 + jj);
        const float ht = hs[jj * NTH + tid];
        const float hp = jj > 0 ? hs[(jj - 1) * NTH + tid] : h0;
        const float d = g + gv[u] * cv[u];
        if (live) {
          dx[t * plane] = d;
          da[t * plane] = d * hp;
        }
        g = d * av[u];
        float p = gv[u] * ht;
#pragma unroll
        for (int o = 16; o >= N; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
        if (lane < N) red[(jj * NWARP + warp) * N + lane] = p;
      }
    }
    __syncthreads();
    for (int q = tid; q < len * N; q += NTH) {
      const int j = q / N, nn = q % N;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) s += red[(j * NWARP + w) * N + nn];
      part[(size_t)(t0 + j) * N + nn] = s;
    }
    __syncthreads();  // hs and red are rewritten by the next chunk
  }
}

// dC[b, t, n] = sum over blocks of the partials, in block order
__global__ void ssm_dc_reduce_kernel(const float* __restrict__ dCp,
                                     float* __restrict__ dC, int S, int N,
                                     int nblk) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)S * N;
  const int b = blockIdx.y;
  if (q >= per_b) return;
  const float* p = dCp + (size_t)b * nblk * per_b + q;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += p[(size_t)k * per_b];
  dC[(size_t)b * per_b + q] = s;
}

template <int N>
int launch_bwd(const float* A, const float* X, const float* C,
               const float* dy, const float* dhS, const float* hck, float* dA,
               float* dX, float* dC, float* dCp, int B, int S, int di,
               cudaStream_t st) {
  constexpr int bytes = bwd_smem_bytes<N>();
  // set on every launch: the attribute belongs to the current device's
  // context, and the call costs next to nothing
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nblk = n_blocks(di, N);
  ssm_bwd_kernel<N><<<dim3(nblk, B), NTH, bytes, st>>>(
      A, X, C, dy, dhS, hck, dA, dX, dCp, S, di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t per_b = (size_t)S * N;
  ssm_dc_reduce_kernel<<<dim3((unsigned)((per_b + 255) / 256), B), 256, 0,
                         st>>>(dCp, dC, S, N, nblk);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssm

extern "C" {

// Abar, Bx (B, S, di, N), C (B, S, N), dy (B, S, di), hck (B, ceil(S/64),
// di, N) from the forward, all fp32 and contiguous; dhS (B, di, N) may be
// null.  Writes dAbar, dBx (B, S, di, N) and dC (B, S, N); dCp is scratch
// of ssm_scan_partial_floats floats.  Returns a cudaError_t.
int ssm_scan_bwd(const void* A, const void* X, const void* C, const void* dy,
                 const void* dhS, const void* hck, void* dA, void* dX,
                 void* dC, void* dCp, int B, int S, int di, int N,
                 void* stream) {
  using namespace ssm;
  if (!valid_n(N)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || di == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* x = static_cast<const float*>(X);
  const float* c = static_cast<const float*>(C);
  const float* g = static_cast<const float*>(dy);
  const float* gs = static_cast<const float*>(dhS);
  const float* hk = static_cast<const float*>(hck);
  float* da = static_cast<float*>(dA);
  float* dx = static_cast<float*>(dX);
  float* dc = static_cast<float*>(dC);
  float* dp = static_cast<float*>(dCp);
  SSM_DISPATCH_N(N, return launch_bwd<NN>(a, x, c, g, gs, hk, da, dx, dc, dp,
                                          B, S, di, st))
}

// floats of the dC partials' scratch
long long ssm_scan_partial_floats(int B, int S, int di, int N) {
  return (long long)B * ssm::n_blocks(di, N) * S * N;
}

// dynamic shared memory of one backward block (-1: unsupported N)
int ssm_scan_bwd_smem_bytes(int N) {
  using namespace ssm;
  if (!valid_n(N)) return -1;
  SSM_DISPATCH_N(N, return bwd_smem_bytes<NN>())
}

}  // extern "C"
