// Mamba selective scan, forward, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Replaces kernels/ssm_scan/ssm_scan.py::ssm_scan (the TPU kernel
// _ssm_kernel): for every batch row b, channel i and step t,
//     h_t = Abar_t * h_{t-1} + Bx_t,    y_t[i] = sum_n h_t[i, n] C_t[n],
// Abar, Bx (B, S, di, N) and C (B, S, N) fp32, y (B, S, di) fp32.  The
// Pallas kernel walks time chunks in order with the (block_d, N) state in
// VMEM and needs S a multiple of its chunk and di of its channel block; here
// any S and di are taken.
//
// Design.  One thread per state element (ssm_scan.cuh): each thread walks
// t = 0..S-1 with its h in a register, the U loads of U steps issued before
// their updates so that each thread keeps 3U loads in flight.  y_t[i] is a
// shuffle reduction over the N lanes of the channel, written by lane n = 0.
// At jamba's training shape (di 8192, N 16) that is 131,072 threads per
// batch row, ~31 warps per SM.  Optionally the kernel writes the final state
// h_S (prefill hands it to decode) and, for the backward, the state before
// every CHUNK-step chunk, h_{64k-1} (h_{-1} = 0), to a workspace
// (B, ceil(S / 64), di, N): 16 MiB a layer at B 1, S 2048.
//
// Bound: bytes.  Abar and Bx are read once (2 x 1 GiB at B 1, S 2048),
// C once and y written once; the recurrence is 2 flops per element and
// step.  Nothing is staged in shared memory: every element is read once.
#include <cuda_runtime.h>

#include "ssm_scan.cuh"

namespace ssm {
namespace {

template <int N>
__global__ void __launch_bounds__(NTH) ssm_fwd_kernel(
    const float* __restrict__ A, const float* __restrict__ X,
    const float* __restrict__ C, float* __restrict__ y,
    float* __restrict__ hS, float* __restrict__ hck, int S, int di) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * NTH + threadIdx.x;  // element i * N + n
  const int i = e / N, n = e % N;
  const bool live = i < di;
  const size_t plane = (size_t)di * N;
  const float* a = A + (size_t)b * S * plane + e;
  const float* x = X + (size_t)b * S * plane + e;
  const float* c = C + (size_t)b * S * N + n;
  float* yo = y + (size_t)b * S * di + i;
  float* hk = hck == nullptr
                  ? nullptr
                  : hck + (size_t)b * ((S + CHUNK - 1) / CHUNK) * plane + e;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    if (hk != nullptr && live) hk[(size_t)(t0 / CHUNK) * plane] = h;
    const int t1 = min(S, t0 + CHUNK);
    for (int t = t0; t < t1; t += U) {
      float av[U], xv[U], cv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = t + u;
        const bool in = tt < t1;
        av[u] = in && live ? __ldg(a + (size_t)tt * plane) : 0.f;
        xv[u] = in && live ? __ldg(x + (size_t)tt * plane) : 0.f;
        cv[u] = in ? __ldg(c + (size_t)tt * N) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u >= t1) break;  // the same for every thread
        h = fmaf(av[u], h, xv[u]);
        float p = h * cv[u];
#pragma unroll
        for (int o = N / 2; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
        if (n == 0 && live) yo[(size_t)(t + u) * di] = p;
      }
    }
  }
  if (hS != nullptr && live) hS[(size_t)b * plane + e] = h;
}

template <int N>
int launch_fwd(const float* A, const float* X, const float* C, float* y,
               float* hS, float* hck, int B, int S, int di,
               cudaStream_t st) {
  const dim3 grid(n_blocks(di, N), B);
  ssm_fwd_kernel<N><<<grid, NTH, 0, st>>>(A, X, C, y, hS, hck, S, di);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssm

extern "C" {

// Abar, Bx (B, S, di, N), C (B, S, N), y (B, S, di), all fp32 and
// contiguous; N a power of two in [1, 32].  hS (B, di, N) and hck
// (B, ceil(S / 64), di, N) may be null.  Returns a cudaError_t.
int ssm_scan_fwd(const void* A, const void* X, const void* C, void* y,
                 void* hS, void* hck, int B, int S, int di, int N,
                 void* stream) {
  using namespace ssm;
  if (!valid_n(N)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || di == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* x = static_cast<const float*>(X);
  const float* c = static_cast<const float*>(C);
  float* yo = static_cast<float*>(y);
  float* hs = static_cast<float*>(hS);
  float* hk = static_cast<float*>(hck);
  SSM_DISPATCH_N(N, return launch_fwd<NN>(a, x, c, yo, hs, hk, B, S, di, st))
}

// steps between the chunk-boundary states of the workspace
int ssm_scan_chunk(void) { return ssm::CHUNK; }

const char* ssm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
