// Closed-form gradient of the GP fit's loss for Hopper (sm_90a), plain C
// interface for ctypes; built into the gp_acquisition library beside the
// scoring kernels.
//
// It replaces no Pallas kernel: the JAX package takes the fit's gradient
// with jax.grad under XLA.  The port's fit (core/gp.py fit_hypers_bank)
// takes, at every Adam step, the gradient of each study's
//     -log ML / n_eff = (z^T K^-1 z + log det K) / (2 n_eff) + const
// in closed form,
//     d/dtheta = 0.5 sum_ij W_ij dK_ij/dtheta / n_eff,
//     W = K^-1 - alpha alpha^T,   alpha = K^-1 z,
// for all d + 2 log-hyperparameters (log ls_1..d, log var, log noise).  K^-1
// and alpha come from the factor (torch.matmul and two matvecs); this
// kernel forms W on the fly from them and recomputes dK/dtheta per pair of
// rows from X, as ref.matern52 defines K (clamp(d2, 1e-12) included):
//   off the diagonal, r^2 = d2 = sum_d (x_id - x_jd)^2 / ls_d^2, s = sqrt5 r,
//     dk/dlog ls_d = (5/3) var (1 + s) e^-s (x_id - x_jd)^2 / ls_d^2
//       (d2 under the clamp: -(10/3) var e^-s (x_id - x_jd)^2 / ls_d^2,
//        the derivative of the polynomial's d2 term alone),
//     dk/dlog var = k, scaled by mask_i mask_j as K is;
//   on the diagonal of an observed row, K_ii = var + noise + 1e-6 max(var, 1):
//     dK_ii/dlog var = var (+ 1e-6 var where var >= 1), dK_ii/dlog noise =
//     exp(log noise), dK_ii/dlog ls = 0.  Masked rows contribute nothing.
//
//   Bound at the fleet cells' shape (B = 16 studies, na = 1024, d = 6): the
//   kernel reads K^-1's upper triangle once, each pair (i < j) doubled:
//   B na (na + 1) / 2 * 4 B = 33.6 MB, 0.010 ms at 3.35 TB/s (all of K^-1,
//   67.1 MB, would take 0.020 ms).  The operations, ~70 a pair over 8.4 M
//   pairs, take less.  So bytes bound it.
//
//   Design.  Pass 1: one block of 256 threads for each 64 x 64 tile of a
//   study's upper triangle (tiles below the diagonal return at once).  The
//   tile's rows of X, divided by ls and zero-padded to a multiple of 8
//   columns, go to shared memory (the column rows transposed, so a warp's
//   32 columns read 32 banks); each thread takes one column j and 16 rows i,
//   so a warp reads 128 contiguous bytes of a K^-1 row.  A pair's weight
//   for the lengthscales stays in a register while the dimensions are
//   summed 8 at a time.  A thread sums its 16 pairs in fp32; from there
//   the sums run in fp64, through warp shuffles and the block's 8 warps in
//   a fixed order, into one partial per tile and hyperparameter.  Pass 2:
//   one block a study adds its tiles' partials, each thread a fixed set of
//   tiles, then the threads' sums in a fixed order, and divides by n_eff.
//   No atomics: the same inputs give the same bits.
//
// masked_kernel_kernel builds the fit's masked kernel matrix (core/gp.py
// _masked_kernel, ref.masked_kernel) in one pass for the fit's Cholesky
// factor, in place of the plain version's ~28 elementwise launches at each
// Adam step; it replaces no Pallas kernel (XLA fuses the JAX fit's K).  It
// writes K, B na^2 * 4 B = 67.1 MB at the cells' shape: 0.020 ms at 3.35
// TB/s bounds it.  Its squared distance is summed from the differences, as
// the gradient's is; the plain version expands |x|^2 + |y|^2 - 2 x.y, whose
// rounding (a few ulps of |x|^2 + |y|^2) moves K by at most 8 eps32
// (|x|^2 + |y|^2) var, the bound the two are held to.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FT = 64;           // rows and columns of a tile
constexpr int FNT = 256;         // threads of a pass-1 block
constexpr int FROWS = FT / (FNT / FT);  // rows each thread takes: 16
constexpr int FDC = 8;           // dimensions summed at once
constexpr int FWARPS = FNT / 32;
constexpr float SQRT5 = 2.2360679774997896f;
constexpr float JITTER = 1e-6f;  // core/scoring.py JITTER

// v[0..FDC) summed over the block in a fixed order; out[q] for q < count
// (thread q writes it).  red holds FWARPS * FDC doubles.
__device__ __forceinline__ void block_sum(double (&v)[FDC], double* red,
                                          double* out, int count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < FDC; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < FDC; ++q) red[warp * FDC + q] = v[q];
  }
  __syncthreads();
  if ((int)threadIdx.x < count) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < FWARPS; ++w) s += red[w * FDC + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The tile's rows i0.. and columns j0.. of X divided by ls, zero-padded to
// dpad columns (xi row-major, xjT transposed), and their mask values.
__device__ __forceinline__ void load_tile(const float* __restrict__ Xb,
                                          const float* __restrict__ lsb,
                                          const float* __restrict__ maskb,
                                          float* xi, float* xjT, float* mi,
                                          float* mj, int i0, int j0, int na,
                                          int d, int dpad) {
  for (int e = threadIdx.x; e < FT * dpad; e += FNT) {
    const int r = e / dpad, q = e % dpad;
    const bool in = q < d;
    const int i = i0 + r, j = j0 + r;
    xi[r * dpad + q] =
        (in && i < na) ? Xb[(size_t)i * d + q] / lsb[q] : 0.0f;
    xjT[q * FT + r] =
        (in && j < na) ? Xb[(size_t)j * d + q] / lsb[q] : 0.0f;
  }
  for (int r = threadIdx.x; r < FT; r += FNT) {
    mi[r] = i0 + r < na ? maskb[i0 + r] : 0.0f;
    mj[r] = j0 + r < na ? maskb[j0 + r] : 0.0f;
  }
}

// d2 of the tile's row il and column tx, summed in order over dpad
__device__ __forceinline__ float tile_d2(const float* xi, const float* xjT,
                                         int il, int tx, int dpad) {
  float d2 = 0.0f;
  for (int q = 0; q < dpad; ++q) {
    const float u = xi[il * dpad + q] - xjT[q * FT + tx];
    d2 = fmaf(u, u, d2);
  }
  return d2;
}

// The masked kernel matrix of _masked_kernel (core/gp.py), one 64 x 64
// tile a block: var (1 + s + 5/3 d2) e^-s mask_i mask_j off the diagonal;
// var + noise + jitter on an observed row's diagonal, 1 on a masked row's.
__global__ void __launch_bounds__(FNT) masked_kernel_kernel(
    const float* __restrict__ X, const float* __restrict__ mask,
    const float* __restrict__ ls, const float* __restrict__ var,
    const float* __restrict__ noise, const float* __restrict__ jitter,
    float* __restrict__ K, int na, int d, int dpad, int T) {
  const int b = blockIdx.y;
  const int i0 = blockIdx.x / T * FT, j0 = blockIdx.x % T * FT;
  extern __shared__ double smem[];
  float* xi = reinterpret_cast<float*>(smem);
  float* xjT = xi + FT * dpad;
  float* mi = xjT + FT * dpad;
  float* mj = mi + FT;
  load_tile(X + (size_t)b * na * d, ls + (size_t)b * d, mask + (size_t)b * na,
            xi, xjT, mi, mj, i0, j0, na, d, dpad);
  __syncthreads();
  const float vb = var[b];
  const float diag = (vb + noise[b]) + jitter[b];
  const int tx = threadIdx.x % FT, ty = threadIdx.x / FT;
  const int j = j0 + tx;
  float* Kb = K + (size_t)b * na * na;
#pragma unroll 4
  for (int r = 0; r < FROWS; ++r) {
    const int il = ty + r * (FNT / FT);
    const int i = i0 + il;
    if (i >= na || j >= na) continue;
    float k;
    if (i == j) {
      k = mi[il] > 0.0f ? diag : 1.0f;
    } else {
      const float d2 = tile_d2(xi, xjT, il, tx, dpad);
      const float s = SQRT5 * sqrtf(fmaxf(d2, 1e-12f));
      k = vb * (1.0f + s + (5.0f / 3.0f) * d2) * expf(-s) * (mi[il] * mj[tx]);
    }
    Kb[(size_t)i * na + j] = k;
  }
}

__global__ void __launch_bounds__(FNT) fit_grad_tiles_kernel(
    const float* __restrict__ X, const float* __restrict__ mask,
    const float* __restrict__ Kinv, const float* __restrict__ alpha,
    const float* __restrict__ ls, const float* __restrict__ var,
    const float* __restrict__ noise_exp, double* __restrict__ partial,
    int na, int d, int dpad, int T) {
  const int b = blockIdx.y;
  const int ti = blockIdx.x / T, tj = blockIdx.x % T;
  if (ti > tj) return;  // pass 2 reads the upper triangle's tiles only
  const int P = d + 2;
  double* out = partial + ((size_t)b * T * T + blockIdx.x) * P;

  extern __shared__ double smem[];
  double* red = smem;                                  // FWARPS * FDC
  float* xi = reinterpret_cast<float*>(red + FWARPS * FDC);  // FT x dpad
  float* xjT = xi + FT * dpad;                         // dpad x FT
  float* ai = xjT + FT * dpad;
  float* aj = ai + FT;
  float* mi = aj + FT;
  float* mj = mi + FT;

  const int i0 = ti * FT, j0 = tj * FT;
  load_tile(X + (size_t)b * na * d, ls + (size_t)b * d, mask + (size_t)b * na,
            xi, xjT, mi, mj, i0, j0, na, d, dpad);
  for (int r = threadIdx.x; r < FT; r += FNT) {
    ai[r] = i0 + r < na ? alpha[(size_t)b * na + i0 + r] : 0.0f;
    aj[r] = j0 + r < na ? alpha[(size_t)b * na + j0 + r] : 0.0f;
  }
  __syncthreads();

  const float vb = var[b], en = noise_exp[b];
  const float dvar_diag = vb + (vb >= 1.0f ? JITTER * vb : 0.0f);
  const int tx = threadIdx.x % FT, ty = threadIdx.x / FT;
  const int j = j0 + tx;
  const float* Kb = Kinv + (size_t)b * na * na;
  // the thread's 16 entries of K^-1, all loads issued before any is used
  float kv[FROWS];
#pragma unroll
  for (int r = 0; r < FROWS; ++r) {
    const int i = i0 + ty + r * (FNT / FT);
    kv[r] = (i < na && j < na && i <= j) ? Kb[(size_t)i * na + j] : 0.0f;
  }
  float c[FROWS];  // each pair's weight of (x_id - x_jd)^2 / ls_d^2
  float acc_var = 0.0f, acc_noise = 0.0f;
#pragma unroll
  for (int r = 0; r < FROWS; ++r) {
    const int il = ty + r * (FNT / FT);
    const int i = i0 + il;
    c[r] = 0.0f;
    if (i >= na || j >= na || i > j) continue;
    const float w = kv[r] - ai[il] * aj[tx];
    if (i == j) {
      if (mi[il] > 0.0f) {
        acc_var += 0.5f * (w * dvar_diag);
        acc_noise += 0.5f * (w * en);
      }
      continue;
    }
    const float m = mi[il] * mj[tx];
    if (m == 0.0f) continue;
    const float d2 = tile_d2(xi, xjT, il, tx, dpad);
    const float s = SQRT5 * sqrtf(fmaxf(d2, 1e-12f));
    const float ex = expf(-s);
    const float k = vb * (1.0f + s + (5.0f / 3.0f) * d2) * ex;
    const float g = d2 >= 1e-12f ? (5.0f / 3.0f) * vb * (1.0f + s) * ex
                                 : -(10.0f / 3.0f) * vb * ex;
    const float wm = w * m;
    acc_var += wm * k;
    c[r] = wm * g;
  }

  double v[FDC];
  for (int c0 = 0; c0 < dpad; c0 += FDC) {
    float a[FDC];
#pragma unroll
    for (int q = 0; q < FDC; ++q) a[q] = 0.0f;
#pragma unroll
    for (int r = 0; r < FROWS; ++r) {
      const int il = ty + r * (FNT / FT);
#pragma unroll
      for (int q = 0; q < FDC; ++q) {
        const float u = xi[il * dpad + c0 + q] - xjT[(c0 + q) * FT + tx];
        a[q] = fmaf(c[r], u * u, a[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < FDC; ++q) v[q] = a[q];
    block_sum(v, red, out + c0, min(FDC, d - c0));
  }
  v[0] = acc_var;
  v[1] = acc_noise;
#pragma unroll
  for (int q = 2; q < FDC; ++q) v[q] = 0.0;
  block_sum(v, red, out + d, 2);
}

// One block a study: thread t sums tiles t, t + FNT, ... of the upper
// triangle for each hyperparameter k, then the block sums the threads' in a
// fixed order.
__global__ void __launch_bounds__(FNT) fit_grad_sum_kernel(
    const double* __restrict__ partial, const float* __restrict__ n_eff,
    float* __restrict__ grad, int P, int T) {
  __shared__ double red[FWARPS];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double* pb = partial + (size_t)b * T * T * P;
  for (int k = 0; k < P; ++k) {
    double s = 0.0;
    for (int t = threadIdx.x; t < T * T; t += FNT)
      if (t / T <= t % T) s += pb[(size_t)t * P + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      double tot = 0.0;
#pragma unroll
      for (int w = 0; w < FWARPS; ++w) tot += red[w];
      grad[(size_t)b * P + k] = (float)(tot / (double)n_eff[b]);
    }
    __syncthreads();
  }
}

long fit_grad_smem_bytes(int dpad) {
  return (long)FWARPS * FDC * sizeof(double) +
         (2L * FT * dpad + 4L * FT) * sizeof(float);
}

long masked_kernel_smem_bytes(int dpad) {
  return (2L * FT * dpad + 2L * FT) * sizeof(float);
}

// Raises the kernel's dynamic shared memory limit where bytes need it.
template <typename F>
cudaError_t allow_smem(F* kernel, long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Doubles of pass 1's workspace at (B, na, d): one partial per tile of the
// study's tile grid and hyperparameter.
long gp_fit_grad_workspace(int B, int na, int d) {
  const long T = (na + FT - 1) / FT;
  return (long)B * T * T * (d + 2);
}

// K (B, na, na), the masked kernel matrix of rows X (B, na, d) under ls
// (B, d), var, noise (with its 1e-5 floor added) and jitter (B,).
int gp_masked_kernel(const float* X, const float* mask, const float* ls,
                     const float* var, const float* noise,
                     const float* jitter, float* K, int B, int na, int d,
                     void* stream) {
  if (B == 0 || na == 0) return 0;
  const int T = (na + FT - 1) / FT;
  const int dpad = (d + FDC - 1) / FDC * FDC;
  const long bytes = masked_kernel_smem_bytes(dpad);
  cudaError_t err;
  if ((err = allow_smem(masked_kernel_kernel, bytes)) != cudaSuccess)
    return (int)err;
  masked_kernel_kernel<<<dim3(T * T, B), FNT, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      X, mask, ls, var, noise, jitter, K, na, d, dpad, T);
  return (int)cudaGetLastError();
}

// grad (B, d + 2): [log ls_1..d, log var, log noise] of each study's
// -log ML / n_eff.  X (B, na, d) raw rows; mask, alpha (B, na); Kinv
// (B, na, na); ls (B, d); var, noise_exp = exp(log noise), n_eff (B,);
// partial: gp_fit_grad_workspace(B, na, d) doubles.
int gp_fit_grad(const float* X, const float* mask, const float* Kinv,
                const float* alpha, const float* ls, const float* var,
                const float* noise_exp, const float* n_eff, double* partial,
                float* grad, int B, int na, int d, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (na + FT - 1) / FT;
  const int dpad = (d + FDC - 1) / FDC * FDC;
  const long bytes = fit_grad_smem_bytes(dpad);
  cudaError_t err;
  if (T > 0) {
    if ((err = allow_smem(fit_grad_tiles_kernel, bytes)) != cudaSuccess)
      return (int)err;
    fit_grad_tiles_kernel<<<dim3(T * T, B), FNT, bytes, st>>>(
        X, mask, Kinv, alpha, ls, var, noise_exp, partial, na, d, dpad, T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  fit_grad_sum_kernel<<<B, FNT, 0, st>>>(partial, n_eff, grad, d + 2, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
