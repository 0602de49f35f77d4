// Shared by the selective-scan kernels (ssm_scan.cu, ssm_scan_bwd.cu).
//
// Thread layout of both directions: one thread per state element (b, i, n)
// of the (di, N) state, N a power of two up to 32, so the N states of one
// channel sit on N neighbouring lanes of one warp and neighbouring threads
// read neighbouring floats of Abar / Bx (B, S, di, N).  Blocks of NTH
// threads cover NTH / N channels; blockIdx.y is the batch row.
#pragma once
#include <cuda_runtime.h>

namespace ssm {

constexpr int NTH = 256;           // threads per block
constexpr int NWARP = NTH / 32;
constexpr int CHUNK = 64;          // steps between kept chunk-boundary states
constexpr int U = 8;               // steps whose loads are issued together
constexpr unsigned FULL = 0xffffffffu;

inline int n_blocks(int di, int N) { return (di * N + NTH - 1) / NTH; }
inline bool valid_n(int N) { return N >= 1 && N <= 32 && !(N & (N - 1)); }

// runs the statement __VA_ARGS__ with NN the runtime state size N
#define SSM_DISPATCH_N(N, ...)                           \
  switch (N) {                                           \
    case 1: { constexpr int NN = 1; __VA_ARGS__; }       \
    case 2: { constexpr int NN = 2; __VA_ARGS__; }       \
    case 4: { constexpr int NN = 4; __VA_ARGS__; }       \
    case 8: { constexpr int NN = 8; __VA_ARGS__; }       \
    case 16: { constexpr int NN = 16; __VA_ARGS__; }     \
    case 32: { constexpr int NN = 32; __VA_ARGS__; }     \
    default: return (int)cudaErrorInvalidValue;          \
  }

}  // namespace ssm
