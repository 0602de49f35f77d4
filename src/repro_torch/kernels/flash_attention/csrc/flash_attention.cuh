// Shared by the flash-attention kernels (flash_attention.cu forward,
// flash_attention_bwd.cu backward): tile sizes, the 16 x 16 thread grid and
// the fp32 / bf16 loads and stores.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int NTHREADS = 256;  // 16 x 16
constexpr int RQ = BQ / 16;    // query rows per thread
constexpr int CK = BK / 16;    // key columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// runs the statement __VA_ARGS__ with HDT the tile width in {32, 64, 96,
// 128} that covers the head size hd (a multiple of 8 in [8, 128])
#define FLASH_DISPATCH_HD(hd, ...)                     \
  if ((hd) < 8 || (hd) > 128 || (hd) % 8)              \
    return (int)cudaErrorInvalidValue;                 \
  if ((hd) <= 32) { constexpr int HDT = 32; __VA_ARGS__; } \
  if ((hd) <= 64) { constexpr int HDT = 64; __VA_ARGS__; } \
  if ((hd) <= 96) { constexpr int HDT = 96; __VA_ARGS__; } \
  { constexpr int HDT = 128; __VA_ARGS__; }

}  // namespace flash
