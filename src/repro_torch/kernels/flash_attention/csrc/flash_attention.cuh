// Shared by the flash-attention kernels (flash_attention.cu forward,
// flash_attention_bwd.cu backward).
//
// fp32 path: tile sizes and the 16 x 16 thread grid of the FMA kernels;
// to_f32 for the D = rowsum(dO o O) kernel, which both paths share.
//
// bf16 path: the tensor-core building blocks of the backward (the forward's
// wgmma, TMA and mbarrier pieces live in flash_attention.cu).  mma.sync
// m16n8k16 (bf16 operands, fp32 sums) with its fragments loaded from shared
// memory by ldmatrix (.trans for the operands that contract over rows,
// which 16-bit types allow), and cp.async copies of whole (rows x
// head-size) bf16 tiles from the model's (B, S, heads, hd) layout into
// shared memory.  A tile's rows are HD + 8 elements apart: the 16-byte pad
// puts the eight rows that one ldmatrix phase reads in eight different bank
// groups, so no swizzle is needed.  Fragment layouts (g = lane / 4, c =
// lane % 4): the accumulator of an m16n8 tile holds (row g, cols 2c, 2c+1)
// in d[0], d[1] and (row g + 8, same cols) in d[2], d[3]; an A operand
// (16 x 16) holds (row g, k 2c..2c+1), (row g + 8, k 2c..), (row g,
// k 8+2c..), (row g + 8, k 8+2c..) in a[0..3], so two neighbouring
// accumulator tiles, rounded to bf16 pairs, are an A operand as they
// stand: P and dS go from the accumulators to the next product in
// registers.  A wgmma accumulator holds each warp's 16 rows the same way,
// and its register A operand takes the same layout, which is how the
// forward feeds P to P V.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// runs the statement __VA_ARGS__ with HDT the tile width in {32, 64, 96,
// 128} that covers the head size hd (a multiple of 8 in [8, 128])
#define FLASH_DISPATCH_HD(hd, ...)                     \
  if ((hd) < 8 || (hd) > 128 || (hd) % 8)              \
    return (int)cudaErrorInvalidValue;                 \
  if ((hd) <= 32) { constexpr int HDT = 32; __VA_ARGS__; } \
  if ((hd) <= 64) { constexpr int HDT = 64; __VA_ARGS__; } \
  if ((hd) <= 96) { constexpr int HDT = 96; __VA_ARGS__; } \
  { constexpr int HDT = 128; __VA_ARGS__; }

// ------------------------------------------------------------------------
// bf16 tensor-core path
// ------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without waiting; zeros when !valid (src is then
// not read)
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// a barrier for the 128 threads of one warpgroup (ids 1, 2; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the row address
// of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Two neighbouring 16 x 8 accumulator tiles (columns 16 kk .. 16 kk + 15)
// as the A operand of the next product, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Lane addresses of the ldmatrix.x4 loads of a tile with row stride SR
// (elements), at row r0 and column c0:
//   A operand (16 rows x 16 k, rows of the tile are the operand's rows);
__device__ __forceinline__ int ldsm_a(int SR, int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * SR + c0 + (lane >> 4) * 8;
}
//   B operands of two n8 tiles whose n index runs along the tile's rows
//   (r0 .. r0 + 15) and k along its columns: b0, b1 of rows r0.. in r[0],
//   r[1], of rows r0 + 8.. in r[2], r[3] (ldmatrix, no transpose);
__device__ __forceinline__ int ldsm_b_rows(int SR, int r0, int c0, int lane) {
  return (r0 + (lane & 7) + (lane >> 4) * 8) * SR + c0 + ((lane >> 3) & 1) * 8;
}
//   B operands of two n8 tiles whose k index runs along the tile's rows
//   (r0 .. r0 + 15) and n along its columns (c0 .., c0 + 8 ..): b0, b1 of
//   columns c0.. in r[0], r[1], of columns c0 + 8.. in r[2], r[3]
//   (ldmatrix.trans).
__device__ __forceinline__ int ldsm_b_cols(int SR, int r0, int c0, int lane) {
  return (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SR + c0 + (lane >> 4) * 8;
}

// Rows r0 .. r0 + ROWS - 1 of a head's (S rows, row_stride elements apart)
// bf16 matrix into a ROWS x HD tile with row stride HD + 8, by the NT
// threads numbered t; zeros past S and past hd (a multiple of 8).
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int r0, int S,
                                                size_t row_stride, int hd,
                                                int t) {
  constexpr int CPR = HD / 8, SR = HD + 8;
  constexpr int N = (ROWS * CPR + NT - 1) / NT;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = t + j * NT;
    if (ROWS * CPR % NT != 0 && i >= ROWS * CPR) break;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool valid = r0 + r < S && c < hd;
    cp_async_16(dst + r * SR + c,
                valid ? src + (size_t)(r0 + r) * row_stride + c : src, valid);
  }
}

}  // namespace flash
