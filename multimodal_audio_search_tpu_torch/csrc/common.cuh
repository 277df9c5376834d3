// Shared helpers of the hand-written Hopper kernels: bf16 packing and the
// m16n8k16 bf16 tensor-core product (mma.sync, f32 accumulate).
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16x8, col-major):  b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16; the lower column/row index sits in
// the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 at arbitrary (2-byte aligned) addresses -> one register
__device__ __forceinline__ uint32_t pack_raw(const bf16* lo, const bf16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}
