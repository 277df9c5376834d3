// Shared helpers of the hand-written Hopper kernels: bf16 packing, the
// m16n8k16 bf16 tensor-core product (mma.sync, f32 accumulate) and
// block-wide reductions.
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

// the device indices a host-side cache of per-device values (an
// occupancy, an attribute) holds
constexpr int MAX_DEVICES = 64;

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

// eight bf16 (one 16-byte load) -> eight floats
__device__ __forceinline__ void bf16x8_to_f32(uint4 r, float f[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// sum_{q < S} p[q * stride] added in the order q = 0, 1, ..., S - 1 (a
// fixed order, as a serial loop would add), with 16 loads in flight at a
// time; the loads go through L2 only (values another block just wrote).
// Masked-off loads add a zero, which leaves every sum as it was.
__device__ __forceinline__ float ordered_sum(const float* p, long long stride,
                                             int S) {
  float y = 0.f;
  for (int q = 0; q < S; q += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      v[u] = q + u < S ? __ldcg(p + (q + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) y += v[u];
  }
  return y;
}

// Block-wide max / sum of one float per thread, returned to every thread.
// `sm` holds one float per warp; the calls synchronise before and after,
// so back-to-back calls may share it.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sm[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = fmaxf(r, sm[i]);
  return r;
}

template <int NT>
__device__ __forceinline__ float block_sum(float v, float* sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) r += sm[i];
  return r;
}
