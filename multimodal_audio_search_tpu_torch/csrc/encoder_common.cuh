// Shared pieces of the encoder attention kernels on mma.sync (K9, K11):
// the 64-row tiling, the bf16 tile loader and the o-projection + residual
// epilogue that K11 ends with (K9 has its own, its Wo tiles fed by TMA).
#pragma once

#include "common.cuh"

namespace enc {

constexpr int D = 64;      // head dim of every Whisper preset
constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per K/V tile
constexpr int LDS = D + 8; // padded row stride of the 64-wide tiles
constexpr int NT = 128;    // 4 warps

// [64 rows x 64 cols] bf16 tile from global (row stride ld elements)
// into shared memory; rows >= nrows are zero-filled.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int nrows) {
  for (int i = threadIdx.x; i < 64 * 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) v = *reinterpret_cast<const uint4*>(g + r * ld + c);
    *reinterpret_cast<uint4*>(s + r * LDS + c) = v;
  }
}

// The epilogue: out = x + sA @ Wo + bo for the block's 64 query rows
// (q0 .. q0+63 of batch row b), 64 output columns at a time. sA is the
// merged [64, HD] bf16 attention tile (row stride HD + 8); each warp reads
// only the 16 rows it wrote, so no barrier is needed before this call.
// Wo is [HD (in), HD (out)] row-major, streamed in 64x64 tiles through sW
// (64 x LDS bf16). Rows >= T are not stored.
__device__ __forceinline__ void o_proj_residual(
    const bf16* sA, bf16* sW, const bf16* __restrict__ x,
    const bf16* __restrict__ wo, const bf16* __restrict__ bo,
    bf16* __restrict__ out, int b, int q0, int T, int HD) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int ra = q0 + r0 + g, rb = ra + 8;
  const int HDP = HD + 8;
  const int n_chunks = HD / 64;
  for (int nc = 0; nc < n_chunks; ++nc) {
    float y[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc) {
      __syncthreads();
      load_tile(sW, wo + (long long)kc * 64 * HD + nc * 64, HD, 64);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* ar = sA + (r0 + g) * HDP + kc * 64 + kk * 16 + t4 * 2;
        uint32_t a[4];
        a[0] = ld32(ar);
        a[1] = ld32(ar + 8 * HDP);
        a[2] = ld32(ar + 8);
        a[3] = ld32(ar + 8 * HDP + 8);
        const bf16* wr = sW + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* p = wr + j * 8;
          mma_16816(y[j], a, pack_raw(p, p + LDS),
                    pack_raw(p + 8 * LDS, p + 9 * LDS));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nc * 64 + j * 8 + t4 * 2;
      const float2 bv = unpack_bf16(ld32(bo + col));
      if (ra < T) {
        const long long i = ((long long)b * T + ra) * HD + col;
        const float2 xv = unpack_bf16(ld32(x + i));
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(xv.x + y[j][0] + bv.x, xv.y + y[j][1] + bv.y);
      }
      if (rb < T) {
        const long long i = ((long long)b * T + rb) * HD + col;
        const float2 xv = unpack_bf16(ld32(x + i));
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(xv.x + y[j][2] + bv.x, xv.y + y[j][3] + bv.y);
      }
    }
  }
}

// Raises `kernel`'s dynamic shared-memory limit to the current card's
// opt-in maximum per block.
template <typename F>
inline cudaError_t allow_max_smem(F* kernel) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  return e;
}

}  // namespace enc
