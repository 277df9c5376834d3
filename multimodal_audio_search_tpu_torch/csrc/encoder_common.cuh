// Shared pieces of K9 (encoder_block_int8.cu): the head dim, its 64-row
// tiling and the shared-memory limit.
#pragma once

#include "common.cuh"

namespace enc {

constexpr int D = 64;      // head dim of every Whisper preset
constexpr int BQ = 64;     // query rows per block

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
