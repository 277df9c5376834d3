// K13: streaming read of a bf16 slab, the device-memory rate that the
// search's roofline share divides by.
//   sums[c] += passes x sum_r x[r, c]   for every column c of a row-major
//   [R, C] bf16 slab (float32 sums; the slab is read `passes` times)
// Replaces the Pallas kernel in bench.py::calibrate (rd, body kern :198,
// pallas_call :206), whose grid (passes, n_chunk) sums every [rows, cols]
// block's columns into o and keeps the first 128. The sum runs over ALL
// columns here too, so every byte of the slab is read; the wrapper keeps
// the first 128 as the TPU kernel does.
//
// What bounds it on an H100: device-memory bytes, 2 per element per pass
// for one add, by design (4 GiB x 8 passes = 34.4 GB at the calibration's
// shape). Nothing else is read or written.
//
// Design: a grid of 8 blocks per SM, each thread a fixed 8-column group
// (one 16-byte load per row, neighbouring threads on neighbouring
// addresses, a block's rows contiguous) striding over the rows with four
// loads in flight; streaming loads (the slab does not fit in L2); float32
// partial sums in registers, reduced over the block's row lanes in
// shared memory, then one atomicAdd per column and block.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int UNROLL = 4;

__device__ __forceinline__ void add8(float acc[8], uint4 r) {
  float f[8];
  bf16x8_to_f32(r, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] += f[j];
}

__global__ void __launch_bounds__(NT) stream_read_kernel(
    const bf16* __restrict__ x, float* __restrict__ sums, long long R, int C,
    int passes) {
  extern __shared__ __align__(16) float red[];  // [RPB][C]
  const int CG = C / 8;    // 16-byte column groups per row
  const int RPB = NT / CG; // rows a block reads per step
  const int cg = threadIdx.x % CG, rl = threadIdx.x / CG;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (rl < RPB) {
    const long long step = (long long)gridDim.x * RPB;
    const uint4* base = reinterpret_cast<const uint4*>(x) + cg;
    for (int p = 0; p < passes; ++p) {
      long long r = (long long)blockIdx.x * RPB + rl;
      for (; r + (UNROLL - 1) * step < R; r += UNROLL * step) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          v[u] = __ldcs(base + (r + u * step) * CG);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add8(acc, v[u]);
      }
      for (; r < R; r += step) add8(acc, __ldcs(base + r * CG));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[rl * C + cg * 8 + j] = acc[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f;
    for (int i = 0; i < RPB; ++i) s += red[i * C + c];
    atomicAdd(sums + c, s);
  }
}

}  // namespace

// x: [R, C] bf16 row-major, contiguous, 16-byte aligned, C % 8 == 0 and
// C <= 2048; sums: [C] float32, zeroed by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int mas_stream_read(const void* x, void* sums, long long R, int C,
                               int passes, void* stream) {
  if (R < 1 || C < 8 || C % 8 || C / 8 > NT || passes < 1)
    return (int)cudaErrorInvalidValue;
  const int rpb = NT / (C / 8);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (R + rpb - 1) / rpb;
  const int grid = (int)(want < (long long)sms * BLOCKS_PER_SM
                             ? want
                             : (long long)sms * BLOCKS_PER_SM);
  const size_t smem = (size_t)rpb * C * sizeof(float);
  stream_read_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (float*)sums, R, C, passes);
  return (int)cudaGetLastError();
}
