// K5: dense layer on int8 weights,  out = (x @ W) * scale [+ b],  where W is
// the int8 [K, N] matrix converted to bf16 (exact: |W| <= 127) and scale the
// per-column float32 scale. x is [M, K] bf16; the sums run in float32 on the
// tensor cores; the bias is added in float32 after the scale and the result
// is stored as float32 or rounded once to bf16.
//
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/quant.py::
// quant_matmul (body _qmm_kernel, pallas_call at :113). Its caller,
// quant_dense_apply, adds the bias in float32 after the product and casts
// to the output dtype; this kernel does both in its epilogue, on the same
// values (the multiply and the add are rounded separately, no FMA).
//
// What bounds it on an H100, by regime:
//   * a decode step (M = batch rows, 8-32): the weight bytes. The tied
//     logits matrix is [512, 51865] int8 = 26.5 MB per step, ~8 us at
//     3.35 TB/s; the [512, 512] layers are 0.26 MB and latency-bound.
//   * the cross K/V projection over the encoder output (M = B*1500 =
//     48,000 at B=32): tensor-core work, 25 GFLOP per projection against
//     ~0.1 GB of traffic.
// Design (simple first version). One template, two tilings, picked by the
// wrapper from M:
//   * "large": 128x128 output tile, 8 warps (4 x 2), each 32 x 64;
//   * "small": 32x32 output tile, 4 warps (2 x 2), each 16 x 16, so the
//     N=512 layers of a decode step still spread over 16 blocks and the
//     logits over 1621 (a split over N, as a GEMV would split).
// Per K step, every thread loads its share of the x tile (16-byte loads)
// and of the int8 W tile (4-byte words, or single bytes when N % 4 != 0,
// as for the vocabulary of 51865), converts the int8 codes to bf16 on the
// way into shared memory, and the warps run mma.sync m16n8k16 bf16 tiles
// with float32 accumulation. The next step's global loads are issued into
// registers before the current step's products, so they are in flight
// while the tensor cores work. Columns >= N (the last, partial column tile)
// and rows >= M are zero-filled on load and never stored.
// Later work (ROADMAP): cp.async/TMA staging, wgmma, split-K for the small
// decode layers.
#include "common.cuh"

namespace {

template <int BM, int BN, int BK, int WM, int WN>
struct Tiling {
  static constexpr int NT = WM * WN * 32;
  static constexpr int TM = BM / WM;  // rows of one warp's tile
  static constexpr int TN = BN / WN;  // columns of one warp's tile
  static constexpr int MT = TM / 16;  // m16 fragments per warp
  static constexpr int NF = TN / 8;   // n8 fragments per warp
  static constexpr int LDX = BK + 8;  // padded row strides (bf16 elements)
  static constexpr int LDW = BN + 8;
  static constexpr int XC = BM * BK / 8 / NT;  // 16-byte x chunks per thread
  static constexpr int WW = BK * BN / 4 / NT;  // 4-byte W words per thread
  static_assert(XC * NT * 8 == BM * BK && WW * NT * 4 == BK * BN,
                "tile loads must divide evenly over the threads");
  static_assert(TM % 16 == 0 && TN % 8 == 0 && BK % 16 == 0, "mma tiling");
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) quant_matmul_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, const bf16* __restrict__ bias,
    void* __restrict__ out, int M, int K, int N, int out_bf16) {
  using T = Tiling<BM, BN, BK, WM, WN>;
  __shared__ __align__(16) bf16 sX[BM * T::LDX];
  __shared__ __align__(16) bf16 sW[BK * T::LDW];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const bool words = (N & 3) == 0;  // W rows 4-byte aligned

  uint4 xr[T::XC];
  uint32_t wr[T::WW];
  // global -> registers for the K step starting at k0
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < T::XC; ++j) {
      const int i = tid + j * T::NT;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      xr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K)
        xr[j] = *reinterpret_cast<const uint4*>(x + (long long)m * K + k);
    }
#pragma unroll
    for (int j = 0; j < T::WW; ++j) {
      const int i = tid + j * T::NT;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int k = k0 + r, n = n0 + c;
      uint32_t w = 0u;
      if (k < K) {
        const int8_t* p = wq + (long long)k * N + n;
        if (words) {
          if (n < N) w = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) w |= (uint32_t)(uint8_t)p[e] << (8 * e);
        }
      }
      wr[j] = w;
    }
  };
  // registers -> shared memory; int8 codes become bf16 (exact)
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < T::XC; ++j) {
      const int i = tid + j * T::NT;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(sX + r * T::LDX + c) = xr[j];
    }
#pragma unroll
    for (int j = 0; j < T::WW; ++j) {
      const int i = tid + j * T::NT;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const uint32_t w = wr[j];
      const float f0 = (float)(signed char)(w & 0xffu);
      const float f1 = (float)(signed char)((w >> 8) & 0xffu);
      const float f2 = (float)(signed char)((w >> 16) & 0xffu);
      const float f3 = (float)(signed char)(w >> 24);
      *reinterpret_cast<uint2*>(sW + r * T::LDW + c) =
          make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
    }
  };

  float acc[T::MT][T::NF][4];
#pragma unroll
  for (int a = 0; a < T::MT; ++a)
#pragma unroll
    for (int b = 0; b < T::NF; ++b)
      acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous step's tiles are consumed
    store();
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[T::MT][4];
#pragma unroll
      for (int a = 0; a < T::MT; ++a) {
        const bf16* ar = sX + (wm * T::TM + a * 16 + g) * T::LDX + kk * 16 +
                         t4 * 2;
        af[a][0] = ld32(ar);
        af[a][1] = ld32(ar + 8 * T::LDX);
        af[a][2] = ld32(ar + 8);
        af[a][3] = ld32(ar + 8 * T::LDX + 8);
      }
#pragma unroll
      for (int b = 0; b < T::NF; ++b) {
        const bf16* p = sW + (kk * 16 + t4 * 2) * T::LDW + wn * T::TN + b * 8 +
                        g;
        const uint32_t b0 = pack_raw(p, p + T::LDW);
        const uint32_t b1 = pack_raw(p + 8 * T::LDW, p + 9 * T::LDW);
#pragma unroll
        for (int a = 0; a < T::MT; ++a) mma_16816(acc[a][b], af[a], b0, b1);
      }
    }
  }

  // epilogue: * scale[n] (+ bias[n]), rows < M and columns < N only
#pragma unroll
  for (int a = 0; a < T::MT; ++a) {
#pragma unroll
    for (int b = 0; b < T::NF; ++b) {
      const int col = n0 + wn * T::TN + b * 8 + t4 * 2;
      const int row = m0 + wm * T::TM + a * 16 + g;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = row + 8 * hh;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col + e;
          if (n >= N) continue;
          float y = __fmul_rn(acc[a][b][2 * hh + e], scale[n]);
          if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[n]));
          const long long o = (long long)m * N + n;
          if (out_bf16)
            static_cast<bf16*>(out)[o] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(out)[o] = y;
        }
      }
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   const void* bias, void* out, int M, int K, int N,
                   int out_bf16, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<BM, BN, BK, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(
      (const bf16*)x, (const int8_t*)wq, (const float*)scale,
      (const bf16*)bias, out, M, K, N, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16 contiguous (K % 8 == 0, 16-byte aligned); wq: [K, N] int8
// contiguous; scale: [N] float32; bias: [N] bf16 or null; out: [M, N]
// float32 (out_bf16 = 0) or bf16 (out_bf16 = 1). small = 1 takes the 32x32
// tiling (decode steps), 0 the 128x128 one. Returns cudaGetLastError()
// after the launch.
extern "C" int mas_quant_matmul(const void* x, const void* wq,
                                const void* scale, const void* bias, void* out,
                                int M, int K, int N, int out_bf16, int small,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      small ? launch<32, 32, 64, 2, 2>(x, wq, scale, bias, out, M, K, N,
                                       out_bf16, s)
            : launch<128, 128, 32, 4, 2>(x, wq, scale, bias, out, M, K, N,
                                         out_bf16, s);
  return (int)e;
}
