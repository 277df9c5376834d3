// K12: fused search scoring over the [N, 2, D] segment index.
// Per segment n, with q the unit query (float32) and the index in float32
// or bf16 (widened to float32):
//   s_j   = emb[n, j, :] . q                 (j = 0 ASR, 1 audio; f32 sums)
//   eff_j = w_j * ok_j / max(w_0 ok_0 + w_1 ok_1, 1e-30)
//   score = eff_0 s_0 + eff_1 s_1
//   valid = (s_0 > 0 || s_1 > 0) && total > 0 && score > threshold
//   out[n] = valid ? score : -1e30
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/
// fused_search.py::pallas_fused_scores (body _score_kernel :25,
// pallas_call :73).
//
// What bounds it on an H100: device-memory bytes. The index is read once
// (3.07 GB at N = 1M, D = 384 in float32; 1.54 GB in bf16) for 2 FLOP per
// element, far under the card's balance point; the rest is 2 bytes of
// flags and 4 bytes of output per segment.
//
// Design: one warp per segment, warps striding over N. Each lane reads
// 16-byte pieces of the segment's two embeddings (a segment is one
// contiguous 2*D row), neighbouring lanes on neighbouring addresses, with
// streaming loads (the index is read once); the query sits in shared
// memory. Lanes keep one partial sum per slot, the warp adds them with
// shuffles, and lane 0 applies the weights, the any-positive rule and the
// strict threshold with unfused float32 products and sums, in the plain
// version's order. Any N is valid: there is no padding to a block as on
// the TPU (a Mosaic tiling rule), and the stride loop ends at N. The
// success flags are read as bytes (torch.bool), never widened on the host.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int BLOCKS_PER_SM = 8;  // 64 warps: the SM's thread limit
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dot product of one 16-byte piece of the index with the matching
// query elements (4 float32 or 8 bf16 values)
__device__ __forceinline__ float dot16(uint4 r, const float* q, float) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  float s = __uint_as_float(r.x) * a.x;
  s = fmaf(__uint_as_float(r.y), a.y, s);
  s = fmaf(__uint_as_float(r.z), a.z, s);
  return fmaf(__uint_as_float(r.w), a.w, s);
}
__device__ __forceinline__ float dot16(uint4 r, const float* q, bf16) {
  float e[8];
  bf16x8_to_f32(r, e);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s = fmaf(e[i], q[i], s);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_scores_kernel(
    const float* __restrict__ q, const T* __restrict__ emb,
    const unsigned char* __restrict__ ok, float w0, float w1,
    float threshold, float* __restrict__ out, long long N, int D) {
  extern __shared__ __align__(16) float sq[];  // [D] query
  for (int i = threadIdx.x; i < D; i += NT) sq[i] = q[i];
  __syncthreads();
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte piece
  const int per_slot = D / V, pieces = 2 * per_slot;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long n = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       n < N; n += stride) {
    const uint4* row = reinterpret_cast<const uint4*>(emb + n * 2 * D);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int c = lane; c < pieces; c += 32) {
      const bool audio = c >= per_slot;
      const float s = dot16(__ldcs(row + c),
                            sq + (audio ? c - per_slot : c) * V, T());
      if (audio)
        s1 += s;
      else
        s0 += s;
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      float e0 = __fmul_rn(w0, ok[2 * n] ? 1.f : 0.f);
      float e1 = __fmul_rn(w1, ok[2 * n + 1] ? 1.f : 0.f);
      const float total = __fadd_rn(e0, e1);
      const float den = fmaxf(total, 1e-30f);
      e0 = __fdiv_rn(e0, den);
      e1 = __fdiv_rn(e1, den);
      const float score = __fadd_rn(__fmul_rn(e0, s0), __fmul_rn(e1, s1));
      const bool valid =
          (s0 > 0.f || s1 > 0.f) && total > 0.f && score > threshold;
      out[n] = valid ? score : NEG_INF;
    }
  }
}

}  // namespace

// q: [D] float32; emb: [N, 2, D] float32 (bf16_index = 0) or bf16 (1),
// contiguous, 16-byte aligned, D * element size a multiple of 16; ok:
// [N, 2] bytes (0/1); out: [N] float32. Returns cudaGetLastError() after
// the launch.
extern "C" int mas_fused_scores(const void* q, const void* emb,
                                const void* ok, float w0, float w1,
                                float threshold, void* out, long long N,
                                int D, int bf16_index, void* stream) {
  const int V = bf16_index ? 8 : 4;
  const size_t smem = (size_t)D * sizeof(float);
  if (N < 1 || D < V || D % V || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (N + WARPS - 1) / WARPS;
  const int grid = (int)(want < (long long)sms * BLOCKS_PER_SM
                             ? want
                             : (long long)sms * BLOCKS_PER_SM);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_index)
    fused_scores_kernel<bf16><<<grid, NT, smem, s>>>(
        (const float*)q, (const bf16*)emb, (const unsigned char*)ok, w0, w1,
        threshold, (float*)out, N, D);
  else
    fused_scores_kernel<float><<<grid, NT, smem, s>>>(
        (const float*)q, (const float*)emb, (const unsigned char*)ok, w0,
        w1, threshold, (float*)out, N, D);
  return (int)cudaGetLastError();
}
