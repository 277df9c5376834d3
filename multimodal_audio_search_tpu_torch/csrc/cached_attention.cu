// K7: single-query attention over an int8 K/V cache in the [B, H, T, D]
// layout with per-(b, h, t) scales. Per (batch row b, head h), D = 64:
//   lg[t]  = (sum_d bf16(q[d]) * k8[t, d]) * ks[t] * scale   (f32 sums)
//   p      = softmax_t(lg)                    (exp, then a true division)
//   pw[t]  = bf16(p[t] * vs[t])
//   out[d] = sum_t pw[t] * v8[t, d]           (f32 sums)
// q arrives in bf16 (the TPU kernel rounds it to bf16 before the dot), and
// pw is rounded to bf16 before the second dot, as the TPU kernel does. The
// int8 codes are exact in bf16, and a bf16 x int8 product is exact in
// float32, so only the order of the float32 sums differs from the TPU
// kernel. Output [B, H, D] float32.
//
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/
// cached_attention.py::int8_cached_attention (body _kernel, pallas_call
// at :90). Its GRP=8 grouping of (b, h) rows is a TPU sublane rule and is
// not carried over.
//
// What bounds it on an H100: device-memory bytes, as K6: 24.6 MB of int8 K
// and as much V per layer and decode step at B=32, T=1500, base width.
//
// Design (simple first version): one 256-thread block per (head, batch
// row). Each (b, h) row block of K and V is contiguous ([T, 64] int8), so
// pass 1 reads it with four lanes per row (one 16-byte load each, 16 FMAs,
// a 4-lane shuffle sum) into T logits in shared memory; the softmax runs
// in place with block reductions; pass 2 reads V as 4-byte words, 16
// threads per row and 16 row groups, and the groups' float32 partials are
// summed through shared memory in a fixed order.
// Later work (ROADMAP): split-T, int8 tensor-core dots.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int NT = 256;
constexpr int ROWS1 = NT / 4;
constexpr int GROUPS = NT / 16;

__global__ void __launch_bounds__(NT) int8_cached_attention_kernel(
    const bf16* __restrict__ q, const int8_t* __restrict__ k8,
    const float* __restrict__ ks, const int8_t* __restrict__ v8,
    const float* __restrict__ vs, float* __restrict__ out, int T,
    float scale) {
  extern __shared__ float s_p[];  // [T]: logits, then bf16-rounded pw
  __shared__ float s_red[NT / 32];
  __shared__ float s_acc[GROUPS][D];
  const long long bh = blockIdx.x;  // b * H + h
  const int tid = threadIdx.x;

  // 1. logits, four lanes per key row
  const int sub = tid & 3, r = tid >> 2;
  float qf[16];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(q + bh * D + sub * 16);
    bf16x8_to_f32(qp[0], qf);
    bf16x8_to_f32(qp[1], qf + 8);
  }
  const int8_t* kb = k8 + bh * T * D + sub * 16;
  const float* ksb = ks + bh * T;
  float mloc = -INFINITY;
  for (int t0 = 0; t0 < T; t0 += ROWS1) {
    const int t = t0 + r;
    float s = 0.f;
    if (t < T) {
      const int4 kw = *reinterpret_cast<const int4*>(kb + (long long)t * D);
      const int words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s = fmaf(qf[4 * i + e], (float)(signed char)(words[i] >> (8 * e)),
                   s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (sub == 0 && t < T) {
      const float lg = s * ksb[t] * scale;
      s_p[t] = lg;
      mloc = fmaxf(mloc, lg);
    }
  }
  const float m = block_max<NT>(mloc, s_red);

  // 2. softmax in place, then pw = bf16(p * vs)
  float lsum = 0.f;
  for (int t = tid; t < T; t += NT) {
    const float p = expf(s_p[t] - m);
    s_p[t] = p;
    lsum += p;
  }
  const float l = block_sum<NT>(lsum, s_red);
  const float* vsb = vs + bh * T;
  for (int t = tid; t < T; t += NT)
    s_p[t] = __bfloat162float(__float2bfloat16_rn(s_p[t] / l * vsb[t]));
  __syncthreads();

  // 3. out = pw . v8, 4 columns per thread, 16 row groups
  const int tw = tid & 15, tg = tid >> 4;
  const int8_t* vb = v8 + bh * T * D + tw * 4;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int t = tg; t < T; t += GROUPS) {
    const int w = *reinterpret_cast<const int*>(vb + (long long)t * D);
    const float p = s_p[t];
    a0 = fmaf(p, (float)(signed char)w, a0);
    a1 = fmaf(p, (float)(signed char)(w >> 8), a1);
    a2 = fmaf(p, (float)(signed char)(w >> 16), a2);
    a3 = fmaf(p, (float)(signed char)(w >> 24), a3);
  }
  s_acc[tg][tw * 4 + 0] = a0;
  s_acc[tg][tw * 4 + 1] = a1;
  s_acc[tg][tw * 4 + 2] = a2;
  s_acc[tg][tw * 4 + 3] = a3;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) o += s_acc[i][tid];
    out[bh * D + tid] = o;
  }
}

}  // namespace

// q: [B, H, 64] bf16; k8, v8: [B, H, T, 64] int8; ks, vs: [B, H, T]
// float32, all contiguous; out: [B, H, 64] float32. T * 4 bytes of dynamic
// shared memory <= 48 KB. Returns cudaGetLastError() after the launch.
extern "C" int mas_int8_cached_attention(const void* q, const void* k8,
                                         const void* ks, const void* v8,
                                         const void* vs, void* out, int B,
                                         int H, int T, float scale,
                                         void* stream) {
  int8_cached_attention_kernel<<<B * H, NT, T * (int)sizeof(float),
                                 (cudaStream_t)stream>>>(
      (const bf16*)q, (const int8_t*)k8, (const float*)ks, (const int8_t*)v8,
      (const float*)vs, (float*)out, T, scale);
  return (int)cudaGetLastError();
}
