// K6: single-query attention over merged-head int8 K/V with int8 dots.
// Per (batch row b, head h), with D = 64 and keys t < n_valid:
//   qs     = max(max_d |q[d]|, 1e-12) / 127,  q8 = clip(rint(q / qs))
//   li[t]  = sum_d k8[t, d] * q8[d]                      (int32, exact)
//   lg[t]  = ((li[t] * ks[t]) * qs) * scale
//   p[t]   = exp(lg[t] - max lg),  l = sum_t p[t],  pw[t] = p[t] * vs[t]
//   spw    = max(max_t pw[t], 1e-20) / 127,  pw8 = clip(rint(pw / spw))
//   oi[d]  = sum_t pw8[t] * v8[t, d]                     (int32, exact)
//   out[d] = oi[d] * (spw / l)
// with K/V stored [B, T, H*64] int8 (the merged-head layout of the k/v
// dense outputs) and their scales [B, T, H] float32. Output [B, H*64]
// float32. Rounding is rint (half to even, as jnp.round) and every
// division a true one, so the codes are the TPU kernel's.
//
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/
// cross_attention.py::fused_single_query_attention_int8 (body
// _kernel_int8, pallas_call at :329), including the query quantization
// its wrapper does before the call (:308-311).
//
// What bounds it on an H100: device-memory bytes. At B=32, T=1500, base
// width the int8 K and V are 24.6 MB each per layer and decode step (half
// of K2's bf16 read), plus 1.5 MB of scales, for ~2 integer ops a byte.
//
// Design (simple first version): one 256-thread block per (head, batch
// row), as K2. The block quantizes its head's query (a block max), then
//   1. streams the K rows, four lanes per row with one 16-byte load each,
//      and forms li with four __dp4a; the logits go to shared memory
//      (T floats, dynamic);
//   2. takes the block max, exp, the sums l and max pw (block reductions),
//      overwriting the logits with pw;
//   3. streams the V rows: each thread reads 4 columns (one 4-byte word) of
//      4 consecutive rows, transposes the 4x4 bytes with __byte_perm so
//      each word holds one column's 4 rows, and accumulates them against
//      the 4 rows' packed pw8 codes with __dp4a. The 16 row groups' int32
//      partials are summed through shared memory; integer sums are exact,
//      so oi equals the TPU kernel's bit for bit.
// Keys at t >= n_valid (the pos mask) are not read: the TPU kernel gives
// them p = exp(-1e30 - m) = 0 and pw8 = 0, which adds nothing.
// Later work (ROADMAP): split-T for more blocks in flight, K and V passes
// overlapped.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int NT = 256;
constexpr int ROWS1 = NT / 4;   // K rows per pass-1 iteration
constexpr int GROUPS = NT / 16;  // V row groups in pass 3

__device__ __forceinline__ float code8(float v, float s) {
  return fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

__global__ void __launch_bounds__(NT) sqa_int8_kernel(
    const bf16* __restrict__ q, const int8_t* __restrict__ k8,
    const float* __restrict__ ks, const int8_t* __restrict__ v8,
    const float* __restrict__ vs, float* __restrict__ out, int T, int H,
    int n_valid, float scale) {
  extern __shared__ float s_pw[];  // [n_valid]: logits, then pw
  __shared__ float s_red[NT / 32];
  __shared__ __align__(16) int8_t s_q8[D];
  __shared__ int s_oi[GROUPS][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int HD = H * D;
  const int tid = threadIdx.x;

  // the query's per-head int8 codes
  const float qv =
      tid < D ? __bfloat162float(q[(long long)b * HD + h * D + tid]) : 0.f;
  const float qs = fmaxf(block_max<NT>(fabsf(qv), s_red), 1e-12f) / 127.f;
  if (tid < D) s_q8[tid] = (int8_t)code8(qv, qs);
  __syncthreads();

  // 1. logits, four lanes per key row
  const int sub = tid & 3, r = tid >> 2;
  const int4 qw = *reinterpret_cast<const int4*>(s_q8 + sub * 16);
  const int8_t* kb = k8 + (long long)b * T * HD + h * D + sub * 16;
  const float* ksb = ks + (long long)b * T * H + h;
  float mloc = -INFINITY;
  // uniform trip count over the block, so every lane reaches the shuffles
  for (int t0 = 0; t0 < n_valid; t0 += ROWS1) {
    const int t = t0 + r;
    int li = 0;
    if (t < n_valid) {
      const int4 kw = *reinterpret_cast<const int4*>(kb + (long long)t * HD);
      li = __dp4a(kw.x, qw.x, li);
      li = __dp4a(kw.y, qw.y, li);
      li = __dp4a(kw.z, qw.z, li);
      li = __dp4a(kw.w, qw.w, li);
    }
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (sub == 0 && t < n_valid) {
      const float lg = (float)li * ksb[(long long)t * H] * qs * scale;
      s_pw[t] = lg;
      mloc = fmaxf(mloc, lg);
    }
  }
  const float m = block_max<NT>(mloc, s_red);

  // 2. p, l, pw and its max
  const float* vsb = vs + (long long)b * T * H + h;
  float lsum = 0.f, pmax = 0.f;
  for (int t = tid; t < n_valid; t += NT) {
    const float p = expf(s_pw[t] - m);
    const float pw = p * vsb[(long long)t * H];
    lsum += p;
    pmax = fmaxf(pmax, pw);
    s_pw[t] = pw;
  }
  const float l = block_sum<NT>(lsum, s_red);
  const float spw = fmaxf(block_max<NT>(pmax, s_red), 1e-20f) / 127.f;

  // 3. oi = pw8 . v8, 4 columns x 4 rows per thread and step
  const int tw = tid & 15, tg = tid >> 4;
  const int8_t* vb = v8 + (long long)b * T * HD + h * D + tw * 4;
  int acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  for (int t0 = tg * 4; t0 < n_valid; t0 += GROUPS * 4) {
    uint32_t w[4];
    uint32_t codes = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      w[j] = 0u;
      if (t < n_valid) {
        w[j] = *reinterpret_cast<const uint32_t*>(vb + (long long)t * HD);
        codes |= ((uint32_t)(int)code8(s_pw[t], spw) & 0xffu) << (8 * j);
      }
    }
    // 4 rows x 4 columns of bytes -> one word per column (byte j = row j)
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    acc0 = __dp4a((int)__byte_perm(lo01, lo23, 0x5410), (int)codes, acc0);
    acc1 = __dp4a((int)__byte_perm(lo01, lo23, 0x7632), (int)codes, acc1);
    acc2 = __dp4a((int)__byte_perm(hi01, hi23, 0x5410), (int)codes, acc2);
    acc3 = __dp4a((int)__byte_perm(hi01, hi23, 0x7632), (int)codes, acc3);
  }
  s_oi[tg][tw * 4 + 0] = acc0;
  s_oi[tg][tw * 4 + 1] = acc1;
  s_oi[tg][tw * 4 + 2] = acc2;
  s_oi[tg][tw * 4 + 3] = acc3;
  __syncthreads();
  if (tid < D) {
    int oi = 0;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) oi += s_oi[i][tid];
    out[(long long)b * HD + h * D + tid] = (float)oi * (spw / l);
  }
}

}  // namespace

// q: [B, H*64] bf16; k8, v8: [B, T, H*64] int8; ks, vs: [B, T, H] float32,
// all contiguous; out: [B, H*64] float32. Attends keys 0 .. n_valid-1
// (1 <= n_valid <= T, n_valid * 4 bytes of dynamic shared memory <= 48 KB).
// Returns cudaGetLastError() after the launch.
extern "C" int mas_single_query_attention_int8(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, void* out, int B, int H, int T, int n_valid, float scale,
    void* stream) {
  dim3 grid(H, B);
  sqa_int8_kernel<<<grid, NT, n_valid * (int)sizeof(float),
                    (cudaStream_t)stream>>>(
      (const bf16*)q, (const int8_t*)k8, (const float*)ks, (const int8_t*)v8,
      (const float*)vs, (float*)out, T, H, n_valid, scale);
  return (int)cudaGetLastError();
}
