// K2: single-query attention over merged-head K/V, with a position mask.
// One query row per (batch, head) against K/V stored [B, T, H*64] -- the
// order the k/v dense layers emit, so no head split is ever materialised.
// Keys t > n_valid - 1 are skipped (causal self attention over the decode
// cache); n_valid = T attends every key (cross attention). Output is
// [B, H*64] float32: softmax and both products run in f32 on the bf16
// inputs, and the result is not rounded back to bf16 (the caller rounds
// it into the o-projection's input dtype right after).
//
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/
// cross_attention.py::fused_single_query_attention (body _kernel,
// pallas_call at :145).
//
// What bounds it on an H100: device-memory bytes. Cross K/V at B=32,
// T=1500, base width are 49 MB per tensor per layer, read once per decode
// step for 4 FLOP per byte -- far under the card's balance point.
//
// Design (simple first version): one 256-thread block per (head, batch
// row). Eight lanes cover one 64-wide head row with one 16-byte load each,
// so a block streams 32 K and V rows at a time, fully coalesced
// (128 contiguous bytes per row and tensor). Each 8-lane group keeps an
// online softmax (running max, sum, 8 output columns in registers); the
// 32 group states merge through shared memory at the end. The /l division
// is applied once to the merged output, as the TPU kernel defers it.
// Later work (ROADMAP): split-T flash-decoding for more blocks in flight
// at small batch.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int NT = 256;
constexpr int GROUPS = NT / 8;  // K/V rows in flight per block

__device__ __forceinline__ void bf16x8_to_f32(uint4 r, float f[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__global__ void __launch_bounds__(NT) single_query_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, float* __restrict__ out, int T, int HD,
    int n_valid, float scale) {
  __shared__ float sm_m[GROUPS], sm_l[GROUPS];
  __shared__ float sm_acc[GROUPS][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int sub = threadIdx.x & 7, grp = threadIdx.x >> 3;
  const int col = h * D + sub * 8;

  float qf[8];
  bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + (long long)b * HD + col),
                qf);
  const bf16* kb = k + (long long)b * T * HD + col;
  const bf16* vb = v + (long long)b * T * HD + col;

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  // uniform trip count over the block, so every lane reaches the shuffles
  for (int t0 = 0; t0 < n_valid; t0 += GROUPS) {
    const int t = t0 + grp;
    const bool ok = t < n_valid;
    uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
    if (ok) {
      kr = *reinterpret_cast<const uint4*>(kb + (long long)t * HD);
      vr = *reinterpret_cast<const uint4*>(vb + (long long)t * HD);
    }
    float kf[8];
    bf16x8_to_f32(kr, kf);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(qf[i], kf[i], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (ok) {
      s *= scale;
      const float mn = fmaxf(m, s);
      const float c = expf(m - mn);  // 0 for the empty first state
      const float p = expf(s - mn);
      float vf[8];
      bf16x8_to_f32(vr, vf);
      l = l * c + p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i] * c);
      m = mn;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) sm_acc[grp][sub * 8 + i] = acc[i];
  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = -INFINITY;
    for (int i = 0; i < GROUPS; ++i) mx = fmaxf(mx, sm_m[i]);
    float lsum = 0.f, o = 0.f;
    for (int i = 0; i < GROUPS; ++i) {
      // groups that saw no key hold m = -inf and contribute 0
      const float w = expf(sm_m[i] - mx);
      lsum += sm_l[i] * w;
      o += sm_acc[i][d] * w;
    }
    out[(long long)b * HD + h * D + d] = o / lsum;
  }
}

}  // namespace

// q: [B, HD] bf16; k, v: [B, T, HD] bf16 contiguous; out: [B, HD] f32.
// HD = H * 64. Attends keys 0 .. n_valid-1 (1 <= n_valid <= T).
// Returns cudaGetLastError() after the launch.
extern "C" int mas_single_query_attention(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int T, int HD, int n_valid,
                                          float scale, void* stream) {
  dim3 grid(H, B);
  single_query_attention_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)out, T, HD,
      n_valid, scale);
  return (int)cudaGetLastError();
}
