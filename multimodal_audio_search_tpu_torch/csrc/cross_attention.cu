// K2: single-query attention over merged-head K/V, with a position mask.
// One query row per (batch, head) against K/V stored [B, T, H*64] -- the
// order the k/v dense layers emit, so no head split is ever materialised.
// Keys t > n_valid - 1 are skipped (causal self attention over the decode
// cache); n_valid = T attends every key (cross attention). Output is
// [B, H*64] float32: softmax and both products run in f32 on the bf16
// inputs, and the result is not rounded back to bf16 (the caller rounds
// it into the o-projection's input dtype right after). A float32 form of
// the same kernel (mas_single_query_attention_f32) takes float32 q, k and
// v, as the TPU kernel takes either dtype: a float32 decode on the card
// runs it; it stages 64 keys at a time, half the rows, so that its
// shared memory stays that of the bf16 form.
//
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/
// cross_attention.py::fused_single_query_attention (body _kernel,
// pallas_call at :145).
//
// What bounds it on an H100: device-memory bytes. Cross K/V at B=32,
// T=1500, base width are 49 MB per tensor per layer, read once per decode
// step for 4 FLOP per byte -- far under the card's balance point. With one
// query row per head the products have M = 1, so the tensor cores would
// sit idle; the dots are f32 FMAs on the CUDA cores.
//
// Design: split T (flash-decoding) with asynchronous copies.
//   * The grid is (H, S, B): split s of (b, h) takes keys s*chunk ..
//     (s+1)*chunk - 1 below n_valid; the host picks S from n_valid
//     (ops/cross_attention.py::split_plan: 128 keys a split, S = 12 at
//     T = 1500, 3072 blocks; S = 1 for the self-attention calls). Heads
//     vary fastest, so blocks resident together read whole K/V rows.
//   * A block of 128 threads stages up to 128 keys at a time. Before its
//     first arithmetic it issues every copy of them (cp.async, 16 bytes a
//     thread per row and tensor: 8 lanes cover a head's 128-byte slice of
//     a row, 16 rows a pass, eight passes), so 32 KB are in flight per
//     block and several blocks per SM. Each thread reads back only the
//     bytes it copied itself, so no barrier stands between copy and use.
//   * Each 8-lane group keeps an online softmax (running max, sum, its 8
//     output columns) over its rows; the four groups of a warp merge by
//     shuffles, the four warps through shared memory.
//   * S = 1 divides by l and writes the output. Otherwise each split
//     writes its (m, l, acc[64]) to a float32 scratch and the last block
//     to arrive for its (batch, head) (a __threadfence, then an atomic on
//     the pair's counter) merges the S states and writes the output, so a
//     call stays one launch; it leaves the counter at zero for the next.
//     A split or group with no valid key holds m = -inf, l = 0, acc = 0
//     and contributes nothing.
// The /l division is applied once to the merged output, as the TPU kernel
// defers it. Tried on an H100 and not kept: a ring of cp.async stages
// over longer chunks, TMA boxes in place of cp.async, 256- and 64-thread
// blocks, 6 to 48 splits at T=1500 -- none read more than a few percent
// faster than this, and the one-block-per-head kernel this replaced
// reads at the same rate on the device (PERF.md).
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int D = 64;
constexpr int NT = 128;
constexpr int GROUPS = NT / 8;          // key rows per pass, 8 lanes a row
constexpr int PART = D + 2;             // floats of a split's state: m, l, acc

// Eight consecutive elements of a head's slice, as floats.
__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  bf16x8_to_f32(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
// Eight consecutive elements copied to shared memory, asynchronously.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void copy8(float* dst, const float* src) {
  cp_async16(dst, src);
  cp_async16(dst + 4, src + 4);
}

// Weight of a state with max m in a merge whose max is mx (0 for an empty
// state, m = -inf, even when mx is -inf too).
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// E: the element type of q, k and v; PASSES: the passes of GROUPS rows a
// block stages before it computes (CHUNK keys).
template <typename E, int PASSES>
__global__ void __launch_bounds__(NT, 8) single_query_attention_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, float* __restrict__ out, float* part,
    int* counters, int T, int HD, int n_valid, int chunk, float scale) {
  constexpr int CHUNK = GROUPS * PASSES;  // keys staged at once
  __shared__ __align__(16) E sk[CHUNK * D], sv[CHUNK * D];
  __shared__ float sm_m[NT / 32], sm_l[NT / 32], sm_acc[NT / 32][D];
  __shared__ int s_last;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.x, S = gridDim.y;
  const int sub = threadIdx.x & 7, grp = threadIdx.x >> 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = h * D + sub * 8;
  const int t0 = split * chunk;
  const int t1 = min(n_valid, t0 + chunk);  // keys t0 .. t1 - 1, maybe none

  float qf[8];
  load8(q + (long long)b * HD + col, qf);
  const E* kb = k + (long long)b * T * HD + col;
  const E* vb = v + (long long)b * T * HD + col;

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  for (int p0 = t0; p0 < t1; p0 += CHUNK) {  // uniform over the block
    // every copy of this piece first: rows p0 + grp + 16 i, 8 elements each
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int r = grp + i * GROUPS;
      if (p0 + r < t1) {
        copy8(sk + r * D + sub * 8, kb + (long long)(p0 + r) * HD);
        copy8(sv + r * D + sub * 8, vb + (long long)(p0 + r) * HD);
      }
    }
    cp_async_commit();
    cp_async_wait_all();

    float sc[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      float kf[8];
      load8(sk + (grp + i * GROUPS) * D + sub * 8, kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(qf[e], kf[e], d);
      sc[i] = d;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
      for (int i = 0; i < PASSES; ++i)
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], off);
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      // a row past t1 holds stale bytes: replaced, never used in arithmetic
      sc[i] = p0 + grp + i * GROUPS < t1 ? sc[i] * scale : -INFINITY;
      mx = fmaxf(mx, sc[i]);
    }
    if (mx != -INFINITY) {  // the group has seen a key
      const float c = expf(m - mx);  // 0 for the empty first state
      l *= c;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= c;
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        if (sc[i] == -INFINITY) continue;
        const float p = expf(sc[i] - mx);
        float vf[8];
        load8(sv + (grp + i * GROUPS) * D + sub * 8, vf);
        l += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
      }
      m = mx;
    }
  }

  // the warp's four group states (lanes 8 apart share columns)
#pragma unroll
  for (int off = 8; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float ca = weight(m, mn), cb = weight(mo, mn);
    l = l * ca + lo * cb;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] = acc[e] * ca + __shfl_xor_sync(0xffffffffu, acc[e], off) * cb;
    m = mn;
  }
  if (lane < 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[warp][sub * 8 + e] = acc[e];
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {  // the block's state, one column a thread
    const int d = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) mx = fmaxf(mx, sm_m[w]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const float c = weight(sm_m[w], mx);
      ls += sm_l[w] * c;
      o += sm_acc[w][d] * c;
    }
    if (S == 1) {
      out[(long long)b * HD + h * D + d] = o / ls;
    } else {
      float* ps = part + ((long long)(b * H + h) * S + split) * PART;
      if (d == 0) {
        ps[0] = mx;
        ps[1] = ls;
      }
      ps[2 + d] = o;
    }
  }
  if (S == 1) return;

  // the last split of (b, h) to arrive merges the S states
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counters + b * H + h, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    const float* ps = part + (long long)(b * H + h) * S * PART;
    float mx = -INFINITY;
    for (int i = 0; i < S; ++i) mx = fmaxf(mx, __ldcg(ps + i * PART));
    float ls = 0.f, o = 0.f;
    for (int i = 0; i < S; ++i) {
      const float c = weight(__ldcg(ps + i * PART), mx);
      ls += __ldcg(ps + i * PART + 1) * c;
      o += __ldcg(ps + i * PART + 2 + d) * c;
    }
    out[(long long)b * HD + h * D + d] = o / ls;
  }
  if (threadIdx.x == 0) counters[b * H + h] = 0;
}

template <typename E, int PASSES>
int launch_k2(const void* q, const void* k, const void* v, void* out,
              void* part, void* counters, int B, int H, int T, int HD,
              int n_valid, int splits, int chunk, float scale,
              void* stream) {
  dim3 grid(H, splits, B);
  single_query_attention_kernel<E, PASSES>
      <<<grid, NT, 0, (cudaStream_t)stream>>>(
          (const E*)q, (const E*)k, (const E*)v, (float*)out, (float*)part,
          (int*)counters, T, HD, n_valid, chunk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, HD] bf16; k, v: [B, T, HD] bf16 contiguous; out: [B, HD] f32.
// HD = H * 64. Attends keys 0 .. n_valid-1 (1 <= n_valid <= T) in
// `splits` splits of `chunk` keys (splits * chunk >= n_valid). With
// splits > 1, part holds B*H*splits*66 floats and counters B*H zeroed
// ints, which the call leaves zero. Returns cudaGetLastError() after the
// launch.
extern "C" int mas_single_query_attention(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* part, void* counters, int B,
                                          int H, int T, int HD, int n_valid,
                                          int splits, int chunk, float scale,
                                          void* stream) {
  return launch_k2<bf16, 8>(q, k, v, out, part, counters, B, H, T, HD,
                            n_valid, splits, chunk, scale, stream);
}

// The same on float32 q, k and v (16-byte aligned, as the bf16 form's).
extern "C" int mas_single_query_attention_f32(
    const void* q, const void* k, const void* v, void* out, void* part,
    void* counters, int B, int H, int T, int HD, int n_valid, int splits,
    int chunk, float scale, void* stream) {
  return launch_k2<float, 4>(q, k, v, out, part, counters, B, H, T, HD,
                             n_valid, splits, chunk, scale, stream);
}
