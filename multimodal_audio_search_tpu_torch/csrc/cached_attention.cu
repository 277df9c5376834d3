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
// and as much V per layer and decode step at B=32, T=1500, base width,
// plus 3 MB of scales.
//
// Design: split-T across a thread-block cluster. Each (b, h) row gets a
// cluster of CS <= 8 blocks (ops/cached_attention.py::cluster_plan), rank
// r taking the keys [r * chunk, (r + 1) * chunk) (none past T; a rank may
// hold no key). An SM pulls at most ~30 GB/s whatever the copy engine
// (TMA, bulk or cp.async: measured on the H100), so the rate is set by
// keeping every SM's link busy with every block resident at once: an H100
// holds about 8 blocks of a cluster launch an SM, so the plan takes the
// largest cluster whose B * H clusters all fit (B=32: 2 blocks of 750
// keys at H=8, 5 of 300 at H=6). K and V of one (b, h) are contiguous
// [T, 64] int8, and both must cross the link: at entry one thread puts
// the rank's V chunk in flight into shared memory as one 1-D bulk copy
// on an mbarrier, while every thread streams K through registers (16
// codes a lane, four passes of 64 keys in flight) into the logits, so
// V lands during the K pass and the exchanges. ks is staged in the
// logits' array at entry; vs is read where pw is formed. The pw rounding
// needs the row's global max and sum, so the ranks exchange them through
// distributed shared memory: each block's max, then each block's sum of
// exp, read by every rank in rank order. pw = bf16(p / l * vs) is then
// formed with the global l exactly where the one-block kernel formed it.
// Each rank's float32 partial of out [64] (row groups summed in order)
// is summed by rank 0 in rank order.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int D = 64;
constexpr int NT = 256;
constexpr int LANES = 4;              // lanes a key in the logits pass
constexpr int PASSES = 4;             // logits passes whose loads fly at once
constexpr int ROWS1 = NT / LANES;     // keys a logits pass
constexpr int GROUPS = NT / 8;        // key groups of the p . V pass
constexpr int MAX_PER_THREAD = 6;     // keys a thread of a 1536-key block
constexpr int MAX_CS = 8;
constexpr int MAX_T = 12288;

// the buffer holds V, then the warps' partials [NT / 32][64]
__host__ __device__ inline size_t buf_bytes(int chunk) {
  return (size_t)(chunk > NT / 32 * 4 ? chunk : NT / 32 * 4) * D;
}
inline size_t smem_bytes(int chunk) { return buf_bytes(chunk) + chunk * 4; }
// the largest block: MAX_T / MAX_CS keys
constexpr size_t SMEM_MAX = (size_t)(MAX_T / MAX_CS) * (D + 4);

// int8 code b (byte e of w) as a float, exactly: b + 128 goes into the low
// mantissa bits of 2^23 (one byte permute) and 2^23 + 128 comes off (the
// int8 -> float conversion instruction runs at a quarter of the FMA rate)
__device__ __forceinline__ float i8f(uint32_t w, int e) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                    0x7540 | e)) -
         8388736.f;
}

__global__ void __launch_bounds__(NT, 4) int8_cached_attention_kernel(
    const bf16* __restrict__ q, const int8_t* __restrict__ k8,
    const float* __restrict__ ks, const int8_t* __restrict__ v8,
    const float* __restrict__ vs, float* __restrict__ out, int T, int chunk,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* sV = reinterpret_cast<int8_t*>(smem_raw);  // [chunk][64]
  float* sP = reinterpret_cast<float*>(sV + buf_bytes(chunk));  // lg -> pw
  __shared__ uint64_t vbar;      // V landed
  __shared__ float s_red[NT / 32];
  __shared__ float s_ml[2];      // this rank's max, then its sum of exp
  __shared__ float s_bc;         // the cluster's max, then its sum
  __shared__ float s_part[D];    // this rank's share of out
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const long long bh = blockIdx.y;  // b * H + h
  const int t0 = rank * chunk;
  const int n = max(0, min(chunk, T - t0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = bh * T + t0;  // the rank's first key
  const uint32_t kv = (uint32_t)n * D;

  if (tid == 0) {
    mbar_init(&vbar, 1);
    fence_mbar_init();
    mbar_expect_tx(&vbar, kv);
    if (n > 0) bulk_copy(sV, v8 + row * D, kv, &vbar);
  }
  float vsr[MAX_PER_THREAD];  // vs of keys tid, tid + NT, ...
#pragma unroll
  for (int k = 0; k < MAX_PER_THREAD; ++k) {
    const int i = tid + k * NT;
    if (i < n) {
      sP[i] = ks[row + i];  // then the logit
      vsr[k] = vs[row + i];
    }
  }
  const int sub = tid % LANES, r = tid / LANES;
  float qf[D / LANES];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(q + bh * D + sub * 16);
    bf16x8_to_f32(qp[0], qf);
    bf16x8_to_f32(qp[1], qf + 8);
  }
  __syncthreads();  // the barrier's init, the scales

  // 1. logits of the rank's keys, four lanes a key row (16 codes each),
  // PASSES passes of ROWS1 keys whose loads are in flight together
  const int8_t* kb = k8 + row * D + sub * 16;
  float mloc = -INFINITY;
  for (int i0 = 0; i0 < n; i0 += PASSES * ROWS1) {
    int4 kw[PASSES];
#pragma unroll
    for (int u = 0; u < PASSES; ++u)
      kw[u] = __ldg(reinterpret_cast<const int4*>(
          kb + (long long)min(i0 + u * ROWS1 + r, n - 1) * D));
#pragma unroll
    for (int u = 0; u < PASSES; ++u) {
      const int i = i0 + u * ROWS1 + r;
      const int words[4] = {kw[u].x, kw[u].y, kw[u].z, kw[u].w};
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s = fmaf(qf[4 * w + e], i8f(words[w], e), s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (sub == 0 && i < n) {
        const float lg = s * sP[i] * scale;
        sP[i] = lg;
        mloc = fmaxf(mloc, lg);
      }
    }
  }
  // 2. the cluster's max: every rank's, read by warp 0
  const float mb = block_max<NT>(mloc, s_red);
  if (tid == 0) s_ml[0] = mb;
  cluster.sync();
  if (warp == 0) {
    float v = lane < cs ? *cluster.map_shared_rank(&s_ml[0], lane)
                        : -INFINITY;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) s_bc = v;
  }
  __syncthreads();
  const float m = s_bc;
  float lsum = 0.f;
  for (int i = tid; i < n; i += NT) {
    const float p = expf(sP[i] - m);
    sP[i] = p;
    lsum += p;
  }
  // 3. the cluster's sum, the ranks' sums added in rank order
  const float lb = block_sum<NT>(lsum, s_red);
  if (tid == 0) s_ml[1] = lb;
  cluster.sync();
  if (warp == 0) {
    const float v = lane < cs ? *cluster.map_shared_rank(&s_ml[1], lane)
                              : 0.f;
    float l = 0.f;
    for (int k = 0; k < cs; ++k) l += __shfl_sync(0xffffffffu, v, k);
    if (lane == 0) s_bc = l;
  }
  __syncthreads();
  const float l = s_bc;
#pragma unroll
  for (int k = 0; k < MAX_PER_THREAD; ++k) {
    const int i = tid + k * NT;
    if (i < n)
      sP[i] = __bfloat162float(__float2bfloat16_rn(sP[i] / l * vsr[k]));
  }
  __syncthreads();
  mbar_wait(&vbar, 0);

  // 4. this rank's share of out = pw . v8: 8 threads a key row (8 codes
  // each), 32 row groups; a warp's four groups add in a tree ((0 + 2) +
  // (1 + 3)), then the warps in order
  const int tw = tid & 7, tg = tid >> 3;
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tg; i < n; i += GROUPS) {
    const uint2 w = *reinterpret_cast<const uint2*>(sV + i * D + tw * 8);
    const float p = sP[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = fmaf(p, i8f(w.x, e), a[e]);
      a[4 + e] = fmaf(p, i8f(w.y, e), a[4 + e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    a[e] += __shfl_down_sync(0xffffffffu, a[e], 16);
    a[e] += __shfl_down_sync(0xffffffffu, a[e], 8);
  }
  __syncthreads();  // V is read: its buffer takes the warps' partials
  float* s_acc = reinterpret_cast<float*>(sV);  // [NT / 32][64]
  if (lane < 8)
#pragma unroll
    for (int e = 0; e < 8; ++e) s_acc[warp * D + tw * 8 + e] = a[e];
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) o += s_acc[w * D + tid];
    s_part[tid] = o;
  }
  // 5. rank 0 adds the ranks' shares in rank order, every rank's load in
  // flight; every rank stays until rank 0 has read them
  cluster.sync();
  if (rank == 0 && tid < D) {
    float v[MAX_CS];
#pragma unroll
    for (int k = 0; k < MAX_CS; ++k)
      v[k] = cluster.map_shared_rank(s_part, k < cs ? k : 0)[tid];
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CS; ++k)
      if (k < cs) o += v[k];
    out[bh * D + tid] = o;
  }
  cluster.sync();
}

}  // namespace

// Raises K7's dynamic shared-memory limit. Called once, when the library
// is loaded.
extern "C" int mas_int8_cached_attention_init(void) {
  return (int)cudaFuncSetAttribute(int8_cached_attention_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_MAX);
}

// q: [B, H, 64] bf16; k8, v8: [B, H, T, 64] int8; ks, vs: [B, H, T]
// float32, all contiguous and 16-byte aligned; out: [B, H, 64] float32.
// cs blocks a (b, h) (a cluster, 1..8), chunk keys a block (cs * chunk >=
// T; the plan: ops/cached_attention.py::cluster_plan). Returns the
// launch's cudaError_t.
extern "C" int mas_int8_cached_attention(const void* q, const void* k8,
                                         const void* ks, const void* v8,
                                         const void* vs, void* out, int B,
                                         int H, int T, int cs, int chunk,
                                         float scale, void* stream) {
  if (T < 1 || cs < 1 || cs > MAX_CS || chunk < 1 ||
      (long long)cs * chunk < T || smem_bytes(chunk) > SMEM_MAX ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_cluster(int8_cached_attention_kernel, dim3(cs, B * H), cs,
                        NT, smem_bytes(chunk), (cudaStream_t)stream,
                        (const bf16*)q, (const int8_t*)k8, (const float*)ks,
                        (const int8_t*)v8, (const float*)vs, (float*)out, T,
                        chunk, scale);
}

// The clusters of cs K7 blocks of chunk keys the card holds at once (an
// H100 holds about 8 blocks of a cluster launch an SM, whatever their
// size: 124 clusters of 8). Returns a cudaError_t value.
extern "C" int mas_int8_cached_attention_fit(int cs, int chunk, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(chunk);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)int8_cached_attention_kernel, &cfg);
}
