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
// Design: split-T across a thread-block cluster, after K7
// (cached_attention.cu). A block takes G heads (G divides H) of one batch
// row; the CS blocks of a cluster split the keys, rank r taking
// [r * chunk, (r + 1) * chunk) below n_valid (a rank may hold none). An SM
// pulls at most ~30 GB/s whatever the copy engine (measured on the H100),
// so the rate comes from keeping every SM's link busy with every cluster
// resident at once: the plan (ops/cross_attention.py::int8_plan) takes the
// largest cluster whose B * H / G clusters the card holds together, asked
// of it (mas_single_query_attention_int8_fit). G is 2 for an even H: a
// block of G heads reads 64 G contiguous bytes of K and V a key, and G of
// the key's H scales, which arrive as whole 32-byte sectors, so G = 1
// moves 8x the scales' bytes over the SM's link and G = H, which wastes
// none, needs clusters of 8-16 blocks that the card does not place all at
// once (the sweep of G and CS in PERF.md). Every G is one kernel: the
// rank's V rows come into shared memory by TMA over a rank-4 map of v8
// ({64, H, n_valid, B}, boxes of {64, G, R <= 256 rows}), issued at entry
// by one thread, while every thread stages the rank's ks and vs (16 loads
// in flight a thread) and then streams K through registers (four lanes a
// key and head, 16 codes each, four passes of loads in flight) into the
// logits with __dp4a. Keys >= n_valid lie outside the map and arrive as
// zeros: they are never read, as the pos mask asks.
// The pw codes need the row's global max, sum and spw, so the ranks
// exchange them through distributed shared memory: each rank's logit max
// (read by every rank), then each rank's sum of exp(lg - m) and max of pw,
// both formed with the global m. Every rank then forms pw8 = clip(rint(pw
// / spw)) with the global spw, exactly where the one-block kernel formed
// it, once a key; its int32 partial of oi is exact, so rank 0's sum over
// the ranks (in rank order) is the one-block kernel's oi bit for bit, and
// l is summed in rank order. p . V takes one 4-byte word (4 columns) of 4
// rows a step, transposed with __byte_perm into one word a column, and
// adds it against the 4 rows' packed pw8 codes with __dp4a.
// Where the time goes (stamps, PERF.md): the bytes a block moves over its
// SM's link (K, V and the scales' sectors) up to the first exchange, then
// ~8 us of exchanges, p . V and rank 0's sum.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int D = 64;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int LANES = 4;           // lanes a (key, head) in the logits pass
constexpr int PASSES = 4;          // logits passes whose loads fly at once
constexpr int ROWS1 = NT / LANES;  // (key, head) pairs a logits pass
constexpr int MAX_G = 32;          // heads a block
constexpr int MAX_CS = 16;         // blocks a cluster (non-portable above 8)
constexpr int MAX_NU = (MAX_G * 16 + NT - 1) / NT;  // p . V units a thread
constexpr int SMEM_LIMIT = 200 * 1024;

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }
// V rows a TMA box: the chunk in as few boxes of at most 256 rows (TMA's
// limit a box dimension) as it takes, an even count each, so every box
// starts 128-byte aligned and at most a row a box is past the chunk
__host__ __device__ inline int box_rows(int chunk) {
  const int nbox = (chunk + 255) / 256;
  const int r = (chunk + nbox - 1) / nbox;
  return r + (r & 1);
}
// the V rows, then the p . V pass's row-group partials ([NT / (16 G) or
// 1][G][64] ints)
__host__ __device__ inline int v_bytes(int g, int chunk) {
  const int r = box_rows(chunk);
  const int v = (chunk + r - 1) / r * r * g * D;
  const int part = 4 * (4 * NT > D * g ? 4 * NT : D * g);
  return align128(v > part ? v : part);
}
// the scales, then logits and pw; later this rank's oi ([G][64] ints)
__host__ __device__ inline int p_bytes(int g, int chunk) {
  return align128(4 * g * (chunk > D ? chunk : D));
}
__host__ __device__ inline int smem_bytes(int g, int chunk) {
  return v_bytes(g, chunk) + 2 * p_bytes(g, chunk) + g * D;
}

__device__ __forceinline__ float code8(float v, float s) {
  return fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT) sqa_int8_kernel(
    const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
    const int8_t* __restrict__ k8, const float* __restrict__ ks,
    const float* __restrict__ vs, float* __restrict__ out, int T, int H,
    int G, int n_valid, int chunk, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* sV = reinterpret_cast<int8_t*>(smem_raw);  // [rows][G][64]
  float* sP = reinterpret_cast<float*>(smem_raw + v_bytes(G, chunk));
  float* sS = sP + p_bytes(G, chunk) / 4;  // [G][chunk]: vs, then pw8
  int8_t* s_q8 = reinterpret_cast<int8_t*>(sS + p_bytes(G, chunk) / 4);
  __shared__ uint64_t vbar;  // V landed
  __shared__ float s_qs[MAX_G];
  __shared__ float s_r1[MAX_G], s_r2[MAX_G];  // per-(head, slice) partials
  __shared__ float s_m[MAX_G], s_l[MAX_G], s_pm[MAX_G];  // this rank's
  __shared__ float s_gm[MAX_G], s_gl[MAX_G], s_gs[MAX_G];  // the cluster's

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int groups = H / G;
  const int b = blockIdx.y / groups, h0 = blockIdx.y % groups * G;
  const int t0 = rank * chunk;
  const int n = max(0, min(chunk, n_valid - t0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = H * D;
  const int R = box_rows(chunk);
  const int nbox = (n + R - 1) / R;

  if (tid == 0) {
    prefetch_map(&tv);
    mbar_init(&vbar, 1);
    fence_mbar_init();
    mbar_expect_tx(&vbar, (uint32_t)(nbox * R * G * D));
    for (int i = 0; i < nbox; ++i)
      tma_load_4d(sV + i * R * G * D, &tv, &vbar, 0, h0, t0 + i * R, b);
  }
  // the rank's scales: ks into the logits' place, vs beside them, SU
  // entries a thread in flight at once
  const long long row0 = (long long)b * T + t0;  // the rank's first key
  constexpr int SU = 8;
  for (int j0 = 0; j0 < n * G; j0 += SU * NT) {
    float kv[SU], vv[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int j = min(j0 + u * NT + tid, n * G - 1);
      const int i = j / G, g = j - i * G;
      const long long a = (row0 + i) * H + h0 + g;
      kv[u] = __ldg(ks + a);
      vv[u] = __ldg(vs + a);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int j = j0 + u * NT + tid;
      if (j < n * G) {
        const int i = j / G, g = j - i * G;
        sP[g * chunk + i] = kv[u];
        sS[g * chunk + i] = vv[u];
      }
    }
  }
  // the query's int8 codes, a warp per head
  for (int g = warp; g < G; g += NW) {
    const float2 v = unpack_bf16(
        ld32(q + (long long)b * HD + (h0 + g) * D + 2 * lane));
    const float qs =
        fmaxf(warp_max(fmaxf(fabsf(v.x), fabsf(v.y))), 1e-12f) / 127.f;
    s_q8[g * D + 2 * lane] = (int8_t)code8(v.x, qs);
    s_q8[g * D + 2 * lane + 1] = (int8_t)code8(v.y, qs);
    if (lane == 0) s_qs[g] = qs;
  }
  __syncthreads();

  // 1. logits of the rank's (key, head) pairs, four lanes a pair (16 codes
  // each), PASSES passes of ROWS1 pairs whose loads are in flight together
  const int sub = tid % LANES, r = tid / LANES;
  const int P = n * G;
  for (int i0 = 0; i0 < P; i0 += PASSES * ROWS1) {
    int4 kw[PASSES];
#pragma unroll
    for (int u = 0; u < PASSES; ++u) {
      const int pi = min(i0 + u * ROWS1 + r, P - 1);
      const int i = pi / G, g = pi - i * G;
      kw[u] = __ldg(reinterpret_cast<const int4*>(
          k8 + (row0 + i) * HD + (h0 + g) * D + sub * 16));
    }
#pragma unroll
    for (int u = 0; u < PASSES; ++u) {
      const int pi = i0 + u * ROWS1 + r;
      const int pc = min(pi, P - 1);
      const int i = pc / G, g = pc - i * G;
      const int4 qw = *reinterpret_cast<const int4*>(s_q8 + g * D + sub * 16);
      int li = __dp4a(kw[u].x, qw.x, 0);
      li = __dp4a(kw[u].y, qw.y, li);
      li = __dp4a(kw[u].z, qw.z, li);
      li = __dp4a(kw[u].w, qw.w, li);
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      if (sub == 0 && pi < P)
        sP[g * chunk + i] = (float)li * sP[g * chunk + i] * s_qs[g] * scale;
    }
  }
  __syncthreads();

  // per-head reductions over the rank's keys: WPH warps a head (each a
  // slice of its keys), their partials combined in slice order
  const int WPH = G < NW ? NW / G : 1;
  // 2. the cluster's max of each head's logits
  for (int u = warp; u < G * WPH; u += NW) {
    const int g = u / WPH, sl = u % WPH;
    float mloc = -INFINITY;
    for (int i = sl * 32 + lane; i < n; i += WPH * 32)
      mloc = fmaxf(mloc, sP[g * chunk + i]);
    mloc = warp_max(mloc);
    if (lane == 0) s_r1[u] = mloc;
  }
  __syncthreads();
  if (tid < G) {
    float m = -INFINITY;
    for (int sl = 0; sl < WPH; ++sl) m = fmaxf(m, s_r1[tid * WPH + sl]);
    s_m[tid] = m;
  }
  cluster.sync();
  for (int g = warp; g < G; g += NW) {
    const float v = lane < cs ? *cluster.map_shared_rank(&s_m[g], lane)
                              : -INFINITY;
    const float m = warp_max(v);
    if (lane == 0) s_gm[g] = m;
  }
  __syncthreads();
  // 3. p, pw; each rank's sum of p and max of pw, formed with the global m
  for (int u = warp; u < G * WPH; u += NW) {
    const int g = u / WPH, sl = u % WPH;
    const float m = s_gm[g];
    float lsum = 0.f, pmax = 0.f;
    for (int i = sl * 32 + lane; i < n; i += WPH * 32) {
      const float p = expf(sP[g * chunk + i] - m);
      const float pw = p * sS[g * chunk + i];
      lsum += p;
      pmax = fmaxf(pmax, pw);
      sP[g * chunk + i] = pw;
    }
    lsum = warp_sum(lsum);
    pmax = warp_max(pmax);
    if (lane == 0) {
      s_r1[u] = lsum;
      s_r2[u] = pmax;
    }
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f, pm = 0.f;
    for (int sl = 0; sl < WPH; ++sl) {
      l += s_r1[tid * WPH + sl];
      pm = fmaxf(pm, s_r2[tid * WPH + sl]);
    }
    s_l[tid] = l;
    s_pm[tid] = pm;
  }
  cluster.sync();
  // the cluster's l (the ranks' sums added in rank order) and spw
  for (int g = warp; g < G; g += NW) {
    const float v = lane < cs ? *cluster.map_shared_rank(&s_l[g], lane) : 0.f;
    const float pm = warp_max(
        lane < cs ? *cluster.map_shared_rank(&s_pm[g], lane) : 0.f);
    float l = 0.f;
    for (int k = 0; k < cs; ++k) l += __shfl_sync(0xffffffffu, v, k);
    if (lane == 0) {
      s_gl[g] = l;
      s_gs[g] = fmaxf(pm, 1e-20f) / 127.f;
    }
  }
  __syncthreads();
  // the pw8 codes, in vs's place (4 rows of a head a word)
  int8_t* s_code = reinterpret_cast<int8_t*>(sS);  // [G][chunk rounded to 4]
  const int cp = (chunk + 3) & ~3;
  for (int j = tid; j < n * G; j += NT) {
    const int g = j / n, i = j - g * n;
    s_code[g * cp + i] = (int8_t)code8(sP[g * chunk + i], s_gs[g]);
  }
  mbar_wait(&vbar, 0);
  __syncthreads();

  // 4. this rank's oi = pw8 . v8: a unit is 4 columns (one word) of one
  // head, 4 rows a step; RG row groups a unit, summed in order
  const int UG = G * 16;
  const int RG = UG < NT ? NT / UG : 1;
  int acc[4 * MAX_NU];  // a thread's units, 4 columns each
#pragma unroll
  for (int k = 0; k < MAX_NU; ++k) {
    const int w = tid + k * NT;
    if (w >= UG * RG) break;
    const int unit = w % UG, rg = w / UG;
    const int g = unit / 16, cw = unit % 16;
    const int8_t* vb = sV + g * D + cw * 4;
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int tt = rg * 4; tt < n; tt += RG * 4) {
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wd[j] = tt + j < n
                    ? *reinterpret_cast<const uint32_t*>(vb + (tt + j) * G * D)
                    : 0u;
      // (a row past n has zero V bytes, whatever its code byte holds)
      const uint32_t codes =
          *reinterpret_cast<const uint32_t*>(s_code + g * cp + tt);
      // 4 rows x 4 columns of bytes -> one word per column (byte j = row j)
      const uint32_t lo01 = __byte_perm(wd[0], wd[1], 0x5140);
      const uint32_t hi01 = __byte_perm(wd[0], wd[1], 0x7362);
      const uint32_t lo23 = __byte_perm(wd[2], wd[3], 0x5140);
      const uint32_t hi23 = __byte_perm(wd[2], wd[3], 0x7362);
      a0 = __dp4a((int)__byte_perm(lo01, lo23, 0x5410), (int)codes, a0);
      a1 = __dp4a((int)__byte_perm(lo01, lo23, 0x7632), (int)codes, a1);
      a2 = __dp4a((int)__byte_perm(hi01, hi23, 0x5410), (int)codes, a2);
      a3 = __dp4a((int)__byte_perm(hi01, hi23, 0x7632), (int)codes, a3);
    }
    acc[4 * k] = a0;
    acc[4 * k + 1] = a1;
    acc[4 * k + 2] = a2;
    acc[4 * k + 3] = a3;
  }
  __syncthreads();  // V is read: its buffer takes the partials
  int* s_part = reinterpret_cast<int*>(sV);
#pragma unroll
  for (int k = 0; k < MAX_NU; ++k) {
    const int w = tid + k * NT;
    if (w >= UG * RG) break;
    const int unit = w % UG, rg = w / UG;
    int* pp = s_part + rg * G * D + (unit / 16) * D + (unit % 16) * 4;
    pp[0] = acc[4 * k];
    pp[1] = acc[4 * k + 1];
    pp[2] = acc[4 * k + 2];
    pp[3] = acc[4 * k + 3];
  }
  __syncthreads();  // the logits are read: their buffer takes oi
  int* s_oi = reinterpret_cast<int*>(sP);
  for (int i = tid; i < G * D; i += NT) {
    int oi = 0;
    for (int rg = 0; rg < RG; ++rg) oi += s_part[rg * G * D + i];
    s_oi[i] = oi;
  }
  // 5. rank 0 adds the ranks' exact partials and writes out; every rank
  // stays until rank 0 has read them
  cluster.sync();
  if (rank == 0)
    for (int i = tid; i < G * D; i += NT) {
      int oi = 0;
      for (int k = 0; k < cs; ++k) oi += cluster.map_shared_rank(s_oi, k)[i];
      const int g = i / D;
      out[(long long)b * HD + h0 * D + i] = (float)oi * (s_gs[g] / s_gl[g]);
    }
  cluster.sync();
}

MapCache<64> maps;

}  // namespace

// Raises K6's dynamic shared-memory limit and allows clusters of up to 16
// blocks. Called once, when the library is loaded.
extern "C" int mas_single_query_attention_int8_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaError_t e = cudaFuncSetAttribute(
      sqa_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sqa_int8_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)e;
}

// q: [B, H*64] bf16; k8, v8: [B, T, H*64] int8; ks, vs: [B, T, H] float32,
// all contiguous and 16-byte aligned; out: [B, H*64] float32. Attends keys
// 0 .. n_valid-1 (1 <= n_valid <= T). A block takes G heads (G | H), a
// cluster of cs blocks (1..16) one (b, G heads) row, chunk keys a block
// (cs * chunk >= n_valid; the plan: ops/cross_attention.py::int8_plan).
// Returns a cudaError_t value: a tensor map cuTensorMapEncodeTiled refuses, a shape
// outside these limits, or the launch's error.
extern "C" int mas_single_query_attention_int8(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, void* out, int B, int H, int T, int n_valid, int G,
    int cs, int chunk, float scale, void* stream) {
  if (n_valid < 1 || n_valid > T || G < 1 || G > MAX_G || H % G ||
      cs < 1 || cs > MAX_CS || chunk < 1 || (long long)cs * chunk < n_valid ||
      smem_bytes(G, chunk) > SMEM_LIMIT || (long long)B * (H / G) > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tv;
  const int e = maps.get(
      &tv, map_spec(v8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                    {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)n_valid,
                     (cuuint64_t)B},
                    {(cuuint64_t)D, (cuuint64_t)H * D, (cuuint64_t)T * H * D},
                    {(cuuint32_t)D, (cuuint32_t)G, (cuuint32_t)box_rows(chunk),
                     1u},
                    CU_TENSOR_MAP_SWIZZLE_NONE));
  if (e != 0) return e;
  return launch_cluster(sqa_int8_kernel, dim3(cs, B * (H / G)), cs, NT,
                        smem_bytes(G, chunk), (cudaStream_t)stream, tv,
                        (const bf16*)q, (const int8_t*)k8, (const float*)ks,
                        (const float*)vs, (float*)out, T, H, G, n_valid, chunk,
                        scale);
}

// The clusters of cs K6 blocks of G heads and chunk keys the card holds at
// once (0 where a block would ask more shared memory than K6 allows).
// Returns a cudaError_t value.
extern "C" int mas_single_query_attention_int8_fit(int G, int cs, int chunk,
                                                   int* out) {
  *out = 0;
  if (G < 1 || G > MAX_G || cs < 1 || cs > MAX_CS ||
      smem_bytes(G, chunk) > SMEM_LIMIT)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(G, chunk);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)sqa_int8_kernel, &cfg);
}
