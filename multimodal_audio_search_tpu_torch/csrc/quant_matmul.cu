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
// What bounds it on an H100, by regime (ops/quant.py::split_plan picks):
//   * decode-step layers (M = batch rows <= 64; [d, d], [d, 4d], [4d, d]
//     at d = 512 or 384): the weight bytes, 0.15-1 MB a call, 0.05-0.3 us
//     at 3.35 TB/s -- so in practice the latency of one short launch.
//   * the tied logits ([d, 51865] int8, float32 out, once a step): 26.5
//     MB of weights and 6.6 MB of output, ~10 us.
//   * the cross K/V projection over the encoder output (M = B*1500 =
//     48,000 at B=32, [512, 512]): tensor-core work, 25 GFLOP a call
//     against ~0.1 GB of traffic, 0.025 ms at 989 TFLOP/s.
//
// Design, "skinny" (M <= 64; N % 16 == 0):
//   * A block is 32 rows (two m16 tiles of mma.sync m16n8k16) by 32
//     columns over one split of K; the grid is (N tiles, K splits, row
//     blocks). The plan splits K, at most 8 ways, until the grid fills
//     one wave of the card ([2048, 512] at M = 32: 16 tiles x 8 splits of
//     256 K rows), so no block walks more than a few K steps.
//   * K goes in steps of 128 rows; the 8 warps take 16 rows of a step
//     each, so a step is one short chain per warp (eight independent
//     products), and the warps' partial tiles are added in warp order
//     once, at the end.
//   * The x tile and the int8 W rows stream through a 4-stage ring of
//     16-byte cp.async copies (zero-filled past M, K and N); the
//     conversion turns the codes into bf16 (exact) in a second shared
//     tile, read by ldmatrix.trans.
//   * With more than one split, each block writes its float32 partial
//     tile to a persistent per-device scratch, the tile's S partials side
//     by side ([tiles, S, 32, 32]), and the last block of its tile to
//     arrive (an arrival counter, left zero again) sums the splits in
//     split order -- a fixed order, whatever order the blocks ran in --
//     with 8 loads a thread in flight, and applies the epilogue once.
// Design, "table" (the tied logits, on the transposed copy the model
// holds on the card, and any N % 16 != 0): see table_kernel.
// Design, "wide" (M > 64 and N % 16 == 0: the cross K/V projection):
//   * K8's shape (csrc/encoder_attention.cu): a block is 128 x 128 of the
//     output, two consumer warpgroups of 64 rows and one producer warp;
//     the producer's thread keeps TMA copies of the x tile (128 x 64 bf16,
//     128-byte swizzle) and the int8 W tile (64 x 128) in flight through a
//     3-stage ring with full/empty mbarriers.
//   * The consumers turn each int8 tile into bf16 in shared memory, in
//     the 128-byte-swizzled layout of two 64-column MN-major atoms, while
//     the tensor cores run the previous tile's wgmma (two m64n64k16 per 16
//     of K, x K-major, W with the transpose bit); a fence.proxy.async and
//     a named barrier hand the converted tile to wgmma. Two buffers of the
//     converted tile alternate, so conversion and products overlap.
//   * Two blocks a SM (105 KB of shared memory each), so one block's
//     epilogue and conversion meet the other's products.
#include "sm90.cuh"

namespace {

using namespace sm90;

__device__ __forceinline__ void store_out(void* out, const float* scale,
                                          const bf16* bias, int out_bf16,
                                          long long o, int n, float acc) {
  float y = __fmul_rn(acc, scale[n]);
  if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[n]));
  if (out_bf16)
    static_cast<bf16*>(out)[o] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[o] = y;
}

// ------------------------------------------------------------------ skinny
// A block is 32 rows by SB_N = 32 columns over one split of K, taken in
// steps of SB_K = 128 rows through a STAGES-deep cp.async ring; each of
// the 8 warps multiplies its own 16 of a step's 128 rows (two m16 tiles x
// four n8 fragments, eight independent products), so the chain of
// dependent instructions a step is short. The warps' partial tiles are
// added in warp order through shared memory once, at the end.
constexpr int SB_M = 32;        // rows per block
constexpr int SB_N = 32;        // columns per block
constexpr int SB_K = 128;       // K rows per step, 16 a warp
constexpr int S_NT = 256;       // 8 warps
constexpr int S_STAGES = 4;
constexpr int LDX = SB_K + 8;   // bf16 per staged x row (272 bytes)
constexpr int RAW = SB_N + 16;  // staged bytes per W row (16 of padding)
constexpr int LDB = SB_N + 8;   // bf16 per converted W row (80 bytes)
constexpr int LDR = SB_N + 8;   // floats per row of a warp's partial tile
constexpr int RED_U = 8;        // split partials a thread loads at once
constexpr int SX_BYTES = SB_M * LDX * 2, SW_BYTES = SB_K * RAW;
constexpr int S_RING = S_STAGES * (SX_BYTES + SW_BYTES);
constexpr int S_SMEM = S_RING + SB_K * LDB * 2;
static_assert(8 * SB_M * LDR * 4 <= S_RING, "the warps' tiles fit the ring");

__global__ void __launch_bounds__(S_NT) skinny_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, const bf16* __restrict__ bias,
    void* __restrict__ out, float* part, int* counters, int M, int K, int N,
    int out_bf16, int steps) {
  extern __shared__ __align__(128) unsigned char s_smem[];
  __shared__ int s_last;
  auto sX = [&](int st) {
    return reinterpret_cast<bf16*>(s_smem + st * SX_BYTES);
  };
  auto sW = [&](int st) {
    return s_smem + S_STAGES * SX_BYTES + st * SW_BYTES;
  };
  bf16* sB = reinterpret_cast<bf16*>(s_smem + S_RING);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const int n0 = blockIdx.x * SB_N, split = blockIdx.y, S = gridDim.y;
  const int m0 = blockIdx.z * SB_M;
  const int nk = (K + SB_K - 1) / SB_K;
  const int kt0 = split * steps;
  const int nsteps = min(nk, kt0 + steps) - kt0;  // >= 1 (the plan's rule)

  // copies of K step kt into ring stage st (N % 16 == 0: row k of W
  // starts on a 16-byte word; a word past N is zero-filled)
  auto load = [&](int kt, int st) {
    const int k0 = kt * SB_K;
#pragma unroll
    for (int i = tid; i < SB_M * SB_K / 8; i += S_NT) {  // x: 16 words a row
      const int r = i / (SB_K / 8), c = (i % (SB_K / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < K;
      cp_async16_zfill(sX(st) + r * LDX + c,
                       ok ? (const void*)(x + (long long)m * K + k)
                          : (const void*)x,
                       ok ? 16 : 0);
    }
    for (int q = tid; q < SB_K * (SB_N / 16); q += S_NT) {
      const int r = q / (SB_N / 16), w = q % (SB_N / 16), k = k0 + r;
      const bool ok = k < K && n0 + 16 * w < N;
      cp_async16_zfill(sW(st) + r * RAW + 16 * w,
                       ok ? (const void*)(wq + (long long)k * N + n0 + 16 * w)
                          : (const void*)wq,
                       ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      acc[a][f][0] = acc[a][f][1] = acc[a][f][2] = acc[a][f][3] = 0.f;

#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < nsteps) load(kt0 + s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nsteps; ++j) {
    cp_async_wait_group<S_STAGES - 2>();  // step j has landed
    __syncthreads();  // ... for every thread; step j-1's products are done
    if (j + S_STAGES - 1 < nsteps)
      load(kt0 + j + S_STAGES - 1, (j + S_STAGES - 1) % S_STAGES);
    cp_async_commit();
    const int st = j % S_STAGES;
    // the stage's int8 rows -> bf16 tile, 8 codes a piece (exact)
#pragma unroll
    for (int p = tid; p < SB_K * SB_N / 8; p += S_NT) {
      const int r = p / (SB_N / 8), c8 = (p % (SB_N / 8)) * 8;
      const uint2 w = *reinterpret_cast<const uint2*>(sW(st) + r * RAW + c8);
      uint4 v;
      i8x4_to_bf16(w.x, v.x, v.y);
      i8x4_to_bf16(w.y, v.z, v.w);
      *reinterpret_cast<uint4*>(sB + r * LDB + c8) = v;
    }
    __syncthreads();
    // warp w: rows 16 w .. 16 w + 15 of the step
    uint32_t af[2][4], bq[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      ldsm_x4(af[a], sX(st) + (a * 16 + lr) * LDX + warp * 16 + lc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm_x4_trans(bq[h], sB + (warp * 16 + lr) * LDB + h * 16 + lc);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_16816(acc[a][2 * h], af[a], bq[h][0], bq[h][1]);
        mma_16816(acc[a][2 * h + 1], af[a], bq[h][2], bq[h][3]);
      }
  }

  // the warps' tiles, added in warp order: thread t then holds the sums of
  // row rq = t / 8, columns c .. c + 3 (c = 4 (t % 8)) of the block's tile
  cp_async_wait_all();
  __syncthreads();  // the ring is idle: it holds the warps' tiles now
  float* red = reinterpret_cast<float*>(s_smem);  // [8][32][LDR]
  // acc[a][f][e]: row 16a + g + 8(e / 2), column 8f + 2 t4 + e % 2
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            red + (warp * SB_M + a * 16 + g + 8 * h) * LDR + f * 8 + 2 * t4) =
            make_float2(acc[a][f][2 * h], acc[a][f][2 * h + 1]);
  __syncthreads();
  const int rq = tid >> 3, c = (tid & 7) * 4, n = n0 + c, m = m0 + rq;
  float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const float4 v =
        *reinterpret_cast<const float4*>(red + (w * SB_M + rq) * LDR + c);
    y.x += v.x;
    y.y += v.y;
    y.z += v.z;
    y.w += v.w;
  }
  if (S > 1) {
    // each split's tile to its own slot of the tile's contiguous region
    // of the scratch, part[tile][split][32][32]; the last split of the
    // tile to arrive adds the S tiles in split order
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    float* pt = part + (long long)tile * S * SB_M * SB_N;
    *reinterpret_cast<float4*>(pt + ((long long)split * SB_M + rq) * SB_N +
                               c) = y;
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    y = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < S; s0 += RED_U) {  // RED_U loads in flight
      float4 v[RED_U];
#pragma unroll
      for (int u = 0; u < RED_U; ++u)
        v[u] = s0 + u < S
                   ? __ldcg(reinterpret_cast<const float4*>(
                         pt + ((long long)(s0 + u) * SB_M + rq) * SB_N + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < RED_U; ++u) {
        y.x += v[u].x;
        y.y += v[u].y;
        y.z += v[u].z;
        y.w += v[u].w;
      }
    }
    if (tid == 0) counters[tile] = 0;
  }
  if (m >= M) return;
  const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n + e < N)
      store_out(out, scale, bias, out_bf16, (long long)m * N + n + e, n + e,
                yv[e]);
}

// ------------------------------------------- the logits' table, [N, Kp]
// The tied logits read a device copy of their int8 table transposed to
// [N, Kp] (ops/quant.py::logits_table, made once when the model is placed
// on the card; Kp = K rounded up to 16, the pad zero): row n holds the
// codes of column n contiguously, so 16-byte copies are aligned whatever
// N is, and a thread's four codes k = 4t .. 4t + 3 of one column are one
// shared-memory word. mma.sync's B fragment wants k = 2t, 2t + 1 (b0) and
// 2t + 8, 2t + 9 (b1) of column g; the kernel feeds it physical k = 4t,
// 4t + 1 as b0 and 4t + 2, 4t + 3 as b1, and x's A fragments with the
// same permutation of k (one 8-byte load of x's row gives a0 and a2), so
// the sum over the 16 k of a step is the same sum: no conversion pass
// through shared memory, no ldmatrix.
// The table streams: one block a SM, each block a contiguous range of the
// columns, each of its warps the 16-column chunks c, c + warps, ... of
// that range. A chunk is 16 table rows, taken in pieces of at most T_KP
// codes a row (one piece up to whisper-base width), each piece copied by
// the warp's own cp.async ring of two stages, so the next piece is in
// flight while the warp multiplies this one; x [32, Kp] is copied into
// shared memory once a block. No block-wide barrier after that first
// copy. A warp's chunks run one after another, so the launch takes as
// many warps a block as give no warp more than T_CHUNKS chunks (a warp
// with one chunk more than the rest would add a whole chunk's time at the
// end), as far as shared memory allows.
constexpr int T_STAGES = 2;
constexpr int T_CHUNKS = 3;
constexpr int T_MAX_NT = 512;
constexpr int T_KP = 512;      // codes of a table row a ring stage holds
constexpr int T_MAX_K = 2048;  // x [32, Kp] and four warps' rings fit a SM
constexpr int LDO_T = 17;      // floats per row of a warp's staged outputs

__host__ __device__ constexpr int t_ldx(int Kp) { return Kp + 16; }  // bf16
__host__ __device__ constexpr int t_kp(int Kp) {
  return Kp < T_KP ? Kp : T_KP;
}
__host__ __device__ inline int table_x_bytes(int Kp) {
  return 32 * t_ldx(Kp) * 2;
}
__host__ __device__ inline int table_warp_bytes(int Kp) {
  return T_STAGES * 16 * (t_kp(Kp) + 16) + 32 * LDO_T * 4;
}

__global__ void __launch_bounds__(T_MAX_NT, 1) table_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ wt,
    const float* __restrict__ scale, const bf16* __restrict__ bias,
    void* __restrict__ out, int M, int K, int Kp, int N, int out_bf16) {
  extern __shared__ __align__(128) unsigned char t_smem[];
  const int LDX = t_ldx(Kp), KP = t_kp(Kp), LDW = KP + 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * 32;
  bf16* sX = reinterpret_cast<bf16*>(t_smem);
  unsigned char* ring =
      t_smem + table_x_bytes(Kp) + warp * table_warp_bytes(Kp);
  float* sO = reinterpret_cast<float*>(ring + T_STAGES * 16 * LDW);
  // this block's chunks [c0, c1), balanced over the grid
  const int nch = (N + 15) / 16;
  const int c0 = (int)((long long)blockIdx.x * nch / gridDim.x);
  const int c1 = (int)((long long)(blockIdx.x + 1) * nch / gridDim.x);
  const int mine = c1 - c0 > warp ? (c1 - c0 - warp + nw - 1) / nw
                                  : 0;  // this warp's chunks
  const int npc = (Kp + KP - 1) / KP;   // pieces a chunk
  const int items = mine * npc;         // (chunk, piece), piece fastest

  // item `it` of this warp (chunk it / npc: columns 16 (c0 + warp + nw
  // (it / npc)) ..; piece it % npc: codes KP (it % npc) ..) into stage
  auto load = [&](int it, int st) {
    const int i = it / npc, k0 = (it - i * npc) * KP;
    const int n0 = (c0 + warp + nw * i) * 16, kw = min(KP, Kp - k0) / 16;
    unsigned char* dst = ring + st * 16 * LDW;
    for (int q = lane; q < 16 * kw; q += 32) {
      const int r = q / kw, w = q - r * kw;
      const bool ok = n0 + r < N;
      cp_async16_zfill(dst + r * LDW + 16 * w,
                       ok ? (const void*)(wt + (long long)(n0 + r) * Kp + k0 +
                                          16 * w)
                          : (const void*)wt,
                       ok ? 16 : 0);
    }
  };

  for (int q = tid; q < 32 * (Kp / 8); q += nt) {  // x, once; zeros past K
    const int r = q / (Kp / 8), c = (q - r * (Kp / 8)) * 8;
    const bool ok = m0 + r < M && c < K;
    cp_async16_zfill(sX + r * LDX + c,
                     ok ? (const void*)(x + (long long)(m0 + r) * K + c)
                        : (const void*)x,
                     ok ? 16 : 0);
  }
  cp_async_commit();
  if (items > 0) load(0, 0);
  cp_async_commit();
  cp_async_wait_group<1>();  // x has landed (item 0 may not have)
  __syncthreads();

  float acc[2][2][4];
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) load(it + 1, (it + 1) % T_STAGES);
    cp_async_commit();
    cp_async_wait_group<1>();  // item it has landed
    __syncwarp();
    const int i = it / npc, p = it - i * npc;
    const int k0 = p * KP, kw = min(KP, Kp - k0) / 16;
    const unsigned char* sW = ring + (it % T_STAGES) * 16 * LDW;
    if (p == 0) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < kw; ++kk) {
      uint32_t af[2][4], bq[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const bf16* xr = sX + (a * 16 + g) * LDX + k0 + kk * 16 + 4 * t4;
        const uint2 lo = *reinterpret_cast<const uint2*>(xr);
        const uint2 hi = *reinterpret_cast<const uint2*>(xr + 8 * LDX);
        af[a][0] = lo.x;
        af[a][1] = hi.x;
        af[a][2] = lo.y;
        af[a][3] = hi.y;
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
        i8x4_to_bf16(*reinterpret_cast<const uint32_t*>(
                         sW + (b * 8 + g) * LDW + kk * 16 + 4 * t4),
                     bq[b][0], bq[b][1]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          mma_16816(acc[a][b], af[a], bq[b][0], bq[b][1]);
    }
    if (p == npc - 1) {
      // the chunk's [32, 16] outputs through shared memory, so a half
      // warp stores 16 consecutive columns of a row
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sO[(a * 16 + g + 8 * (e >> 1)) * LDO_T + b * 8 + 2 * t4 +
               (e & 1)] = acc[a][b][e];
      __syncwarp();  // every lane has its outputs in
      const int n = (c0 + warp + nw * i) * 16 + (lane & 15);
      if (n < N) {
#pragma unroll 4
        for (int r = lane >> 4; r < 32; r += 2)
          if (m0 + r < M)
            store_out(out, scale, bias, out_bf16, (long long)(m0 + r) * N + n,
                      n, sO[r * LDO_T + (lane & 15)]);
      }
    }
    __syncwarp();  // every lane is done with the stage (and sO)
  }
}

// -------------------------------------------------------------------- wide
constexpr int WB_M = 128, WB_N = 128, WB_K = 64;
constexpr int W_STAGES = 3;
constexpr int W_NT = 288;  // two consumer warpgroups + one producer warp
constexpr int XT_BYTES = WB_M * WB_K * 2;  // x tile, bf16
constexpr int RT_BYTES = WB_K * WB_N;      // W tile, int8
constexpr int BT_BYTES = WB_K * WB_N * 2;  // W tile, bf16: two 64-col atoms
constexpr int W_SMEM =
    1024 + W_STAGES * (XT_BYTES + RT_BYTES) + 2 * BT_BYTES + 128;
// the output tile's row pitch in shared memory (elements; 16 bytes of
// padding keep a warp's fragment stores on distinct banks)
constexpr int WO_BF = WB_N + 8, WO_F = WB_N + 4;
static_assert(WB_M * WO_F * 4 <= W_STAGES * (XT_BYTES + RT_BYTES),
              "the output tile fits the idle ring");

// named barrier 1: the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The int8 tile of ring stage `raw` -> bf16 at `dst`: two atoms [64 k][64
// n] of 128-byte rows, the 16-byte chunk c of row k at chunk c ^ (k % 8)
// (the layout a 128-byte-swizzled TMA copy writes). 256 threads, two
// 16-code pieces each.
__device__ __forceinline__ void convert_tile(const uint8_t* raw,
                                             unsigned char* dst, int ct) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = ct + i * 256;
    const int k = c >> 3, n = (c & 7) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + k * WB_N + n);
    uint4 lo, hi;
    i8x4_to_bf16(w.x, lo.x, lo.y);
    i8x4_to_bf16(w.y, lo.z, lo.w);
    i8x4_to_bf16(w.z, hi.x, hi.y);
    i8x4_to_bf16(w.w, hi.z, hi.w);
    unsigned char* row = dst + (n >> 6) * (BT_BYTES / 2) + k * 128;
    const int cc = (n & 63) >> 3;
    *reinterpret_cast<uint4*>(row + ((cc ^ (k & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((cc + 1) ^ (k & 7)) << 4)) = hi;
  }
}

// One K step of a warpgroup: 64 rows x 128 columns x 64 of K.
__device__ __forceinline__ void issue_step(float d0[32], float d1[32],
                                           uint64_t da,
                                           const unsigned char* wb) {
  const uint64_t db0 = desc_sw128(wb, 16, 1024);
  const uint64_t db1 = desc_sw128(wb + BT_BYTES / 2, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < WB_K / 16; ++kk) {
    wgmma_m64n64k16_ss_mn(d0, da + 2 * kk, db0 + kk * (2048 >> 4));
    wgmma_m64n64k16_ss_mn(d1, da + 2 * kk, db1 + kk * (2048 >> 4));
  }
}

__global__ void __launch_bounds__(W_NT, 2) wide_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw, const float* __restrict__ scale,
    const bf16* __restrict__ bias, void* __restrict__ out, int M, int K,
    int N, int out_bf16) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sX = base;                           // [ST][128][64] bf16
  uint8_t* sR = base + W_STAGES * XT_BYTES;           // [ST][64][128] int8
  unsigned char* sB = sR + W_STAGES * RT_BYTES;       // [2] converted tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + 2 * BT_BYTES);
  uint64_t* empty = full + W_STAGES;
  const int m0 = blockIdx.y * WB_M, n0 = blockIdx.x * WB_N;
  const int nk = (K + WB_K - 1) / WB_K;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp; one thread issues every copy
    if (threadIdx.x == 256) {
      prefetch_map(&tx);
      prefetch_map(&tw);
      for (int j = 0; j < nk; ++j) {
        const int s = j % W_STAGES;
        mbar_wait(&empty[s], ((j / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], XT_BYTES + RT_BYTES);
        tma_load_2d(sX + s * XT_BYTES, &tx, &full[s], j * WB_K, m0);
        tma_load_2d(sR + s * RT_BYTES, &tw, &full[s], n0, j * WB_K);
      }
    }
    return;
  }

  const int ct = threadIdx.x, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float d0[32], d1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;
  auto da = [&](int s) {
    return desc_sw128(sX + s * XT_BYTES + wg * 64 * 128, 16, 1024);
  };

  mbar_wait(&full[0], 0);
  convert_tile(sR, sB, ct);
  fence_proxy_async();
  consumers_sync();
  // step j's products run while step j + 1's tile is converted; the last
  // step is peeled off, so no branch stands between issue and wait
  for (int j = 0; j + 1 < nk; ++j) {
    const int s = j % W_STAGES, s1 = (j + 1) % W_STAGES;
    mbar_wait(&full[s1], ((j + 1) / W_STAGES) & 1);
    wg_fence();
    issue_step(d0, d1, da(s), sB + (j & 1) * BT_BYTES);
    wg_commit();
    convert_tile(sR + s1 * RT_BYTES, sB + ((j + 1) & 1) * BT_BYTES, ct);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      reg_fence(d0[i]);
      reg_fence(d1[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    fence_proxy_async();
    consumers_sync();
  }
  {
    const int j = nk - 1;
    wg_fence();
    issue_step(d0, d1, da(j % W_STAGES), sB + (j & 1) * BT_BYTES);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      reg_fence(d0[i]);
      reg_fence(d1[i]);
    }
  }

  // The tile goes through shared memory (the ring is idle once both
  // warpgroups' products are done), so the stores to device memory are
  // whole 16-byte words of full rows. d[4jj + 2h + e] = D[16 warp + g +
  // 8h][8jj + 2 t4 + e] of each 64-column atom.
  consumers_sync();
  bf16* tb = reinterpret_cast<bf16*>(base);    // [128][WO_BF] when bf16
  float* tf = reinterpret_cast<float*>(base);  // [128][WO_F] when float32
  const int lr = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int at = 0; at < 2; ++at) {
    const float* d = at ? d1 : d0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = at * 64 + jj * 8 + 2 * t4, n = n0 + c;
      if (n >= N) continue;  // N % 16 == 0: n + 1 < N too
      const float s0 = scale[n], s1 = scale[n + 1];
      const float b0 = bias ? __bfloat162float(bias[n]) : 0.f;
      const float b1 = bias ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = __fmul_rn(d[4 * jj + 2 * h], s0);
        float y1 = __fmul_rn(d[4 * jj + 2 * h + 1], s1);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        const int r = lr + 8 * h;
        if (out_bf16)
          *reinterpret_cast<uint32_t*>(tb + r * WO_BF + c) = pack_bf16(y0, y1);
        else
          *reinterpret_cast<float2*>(tf + r * WO_F + c) = make_float2(y0, y1);
      }
    }
  }
  consumers_sync();
  const int words = out_bf16 ? WB_N / 8 : WB_N / 4;  // 16-byte words a row
  for (int i = ct; i < WB_M * words; i += 256) {
    const int r = i / words, c = (i % words) * (out_bf16 ? 8 : 4);
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const long long o = (long long)m * N + n;
    if (out_bf16)
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) =
          *reinterpret_cast<const uint4*>(tb + r * WO_BF + c);
    else
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
          *reinterpret_cast<const float4*>(tf + r * WO_F + c);
  }
}

}  // namespace

// Raises the three kernels' dynamic shared-memory limits (the table
// kernel's to the device's opt-in maximum) and looks the driver's
// tensor-map encoder up. Called once, when the library is loaded.
extern "C" int mas_quant_matmul_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(skinny_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S_SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
}

// x: [M, K] bf16 contiguous (K % 8 == 0, 16-byte aligned); wq: [K, N] int8
// contiguous, 16-byte aligned; scale: [N] float32; bias: [N] bf16 or null;
// out: [M, N] float32 (out_bf16 = 0) or bf16 (out_bf16 = 1).
// N % 16 == 0. wide = 1 takes the wgmma kernel; otherwise the
// skinny kernel with column tiles of bn = 32 and `splits` splits of
// `steps` 128-row K steps (every split holds a step); with splits > 1,
// part holds splits * tiles * 32 * 32 floats and counters one zeroed int
// per tile (row block, column tile), which the call leaves zero. Returns a cudaError_t
// value: a tensor map the driver refuses, a plan the kernel does not
// take, or cudaGetLastError() after the launch.
extern "C" int mas_quant_matmul(const void* x, const void* wq,
                                const void* scale, const void* bias, void* out,
                                void* part, void* counters, int M, int K,
                                int N, int out_bf16, int wide, int bn,
                                int splits, int steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N % 16) return (int)cudaErrorInvalidValue;
  if (wide) {
    CUtensorMap tx, tw;
    int e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                      (long long)K * 2, WB_K, WB_M, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0)
      e = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, K, N, N, WB_N,
                    WB_K, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
    dim3 grid((N + WB_N - 1) / WB_N, (M + WB_M - 1) / WB_M);
    wide_kernel<<<grid, W_NT, W_SMEM, s>>>(tx, tw, (const float*)scale,
                                           (const bf16*)bias, out, M, K, N,
                                           out_bf16);
    return (int)cudaGetLastError();
  }
  const int nk = (K + SB_K - 1) / SB_K;
  if (splits < 1 || steps < 1 || (splits - 1) * steps >= nk ||
      splits * steps < nk || bn != SB_N)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + SB_N - 1) / SB_N, splits, (M + SB_M - 1) / SB_M);
  skinny_kernel<<<grid, S_NT, S_SMEM, s>>>(
      (const bf16*)x, (const int8_t*)wq, (const float*)scale,
      (const bf16*)bias, out, (float*)part, (int*)counters, M, K, N,
      out_bf16, steps);
  return (int)cudaGetLastError();
}

// K5 on a transposed table: wt: [N, Kp] int8 contiguous, 16-byte
// aligned, Kp = K rounded up to 16 (the pad zero), Kp <= 2048; sms: the
// card's multiprocessors (one block each); the rest as mas_quant_matmul.
// Returns cudaGetLastError() after the launch.
extern "C" int mas_quant_matmul_table(const void* x, const void* wt,
                                      const void* scale, const void* bias,
                                      void* out, int M, int K, int Kp, int N,
                                      int out_bf16, int sms, void* stream) {
  if (Kp % 16 || K > Kp || Kp - K >= 16 || Kp > T_MAX_K || sms < 1)
    return (int)cudaErrorInvalidValue;
  // the opt-in shared memory a block, read once per device
  static int optin_of[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  int& optin = optin_of[dev];
  if (optin == 0) {
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int nch = (N + 15) / 16;
  const int fit = (optin - table_x_bytes(Kp)) / table_warp_bytes(Kp);
  const int want = max(4, min(T_MAX_NT / 32,
                              (nch + T_CHUNKS * sms - 1) / (T_CHUNKS * sms)));
  const int nw = min(fit, want);
  if (nw < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(sms, (M + 31) / 32);
  table_kernel<<<grid, nw * 32, table_x_bytes(Kp) + nw * table_warp_bytes(Kp),
                 (cudaStream_t)stream>>>(
      (const bf16*)x, (const int8_t*)wt, (const float*)scale,
      (const bf16*)bias, out, M, K, Kp, N, out_bf16);
  return (int)cudaGetLastError();
}
