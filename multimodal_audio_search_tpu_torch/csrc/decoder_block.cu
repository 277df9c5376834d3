// K3 and K4: the two fused sub-blocks of one Whisper decode step.
//
// K3, decoder self block (template flag TAIL = K3-q):
//   x_out = x + (single-query attention of LN(x) over the cache rows
//           t < pos + the fresh row, heads merged) @ Wo + bo,
//   k1/v1 written into row pos of the caches; with TAIL also
//   q_cross = LN2(x_out) @ Wcq + bcq.
// Replaces the Pallas kernels multimodal_audio_search_tpu/ops/
// decoder_block.py::fused_self_block (body _self_block_body, pallas_call
// at :200) and, with TAIL, fused_self_block_q (pallas_call at :272).
//
// K4, decoder MLP block (template flag HEAD = K4-o):
//   out = x1 + fc2(gelu(fc1(LN(x1)))),  x1 = x, or with HEAD
//   x1 = x + attn @ Wco + bco (float32, not rounded).
// Replaces fused_mlp_block (pallas_call at :611) and, with HEAD,
// fused_mlp_block_o (pallas_call at :363).
//
// What bounds them on an H100: weight bytes. One decode step at B=32 and
// whisper-base width reads 2 MB of Wq/Wk/Wv/Wo (K3) plus at most 4.5 MB
// of K/V cache at L=68, and 4 MB of fc1/fc2 (K4), per layer, for ~2 FLOP
// per weight element and row: far under the card's balance point. The
// TPU kernels run on 4 grid steps of 8 rows (BC=8); 4 blocks on 132 SMs
// would leave the card's bandwidth unused. So both kernels split the
// WEIGHTS across blocks:
//   * K3 (redesigned): a thread-block cluster of CS = min(H, 16) blocks
//     (ops/decoder_block.py::self_block_plan), rank r taking heads
//     [r H / CS, (r + 1) H / CS), for each tile of up to 16 batch rows,
//     launched with cudaLaunchKernelEx and a cluster dimension (a refused
//     launch raises). Each block streams its heads' 64 columns of Wq/Wk/
//     Wv and 64 rows of Wo once per row tile through a ring of 8 KB
//     tiles, each one TMA copy (128-byte swizzle) on an mbarrier, which a
//     producer warp keeps full from the first instruction on (an SM
//     pulls ~30 GB/s, so its link must never idle; the tiles are as
//     many as the card holds clusters at once); q/k/v and the
//     o-projection run on mma.sync m16n8k16 (bf16 in, float32 sums), one
//     n8 fragment a warp;
//     the attention's logits take a (row, key) pair a thread, its softmax
//     a warp a row, and its p . V splits the keys over the 8 warps, whose
//     partials add in warp order. Each block keeps its heads' o-projection
//     partials [rows, D] in shared memory; after a cluster barrier rank r
//     sums the CS partials of its heads' columns in rank order (so the
//     heads in order) through distributed shared memory and adds bias and
//     residual. No global partials, no arrival counters, nothing
//     allocated per call. K3-q continues in the same launch: the cross
//     layer norm's row sums go round the cluster the same way, each rank
//     gathers the whole h2 rows and projects its columns onto Wcq, whose
//     tiles close the same stream.
//   * K4 (redesigned): a block per 32 fc1 columns (a slice) and all B
//     rows, in 32-row blocks (64 blocks at base width; a block takes
//     several slices where F / 32 exceeds what the card holds at once),
//     so each weight byte leaves device memory once a launch; both
//     products on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//     sums) with the slice's fc1/fc2 tiles copied by cp.async; the layer
//     norm once per row, spread over the grid; two grid-wide barriers
//     (a cooperative launch) hand h to every block and the partials to
//     a spread, fixed-order reduction (see mlp_kernel).
//   * K4-o needs a whole row before its extra product (the LN after the
//     cross o-projection), which no one block of the split has. So it
//     runs one more small kernel, one block per (64 columns, 4 rows),
//     launched from the same C call: attn @ Wco + bco + x into a float32
//     buffer that K4-o's blocks read as their x.
// K14, decoder cross + MLP block (one C call, three stages):
//   q1 = LN2(x) @ Wcq + bcq             (rowproj_kernel<true, bf16>)
//   attn = single-query attention of q1 over merged cross K/V [B, T, D]
//                                       (cross_attention_split_kernel)
//   out = K4-o on (x, attn)             (rowproj_kernel<false> + mlp_kernel)
// Replaces fused_cross_mlp_block (body _cross_mlp_kernel :389,
// pallas_call at :515), which the JAX package keeps unwired (it measured
// slower than the unfused block on the TPU); K14 is not wired into the
// decode step either. Bounded by the cross K/V bytes (98 MB at B=32,
// T=1500, whisper-base width) against 5 MB of weights, so its attention
// is split over the keys, a thread-block cluster a (batch row, head)
// streaming K and then V with every cluster resident (see
// cross_attention_split_kernel), and launched as a programmatic dependent
// of the q-projection so its first copies overlap it: computing q1 in
// each block instead would read a head's 64 columns of Wcq (64 KB at base
// width) once per block, 512 times a call, 32 MB through the
// multiprocessors' links beside the 98 MB of K/V. It rounds where the
// TPU kernel rounds, not where K2 does: p = exp(logit - max) is taken
// against the row's global maximum (the ranks exchange theirs first); p
// is summed into l unrounded, rounded to bf16 before PV, and the
// division by l comes after PV.
//
// The extra phases' products (rowproj_kernel) are FMA in float32 on bf16
// operands, with 16-byte weight loads coalesced across threads (8
// columns a thread); a block reduces its threads' K slices through shared
// memory in a fixed order.
//
// Numerics follow the TPU kernels' roundings (ops/decoder_block.py's
// plain versions): h, q1, k1, v1, the fresh-row products q1*k1, the
// normalised weights p and pn, the merged attention output and gelu's
// output are rounded to bf16; LN scales (float32 in the parameter tree)
// are rounded to bf16 as the JAX wrappers cast them. The cache rows
// t < pos are read, the fresh row enters in closed form, and row pos is
// written by the blocks of its head -- so it is counted once. The GELU
// takes erff where the TPU kernels evaluate Abramowitz-Stegun 7.1.26
// (|difference| < 1.5e-7).
#include <cooperative_groups.h>

#include <mutex>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int NT = 256;   // threads per block
constexpr int HDIM = 64;  // head dim of every Whisper preset
constexpr int RB4 = 4;    // rows per extra-phase (rowproj) block
constexpr int PC = 64;    // output columns per extra-phase block
constexpr size_t SMEM_MAX = 48 * 1024;  // rowproj_kernel's

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Layer norm of the block's rows into sH [RB][ld] bf16, one warp per row:
// float32 mean and variance, (x - mu) / sqrt(var + eps) * g + b with g
// and b rounded to bf16, the result rounded to bf16. Rows >= nrows (the
// ragged edge of the batch) are zero.
template <int RB, typename Load>
__device__ void ln_rows(Load load, int nrows, int D, const float* g,
                        const bf16* b, float eps, bf16* sH, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RB; r += NT / 32) {
    bf16* hr = sH + r * ld;
    if (r >= nrows) {
      for (int k = lane; k < D; k += 32) hr[k] = __float2bfloat16(0.f);
      continue;
    }
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s += load(r, k);
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float d = load(r, k) - mu;
      v = fmaf(d, d, v);
    }
    const float rs = 1.f / sqrtf(warp_sum(v) / D + eps);
    for (int k = lane; k < D; k += 32)
      hr[k] = __float2bfloat16((load(r, k) - mu) * rs * bfr(g[k]) + bf(b[k]));
  }
}

// sum_k sIn[r][k] * W[k][c] for the block's RB rows and NC columns of a
// row-major bf16 W (row stride ldw; NC % 8 == 0, NC / 8 <= NT): thread
// (cg, ks) accumulates columns 8cg..8cg+7 over k = ks, ks + KS, ... with
// one 16-byte load per W row; the KS partial sums are added in order and
// handed to epi(r, c, sum) once per (r, c). red: NT * 8 * RB floats.
template <int RB, typename Epi>
__device__ void rows_x_w(const bf16* sIn, int K, const bf16* __restrict__ W,
                         int ldw, int NC, float* red, Epi epi) {
  const int CG = NC / 8, KS = NT / CG;
  const int cg = threadIdx.x % CG, ks = threadIdx.x / CG;
  if (ks < KS) {
    float acc[RB][8];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    const bf16* wp = W + cg * 8;
#pragma unroll 4
    for (int k = ks; k < K; k += KS) {
      float w[8];
      bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(
                        wp + (long long)k * ldw)), w);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float hv = bf(sIn[r * K + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(hv, w[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float4* dst = reinterpret_cast<float4*>(red + (ks * RB + r) * NC +
                                              cg * 8);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RB * NC; i += NT) {
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += red[q * RB * NC + i];
    epi(i / NC, i % NC, s);
  }
  __syncthreads();
}

// K3 / K3-q's cluster kernel (see the file's head). Shared memory of a
// block, in order: the weight ring [S][64 x 64] bf16 (on a 1024-byte
// boundary: each tile lands by TMA with the 128-byte swizzle, its 16-byte
// chunks XOR-ed by row, so ldmatrix.trans reads without bank conflicts),
// then for the tile's rt rows: the o-projection partials [rt][D + 4]
// float32 (read by the cluster), h [rt + 1][D + 8] bf16 (row rt zero:
// the m16 fragments' rows past rt read it), q1 / k1 / v1 [rt][68]
// float32, the fresh-row weights [16], the logits and p [rt][L] (then the
// warps' PV partials [8][rt][64]) and the attention output [16][72] bf16.
constexpr int K3_NT = NT + 32;      // 8 compute warps and a producer warp
constexpr int K3_RT = 16;           // rows of a tile: one m16 fragment
constexpr int K3_TILE = 64 * 64;    // bf16 of a streamed weight tile
constexpr int K3_MAX_STAGES = 24;   // ring slots
constexpr int K3_MIN_STAGES = 6;    // a q/k/v group of 3 and 3 ahead
constexpr int K3_MAX_CS = 16;       // an H100's largest cluster
constexpr int K3_QS = HDIM + 4;     // float stride of q1 / k1 / v1 rows
constexpr int K3_AS = HDIM + 8;     // bf16 stride of attention rows
constexpr int K3_LN_CH = 8;         // 16-byte chunks a lane: D <= 2048
// an H100 block's shared memory, less 1 KB for the static arrays
constexpr size_t K3_SMEM_MAX = 232448 - 1024;

// floats of the logits / PV-partials region of a tile of rt rows
__host__ __device__ inline int k3_scores(int rt, int L) {
  const int n = rt * L > 8 * rt * HDIM ? rt * L : 8 * rt * HDIM;
  return (n + 3) / 4 * 4;
}
inline size_t k3_smem(int D, int L, int stages, int rt) {
  return 1024 + (size_t)stages * K3_TILE * 2 + (size_t)rt * (D + 4) * 4 +
         (size_t)(rt + 1) * (D + 8) * 2 + (size_t)3 * rt * K3_QS * 4 +
         K3_RT * 4 + (size_t)k3_scores(rt, L) * 4 + (size_t)K3_RT * K3_AS * 2;
}

// Layer norm of x's rows [0, nrows) into sH [rows][ld] bf16 (rows past
// nrows zero; nrows <= 16), a warp a row, lane l the 16-byte chunks l,
// l + 32, ...; every load of a warp's two rows is issued before the first
// sum. The arithmetic is ln_rows's (float32 sums in another order).
__device__ void ln_tile(const bf16* __restrict__ x, int nrows, int rows,
                        int D, const float* __restrict__ g,
                        const bf16* __restrict__ b, float eps, bf16* sH,
                        int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = D / 8;
  uint4 v[2][K3_LN_CH];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = min(warp + 8 * q, nrows - 1);
#pragma unroll
    for (int j = 0; j < K3_LN_CH; ++j)
      v[q][j] = __ldg(reinterpret_cast<const uint4*>(x + (long long)r * D) +
                      min(lane + 32 * j, nch - 1));
  }
  for (int r = max(nrows, 0) + warp; r < rows; r += 8)  // zero rows
    for (int c = lane; c < nch; c += 32)
      *reinterpret_cast<uint4*>(sH + r * ld + c * 8) = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = warp + 8 * q;
    bf16* hr = sH + r * ld;
    if (r >= nrows) continue;
    float f[K3_LN_CH][8];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < K3_LN_CH; ++j) {
      bf16x8_to_f32(v[q][j], f[j]);
      if (lane + 32 * j < nch)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[j][e];
    }
    const float mu = warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < K3_LN_CH; ++j)
      if (lane + 32 * j < nch)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[j][e] - mu;
          var = fmaf(d, d, var);
        }
    const float rs = 1.f / sqrtf(warp_sum(var) / D + eps);
#pragma unroll
    for (int j = 0; j < K3_LN_CH; ++j) {
      const int c = lane + 32 * j;
      if (c >= nch) break;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g) + 2 * c);
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g) + 2 * c + 1);
      float bb[8];
      bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(b) + c), bb);
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = pack_bf16((f[j][2 * e] - mu) * rs * bfr(gg[2 * e]) + bb[2 * e],
                         (f[j][2 * e + 1] - mu) * rs * bfr(gg[2 * e + 1]) +
                             bb[2 * e + 1]);
      *reinterpret_cast<uint4*>(hr + c * 8) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// the compute warps' barrier (barrier 1): the producer warp does not take
// part in it
__device__ __forceinline__ void k3_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// D is the model width (x, the layer norm, the rows of Wq/Wk/Wv, the
// columns of Wo); H * 64 the width of the block's heads (the columns of
// Wq/Wk/Wv, the rows of Wo, the caches' rows): K3 and K3-q have D = H *
// 64, K3p (PARTIAL) a rank's head shard of the mesh's model axis, which
// writes the float32 o-projection sum to xout32 without x and bo.
template <bool TAIL, bool PARTIAL = false>
__global__ void __launch_bounds__(K3_NT, 1) self_block_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mo,
    const __grid_constant__ CUtensorMap mcq, const bf16* __restrict__ x,
    const float* __restrict__ g1, const bf16* __restrict__ b1,
    const bf16* __restrict__ bq, const bf16* __restrict__ bv,
    const bf16* __restrict__ bo, const float* __restrict__ g2,
    const bf16* __restrict__ b2, const bf16* __restrict__ bcq, bf16* kc,
    bf16* vc, bf16* __restrict__ xout, float* __restrict__ xout32,
    bf16* __restrict__ qcross, int B, int D, int H, int L, int pos, int rt,
    int S, float scale, float eps) {
  static_assert(!(TAIL && PARTIAL), "K3p has no tail");
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[K3_MAX_STAGES], empty[K3_MAX_STAGES];
  cg::cluster_group cluster = cg::this_cluster();
  const int LDH = D + 8, LDP = D + 4, nkc = D / 64, HL = H * HDIM;
  const int rank = blockIdx.x, CS = gridDim.x;  // a cluster spans x
  // the rank's heads: [h0, h0 + G), H / CS of them rounded down or up
  const int h0 = rank * H / CS, G = (rank + 1) * H / CS - h0;
  // the rank's output chunks of the head sum: [oc0, oc0 + ocn) of the nkc
  // (K3, K3-q: its heads' columns, the same split)
  const int oc0 = rank * nkc / CS, ocn = (rank + 1) * nkc / CS - oc0;
  const int r0 = blockIdx.y * rt, nrows = min(rt, B - r0);
  bf16* ring = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* sPart = reinterpret_cast<float*>(ring + (size_t)S * K3_TILE);
  bf16* sH = reinterpret_cast<bf16*>(sPart + rt * LDP);
  float* sQ = reinterpret_cast<float*>(sH + (rt + 1) * LDH);
  float* sK = sQ + rt * K3_QS;
  float* sV = sK + rt * K3_QS;
  float* sPn = sV + rt * K3_QS;
  float* sS = sPn + K3_RT;
  bf16* sA = reinterpret_cast<bf16*>(sS + k3_scores(rt, L));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const bf16* hA = sH + min(lr, rt) * LDH + lc;  // this lane's A row of h
  const bf16* kcr = kc + (long long)r0 * L * HL;  // the tile's cache rows
  const bf16* vcr = vc + (long long)r0 * L * HL;

  // The weight stream, tile u into ring slot u % S on barrier u % S: for
  // each head of the rank, its 3 nkc q/k/v tiles (rows 64kc.. of Wq, Wk,
  // Wv and the head's 64 columns; kc outer) and its nkc Wo tiles (the
  // head's 64 rows, columns 64c..); with TAIL then the G nkc Wcq tiles of
  // the rank's G * 64 output columns (column tile outer). A producer warp
  // (warp 8) puts tile u in flight as soon as the 8 compute warps have
  // released tile u - S (empty[u % S]), from the kernel's first
  // instruction on: an SM's copies share one ~30 GB/s link, which the
  // ring keeps busy while the warps compute.
  const int per_head = 4 * nkc, nheads = G * per_head;
  const int ntiles = nheads + (TAIL ? G * nkc : 0);
  auto issue = [&](int u) {
    if (u >= ntiles) return;
    const int j = u % per_head, c0 = (h0 + u / per_head) * HDIM;
    uint64_t* bar = &full[u % S];
    bf16* dst = ring + (size_t)(u % S) * K3_TILE;
    mbar_expect_tx(bar, K3_TILE * 2);
    if (u >= nheads)
      tma_load_2d(dst, &mcq, bar, (h0 + (u - nheads) / nkc) * HDIM,
                  (u - nheads) % nkc * 64);
    else if (j < 3 * nkc)
      tma_load_2d(dst, j % 3 == 0 ? &mq : j % 3 == 1 ? &mk : &mv, bar, c0,
                  (j / 3) * 64);
    else
      tma_load_2d(dst, &mo, bar, (j - 3 * nkc) * 64, c0);
  };
  // tiles i .. i + k - 1 have landed / this warp is done with them. The
  // warps read a tile with plain loads (ldmatrix) and the slot's next
  // TMA write is an async-proxy access, which the arrival alone does not
  // order after those loads: the proxy fence does (as K9's release_slot)
  auto acquire = [&](int i, int k) {
    for (int u = i; u < i + k; ++u) mbar_wait(&full[u % S], (u / S) & 1);
  };
  auto release = [&](int i, int k) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0)
      for (int u = i; u < i + k; ++u) mbar_arrive(&empty[u % S]);
  };
  auto tile = [&](int u) { return ring + (size_t)(u % S) * K3_TILE; };
  // the B fragment (k16 step kk, n8 fragment nf) of a swizzled tile
  auto ldb = [&](uint32_t b[2], const bf16* t, int kk, int nf) {
    const int row = kk * 16 + (lane & 15);
    ldsm_x2_trans(b, t + row * 64 + ((nf ^ (row & 7)) << 3));
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();  // the only barrier the producer takes part in
  if (warp == NT / 32) {
    // the producer: tiles u0 .. u1 - 1, each once its slot is released
    auto put = [&](int u0, int u1) {
      if (lane == 0)
        for (int u = u0; u < u1; ++u) {
          if (u >= S) mbar_wait(&empty[u % S], (u / S - 1) & 1);
          issue(u);
        }
      __syncwarp();
    };
    if (lane == 0) {
      prefetch_map(&mq);
      prefetch_map(&mk);
      prefetch_map(&mv);
      prefetch_map(&mo);
      if (TAIL) prefetch_map(&mcq);
    }
    // the heads' tiles are all released before the compute warps meet
    // at step 6's cluster barrier; the Wcq tiles past the first S only
    // after the tail's three barriers: the producer meets each barrier
    // between the tiles it needs
    put(0, nheads);
    cluster.sync();
    if (TAIL) {
      put(nheads, min(ntiles, nheads + S));
      for (int k = 0; k < 3; ++k) cluster.sync();
      put(nheads + S, ntiles);
    }
    cluster.sync();
    return;
  }
  // 0. the layer norm, the ring already in flight
  ln_tile(x + (long long)r0 * D, nrows, rt + 1, D, g1, b1, eps, sH, LDH);
  k3_sync();
  int ti = 0;
  const int kw = min(4, S / 2);  // Wo tiles a group
  for (int g = 0; g < G; ++g) {
    const int c0 = (h0 + g) * HDIM;
    // 1. q1, k1, v1 of the head: warp w the n8 fragment w of each, a
    // k-chunk's three tiles a step
    float acc[3][4] = {};
    for (int kc_ = 0; kc_ < nkc; ++kc_, ti += 3) {
      acquire(ti, 3);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, hA + kc_ * 64 + kk * 16);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          uint32_t b[2];
          ldb(b, tile(ti + m), kk, warp);
          mma_16816(acc[m], a, b[0], b[1]);
        }
      }
      release(ti, 3);
    }
    // rounded where rows_x_w's epilogues rounded; k1 / v1 into row pos
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = g8 + 8 * hf, c = warp * 8 + 2 * t4;
      float q2[2], k2[2], v2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        q2[e] = bfr(acc[0][2 * hf + e] + bf(bq[c0 + c + e]));
        k2[e] = bfr(acc[1][2 * hf + e]);
        v2[e] = bfr(acc[2][2 * hf + e] + bf(bv[c0 + c + e]));
        if (r < rt) {
          sQ[r * K3_QS + c + e] = q2[e];
          sK[r * K3_QS + c + e] = k2[e];
          sV[r * K3_QS + c + e] = v2[e];
        }
      }
      if (r < nrows) {
        const long long off = ((long long)(r0 + r) * L + pos) * HL + c0 + c;
        *reinterpret_cast<uint32_t*>(kc + off) = pack_bf16(k2[0], k2[1]);
        *reinterpret_cast<uint32_t*>(vc + off) = pack_bf16(v2[0], v2[1]);
      }
    }
    k3_sync();
    // 2. logits of the cache rows t < pos, a (row, key) pair a thread,
    // two pairs' loads in flight at once
    const int npair = nrows * pos;
    for (int i0 = tid; i0 < npair; i0 += 2 * NT) {
      uint4 kw8[2][8];
      int rr[2], tt[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = min(i0 + u * NT, npair - 1);
        rr[u] = i / pos;
        tt[u] = i - rr[u] * pos;
        const uint4* kr = reinterpret_cast<const uint4*>(
            kcr + ((long long)rr[u] * L + tt[u]) * HL + c0);
#pragma unroll
        for (int w = 0; w < 8; ++w) kw8[u][w] = __ldg(kr + w);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (i0 + u * NT >= npair) break;
        const float* q = sQ + rr[u] * K3_QS;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          float kf[8];
          bf16x8_to_f32(kw8[u][w], kf);
#pragma unroll
          for (int j = 0; j < 8; ++j) s = fmaf(q[w * 8 + j], kf[j], s);
        }
        sS[rr[u] * L + tt[u]] = s * scale;
      }
    }
    k3_sync();
    // 3. softmax with the fresh row in closed form, a warp a row
    for (int r = warp; r < nrows; r += NT / 32) {
      float* p = sS + r * L;
      const float* q = sQ + r * K3_QS;
      const float* k1 = sK + r * K3_QS;
      float mx = -INFINITY;
      for (int t = lane; t < pos; t += 32) mx = fmaxf(mx, p[t]);
      // the fresh row: per-head sum of the bf16-rounded products q1 * k1
      const float l_new = warp_sum(bfr(q[lane] * k1[lane]) +
                                   bfr(q[lane + 32] * k1[lane + 32])) *
                          scale;
      mx = fmaxf(warp_max(mx), l_new);
      float sum = 0.f;
      for (int t = lane; t < pos; t += 32) {
        const float e = expf(p[t] - mx);
        p[t] = e;
        sum += e;
      }
      const float denom = warp_sum(sum) + expf(l_new - mx);
      for (int t = lane; t < pos; t += 32) p[t] = bfr(p[t] / denom);
      if (lane == 0) sPn[r] = bfr(expf(l_new - mx) / denom);
    }
    k3_sync();
    // 4. p . V: warp w the keys [w kpw, (w + 1) kpw) of every row, eight
    // keys' loads in flight at once, lane l the columns 2l, 2l + 1; the
    // warps' partials added in warp order, then the fresh row's pn * v1
    const int kpw = (pos + 7) / 8, ta = warp * kpw;
    const int tb = min(pos, ta + kpw);
    float a[K3_RT][2];
#pragma unroll
    for (int r = 0; r < K3_RT; ++r) {
      a[r][0] = a[r][1] = 0.f;
      if (r >= nrows) continue;
      const bf16* vr = vcr + (long long)r * L * HL + c0 + 2 * lane;
      const float* pr = sS + r * L;
      for (int t = ta; t < tb; t += 8) {
        unsigned w8[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          w8[u] = __ldg(reinterpret_cast<const unsigned*>(
              vr + (long long)min(t + u, tb - 1) * HL));
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float p = t + u < tb ? pr[t + u] : 0.f;
          const float2 v = unpack_bf16(w8[u]);
          a[r][0] = fmaf(p, v.x, a[r][0]);
          a[r][1] = fmaf(p, v.y, a[r][1]);
        }
      }
    }
    k3_sync();  // every warp is done with the logits
    float* red = sS;
#pragma unroll
    for (int r = 0; r < K3_RT; ++r)
      if (r < rt)
        *reinterpret_cast<float2*>(red + (warp * rt + r) * HDIM + 2 * lane) =
            make_float2(a[r][0], a[r][1]);
    k3_sync();
    for (int i = tid; i < K3_RT * HDIM; i += NT) {
      const int r = i / HDIM, d = i % HDIM;
      float o = 0.f;
      if (r < nrows) {
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) o += red[(w * rt + r) * HDIM + d];
        o += sPn[r] * sV[r * K3_QS + d];
      }
      sA[r * K3_AS + d] = __float2bfloat16(o);
    }
    k3_sync();  // sA is whole
    // 5. the head's share of the o-projection into sPart (the rank's
    // heads added in order), kw Wo tiles a step
    uint32_t af[4][4];
    for (int c = 0; c < nkc; c += kw) {
      const int k = min(kw, nkc - c);
      acquire(ti, k);
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(af[kk], sA + lr * K3_AS + kk * 16 + lc);
      }
      float o[4][4] = {};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= k) break;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t b[2];
          ldb(b, tile(ti + u), kk, warp);
          mma_16816(o[u], af[kk], b[0], b[1]);
        }
      }
      release(ti, k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= k) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (g8 + 8 * (e >> 1) >= rt) continue;
          float* dst = sPart + (g8 + 8 * (e >> 1)) * LDP + (c + u) * 64 +
                       warp * 8 + 2 * t4 + (e & 1);
          *dst = g == 0 ? o[u][e] : *dst + o[u][e];
        }
      }
      ti += k;
    }
  }
  // 6. the head sum through distributed shared memory: rank r adds the
  // ranks' partials of its ocn * 64 columns in rank order (so the heads
  // in order), 4 columns a thread with every rank's load in flight, then
  // bias and residual (K3p: the sum alone, in float32). Every rank stays
  // until all have read.
  cluster.sync();
  const int cw = ocn * HDIM, nq = cw / 4;
  float* sX = sS;  // TAIL: the rank's x_out columns [16][cw], float32
  for (int i = tid; i < nrows * nq; i += NT) {
    const int r = i / nq, c = oc0 * HDIM + (i % nq) * 4;
    float4 pv[K3_MAX_CS];
#pragma unroll
    for (int k = 0; k < K3_MAX_CS; ++k)
      pv[k] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sPart, k < CS ? k : 0) + r * LDP + c);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K3_MAX_CS; ++k)
      if (k < CS) {
        o[0] += pv[k].x;
        o[1] += pv[k].y;
        o[2] += pv[k].z;
        o[3] += pv[k].w;
      }
    const long long gi = (long long)(r0 + r) * D + c;
    if (PARTIAL) {
      *reinterpret_cast<float4*>(xout32 + gi) =
          make_float4(o[0], o[1], o[2], o[3]);
      continue;
    }
    const uint2 xw = *reinterpret_cast<const uint2*>(x + gi);
    const uint2 bw = *reinterpret_cast<const uint2*>(bo + c);
    const float2 x01 = unpack_bf16(xw.x), x23 = unpack_bf16(xw.y);
    const float2 b01 = unpack_bf16(bw.x), b23 = unpack_bf16(bw.y);
    const float4 xo = make_float4(
        x01.x + (o[0] + b01.x), x01.y + (o[1] + b01.y),
        x23.x + (o[2] + b23.x), x23.y + (o[3] + b23.y));
    *reinterpret_cast<uint2*>(xout + gi) =
        make_uint2(pack_bf16(xo.x, xo.y), pack_bf16(xo.z, xo.w));
    if (TAIL)
      *reinterpret_cast<float4*>(sX + r * cw + (i % nq) * 4) = xo;
  }
  if (TAIL) {
    // 7. K3-q's tail: the cross layer norm of the float32 x_out rows,
    // whose columns the ranks hold in turn: each rank's row sums, then
    // its sums of squared deviations, added over the ranks in rank
    // order; h2 = LN2(x_out) into the rank's columns of sH, gathered
    // from every rank; then the rank's G * 64 columns of h2 @ Wcq + bcq
    // on mma.sync from the stream's last tiles.
    __shared__ float stat[2][K3_RT];
    __shared__ float row_mu[K3_RT], row_rs[K3_RT];
    k3_sync();
    for (int pass = 0; pass < 2; ++pass) {
      for (int r = warp; r < K3_RT; r += NT / 32) {
        float v = 0.f;
        if (r < nrows)
          for (int c = lane; c < cw; c += 32) {
            const float e = sX[r * cw + c] - (pass ? row_mu[r] : 0.f);
            v = pass ? fmaf(e, e, v) : v + e;
          }
        v = warp_sum(v);
        if (lane == 0) stat[pass][r] = v;
      }
      cluster.sync();
      if (tid < K3_RT) {
        float t = 0.f;
        for (int k = 0; k < CS; ++k)
          t += cluster.map_shared_rank(&stat[pass][0], k)[tid];
        if (pass == 0)
          row_mu[tid] = t / D;
        else
          row_rs[tid] = 1.f / sqrtf(t / D + eps);
      }
      k3_sync();
    }
    for (int i = tid; i < rt * cw; i += NT) {
      const int r = i / cw, c = oc0 * HDIM + i % cw;
      sH[r * LDH + c] = __float2bfloat16(
          r < nrows ? (sX[i] - row_mu[r]) * row_rs[r] * bfr(g2[c]) + bf(b2[c])
                    : 0.f);
    }
    cluster.sync();  // every rank's h2 columns are in place
    for (int i = tid; i < rt * (D / 8); i += NT) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      int k = 0;  // the rank holding chunk c8 / 8
      while ((k + 1) * nkc / CS <= c8 / 8) ++k;
      if (k != rank)
        *reinterpret_cast<uint4*>(sH + r * LDH + c8 * 8) =
            *reinterpret_cast<const uint4*>(
                cluster.map_shared_rank(sH, k) + r * LDH + c8 * 8);
    }
    k3_sync();  // the gathered h2 is whole
    for (int cc = 0; cc < G; ++cc) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < nkc; k0 += kw) {
        const int k = min(kw, nkc - k0);
        acquire(ti, k);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= k) break;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t a[4], b[2];
            ldsm_x4(a, hA + (k0 + u) * 64 + kk * 16);
            ldb(b, tile(ti + u), kk, warp);
            mma_16816(acc, a, b[0], b[1]);
          }
        }
        release(ti, k);
        ti += k;
      }
      const int c = (h0 + cc) * HDIM + warp * 8 + 2 * t4;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g8 + 8 * hf;
        if (r < nrows)
          *reinterpret_cast<uint32_t*>(qcross + (long long)(r0 + r) * D + c) =
              pack_bf16(acc[2 * hf] + bf(bcq[c]), acc[2 * hf + 1] +
                                                     bf(bcq[c + 1]));
      }
    }
  }
  cluster.sync();
}

__device__ __forceinline__ float ldf(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ldf(const bf16* p, long long i) {
  return bf(p[i]);
}

// One block per (64 output columns, 4 rows) of a [B, D] x [D, D] product
// on input rows `in` (float32, or bf16 for K14's first stage):
//   LN:  out (bf16) = LN(in) @ W + bias          (K3-q's tail, K14's q)
//   !LN: out (f32)  = xres + bf16(in) @ W + bias  (K4-o's head)
template <bool LN, typename In>
__global__ void __launch_bounds__(NT) rowproj_kernel(
    const In* __restrict__ in, const float* __restrict__ g,
    const bf16* __restrict__ bln, const bf16* __restrict__ W,
    const bf16* __restrict__ bias, const bf16* __restrict__ xres, void* out,
    int B, int D, float eps) {
  // K14's attention, launched as a programmatic dependent of its
  // q-projection, may start now (it waits for q1 before reading it); no
  // other launch after this kernel asks to start early
  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);    // NT * 8 * RB4
  bf16* sH = reinterpret_cast<bf16*>(red + NT * 8 * RB4);  // [RB4][D]
  const int c0 = blockIdx.x * PC, r0 = blockIdx.y * RB4;
  const int nrows = min(RB4, B - r0);
  auto load = [&](int r, int k) {
    return ldf(in, (long long)(r0 + r) * D + k);
  };
  if (LN) {
    ln_rows<RB4>(load, nrows, D, g, bln, eps, sH, D);
  } else {
    for (int i = threadIdx.x; i < RB4 * D; i += NT)
      sH[i] = __float2bfloat16(i / D < nrows ? load(i / D, i % D) : 0.f);
  }
  __syncthreads();
  rows_x_w<RB4>(sH, D, W + c0, D, PC, red, [&](int r, int c, float s) {
    if (r >= nrows) return;
    const long long i = (long long)(r0 + r) * D + c0 + c;
    const float y = s + bf(bias[c0 + c]);
    if (LN)
      static_cast<bf16*>(out)[i] = __float2bfloat16(y);
    else
      static_cast<float*>(out)[i] = bf(xres[i]) + y;
  });
}

// K4 / K4-o on tensor cores. The F fc1 columns (= fc2 rows) are cut into
// S = F / MLP_FS slices; block b of a grid of G = min(S, the blocks that
// fit on the card at once) takes slices b, b + G, ..., each for every
// 32-row block of the batch (two m16 tiles), so each weight byte leaves
// device memory once a launch and the grid depends on F alone. D is taken
// in chunks of MLP_DC: fc1's rows and h's columns, fc2's columns (one
// chunk at whisper-base width and below, so a slice's weights are staged
// once and serve every row block). The launch is cooperative, so every
// block is resident and the grid can meet at two barriers:
//   1. every block puts its first slice's fc1 and fc2 chunks in flight
//      into shared memory (cp.async), then block b normalises rows b,
//      b + G, ... (once per row over the grid, all 256 threads on a row)
//      into hbuf; barrier;
//   2. per (slice, row block): h's chunks from hbuf (L2) into shared
//      memory; u = gelu(h @ W1[:, slice] + b1) on mma.sync (8 warps: 4 n8
//      fragments x 2 parts of a chunk, each part two chains of products;
//      chains, parts and chunks added in order), rounded to bf16; the
//      slice's share of fc2, u @ W2[slice, :], into part[slice] (float32);
//      barrier;
//   3. block b sums its 1/G of the [B, D] outputs over the S partials in
//      slice order and adds bias and residual; the last block out leaves
//      the barrier counters zero.
// The results do not depend on G: every sum runs in slice order. ONE is
// the single pass (one D chunk, one row block, one slice a block: the
// engine's B <= 32 at whisper-base width and below), where the loops'
// trip counts are the constant 1: runtime counts cost ~4 us a launch at
// base width on an H100 (17.4-18.4 against 13.5-13.9). PARTIAL is K4p,
// one rank of the mesh's model axis: F is the rank's shard of fc1's
// columns (fc2's rows), step 3 writes the float32 sum alone to out32,
// with neither x nor b2 (parallel/mesh.py::model_sum adds them once).
constexpr int MLP_NT = 256;
constexpr int MLP_FS = 32;               // fc1 columns per slice
constexpr int MLP_LDS = MLP_FS + 8;      // bf16 per staged fc1 / u row
constexpr int MLP_PARTS = 8 / (MLP_FS / 8);  // fc1's parts of a D chunk
constexpr int MLP_DC = 512;              // D chunk
constexpr int MLP_MAX_D = 2048;          // the layer norm's 8 values a thread

inline int mlp_dc(int D) { return D < MLP_DC ? D : MLP_DC; }
inline size_t mlp_smem(int dc) {
  return (size_t)(dc * MLP_LDS + (MLP_FS + 32) * (dc + 8) + 32 * MLP_LDS) *
             2 +
         (MLP_PARTS - 1) * 32 * MLP_FS * 4;
}

// Layer norm of one row by the whole block (D <= MLP_MAX_D) into hr[D]
// bf16, each thread the elements tid, tid + MLP_NT, ...: the same
// function as ln_rows, its float32 sums over the block (a warp tree, then
// the warps in order). Every thread of the block calls it.
template <typename Load>
__device__ void ln_row_block(Load load, int D, const float* g, const bf16* b,
                             float eps, bf16* hr, float* sm) {
  constexpr int E = MLP_MAX_D / MLP_NT;
  float v[E], gv[E], bv[E];  // every load issued before the first sum
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = threadIdx.x + e * MLP_NT;
    const bool ok = k < D;
    v[e] = ok ? load(k) : 0.f;
    gv[e] = ok ? bfr(g[k]) : 0.f;
    bv[e] = ok ? bf(b[k]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) s += v[e];
  const float mu = block_sum<MLP_NT>(s, sm) / D;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = threadIdx.x + e * MLP_NT < D ? v[e] - mu : 0.f;
    q = fmaf(v[e], v[e], q);
  }
  const float rs = 1.f / sqrtf(block_sum<MLP_NT>(q, sm) / D + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = threadIdx.x + e * MLP_NT;
    if (k < D) hr[k] = __float2bfloat16(v[e] * rs * gv[e] + bv[e]);
  }
}

// All G blocks meet here (they are co-resident: the launch is
// cooperative). *c counts arrivals; the waiting thread spins on it
// without sleeping (a __nanosleep wakes late by a microsecond).
__device__ __forceinline__ void grid_sync(int* c, int n) {
  __threadfence();  // this thread's stores, before the arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(c, 1);
    while (*reinterpret_cast<volatile int*>(c) < n) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool HEAD, bool ONE, bool PARTIAL = false>
__global__ void __launch_bounds__(MLP_NT, 1) mlp_kernel(
    const bf16* __restrict__ x, const float* __restrict__ x32,
    const float* __restrict__ g, const bf16* __restrict__ bln,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* hbuf,
    float* part, int* bar, bf16* __restrict__ out, float* __restrict__ out32,
    int B, int D, int F, float eps) {
  static_assert(!(HEAD && PARTIAL), "K4p has no head");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DC = min(D, MLP_DC), LDC = DC + 8;
  bf16* sW1 = reinterpret_cast<bf16*>(smem_raw);  // [DC][MLP_LDS]
  bf16* sW2 = sW1 + DC * MLP_LDS;                 // [MLP_FS][LDC]
  bf16* sH = sW2 + MLP_FS * LDC;                  // [32][LDC]
  bf16* sU = sH + 32 * LDC;                       // [32][MLP_LDS]
  float* sRed = reinterpret_cast<float*>(sU + 32 * MLP_LDS);  // [P-1][32][FS]
  const int G = gridDim.x, S = F / MLP_FS;
  const int nch = ONE ? 1 : (D + DC - 1) / DC;
  const int nrb = ONE ? 1 : (B + 31) / 32;
  const int j1 = ONE ? blockIdx.x + 1 : S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  auto xin = [&](long long i) { return HEAD ? x32[i] : bf(x[i]); };

  // copies of fc1 rows [k0, k0 + DC) x slice j's columns into sW1, of
  // slice j's fc2 rows x columns [n0, n0 + DC) into sW2, and of h's row
  // block rb x columns [k0, k0 + DC) into sH (zeros past B)
  auto stage_w1 = [&](int j, int c) {
    const int k0 = c * DC, kc = min(DC, D - k0);
    for (int i = tid; i < kc * (MLP_FS / 8); i += MLP_NT) {
      const int k = i / (MLP_FS / 8), cc = (i % (MLP_FS / 8)) * 8;
      cp_async16(sW1 + k * MLP_LDS + cc,
                 w1 + (long long)(k0 + k) * F + j * MLP_FS + cc);
    }
  };
  auto stage_w2 = [&](int j, int c) {
    const int n0 = c * DC, cw = min(DC, D - n0) / 8;
    for (int i = tid; i < MLP_FS * cw; i += MLP_NT) {
      const int r = i / cw, cc = (i % cw) * 8;
      cp_async16(sW2 + r * LDC + cc,
                 w2 + (long long)(j * MLP_FS + r) * D + n0 + cc);
    }
  };
  auto stage_h = [&](int rb, int c) {
    const int r0 = rb * 32, nrows = min(32, B - r0);
    const int k0 = c * DC, cw = min(DC, D - k0) / 8;
    for (int i = tid; i < 32 * cw; i += MLP_NT) {
      const int r = i / cw, cc = (i % cw) * 8;
      const bool ok = r < nrows;
      cp_async16_zfill(
          sH + r * LDC + cc,
          ok ? (const void*)(hbuf + (long long)(r0 + r) * D + k0 + cc)
             : (const void*)hbuf,
          ok ? 16 : 0);
    }
  };

  // 1. the first slice's first chunks, in flight through the layer norm
  int w1_at = blockIdx.x * nch, w2_at = blockIdx.x * nch;  // slice*nch+chunk
  stage_w1(blockIdx.x, 0);
  stage_w2(blockIdx.x, 0);
  cp_async_commit();
  __shared__ float sm_ln[MLP_NT / 32];
  for (int r = blockIdx.x; r < B; r += G) {  // a block per row
    const long long row = (long long)r * D;
    ln_row_block([&](int k) { return xin(row + k); }, D, g, bln, eps,
                 hbuf + row, sm_ln);
  }
  grid_sync(bar, G);

  // 2. fc1 + gelu and the slice's share of fc2, per (slice, row block)
  // warp: n8 fragment nf of the slice in fc1, part kp of a D chunk
  const int nf = warp % (MLP_FS / 8), kp = warp / (MLP_FS / 8);
  for (int j = blockIdx.x; j < j1; j += G) {
    const int f0 = j * MLP_FS;
    for (int rb = 0; rb < nrb; ++rb) {
      const int r0 = rb * 32, nrows = min(32, B - r0);
      // two product chains a fragment, on even and odd k16 steps, added
      // after the chunks
      float ac2[2][2][4] = {};
      for (int c = 0; c < nch; ++c) {
        __syncthreads();  // sH and sW1 are free
        if (w1_at != j * nch + c) {
          stage_w1(j, c);
          w1_at = j * nch + c;
        }
        stage_h(rb, c);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        const int steps = min(DC, D - c * DC) / 16 / MLP_PARTS;  // even
#pragma unroll 2
        for (int kk = kp * steps; kk < (kp + 1) * steps; kk += 2) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t a0[4], a1[4], bq[2];
            ldsm_x4(a0, sH + lr * LDC + (kk + q) * 16 + lc);
            ldsm_x4(a1, sH + (16 + lr) * LDC + (kk + q) * 16 + lc);
            ldsm_x2_trans(bq, sW1 + ((kk + q) * 16 + (lane & 15)) * MLP_LDS +
                                  nf * 8);
            mma_16816(ac2[q][0], a0, bq[0], bq[1]);
            mma_16816(ac2[q][1], a1, bq[0], bq[1]);
          }
        }
      }
      float acc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = ac2[0][a][e] + ac2[1][a][e];
      // acc[a][e]: row 16a + g8 + 8(e / 2), column 8nf + 2t4 + e % 2
      if (kp > 0) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sRed[((kp - 1) * 32 + 16 * a + g8 + 8 * (e >> 1)) * MLP_FS +
                 nf * 8 + 2 * t4 + (e & 1)] = acc[a][e];
      }
      __syncthreads();
      if (kp == 0) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * a + g8 + 8 * (e >> 1);
            const int c = nf * 8 + 2 * t4 + (e & 1);
            float u = acc[a][e];
#pragma unroll
            for (int q = 1; q < MLP_PARTS; ++q)
              u += sRed[((q - 1) * 32 + r) * MLP_FS + c];
            u += bf(b1[f0 + c]);
            sU[r * MLP_LDS + c] = __float2bfloat16(
                0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
          }
      }
      __syncthreads();
      for (int c = 0; c < nch; ++c) {
        if (w2_at != j * nch + c) {
          __syncthreads();  // sW2 is free
          stage_w2(j, c);
          w2_at = j * nch + c;
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
        // warp w: columns n0 + w * cw .. of fc2, cw / 8 n8 fragments
        const int n0 = c * DC, cw = min(DC, D - n0) / 8, nfr = cw / 8;
        float acc2[2][MLP_DC / 64][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int f = 0; f < MLP_DC / 64; ++f)
            acc2[a][f][0] = acc2[a][f][1] = acc2[a][f][2] = acc2[a][f][3] =
                0.f;
#pragma unroll
        for (int kk = 0; kk < MLP_FS / 16; ++kk) {
          uint32_t a0[4], a1[4];
          ldsm_x4(a0, sU + lr * MLP_LDS + kk * 16 + lc);
          ldsm_x4(a1, sU + (16 + lr) * MLP_LDS + kk * 16 + lc);
#pragma unroll
          for (int f = 0; f < MLP_DC / 64; ++f) {
            if (f >= nfr) break;
            uint32_t bq[2];
            ldsm_x2_trans(bq, sW2 + (kk * 16 + (lane & 15)) * LDC + warp * cw +
                                  f * 8);
            mma_16816(acc2[0][f], a0, bq[0], bq[1]);
            mma_16816(acc2[1][f], a1, bq[0], bq[1]);
          }
        }
        float* pj = part + ((long long)j * B + r0) * D + n0;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int f = 0; f < MLP_DC / 64; ++f) {
            if (f >= nfr) break;
            const int cc = warp * cw + f * 8 + 2 * t4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * a + g8 + 8 * h;
              if (r < nrows)
                *reinterpret_cast<float2*>(pj + (long long)r * D + cc) =
                    make_float2(acc2[a][f][2 * h], acc2[a][f][2 * h + 1]);
            }
          }
      }
    }
  }
  grid_sync(bar + 1, G);

  // 3. block b's share of the outputs, the S partials summed in order
  const long long total = (long long)B * D;
  const long long chunk = (total + G - 1) / G;
  const long long i1 = min(total, (blockIdx.x + 1) * chunk);
  for (long long i = blockIdx.x * chunk + tid; i < i1; i += MLP_NT) {
    const int c = (int)(i % D);
    const float y = ordered_sum(part + i, total, S);
    if (PARTIAL)
      out32[i] = y;
    else
      out[i] = __float2bfloat16(xin(i) + (y + bf(b2[c])));
  }
  if (tid == 0 && atomicAdd(bar + 2, 1) == G - 1) {
    bar[0] = 0;  // every block has passed both barriers
    bar[1] = 0;
    bar[2] = 0;
  }
}

// K14's attention: split-T over a thread-block cluster (K6's form, on
// bf16 K/V). A cluster of cs blocks takes one (batch row, head); rank r
// the keys [r chunk, (r + 1) chunk) below T (a rank may hold none). The
// plan (ops/decoder_block.py::cross_plan) makes every cluster resident at
// once where the card holds them, so the keys stream in one wave:
//   * at entry one thread puts the first X_PREFIX of the rank's V rows in
//     flight by TMA (a rank-4 map over {64, H, T, B}, boxes of {64, 1,
//     R <= 256 rows, 1}): they land while the q-projection runs (this
//     kernel is launched early, as its programmatic dependent) and while
//     K streams. Shared memory holds no more of V: the whole of it at
//     once would not fit the card (49 MB at B=32, T=1500, base width),
//     and blocks that each held their chunk ran in two waves, the K
//     stream of every block sharing its multiprocessor's link with its V
//     (phase stamps in PERF.md);
//   * every thread streams K through registers, 8 lanes a 128-byte key
//     row (one 16-byte load each), X_AG rows a pass and X_PASSES passes
//     of loads in flight, into the logits in shared memory; the first
//     passes are issued before griddepcontrol.wait, the only wait on the
//     q-projection;
//   * p must be rounded against the row's global max (B12 rounds
//     exp(logit - max) to bf16), so the ranks exchange their max through
//     distributed shared memory before any p is formed; each rank then
//     forms p = exp(logit - m) once a key, sums the unrounded p into l
//     and accumulates bf16(p) * V, its prefix from shared memory and the
//     rest streamed through registers as K was (its row groups added in
//     a fixed order);
//   * rank 0 adds the ranks' l and [64] partials in rank order and
//     divides by l once.
// Output [B, H*64] float32, not rounded (K4-o's head rounds it into the
// o-projection).
constexpr int X_NT = 256;          // threads an attention block
constexpr int X_AG = X_NT / 8;     // key rows a pass
constexpr int X_PASSES = 4;        // passes of loads in flight at once
constexpr int X_PREFIX = 320;      // V rows a block takes by TMA (40 KB)
constexpr int X_MAX_CS = 16;       // blocks a cluster (non-portable above 8)
constexpr int X_SMEM_LIMIT = 200 * 1024;

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }
// V rows a TMA box: the prefix in as few boxes of at most 256 rows (TMA's
// limit a box dimension) as it takes
__host__ __device__ inline int x_box_rows(int chunk) {
  const int p = chunk < X_PREFIX ? chunk : X_PREFIX;
  const int nbox = (p + 255) / 256;
  return (p + nbox - 1) / nbox;
}
// the V prefix in whole boxes (later the row groups' p . V partials),
// then the logits (later the row groups' l); 128 bytes to align the
// prefix
__host__ __device__ inline int x_v_bytes(int chunk) {
  const int p = chunk < X_PREFIX ? chunk : X_PREFIX;
  const int r = x_box_rows(chunk);
  const int v = (p + r - 1) / r * r * HDIM * 2;
  return align128(v > X_AG * HDIM * 4 ? v : X_AG * HDIM * 4);
}
__host__ __device__ inline int x_smem_bytes(int chunk) {
  return 128 + x_v_bytes(chunk) +
         align128(4 * (chunk > X_AG ? chunk : X_AG));
}

// A pass group's rows i0 + u X_AG + grp (u < X_PASSES), 16 bytes of each
// at base (row stride HD); rows >= n read as zeros.
__device__ __forceinline__ void load_rows(uint4 (&kr)[X_PASSES],
                                          const bf16* base, int i0, int grp,
                                          int n, int HD) {
#pragma unroll
  for (int u = 0; u < X_PASSES; ++u) {
    const int i = i0 + u * X_AG + grp;
    kr[u] = i < n ? __ldg(reinterpret_cast<const uint4*>(
                        base + (long long)i * HD))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc += bf16(p) * V row (eight columns as one 16-byte word), l += p,
// p = exp(logit - m)
__device__ __forceinline__ void pv_row(float acc[8], float& l, float logit,
                                       float m, uint4 vw) {
  const float p = expf(logit - m);
  l += p;
  const float pb = bfr(p);
  float vf[8];
  bf16x8_to_f32(vw, vf);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = fmaf(pb, vf[e], acc[e]);
}

__global__ void __launch_bounds__(X_NT, 4) cross_attention_split_kernel(
    const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    float* __restrict__ out, int T, int H, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA writes boxes to 128-byte aligned shared memory
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  bf16* sV = reinterpret_cast<bf16*>(base);  // [prefix rows][64]
  float* sS = reinterpret_cast<float*>(base + x_v_bytes(chunk));
  __shared__ uint64_t vbar;  // the V prefix landed
  __shared__ float s_red[X_NT / 32];
  __shared__ float s_m, s_gm, s_l;  // this rank's max, the cluster's, l
  __shared__ float s_o[HDIM];       // this rank's p . V

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int t0 = rank * chunk;
  const int n = max(0, min(chunk, T - t0));
  const int np = min(n, X_PREFIX);  // rows of the prefix
  const int tid = threadIdx.x, sub = tid & 7, grp = tid >> 3;
  const int HD = H * HDIM;
  const int R = x_box_rows(chunk);
  const int nbox = (np + R - 1) / R;

  if (tid == 0) {
    prefetch_map(&tv);
    mbar_init(&vbar, 1);
    fence_mbar_init();
    mbar_expect_tx(&vbar, (uint32_t)(nbox * R * HDIM * 2));
    for (int i = 0; i < nbox; ++i)
      tma_load_4d(sV + i * R * HDIM, &tv, &vbar, 0, h, t0 + i * R, b);
  }
  // 1. logits of the rank's keys
  const long long off = ((long long)b * T + t0) * HD + h * HDIM + sub * 8;
  const bf16* kb = k + off;
  constexpr int STEP = X_PASSES * X_AG;
  uint4 ka[X_PASSES];
  load_rows(ka, kb, 0, grp, n, HD);
  grid_dependency_wait();  // q1: the q-projection has finished
  float qf[8];
  bf16x8_to_f32(
      *reinterpret_cast<const uint4*>(q + (long long)b * HD + h * HDIM +
                                      sub * 8),
      qf);
  float mx = -INFINITY;
  // uniform trip count over the block, so every lane reaches the shuffles
  for (int i0 = 0; i0 < n; i0 += STEP) {
    uint4 kn[X_PASSES];
    load_rows(kn, kb, i0 + STEP, grp, n, HD);
#pragma unroll
    for (int u = 0; u < X_PASSES; ++u) {
      float kf[8];
      bf16x8_to_f32(ka[u], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(qf[e], kf[e], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      const int i = i0 + u * X_AG + grp;
      if (i < n) {
        s *= scale;
        if (sub == 0) sS[i] = s;
        mx = fmaxf(mx, s);
      }
      ka[u] = kn[u];
    }
  }
  // 2. the cluster's max (its barriers publish sS too)
  mx = block_max<X_NT>(mx, s_red);
  if (tid == 0) s_m = mx;
  cluster.sync();
  if (tid < 32) {
    const float v0 =
        tid < cs ? *cluster.map_shared_rank(&s_m, tid) : -INFINITY;
    const float m = warp_max(v0);
    if (tid == 0) s_gm = m;
  }
  __syncthreads();
  // 3. p = exp(logit - m), l over the unrounded p, bf16(p) . V: the
  // rows past the prefix streamed (their first loads in flight while the
  // prefix is summed), then the prefix from shared memory
  const float m = s_gm;
  float l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const bf16* vb = v + off;
  uint4 va[X_PASSES];
  load_rows(va, vb, np, grp, n, HD);
  mbar_wait(&vbar, 0);
  for (int i = grp; i < np; i += X_AG)
    pv_row(acc, l, sS[i], m,
           *reinterpret_cast<const uint4*>(sV + i * HDIM + sub * 8));
  for (int i0 = np; i0 < n; i0 += STEP) {
    uint4 vn[X_PASSES];
    load_rows(vn, vb, i0 + STEP, grp, n, HD);
#pragma unroll
    for (int u = 0; u < X_PASSES; ++u) {
      const int i = i0 + u * X_AG + grp;
      if (i < n) pv_row(acc, l, sS[i], m, va[u]);
      va[u] = vn[u];
    }
  }
  __syncthreads();  // the prefix and the logits are read: they take sums
  float* s_part = reinterpret_cast<float*>(sV);  // [X_AG][64]
#pragma unroll
  for (int e = 0; e < 8; ++e) s_part[grp * HDIM + sub * 8 + e] = acc[e];
  if (sub == 0) sS[grp] = l;
  __syncthreads();
  if (tid < HDIM) {
    float o = 0.f;
    for (int g = 0; g < X_AG; ++g) o += s_part[g * HDIM + tid];
    s_o[tid] = o;
  } else if (tid == HDIM) {
    float ls = 0.f;
    for (int g = 0; g < X_AG; ++g) ls += sS[g];
    s_l = ls;
  }
  // 4. rank 0 adds the ranks' partials and l in rank order; every rank
  // stays until rank 0 has read them
  cluster.sync();
  if (rank == 0 && tid < HDIM) {
    float o = 0.f, ls = 0.f;
    for (int r = 0; r < cs; ++r) {
      o += cluster.map_shared_rank(s_o, r)[tid];
      ls += *cluster.map_shared_rank(&s_l, r);
    }
    out[(long long)b * HD + h * HDIM + tid] = o / ls;
  }
  cluster.sync();
}

inline dim3 rows_grid(int cols, int B, int rb) {
  return dim3(cols, (B + rb - 1) / rb);
}

// K3's weight maps: a [rows, cols] bf16 row-major matrix in 64 x 64 boxes
// with the 128-byte swizzle. Encoding one is host work of about a
// microsecond, so the maps are kept per (matrix, shape) in a ring (a
// decoder's 4 matrices a layer; the oldest entry makes room).
constexpr int K3_MAPS = 128;
struct WeightMap {
  const void* base;
  int rows, cols;
  CUtensorMap map;
};
WeightMap k3_maps[K3_MAPS];
int k3_maps_used = 0, k3_maps_next = 0;
std::mutex k3_maps_lock;

int weight_map(CUtensorMap* map, const void* base, int rows, int cols) {
  std::lock_guard<std::mutex> guard(k3_maps_lock);
  for (int i = 0; i < k3_maps_used; ++i)
    if (k3_maps[i].base == base && k3_maps[i].rows == rows &&
        k3_maps[i].cols == cols) {
      *map = k3_maps[i].map;
      return 0;
    }
  const int e = encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows,
                          cols, (long long)cols * 2, 64, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0) {
    k3_maps[k3_maps_next] = {base, rows, cols, *map};
    k3_maps_next = (k3_maps_next + 1) % K3_MAPS;
    if (k3_maps_used < K3_MAPS) ++k3_maps_used;
  }
  return e;
}

// K14's V maps (a rank-4 map over the merged cross V of one call's shape)
MapCache<64> x_maps;

// K3 / K3-q (wcq != NULL) and K3p (xout32 != NULL) at model width D and
// the block's H heads (see mas_decoder_self_block and
// mas_decoder_self_block_partial).
int launch_self(const void* x, const void* g1, const void* b1, const void* wq,
                const void* bq, const void* wk, const void* wv,
                const void* bv, const void* wo, const void* bo, void* kc,
                void* vc, void* x_out, float* xout32, const void* g2,
                const void* b2, const void* wcq, const void* bcq,
                void* q_cross, int B, int D, int H, int L, int pos, int CS,
                int rt, int S, float scale, float eps, void* stream) {
  const int HL = H * HDIM;
  const bool tail = wcq != nullptr, partial = xout32 != nullptr;
  if (B < 1 || H < 1 || D < 64 || D % 64 || D > 32 * K3_LN_CH * 8 ||
      CS < 1 || CS > H || CS > D / 64 || CS > K3_MAX_CS || rt < 1 ||
      rt > K3_RT || S < K3_MIN_STAGES || S > K3_MAX_STAGES || pos < 0 ||
      pos >= L || k3_smem(D, L, S, rt) > K3_SMEM_MAX ||
      (B + rt - 1) / rt > 65535 || (tail && (partial || D != HL)) ||
      (!partial && D != HL))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo, mcq;
  int e = weight_map(&mq, wq, D, HL);
  if (e == 0) e = weight_map(&mk, wk, D, HL);
  if (e == 0) e = weight_map(&mv, wv, D, HL);
  if (e == 0) e = weight_map(&mo, wo, HL, D);
  if (e == 0) e = weight_map(&mcq, tail ? wcq : wq, D, HL);  // K3: unread
  if (e != 0) return e;
  auto* kernel = tail      ? &self_block_kernel<true>
                 : partial ? &self_block_kernel<false, true>
                           : &self_block_kernel<false>;
  return launch_cluster(
      kernel, dim3(CS, (B + rt - 1) / rt), CS, K3_NT, k3_smem(D, L, S, rt),
      (cudaStream_t)stream, mq, mk, mv, mo, mcq, (const bf16*)x,
      (const float*)g1, (const bf16*)b1, (const bf16*)bq, (const bf16*)bv,
      (const bf16*)bo, (const float*)g2, (const bf16*)b2, (const bf16*)bcq,
      (bf16*)kc, (bf16*)vc, (bf16*)x_out, xout32, (bf16*)q_cross, B, D, H, L,
      pos, rt, S, scale, eps);
}

// K4's six instances: [K4, K4-o, K4p][ONE]
const void* const MLP_FN[3][2] = {
    {(const void*)mlp_kernel<false, false>, (const void*)mlp_kernel<false, true>},
    {(const void*)mlp_kernel<true, false>, (const void*)mlp_kernel<true, true>},
    {(const void*)mlp_kernel<false, false, true>,
     (const void*)mlp_kernel<false, true, true>}};

// K4 / K4-o (wco != NULL) and K4p (out32 != NULL): see
// mas_decoder_mlp_block and mas_decoder_mlp_block_partial.
int launch_mlp(const void* x, const void* g, const void* bln, const void* w1,
               const void* b1, const void* w2, const void* b2,
               const void* attn, const void* wco, const void* bco, void* x32,
               void* h, void* part, void* counter, void* out, float* out32,
               int B, int D, int F, float eps, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || D % PC || D > MLP_MAX_D || F % MLP_FS || sms < 1)
    return (int)cudaErrorInvalidValue;
  const bool head = wco != nullptr, partial = out32 != nullptr;
  if (head && partial) return (int)cudaErrorInvalidValue;
  if (head) {
    const size_t smem2 = (size_t)NT * 8 * RB4 * 4 + (size_t)RB4 * D * 2;
    rowproj_kernel<false, float><<<rows_grid(D / PC, B, RB4), NT, smem2, s>>>(
        (const float*)attn, nullptr, nullptr, (const bf16*)wco,
        (const bf16*)bco, (const bf16*)x, x32, B, D, 0.f);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // blocks a multiprocessor holds, per device, variant and chunk width
  // (read once; the instances differ only in their loops' trip counts)
  static int per_sm[MAX_DEVICES][3][MLP_DC / 64 + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  const int dc = mlp_dc(D);
  const int kind = partial ? 2 : head;
  int& fit = per_sm[dev][kind][dc / 64];
  if (fit == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, MLP_FN[kind][0], MLP_NT, mlp_smem(dc));
    if (e != cudaSuccess) return (int)e;
    if (fit == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int grid = F / MLP_FS < sms * fit ? F / MLP_FS : sms * fit;
  const bool one = D <= MLP_DC && B <= 32 && grid == F / MLP_FS;
  const void* fn = MLP_FN[kind][one];
  void* args[] = {(void*)&x,   (void*)&x32,  (void*)&g,       (void*)&bln,
                  (void*)&w1,  (void*)&b1,   (void*)&w2,      (void*)&b2,
                  (void*)&h,   (void*)&part, (void*)&counter, (void*)&out,
                  (void*)&out32, (void*)&B,  (void*)&D,       (void*)&F,
                  (void*)&eps};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(MLP_NT), args,
                                          mlp_smem(dc), s);
}

}  // namespace

// Raises K3's dynamic shared-memory limit and allows its clusters of up
// to 16 blocks (every instance), and looks up cuTensorMapEncodeTiled.
// Called once, when the library is loaded.
extern "C" int mas_decoder_self_block_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  for (const void* fn : {(const void*)self_block_kernel<false>,
                         (const void*)self_block_kernel<true>,
                         (const void*)self_block_kernel<false, true>}) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K3_SMEM_MAX);
    if (e == cudaSuccess)  // clusters of more than 8 blocks (H = 12, 20)
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The clusters of cs K3 blocks of smem bytes the card holds at once (a
// cluster's blocks share a GPC: an H100 holds 15 clusters of 8 blocks of
// 225 KB, not 132 / 8). Returns a cudaError_t value.
extern "C" int mas_decoder_self_block_fit(int cs, int smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(K3_NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)self_block_kernel<true>, &cfg);
}

// K3 / K3-q. x, x_out, q_cross: [B, D] bf16 (D = H * 64); g1, g2: [D]
// float32 LN scales; b1, b2, bq, bv, bo, bcq: [D] bf16; wq, wk, wv, wo,
// wcq: [D, D] bf16 row-major ([in, out]); kc, vc: [B, L, D] bf16 caches,
// row pos written. wcq == NULL runs K3 (g2, b2, bcq, q_cross unused). One
// launch either way. The plan (ops/decoder_block.py::
// self_block_plan): CS <= min(H, 16) blocks a cluster, rt <= 16 rows a
// tile, S ring stages. Every pointer 16-byte aligned. Returns a
// cudaError_t value: a weight map the driver refuses, or a launch the
// card refuses.
extern "C" int mas_decoder_self_block(
    const void* x, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv,
    const void* wo, const void* bo, void* kc, void* vc, void* x_out,
    const void* g2, const void* b2, const void* wcq, const void* bcq,
    void* q_cross, int B, int H, int L, int pos, int CS, int rt, int S,
    float scale, float eps, void* stream) {
  return launch_self(x, g1, b1, wq, bq, wk, wv, bv, wo, bo, kc, vc, x_out,
                     nullptr, g2, b2, wcq, bcq, q_cross, B, H * HDIM, H, L,
                     pos, CS, rt, S, scale, eps, stream);
}

// K3p, K3's partial form on one rank of the mesh's model axis: out =
// (K3's attention over the rank's H heads, merged) @ wo in float32,
// without x and bo. x: [B, D] bf16 (the whole row, read by the layer
// norm); g1: [D] float32; b1: [D] bf16; wq, wk, wv: [D, H * 64] and wo:
// [H * 64, D] bf16 row-major (the rank's column and row shards); bq, bv:
// [H * 64] bf16; kc, vc: [B, L, H * 64] bf16 caches of the rank's heads,
// row pos written; out: [B, D] float32. D % 64 == 0, D <= 2048; CS <=
// min(H, D / 64, 16). Returns a cudaError_t value, as
// mas_decoder_self_block.
extern "C" int mas_decoder_self_block_partial(
    const void* x, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv,
    const void* wo, void* kc, void* vc, void* out, int B, int D, int H, int L,
    int pos, int CS, int rt, int S, float scale, float eps, void* stream) {
  return launch_self(x, g1, b1, wq, bq, wk, wv, bv, wo, bv, kc, vc, nullptr,
                     (float*)out, nullptr, nullptr, nullptr, nullptr, nullptr,
                     B, D, H, L, pos, CS, rt, S, scale, eps, stream);
}

// Raises K4's dynamic shared-memory limit (every instance). Called once,
// when the library is loaded.
extern "C" int mas_decoder_mlp_block_init(void) {
  for (const auto& row : MLP_FN)
    for (const void* fn : row) {
      cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)mlp_smem(MLP_DC));
      if (e != cudaSuccess) return (int)e;
    }
  return 0;
}

// K4 / K4-o. x, out: [B, D] bf16 (D % 64 == 0, D <= 2048); g: [D]
// float32; bln, b2, bco: [D] bf16; w1: [D, F], w2: [F, D], wco: [D, D]
// bf16 row-major (F % 32 == 0); b1: [F] bf16; attn: [B, D] float32; x32:
// [B, D] float32 scratch; h: [B, D] bf16 scratch; part: [F / 32, B, D]
// float32 scratch; counter: >= 3 zeroed ints, left zero. wco == NULL runs
// K4 (attn, bco, x32 unused). sms: the card's multiprocessors; the grid
// is min(F / 32, sms x the blocks a multiprocessor holds). Returns the
// first CUDA error of the launches (0 = none).
extern "C" int mas_decoder_mlp_block(const void* x, const void* g,
                                     const void* bln, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* attn,
                                     const void* wco, const void* bco,
                                     void* x32, void* h, void* part,
                                     void* counter, void* out, int B, int D,
                                     int F, float eps, int sms,
                                     void* stream) {
  return launch_mlp(x, g, bln, w1, b1, w2, b2, attn, wco, bco, x32, h, part,
                    counter, out, nullptr, B, D, F, eps, sms, stream);
}

// K4p, K4's partial form on one rank of the mesh's model axis: out =
// gelu(LN(x) @ w1 + b1) @ w2 in float32, without x and b2. x: [B, D]
// bf16 (the whole row, read by the layer norm); g: [D] float32; bln: [D]
// bf16; w1: [D, F] and w2: [F, D] bf16 row-major (the rank's column and
// row shards of fc1 and fc2, F % 32 == 0); b1: [F] bf16; h, part,
// counter: K4's scratch; out: [B, D] float32. Returns a cudaError_t
// value, as mas_decoder_mlp_block.
extern "C" int mas_decoder_mlp_block_partial(
    const void* x, const void* g, const void* bln, const void* w1,
    const void* b1, const void* w2, void* h, void* part, void* counter,
    void* out, int B, int D, int F, float eps, int sms, void* stream) {
  return launch_mlp(x, g, bln, w1, b1, w2, nullptr, nullptr, nullptr, nullptr,
                    nullptr, h, part, counter, nullptr, (float*)out, B, D, F,
                    eps, sms, stream);
}

// Raises K14's attention's dynamic shared-memory limit and allows its
// clusters of up to 16 blocks; asks the whole shared-memory carveout for
// it and for its q-projection, so an SM that runs a q-projection block
// also takes attention blocks (launched early, they start beside it:
// otherwise most wait for the q-projection to end, phase stamps in
// PERF.md); and looks the tensor-map encoder up. Called once, when the
// library is loaded.
extern "C" int mas_cross_mlp_block_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaError_t e = cudaFuncSetAttribute(
      cross_attention_split_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, X_SMEM_LIMIT);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cross_attention_split_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  for (const void* fn : {(const void*)cross_attention_split_kernel,
                         (const void*)rowproj_kernel<true, bf16>})
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// The clusters of cs K14 attention blocks of chunk keys the card holds at
// once (0 where a block would ask more shared memory than it may).
// Returns a cudaError_t value.
extern "C" int mas_cross_mlp_attention_fit(int cs, int chunk, int* out) {
  *out = 0;
  if (cs < 1 || cs > X_MAX_CS || chunk < 1 ||
      x_smem_bytes(chunk) > X_SMEM_LIMIT)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(X_NT);
  cfg.dynamicSmemBytes = x_smem_bytes(chunk);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)cross_attention_split_kernel, &cfg);
}

// K14. x, out: [B, D] bf16 (D = H * 64); g2, g3: [D] float32 LN scales;
// b2, bcq, bco, b3, b2m: [D] bf16; wcq, wco: [D, D], w1: [D, F], w2:
// [F, D] bf16 row-major (F % 32 == 0); b1: [F] bf16; k, v: [B, T, D]
// bf16 merged-head cross K/V; q1 and h: [B, D] bf16, attn and x32: [B, D]
// float32, part: [F / 32, B, D] float32 scratch; counter: >= 3 zeroed
// ints; sms as K4's. The attention's plan (ops/decoder_block.py::
// cross_plan): cs blocks a cluster (1..16), chunk keys a block (cs chunk
// >= T). Every pointer 16-byte aligned. Returns the first CUDA error of
// the launches (0 = none): a shape outside these limits, a tensor map
// the driver refuses, or a launch the card refuses.
extern "C" int mas_cross_mlp_block(
    const void* x, const void* g2, const void* b2, const void* wcq,
    const void* bcq, const void* wco, const void* bco, const void* g3,
    const void* b3, const void* w1, const void* b1, const void* w2,
    const void* b2m, const void* k, const void* v, void* q1, void* attn,
    void* x32, void* h, void* part, void* counter, void* out, int B, int H,
    int T, int F, int cs, int chunk, float scale, float eps, int sms,
    void* stream) {
  const int D = H * HDIM;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem_q = (size_t)NT * 8 * RB4 * 4 + (size_t)RB4 * D * 2;
  if (T < 1 || smem_q > SMEM_MAX || cs < 1 || cs > X_MAX_CS || chunk < 1 ||
      (long long)cs * chunk < T || x_smem_bytes(chunk) > X_SMEM_LIMIT ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tv;
  int e = x_maps.get(
      &tv, map_spec(v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    {(cuuint64_t)HDIM, (cuuint64_t)H, (cuuint64_t)T,
                     (cuuint64_t)B},
                    {(cuuint64_t)HDIM * 2, (cuuint64_t)D * 2,
                     (cuuint64_t)T * D * 2},
                    {(cuuint32_t)HDIM, 1u, (cuuint32_t)x_box_rows(chunk), 1u},
                    CU_TENSOR_MAP_SWIZZLE_NONE));
  if (e != 0) return e;
  rowproj_kernel<true, bf16><<<rows_grid(D / PC, B, RB4), NT, smem_q, s>>>(
      (const bf16*)x, (const float*)g2, (const bf16*)b2, (const bf16*)wcq,
      (const bf16*)bcq, nullptr, q1, B, D, eps);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  e = launch_cluster_ex(true, cross_attention_split_kernel, dim3(cs, B * H),
                        cs, X_NT, x_smem_bytes(chunk), s, tv,
                        (const bf16*)q1, (const bf16*)k, (const bf16*)v,
                        (float*)attn, T, H, chunk, scale);
  if (e != 0) return e;
  return mas_decoder_mlp_block(x, g3, b3, w1, b1, w2, b2m, attn, wco, bco,
                               x32, h, part, counter, out, B, D, F, eps,
                               sms, stream);
}
