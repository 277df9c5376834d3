// K8: encoder self-attention per (batch, head), on Hopper's warpgroup
// matrix products (wgmma) fed by TMA tensor copies.
//
// Function: softmax(Q K^T / sqrt(64)) V per (batch, head), non-causal, on
// [B, H, T, 64] bf16 views with a unit last stride (the encoder passes the
// head-split views of its q/k/v dense outputs); the bf16 output goes into
// a merged [B, T, H, 64] buffer, the layout the o-projection reads.
//
// Replaces multimodal_audio_search_tpu/ops/attention.py::
// fused_encoder_attention (body _attn_kernel, pallas_call :83), the
// fused_encoder=False path at T >= 512. Its roundings are kept: scores in
// float32, p = exp(s - m) rounded to bf16 before the PV product, the row
// sums l taken over the unrounded p, and a true division of the [rows, 64]
// output by l before the bf16 store.
//
// What bounds it on an H100: tensor-core operations. At B=32, T=1500, H=8
// the two products are 147 GFLOP against 98 MB of q/k/v/out, about 1500
// FLOP a byte, five times the card's balance point. With a head dim of 64
// the softmax weighs as much: one exp2 (the SM's 16-a-clock MUFU unit) per
// score against 256 FLOP of tensor-core work per score, about equal times.
//
// Design.
//   * A block is 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows and one producer warp, 288 threads. Blocks of
//     one head are adjacent in the grid, so its K/V stay in L2.
//   * The producer's one thread issues TMA copies (cp.async.bulk.tensor
//     over a rank-4 tensor map of each view, box {64, 128} rows, 128-byte
//     swizzle: a 64-wide bf16 row is exactly one swizzle atom): the Q tile
//     once, then K/V tiles of 128 keys into a STAGES-deep ring with full
//     and empty mbarriers, so the next tiles are in flight while the
//     consumers compute. The maps' T extent is T: TMA writes zeros for
//     rows past T, and the consumers still set those keys to -inf (a zero
//     key scores 0, not -inf).
//   * Each consumer warpgroup: S = Q K^T as four wgmma m64n128k16 with Q
//     and K in shared memory (K's rows are the K-major B operand); the
//     online softmax in registers (f32 row max and sum, exp2 with log2(e)
//     folded into the scale); P re-packed from the S accumulators to bf16
//     A fragments in registers (the accumulator and A layouts agree per
//     16-key step), and O += P V as eight wgmma m64n64k16 with V as the
//     MN-major B operand (the transpose bit).
//   * Overlap: tile j's scores are issued together with tile j-1's PV
//     product, so the softmax of tile j (the exp2 work) runs while the
//     tensor cores finish that product; the first tile is peeled off the
//     loop, which keeps the wgmma pipeline free of branches (ptxas
//     serialises the products otherwise). Two named barriers make the
//     warpgroups take turns issuing their products (ping-pong), so one's
//     softmax meets the other's products. After its PV product a warp
//     releases the stage to the producer.
//   * Host: the three tensor maps are encoded once per view and kept in
//     a small cache (sm90::MapCache), so a call with views seen before
//     only launches.
//   * Registers: S (64) + O (32) + P (32) a thread, ~160 in all, so one
//     block fills an SM; shared memory holds Q (16 KB) and STAGES x 32 KB
//     of K/V, above the 48 KB default, so mas_encoder_attention_init
//     raises the limit once at library load.
// Tried on an H100 and not kept (PERF.md): 192-key tiles (S of 96
// registers spills), two stages, no ping-pong, and no overlap, each
// slower. Later work: a TMA store of the output.
//
// The float32 form (mas_encoder_attention_f32), for a float32 encode on
// the card, as the TPU kernel takes either dtype: the same function on
// float32 views into a float32 [B, T, H, 64] output, with the plain
// version's float32 roundings. It runs on the tensor cores in three TF32
// products an operand pair (3xTF32, tf32x3.cuh): a block is 64 query rows
// of one (batch, head), four warps of mma.sync m16n8k8 over 64-key K/V
// tiles double-buffered by cp.async, P fed from the score accumulators
// into the PV product's A fragments, each tile's P V summed apart and
// added rounded to nearest. What bounds it: TF32 operations, three a
// float32 product (at B=8, T=1500, H=6, 83 GFLOP of TF32 for 28 GFLOP of
// float32 work: 0.17 ms at the H100's 495 TFLOP/s, against 0.41 ms of
// float32 on the CUDA cores). Kept over wgmma in TF32, which would need a
// transposed copy of V and the splits in shared memory; the first design
// of this form, one query row a thread on the CUDA cores, ran 2.5x slower
// (PERF.md).
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace sm90;
using namespace sm90::fa;  // D, BM, BN, NS and the loop's pieces

constexpr int STAGES = 3;
constexpr int NT = 288;  // two consumer warpgroups + one producer warp
constexpr int TILE = BN * D;                        // elements of one tile
constexpr int TILE_BYTES = TILE * (int)sizeof(bf16);  // 16 KB
constexpr int SMEM_BYTES =
    1024 + (BM * D + 2 * STAGES * TILE) * (int)sizeof(bf16) + 128;

__global__ void __launch_bounds__(NT, 1) encoder_attention_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int T,
    int H, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  bf16* sQ = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* sK = sQ + BM * D;         // [STAGES][BN][64]
  bf16* sV = sK + STAGES * TILE;  // [STAGES][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (T + BN - 1) / BN;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp; one thread issues every copy
    if (threadIdx.x == 256) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(q_full, BM * D * (int)sizeof(bf16));
      tma_load_4d(sQ, &tq, q_full, 0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&kv_empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * TILE_BYTES);
        tma_load_4d(sK + s * TILE, &tk, &kv_full[s], 0, j * BN, h, b);
        tma_load_4d(sV + s * TILE, &tv, &kv_full[s], 0, j * BN, h, b);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: query rows q0 + 64 wg .. + 63. Tile j's
  // scores are issued together with tile j-1's PV product, so the softmax
  // of tile j runs while the tensor cores finish that PV product.
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint64_t dq = desc_sw128(sQ + wg * 64 * D, 16, 1024);
  float o[32], s[NS];
  uint32_t pa[NS / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  if (wg == 1) named_arrive(1);  // warpgroup 0 issues first

  mbar_wait(q_full, 0);
  // tile 0: its scores alone
  mbar_wait(&kv_full[0], 0);
  named_sync(1 + wg);
  wg_fence();
  issue_scores(s, dq, desc_sw128(sK, 16, 1024));
  wg_commit();
  if (wg == 0 || n_tiles > 1) named_arrive(2 - wg);
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NS; ++i) reg_fence(s[i]);
  {
    float c0, c1;
    softmax_step(s, 0, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
  }
  pack_p(pa, s);
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(&kv_full[st], (j / STAGES) & 1);
    named_sync(1 + wg);
    wg_fence();
    issue_scores(s, dq, desc_sw128(sK + st * TILE, 16, 1024));
    wg_commit();
    // tile j-1's PV product, P from the last softmax
    issue_pv(o, pa, desc_sw128(sV + ((j - 1) % STAGES) * TILE, 16, 1024));
    wg_commit();
    if (wg == 0 || j + 1 < n_tiles) named_arrive(2 - wg);
    wg_wait<1>();
#pragma unroll
    for (int i = 0; i < NS; ++i) reg_fence(s[i]);
    float c0, c1;
    softmax_step(s, j * BN, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(o[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[(j - 1) % STAGES]);
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      o[4 * jd] *= c0;
      o[4 * jd + 1] *= c0;
      o[4 * jd + 2] *= c1;
      o[4 * jd + 3] *= c1;
    }
    pack_p(pa, s);
  }
  // the last tile's PV product
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(o[i]);
  wg_fence();
  issue_pv(o, pa, desc_sw128(sV + ((n_tiles - 1) % STAGES) * TILE, 16, 1024));
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(o[i]);

  // o / l, rounded to bf16, into the merged [B, T, H, 64] buffer
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int ra = q0 + wg * 64 + warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const int col = h * D + jd * 8 + 2 * t4;
    if (ra < T)
      *reinterpret_cast<uint32_t*>(out + ((long long)b * T + ra) * H * D +
                                   col) = pack_bf16(o[4 * jd] / l0,
                                                    o[4 * jd + 1] / l0);
    if (rb < T)
      *reinterpret_cast<uint32_t*>(out + ((long long)b * T + rb) * H * D +
                                   col) = pack_bf16(o[4 * jd + 2] / l1,
                                                    o[4 * jd + 3] / l1);
  }
}

// The maps of recent views (the encoder's q/k/v buffers recur from batch
// to batch): a rank-4 map over a bf16 [B, H, T, 64] view with element
// strides (sb, sh, st, 1), box {64, rows}, 128-byte swizzle.
MapCache<64> maps;

int bhtd_map(CUtensorMap* map, const void* base, int B, int H, int T,
             int rows, long long sb, long long sh, long long st) {
  return maps.get(map, map_spec(base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                {64u, (cuuint64_t)T, (cuuint64_t)H,
                                 (cuuint64_t)B},
                                {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2},
                                {64u, (cuuint32_t)rows, 1u, 1u},
                                CU_TENSOR_MAP_SWIZZLE_128B));
}

// bounds for two blocks an SM, which lets ptxas pass 168 registers a
// thread: 3-4 % faster than three blocks an SM on an H100 (PERF.md); K1's
// float32 form, mixed there, keeps three
__global__ void __launch_bounds__(tf32x3::NT, 2)
    encoder_attention_f32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v, long long sb,
                                 long long sh, long long st,
                                 float* __restrict__ out, int T, int H,
                                 float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long base = b * sb + h * sh;
  tf32x3::attend(q + base, k + base, v + base, st, T,
                 blockIdx.x * tf32x3::ROWS, scale, smem_f32,
                 out + ((long long)b * T * H + h) * D, (long long)H * D);
}

}  // namespace

// Raises the dynamic shared-memory limits of K8's two forms and looks the
// driver's tensor-map encoder up. Called once, when the library is loaded.
extern "C" int mas_encoder_attention_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const cudaError_t e = cudaFuncSetAttribute(
      encoder_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(encoder_attention_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   tf32x3::SMEM_BYTES);
}

// K8. q/k/v: [B, H, T, 64] bf16 views sharing element strides (sb, sh, st)
// with unit stride on the last dim, each stride a multiple of 8 and each
// base 16-byte aligned (TMA's rules); out: [B, T, H, 64] contiguous bf16.
// Returns a cudaError_t value: a tensor map the driver refuses, or
// cudaGetLastError() after the launch. Safe to call from several threads.
extern "C" int mas_encoder_attention(const void* q, const void* k,
                                     const void* v, long long sb,
                                     long long sh, long long st, void* out,
                                     int B, int H, int T, float scale_log2,
                                     void* stream) {
  CUtensorMap tq, tk, tv;
  int e = bhtd_map(&tq, q, B, H, T, BM, sb, sh, st);
  if (e == 0) e = bhtd_map(&tk, k, B, H, T, BN, sb, sh, st);
  if (e == 0) e = bhtd_map(&tv, v, B, H, T, BN, sb, sh, st);
  if (e != 0) return e;
  dim3 grid((T + BM - 1) / BM, B * H);
  encoder_attention_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tk, tv, (bf16*)out, T, H, scale_log2);
  return (int)cudaGetLastError();
}

// K8's float32 form. q/k/v: [B, H, T, 64] float32 views sharing element
// strides (sb, sh, st) with unit stride on the last dim, each stride a
// multiple of 4 and each base 16-byte aligned; out: [B, T, H, 64]
// contiguous float32; scale = 1/sqrt(64). Returns cudaGetLastError()
// after the launch.
extern "C" int mas_encoder_attention_f32(const void* q, const void* k,
                                         const void* v, long long sb,
                                         long long sh, long long st,
                                         void* out, int B, int H, int T,
                                         float scale, void* stream) {
  dim3 grid((T + tf32x3::ROWS - 1) / tf32x3::ROWS, B * H);
  encoder_attention_f32_kernel<<<grid, tf32x3::NT, tf32x3::SMEM_BYTES,
                                 (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, sb, sh, st,
      (float*)out, T, H, scale);
  return (int)cudaGetLastError();
}
