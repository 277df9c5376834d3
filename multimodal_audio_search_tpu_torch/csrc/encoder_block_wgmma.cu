// K1, K10 and K11: the encoder block's attention over every head, its
// o-projection and the residual, in one launch, on Hopper's warpgroup
// products (wgmma) fed by TMA tensor copies.
//
// K1  out = x + (softmax(Q K^T / sqrt(64)) V, heads merged) @ Wo + bo.
//     Replaces multimodal_audio_search_tpu/ops/encoder_block.py::
//     fused_attention_o_residual (body _attn_o_kernel, pallas_call :425).
// K10 the same function with the heads taken two at a time. Replaces the
//     same wrapper's pair_heads=True form (body _attn_o_kernel_paired,
//     pallas_call :375).
// K1p K1's partial form, one rank of the mesh's model axis (tensor
//     parallelism): out = (softmax(Q K^T / sqrt(64)) V over the rank's
//     H heads, merged) @ Wo_rows in float32, with Wo_rows the [H*64,
//     HD_out] row shard of the layer's o-projection; no x, no bo (the
//     ranks' partials are summed, bias and residual added once, by
//     parallel/mesh.py::model_sum). The head shard of the JAX kernel's
//     non-square Wo (tests/test_production_geometry_mesh.py runs it under
//     shard_map with a psum over "model").
// K10p K10's partial form, the same on pairs of the rank's heads: a rank
//     of the model axis with an even head count takes its heads two at a
//     time as K10 does (pairs (0, 1), (2, 3), ... of the rank's contiguous
//     block, which are the pairs of the whole layer's K10), and writes the
//     float32 partial as K1p does. Replaces the head shard of the same
//     wrapper's pair_heads=True form (pallas_call :375) with a non-square
//     Wo. A rank with an odd head count takes K1p (ops/encoder_block.py).
// K11 K1's function with the softmax division placed three ways (the
//     template's Form), the A/B of the TPU tool: replaces tools/
//     profile_encoder_kernel_ab.py::fused_v2 (body _kernel_v2 :48,
//     pallas_call :118). POST ("post") is K1 itself; DIV (True) divides
//     each head's output by l in place of x 1/l; NORM (False) divides p
//     by l before the PV product, so it needs l first: per head the
//     producer streams the head's K tiles alone into the ring, the
//     consumers take each row's max and sum over them (tile j + 1's
//     scores issued while tile j's max and sum are taken, no PV), then
//     K and V stream as in K1 and the consumers recompute S, form p =
//     exp2(s c - m) / l, round it to bf16 and run PV with no rescale; Q
//     stays resident across both passes. Every division is a row
//     reciprocal with one correction step (sm90.cuh div_row), which gives
//     the true quotient with no division call a score.
//
// Roundings: scores and the softmax in float32; p = exp(s - m) rounded to
// bf16 before the PV product (the TPU kernel casts p to V's dtype; K11's
// NORM rounds p / l), the row sums l taken over the unrounded p; each
// head's [rows, 64] output multiplied by 1/l after the PV product (K11:
// as its form says) and rounded to bf16 before the o-projection
// (attn.astype(wo.dtype)); the o-projection summed in float32, then + bo,
// + x, and the sum rounded to bf16.
//
// What bounds it on an H100: tensor-core operations. At B=32, T=1500,
// H=8 the attention is 147 GFLOP and the o-projection 25 GFLOP against
// ~0.2 GB of q/k/v/x/out/Wo, ~900 FLOP a byte, three times the card's
// balance point: 0.17 ms at 989 TFLOP/s.
//
// Design. The merged bf16 attention tile of 128 query rows is 128 x H*64
// x 2 bytes: 96 KB at whisper-tiny, 320 KB at whisper-large. Beside K8's
// Q tile and ring it fits a block at no width past tiny, so the heads of
// one (batch, 128-row) tile are spread over a thread-block cluster:
//   * A cluster of CS blocks spans x; rank r takes the units [rU/CS,
//     (r+1)U/CS) (U = H heads for K1, H/2 pairs for K10), one to four
//     heads, and the output columns of those heads. The wrapper's plan
//     (ops/encoder_block.py::cluster_plan) costs each size from the
//     clusters the card holds (cudaOccupancyMaxActiveClusters): on an
//     H100 clusters of 2 fill all 132 multiprocessors and larger ones
//     102-120, so B=32 takes 2 blocks of 3-4 heads at tiny and base width.
//   * Attention: K8's loop (sm90::fa). The producer warp's one thread
//     keeps Q and a ring of 128-key K/V tiles in flight by TMA (rank-4
//     maps over the [B, H, T, 64] views, 128-byte swizzle, full/empty
//     mbarriers); two consumer warpgroups of 64 rows take turns issuing
//     their products (ping-pong on named barriers 1 and 2); S = Q K^T is
//     wgmma m64n128k16, P goes back as register A fragments, O += P V is
//     wgmma m64n64k16 with V MN-major; tile j's scores are issued with
//     tile j-1's PV product and each head's first tile is peeled off.
//   * K10 fetches a pair's K (and V) tile as one TMA box {64, 128, 2}:
//     both heads' 128 columns of the merged dense output, two swizzle
//     atoms, the one fetch a pair that the TPU kernel pairs heads for.
//     Its warpgroups alternate the two heads tile by tile, each head with
//     its own online softmax: head 1's scores are issued with head 0's PV
//     product and head 0's of the next tile with head 1's. Holding both
//     heads' outputs beside the scores takes 232 registers a consumer
//     thread, given by a producer warpgroup cut to 40 (setmaxnreg).
//   * Each head's output, x 1/l and rounded to bf16, is stored to `out`
//     at its columns: `out` doubles as the merged [B, T, H*64] tile, so
//     the call allocates no scratch; the tile is read back while it sits
//     in L2. x's tile of the block's columns arrives by TMA meanwhile.
//   * Cluster barrier 1, after a proxy fence (TMA reads what ordinary
//     stores wrote): every head of the tile is in place. The producer has
//     already put the first Wo tiles into the stages the attention freed.
//   * O-projection, in groups of two output chunks: A = the merged tile's
//     64-column chunks by TMA (a rank-3 map over out), B = Wo's [64 in,
//     64 out] tiles by TMA (MN-major, as V), through the same ring; wgmma
//     m64n64k16 from shared memory, float32 accumulators; then x + (y +
//     bo) in float32 into x's tile in shared memory, in place.
//   * Cluster barrier 2 (arrived at once the last products have read
//     out, waited on after the epilogue): no rank overwrites `out` while
//     a peer may read it; then one thread stores the block's columns by
//     TMA (rows past T are not written).
// K1p's (and K10p's) cluster decouples the two splits: rank r attends the heads [rH/CS,
// (r+1)H/CS) as K1's ranks do (K10p: the units of pairs, as K10's), but
// projects the output chunks [rN/CS,
// (r+1)N/CS) of N = HD_out/64 chunks (K1: N = H, the same split), each
// over all H 64-row chunks of the merged tile, which lies in a scratch
// [B, T, H*64] bf16 buffer of the wrapper's; the float32 sums go from
// the accumulators straight to `out` (rows past T are not written), so
// x's tile, bo and the TMA store are left out.
// Why the merged tile goes through L2 and not through the peers' shared
// memory: every rank reads the whole tile, half of it from its peer at
// base width, over the SM-to-SM network as element loads that no ring
// hides; from L2 the same bytes come as TMA boxes that the producer
// keeps in flight ahead of the products, and the tile costs no memory
// beyond `out` itself (PERF.md gives the reckoning).
// Shared memory: Q (K1 two 16 KB slots, K10 one 32 KB slot), the ring
// (K1 4 x 32 KB, K10 2 x 64 KB) and x's tile (4 x 16 KB): 225 KB, above
// the 48 KB default, so mas_encoder_block_init raises the limit once, at
// library load, and allows clusters of up to 16 blocks. A launch the card
// refuses (a cluster it cannot place) returns its error; nothing falls
// back.
#include "sm90.cuh"

namespace {

using namespace sm90;
using namespace sm90::fa;  // D, BM, BN, NS and the loop's pieces

constexpr int TILE_BYTES = BN * D * 2;  // 16 KB: 128 rows of one head
constexpr int W_BYTES = 64 * D * 2;     // 8 KB: one [64 in, 64 out] Wo tile
constexpr int MAX_COLS = 4;  // heads (64-column output chunks) a block

// where the softmax division sits (K11's forms, by the code the wrapper
// passes: ops/encoder_block.py::AB_FORMS): x 1/l after PV (K1, "post"),
// / l after PV (True), p / l before PV (False)
enum Form { POST = 0, DIV = 1, NORM = 2 };

// K1 (PAIR false) and K10 (true): heads a unit, ring stages, Q slots and
// bytes, bytes a stage (K tiles, then V tiles), shared memory.
// K10 holds two heads' outputs beside the scores: its consumers take 232
// registers from a producer warpgroup cut to 40 (384 x 168 at launch)
constexpr int K10_CONSUMER_REGS = 232, K10_PRODUCER_REGS = 40;

template <bool PAIR>
struct Cfg {
  static constexpr int NT = PAIR ? 384 : 288;
  static constexpr int HEADS = PAIR ? 2 : 1;
  static constexpr int STAGES = PAIR ? 2 : 4;
  static constexpr int Q_SLOTS = PAIR ? 1 : 2;
  static constexpr int Q_BYTES = HEADS * TILE_BYTES;
  static constexpr int SLOT = 2 * HEADS * TILE_BYTES;
  // x's tile of the block's output columns, then the output itself: up to
  // MAX_COLS 64-column chunks (a block's heads)
  static constexpr int X_BYTES = MAX_COLS * TILE_BYTES;
  static constexpr int SMEM =
      1024 + Q_SLOTS * Q_BYTES + STAGES * SLOT + X_BYTES + 128;
};

// The descriptor of a 128-row (or 64-row) swizzled tile at `p`.
__device__ __forceinline__ uint64_t desc(const uint8_t* p) {
  return desc_sw128(p, 16, 1024);
}

// Tile i of the ring: its stage's bytes, and the wait for its arrival.
template <int STAGES, int SLOT>
__device__ __forceinline__ const uint8_t* stage(const uint8_t* ring, int i) {
  return ring + (i % STAGES) * SLOT;
}
template <int STAGES>
__device__ __forceinline__ void wait_full(uint64_t* full, int i) {
  mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
}

// A warp's arrival on an mbarrier counting the 8 consumer warps.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void zero32(float o[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
}

__device__ __forceinline__ void fence32(float o[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(o[i]);
}

__device__ __forceinline__ void rescale(float o[32], float c0, float c1) {
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    o[4 * jd] *= c0;
    o[4 * jd + 1] *= c0;
    o[4 * jd + 2] *= c1;
    o[4 * jd + 3] *= c1;
  }
}

// Tile i's scores S = Q K^T into s, issued in this warpgroup's turn (K
// at the stage's start).
template <int STAGES, int SLOT>
__device__ __forceinline__ void issue_tile(float s[NS], uint64_t dq,
                                           const uint8_t* ring,
                                           uint64_t* full, int i, int wg) {
  wait_full<STAGES>(full, i);
  named_sync(1 + wg);
  wg_fence();
  issue_scores(s, dq, desc(stage<STAGES, SLOT>(ring, i)));
  wg_commit();
  named_arrive(2 - wg);
}

// NORM's first pass, a tile whose scores have landed: its stage is
// released and its keys join the row max m and sum l (softmax_step's
// online form; the p it forms are not used).
template <int STAGES>
__device__ __forceinline__ void stats_tile(float s[NS], uint64_t* empty,
                                           int i, int kv0, int T,
                                           float scale_log2, int lane,
                                           int t4, float& m0, float& m1,
                                           float& l0, float& l1) {
#pragma unroll
  for (int k = 0; k < NS; ++k) reg_fence(s[k]);
  warp_arrive(&empty[i % STAGES], lane);
  float c0, c1;
  softmax_step(s, kv0, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
}

// NORM's first pass over the head's K tiles it .. it + n_tiles - 1 (K
// alone in each stage): each row's max m (log2 domain) and sum l, summed
// over its quad. Two score buffers: tile j + 1's scores are issued before
// tile j's max and sum are taken. The loop takes two tiles a round with
// no branch around its products; the last one or two tiles follow it.
template <int STAGES, int SLOT>
__device__ __forceinline__ void row_stats(uint64_t dq, const uint8_t* ring,
                                          uint64_t* full, uint64_t* empty,
                                          int it, int n_tiles, int T,
                                          float scale_log2, int wg, int lane,
                                          int t4, float& m0, float& m1,
                                          float& l0, float& l1) {
  float sa[NS], sb[NS];
  m0 = m1 = -INFINITY;
  l0 = l1 = 0.f;
  issue_tile<STAGES, SLOT>(sa, dq, ring, full, it, wg);
  int j = 0;
  for (; j + 2 < n_tiles; j += 2) {
    issue_tile<STAGES, SLOT>(sb, dq, ring, full, it + j + 1, wg);
    wg_wait<1>();
    stats_tile<STAGES>(sa, empty, it + j, j * BN, T, scale_log2, lane, t4,
                       m0, m1, l0, l1);
    issue_tile<STAGES, SLOT>(sa, dq, ring, full, it + j + 2, wg);
    wg_wait<1>();
    stats_tile<STAGES>(sb, empty, it + j + 1, (j + 1) * BN, T, scale_log2,
                       lane, t4, m0, m1, l0, l1);
  }
  if (j + 1 < n_tiles) {
    issue_tile<STAGES, SLOT>(sb, dq, ring, full, it + j + 1, wg);
    wg_wait<1>();
    stats_tile<STAGES>(sa, empty, it + j, j * BN, T, scale_log2, lane, t4,
                       m0, m1, l0, l1);
    wg_wait<0>();
    stats_tile<STAGES>(sb, empty, it + j + 1, (j + 1) * BN, T, scale_log2,
                       lane, t4, m0, m1, l0, l1);
  } else {
    wg_wait<0>();
    stats_tile<STAGES>(sa, empty, it + j, j * BN, T, scale_log2, lane, t4,
                       m0, m1, l0, l1);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
}

// NORM's second pass on a tile's scores: p = exp2(s c - m) / l with the
// row's final m and l (r = 1 / l), keys >= T at 0.
__device__ __forceinline__ void norm_step(float s[NS], int kv0, int T, int t4,
                                          float scale_log2, float m0,
                                          float m1, float l0, float l1,
                                          float r0, float r1) {
  mask_tail(s, kv0, T, t4);
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    s[4 * jn] = div_row(ex2(fmaf(s[4 * jn], scale_log2, -m0)), l0, r0);
    s[4 * jn + 1] = div_row(ex2(fmaf(s[4 * jn + 1], scale_log2, -m0)), l0, r0);
    s[4 * jn + 2] = div_row(ex2(fmaf(s[4 * jn + 2], scale_log2, -m1)), l1, r1);
    s[4 * jn + 3] = div_row(ex2(fmaf(s[4 * jn + 3], scale_log2, -m1)), l1, r1);
  }
}

// One head's attention for a consumer warpgroup's 64 rows (K8's loop):
// Q at dq, the head's K/V tiles it .. it + n_tiles - 1 of the ring (K at
// the stage's start, V at its half; NORM: its K tiles alone first, then
// the K/V tiles from it + n_tiles). Returns o and the thread's partial
// row sums l0, l1 (NORM: o already divided, l0 and l1 the rows' sums);
// arrives on q_free once no product reads Q any more and on each stage's
// empty barrier once its tile is consumed.
template <int FORM, int STAGES, int SLOT>
__device__ __forceinline__ void attend_head(
    uint64_t dq, const uint8_t* ring, uint64_t* full, uint64_t* empty,
    uint64_t* q_free, int it, int n_tiles, int T, float scale_log2, int wg,
    int lane, int t4, float o[32], float& l0, float& l1) {
  float s[NS];
  uint32_t pa[NS / 2];
  float m0 = -INFINITY, m1 = -INFINITY, r0 = 0.f, r1 = 0.f;
  l0 = l1 = 0.f;
  if constexpr (FORM == NORM) {
    row_stats<STAGES, SLOT>(dq, ring, full, empty, it, n_tiles, T,
                            scale_log2, wg, lane, t4, m0, m1, l0, l1);
    r0 = 1.f / l0;
    r1 = 1.f / l1;
    it += n_tiles;
  }
  zero32(o);
  float c0, c1;
  // tile 0: its scores alone
  issue_tile<STAGES, SLOT>(s, dq, ring, full, it, wg);
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NS; ++i) reg_fence(s[i]);
  if constexpr (FORM == NORM)
    norm_step(s, 0, T, t4, scale_log2, m0, m1, l0, l1, r0, r1);
  else
    softmax_step(s, 0, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
  pack_p(pa, s);
  for (int j = 1; j < n_tiles; ++j) {
    const int i = it + j;
    wait_full<STAGES>(full, i);
    named_sync(1 + wg);
    wg_fence();
    issue_scores(s, dq, desc(stage<STAGES, SLOT>(ring, i)));
    wg_commit();
    // tile j-1's PV product, P from the last softmax
    issue_pv(o, pa, desc(stage<STAGES, SLOT>(ring, i - 1) + SLOT / 2));
    wg_commit();
    named_arrive(2 - wg);
    wg_wait<1>();
#pragma unroll
    for (int k = 0; k < NS; ++k) reg_fence(s[k]);
    if constexpr (FORM == NORM)
      norm_step(s, j * BN, T, t4, scale_log2, m0, m1, l0, l1, r0, r1);
    else
      softmax_step(s, j * BN, T, t4, scale_log2, m0, m1, l0, l1, c0, c1);
    wg_wait<0>();
    fence32(o);
    warp_arrive(&empty[(i - 1) % STAGES], lane);
    if constexpr (FORM != NORM) rescale(o, c0, c1);
    pack_p(pa, s);
  }
  warp_arrive(q_free, lane);  // every score product on Q is done
  // the last tile's PV product
  const int last = it + n_tiles - 1;
  fence32(o);
  wg_fence();
  issue_pv(o, pa, desc(stage<STAGES, SLOT>(ring, last) + SLOT / 2));
  wg_commit();
  wg_wait<0>();
  fence32(o);
  warp_arrive(&empty[last % STAGES], lane);
}

// K10: a pair's attention for a consumer warpgroup's 64 rows. Head e's Q
// at dq[e]; a stage holds K of heads 0, 1 then V of heads 0, 1. Rounds
// alternate the heads: round 2j issues head 0's scores of tile j with
// head 1's PV product of tile j-1, round 2j+1 head 1's scores of tile j
// with head 0's PV product of tile j, so each softmax runs while the
// tensor cores finish the other head's product. Returns o0, o1 and the
// partial row sums (l00, l01 head 0; l10, l11 head 1).
template <int STAGES, int SLOT>
__device__ __forceinline__ void attend_pair(
    uint64_t dq0, uint64_t dq1, const uint8_t* ring, uint64_t* full,
    uint64_t* empty, uint64_t* q_free, int it, int n_tiles, int T,
    float scale_log2, int wg, int lane, int t4, float o0[32], float o1[32],
    float& l00, float& l01, float& l10, float& l11) {
  float s[NS];
  uint32_t pa[NS / 2];
  zero32(o0);
  zero32(o1);
  float m00 = -INFINITY, m01 = -INFINITY, m10 = -INFINITY, m11 = -INFINITY;
  l00 = l01 = l10 = l11 = 0.f;
  float c0, c1;
  wait_full<STAGES>(full, it);
  const uint8_t* st0 = stage<STAGES, SLOT>(ring, it);
  // round 0: head 0's scores of tile 0 alone
  named_sync(1 + wg);
  wg_fence();
  issue_scores(s, dq0, desc(st0));
  wg_commit();
  named_arrive(2 - wg);
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NS; ++i) reg_fence(s[i]);
  softmax_step(s, 0, T, t4, scale_log2, m00, m01, l00, l01, c0, c1);
  pack_p(pa, s);
  // round 1: head 1's scores of tile 0, head 0's PV product of tile 0
  named_sync(1 + wg);
  wg_fence();
  issue_scores(s, dq1, desc(st0 + TILE_BYTES));
  wg_commit();
  issue_pv(o0, pa, desc(st0 + SLOT / 2));
  wg_commit();
  named_arrive(2 - wg);
  wg_wait<1>();
#pragma unroll
  for (int i = 0; i < NS; ++i) reg_fence(s[i]);
  softmax_step(s, 0, T, t4, scale_log2, m10, m11, l10, l11, c0, c1);
  wg_wait<0>();
  fence32(o0);
  pack_p(pa, s);
  for (int j = 1; j < n_tiles; ++j) {
    const int i = it + j;
    wait_full<STAGES>(full, i);
    const uint8_t* st = stage<STAGES, SLOT>(ring, i);
    const uint8_t* sp = stage<STAGES, SLOT>(ring, i - 1);
    // round 2j: head 0's scores of tile j, head 1's PV of tile j-1
    named_sync(1 + wg);
    wg_fence();
    issue_scores(s, dq0, desc(st));
    wg_commit();
    issue_pv(o1, pa, desc(sp + SLOT / 2 + TILE_BYTES));
    wg_commit();
    named_arrive(2 - wg);
    wg_wait<1>();
#pragma unroll
    for (int k = 0; k < NS; ++k) reg_fence(s[k]);
    softmax_step(s, j * BN, T, t4, scale_log2, m00, m01, l00, l01, c0, c1);
    wg_wait<0>();
    fence32(o1);
    warp_arrive(&empty[(i - 1) % STAGES], lane);  // tile j-1 is consumed
    rescale(o0, c0, c1);
    pack_p(pa, s);
    // round 2j+1: head 1's scores of tile j, head 0's PV of tile j
    named_sync(1 + wg);
    wg_fence();
    issue_scores(s, dq1, desc(st + TILE_BYTES));
    wg_commit();
    issue_pv(o0, pa, desc(st + SLOT / 2));
    wg_commit();
    named_arrive(2 - wg);
    wg_wait<1>();
#pragma unroll
    for (int k = 0; k < NS; ++k) reg_fence(s[k]);
    softmax_step(s, j * BN, T, t4, scale_log2, m10, m11, l10, l11, c0, c1);
    wg_wait<0>();
    fence32(o0);
    rescale(o1, c0, c1);
    pack_p(pa, s);
  }
  warp_arrive(q_free, lane);  // every score product on Q is done
  // head 1's PV product of the last tile
  const int last = it + n_tiles - 1;
  fence32(o1);
  wg_fence();
  issue_pv(o1, pa,
           desc(stage<STAGES, SLOT>(ring, last) + SLOT / 2 + TILE_BYTES));
  wg_commit();
  wg_wait<0>();
  fence32(o1);
  warp_arrive(&empty[last % STAGES], lane);
}

// A head's [64 rows, 64] output, divided as FORM says (POST x 1/l, DIV
// / l, NORM as it is: attend_head divided p), rounded to bf16, into out's
// columns col0 .. col0 + 63 (rows ra, rb of this thread; rows >= T are
// not stored). l0, l1: the thread's partial row sums (POST, DIV).
template <int FORM>
__device__ __forceinline__ void store_head(bf16* out, const float o[32],
                                           float l0, float l1, long long r0,
                                           int ra, int rb, int T, int HD,
                                           int col0, int t4) {
  float y[32];
  if constexpr (FORM == NORM) {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = o[i];
  } else {
    const float L0 = quad_sum(l0), L1 = quad_sum(l1);
    const float i0 = 1.f / L0, i1 = 1.f / L1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = i & 2;  // rows rb: o[4 jd + 2 ..]
      y[i] = FORM == POST ? o[i] * (hi ? i1 : i0)
                          : div_row(o[i], hi ? L1 : L0, hi ? i1 : i0);
    }
  }
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const int col = col0 + jd * 8 + 2 * t4;
    if (ra < T)
      *reinterpret_cast<uint32_t*>(out + (r0 + ra) * HD + col) =
          pack_bf16(y[4 * jd], y[4 * jd + 1]);
    if (rb < T)
      *reinterpret_cast<uint32_t*>(out + (r0 + rb) * HD + col) =
          pack_bf16(y[4 * jd + 2], y[4 * jd + 3]);
  }
}

// One group of the o-projection: a consumer warpgroup's 64 rows and NC
// (1 or 2) output chunks, columns cg * 64 ..: the ring's tiles it .. it +
// H - 1 hold the merged tile's 64-column chunk kc at the stage's start and
// the NC Wo tiles [kc * 64 .., (cg + j) * 64 ..] at its half. Then x's
// tile of these columns (by TMA at sXg, chunk j at j * TILE_BYTES)
// becomes x + (y + bo) in bf16, in place. The last group arrives on the
// second cluster barrier once its products have read the last chunk.
// K1p and K10p (PARTIAL) write the float32 sums to out32's rows (b, q0 ..) at
// columns cg * 64 .. of its HDO, rows >= T left out, and reads neither x
// nor bo.
template <int NC, int STAGES, int SLOT, bool PARTIAL>
__device__ __forceinline__ void o_group(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, uint8_t* sXg,
    uint64_t* x_full, int it, int H, int wg, int lane, int t4, int cg,
    bool last, const bf16* __restrict__ bo, float* __restrict__ out32,
    long long row0, int q0, int T, int HDO) {
  float d[NC][32];
#pragma unroll
  for (int j = 0; j < NC; ++j) zero32(d[j]);
  for (int kc = 0; kc < H; ++kc) {
    const int i = it + kc;
    const uint8_t* st = stage<STAGES, SLOT>(ring, i);
    wait_full<STAGES>(full, i);
    const uint64_t da = desc(st + wg * 64 * 128);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_m64n64k16_ss_mn(d[j], da + 2 * kk,
                              desc(st + SLOT / 2 + j * W_BYTES) +
                                  kk * (2048 >> 4));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NC; ++j) fence32(d[j]);
    warp_arrive(&empty[i % STAGES], lane);
  }
  if (last) cluster_arrive();  // 2: this block reads out no more
  // x + (y + bo) into x's swizzled tile: row r's 16-byte chunk c sits at
  // chunk c ^ (r % 8); this thread's rows r, r + 8 share r % 8 = lane / 4
  const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  if constexpr (PARTIAL) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q0 + r + 8 * h >= T) continue;
      float* row = out32 + (row0 + q0 + r + 8 * h) * HDO + cg * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int jd = 0; jd < 8; ++jd)
          *reinterpret_cast<float2*>(row + j * D + jd * 8) =
              make_float2(d[j][4 * jd + 2 * h], d[j][4 * jd + 2 * h + 1]);
    }
    return;
  }
  mbar_wait(x_full, 0);
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const float2 bv = unpack_bf16(ld32(bo + (cg + j) * D + jd * 8 + 2 * t4));
      uint8_t* cell = sXg + j * TILE_BYTES + r * 128 +
                      ((jd ^ (lane >> 2)) << 4) + 4 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* px = reinterpret_cast<uint32_t*>(cell + h * 8 * 128);
        const float2 xv = unpack_bf16(*px);
        *px = pack_bf16(xv.x + (d[j][4 * jd + 2 * h] + bv.x),
                        xv.y + (d[j][4 * jd + 2 * h + 1] + bv.y));
      }
    }
}

// The block of rank blockIdx.x of the cluster over (batch blockIdx.z,
// rows blockIdx.y * 128 ..); see the file's head.
// `merged` is the [B, T, H*64] tile the heads are stored to (K1, K10,
// K11: out itself); K1p and K10p (PARTIAL) write their float32 result to
// out32 [B, T, HDO], K1's HDO is H * 64.
template <bool PAIR, int FORM, bool PARTIAL = false>
__device__ __forceinline__ void block_body(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* ta, const CUtensorMap* tw, const CUtensorMap* tx,
    const bf16* __restrict__ bo, bf16* __restrict__ merged,
    float* __restrict__ out32, int T, int H, int HDO, float scale_log2) {
  static_assert(!PAIR || FORM == POST, "K10 takes the division after PV");
  static_assert(!PARTIAL || FORM == POST,
                "K1p and K10p are K1's and K10's partial forms");
  using C = Cfg<PAIR>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sQ + C::Q_SLOTS * C::Q_BYTES;  // [STAGES][SLOT]
  uint8_t* sX = ring + C::STAGES * C::SLOT;       // [MAX_COLS][TILE_BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sX + C::X_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* x_full = q_empty + 2;
  uint64_t* full = x_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int rank = blockIdx.x, cs = gridDim.x;  // a cluster spans x
  const int q0 = blockIdx.y * BM, b = blockIdx.z;
  const int units = PAIR ? H / 2 : H;
  const int u0 = rank * units / cs, u1 = (rank + 1) * units / cs;
  const int n_units = u1 - u0;
  // the rank's output chunks: its heads' (K10), or its share of the
  // HDO / 64 chunks (K1, K11: the same as its heads'; K1p, K10p)
  const int nch = HDO / D;
  constexpr bool BY_UNIT = PAIR && !PARTIAL;
  const int c0 = BY_UNIT ? u0 * C::HEADS : rank * nch / cs;
  const int nc = BY_UNIT ? n_units * C::HEADS : (rank + 1) * nch / cs - c0;
  const int n_tiles = (T + BN - 1) / BN;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init(x_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer; thread 256 issues every copy
    if constexpr (PAIR) setmaxnreg_dec<K10_PRODUCER_REGS>();
    int it = 0;
    const int pre = H < C::STAGES ? H : C::STAGES;  // Wo tiles fetched early
    const int nc0 = nc < 2 ? nc : 2;                // chunks of group 0
    if (threadIdx.x == 256) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      prefetch_map(ta);
      prefetch_map(tw);
      prefetch_map(tx);
      for (int u = u0; u < u1; ++u) {
        const int n = u - u0, slot = n % C::Q_SLOTS, use = n / C::Q_SLOTS;
        const int h = u * C::HEADS;
        if (use > 0) mbar_wait(&q_empty[slot], (use - 1) & 1);
        mbar_expect_tx(&q_full[slot], C::Q_BYTES);
        tma_load_4d(sQ + slot * C::Q_BYTES, tq, &q_full[slot], 0, q0, h, b);
        if constexpr (FORM == NORM)  // the K tiles alone, for the row stats
          for (int j = 0; j < n_tiles; ++j, ++it) {
            const int s = it % C::STAGES;
            mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], TILE_BYTES);
            tma_load_4d(ring + s * C::SLOT, tk, &full[s], 0, j * BN, h, b);
          }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::SLOT);
          tma_load_4d(ring + s * C::SLOT, tk, &full[s], 0, j * BN, h, b);
          tma_load_4d(ring + s * C::SLOT + C::SLOT / 2, tv, &full[s], 0,
                      j * BN, h, b);
        }
        if (!PARTIAL && u == u0) {  // x's tile of the rank's columns
          mbar_expect_tx(x_full, nc * TILE_BYTES);
          for (int j = 0; j < nc; ++j)
            tma_load_3d(sX + j * TILE_BYTES, tx, x_full, (c0 + j) * D, q0, b);
        }
      }
      // group 0's first Wo tiles into the stages the attention frees
      for (int kc = 0; kc < pre; ++kc) {
        const int s = (it + kc) % C::STAGES;
        mbar_wait(&empty[s], (((it + kc) / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], TILE_BYTES + nc0 * W_BYTES);
        for (int j = 0; j < nc0; ++j)
          tma_load_2d(ring + s * C::SLOT + C::SLOT / 2 + j * W_BYTES, tw,
                      &full[s], (c0 + j) * D, kc * D);
      }
    }
    __syncwarp();
    cluster_arrive();  // 1: every head of the tile is in out
    cluster_wait();
    if (threadIdx.x == 256) {
      fence_proxy_async_global();
      // the output chunks in groups of two, each over every 64-column
      // chunk of the merged tile
      for (int g0 = 0; g0 < nc; g0 += 2) {
        const int ng = nc - g0 < 2 ? nc - g0 : 2;
        for (int kc = 0; kc < H; ++kc, ++it) {
          const int s = it % C::STAGES;
          if (g0 > 0 || kc >= pre) {
            mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], TILE_BYTES + ng * W_BYTES);
            for (int j = 0; j < ng; ++j)
              tma_load_2d(ring + s * C::SLOT + C::SLOT / 2 + j * W_BYTES, tw,
                          &full[s], (c0 + g0 + j) * D, kc * D);
          }
          tma_load_3d(ring + s * C::SLOT, ta, &full[s], kc * D, q0, b);
        }
      }
    }
    __syncwarp();
    cluster_arrive();  // 2
    cluster_wait();
    return;
  }

  // ---- a consumer warpgroup: rows q0 + 64 wg .. + 63
  if constexpr (PAIR) setmaxnreg_inc<K10_CONSUMER_REGS>();
  const int warp = (threadIdx.x >> 5) & 3, t4 = lane & 3;
  const int ra = q0 + wg * 64 + warp * 16 + (lane >> 2), rb = ra + 8;
  const long long r0 = (long long)b * T;  // out's row of (b, 0)
  const int HD = H * D;
  int it = 0;
  // ping-pong (named barriers 1 and 2): warpgroup 0 issues first; every
  // issue round then lets the other warpgroup go, so one arrival on
  // barrier 1 is left over at the end
  if (wg == 1) named_arrive(1);
  const int head_tiles = FORM == NORM ? 2 * n_tiles : n_tiles;
  for (int u = u0; u < u1; ++u, it += head_tiles) {
    const int n = u - u0, slot = n % C::Q_SLOTS, use = n / C::Q_SLOTS;
    const uint8_t* q = sQ + slot * C::Q_BYTES + wg * 64 * 128;
    mbar_wait(&q_full[slot], use & 1);
    if constexpr (PAIR) {
      float o0[32], o1[32], l00, l01, l10, l11;
      attend_pair<C::STAGES, C::SLOT>(
          desc(q), desc(q + TILE_BYTES), ring, full, empty, &q_empty[slot],
          it, n_tiles, T, scale_log2, wg, lane, t4, o0, o1, l00, l01, l10,
          l11);
      store_head<POST>(merged, o0, l00, l01, r0, ra, rb, T, HD, 2 * u * D,
                       t4);
      store_head<POST>(merged, o1, l10, l11, r0, ra, rb, T, HD,
                       (2 * u + 1) * D, t4);
    } else {
      float o[32], l0, l1;
      attend_head<FORM, C::STAGES, C::SLOT>(
          desc(q), ring, full, empty, &q_empty[slot], it, n_tiles, T,
          scale_log2, wg, lane, t4, o, l0, l1);
      store_head<FORM>(merged, o, l0, l1, r0, ra, rb, T, HD, u * D, t4);
    }
  }
  fence_proxy_async_global();  // the peers' TMA loads read these stores
  cluster_arrive();            // 1
  cluster_wait();
  for (int g0 = 0; g0 < nc; g0 += 2, it += H) {
    const bool last = g0 + 2 >= nc;
    if (nc - g0 >= 2)
      o_group<2, C::STAGES, C::SLOT, PARTIAL>(
          ring, full, empty, sX + g0 * TILE_BYTES, x_full, it, H, wg, lane,
          t4, c0 + g0, last, bo, out32, r0, q0, T, HDO);
    else
      o_group<1, C::STAGES, C::SLOT, PARTIAL>(
          ring, full, empty, sX + g0 * TILE_BYTES, x_full, it, H, wg, lane,
          t4, c0 + g0, last, bo, out32, r0, q0, T, HDO);
  }
  if constexpr (PARTIAL) {
    cluster_wait();  // 2
    return;
  }
  fence_proxy_async();  // the TMA store reads the tile's shared memory
  named_sync(3);        // every consumer's part of the tile is in place
  cluster_wait();       // 2: no peer reads out any more
  if (threadIdx.x == 0) {
    for (int j = 0; j < nc; ++j)
      tma_store_3d(ta, sX + j * TILE_BYTES, (c0 + j) * D, q0, b);
    bulk_commit_wait_read();
  }
}

__global__ void __launch_bounds__(Cfg<false>::NT, 1) encoder_block_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx, const bf16* __restrict__ bo,
    bf16* __restrict__ out, int T, int H, float scale_log2) {
  block_body<false, POST>(&tq, &tk, &tv, &ta, &tw, &tx, bo, out, nullptr, T,
                          H, H * D, scale_log2);
}

// K1p: ta maps the merged scratch, tx is unread (ta again).
__global__ void __launch_bounds__(Cfg<false>::NT, 1)
    encoder_block_partial_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap ta,
                                 const __grid_constant__ CUtensorMap tw,
                                 const __grid_constant__ CUtensorMap tx,
                                 bf16* __restrict__ merged,
                                 float* __restrict__ out, int T, int H,
                                 int HDO, float scale_log2) {
  block_body<false, POST, true>(&tq, &tk, &tv, &ta, &tw, &tx, nullptr,
                                merged, out, T, H, HDO, scale_log2);
}

// K10p: K1p's arguments, on K10's blocks.
__global__ void __launch_bounds__(Cfg<true>::NT, 1)
    encoder_block_paired_partial_kernel(const __grid_constant__ CUtensorMap tq,
                                        const __grid_constant__ CUtensorMap tk,
                                        const __grid_constant__ CUtensorMap tv,
                                        const __grid_constant__ CUtensorMap ta,
                                        const __grid_constant__ CUtensorMap tw,
                                        const __grid_constant__ CUtensorMap tx,
                                        bf16* __restrict__ merged,
                                        float* __restrict__ out, int T, int H,
                                        int HDO, float scale_log2) {
  block_body<true, POST, true>(&tq, &tk, &tv, &ta, &tw, &tx, nullptr, merged,
                               out, T, H, HDO, scale_log2);
}

__global__ void __launch_bounds__(Cfg<true>::NT, 1)
    encoder_block_paired_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap ta,
                                const __grid_constant__ CUtensorMap tw,
                                const __grid_constant__ CUtensorMap tx,
                                const bf16* __restrict__ bo,
                                bf16* __restrict__ out, int T, int H,
                                float scale_log2) {
  block_body<true, POST>(&tq, &tk, &tv, &ta, &tw, &tx, bo, out, nullptr, T,
                         H, H * D, scale_log2);
}

// K11's DIV and NORM forms (its POST form is K1's kernel).
template <int FORM>
__global__ void __launch_bounds__(Cfg<false>::NT, 1) encoder_block_ab_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx, const bf16* __restrict__ bo,
    bf16* __restrict__ out, int T, int H, float scale_log2) {
  block_body<false, FORM>(&tq, &tk, &tv, &ta, &tw, &tx, bo, out, nullptr, T,
                          H, H * D, scale_log2);
}

// The maps of recent calls (the encoder's buffers recur from batch to
// batch): q/k/v as rank-4 maps over the [B, H, T, 64] views with element
// strides (sb, sh, st, 1), box {64, 128 rows, heads}; out (the merged
// tile, loaded and stored) and x as rank-3 maps over [B, T, HD], box {64,
// 128, 1}; Wo as a rank-2 map over [HD in, HD out], box {64, 64}; all
// with the 128-byte swizzle.
MapCache<64> maps;

int bhtd_map(CUtensorMap* map, const void* base, int B, int H, int T,
             int heads, long long sb, long long sh, long long st) {
  return maps.get(map, map_spec(base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                {64u, (cuuint64_t)T, (cuuint64_t)H,
                                 (cuuint64_t)B},
                                {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2},
                                {64u, (cuuint32_t)BN, (cuuint32_t)heads, 1u},
                                CU_TENSOR_MAP_SWIZZLE_128B));
}

int btd_map(CUtensorMap* map, const void* base, int B, int T, int HD) {
  return maps.get(map, map_spec(base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                {(cuuint64_t)HD, (cuuint64_t)T, (cuuint64_t)B},
                                {(cuuint64_t)HD * 2, (cuuint64_t)T * HD * 2},
                                {64u, (cuuint32_t)BM, 1u},
                                CU_TENSOR_MAP_SWIZZLE_128B));
}

// The kernel of K10 (PAIR), K1 (POST) or a K11 form.
template <bool PAIR, int FORM>
inline auto kernel_of() {
  if constexpr (PAIR)
    return encoder_block_paired_kernel;
  else if constexpr (FORM == POST)
    return encoder_block_kernel;
  else
    return encoder_block_ab_kernel<FORM>;
}

// q/k/v's maps, the merged tile's (`merged`, [B, T, H*64]) and Wo's
// ([H*64, HDO]); x's for K1, K10, K11 (x == NULL: K1p, which reads none).
int block_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
               CUtensorMap* ta, CUtensorMap* tw, CUtensorMap* tx,
               const void* q, const void* k, const void* v, long long sb,
               long long sh, long long st, const void* x, const void* wo,
               void* merged, int B, int H, int T, int HDO, int heads) {
  const int HD = H * D;
  int e = bhtd_map(tq, q, B, H, T, heads, sb, sh, st);
  if (e == 0) e = bhtd_map(tk, k, B, H, T, heads, sb, sh, st);
  if (e == 0) e = bhtd_map(tv, v, B, H, T, heads, sb, sh, st);
  if (e == 0) e = btd_map(ta, merged, B, T, HD);
  if (e == 0)
    e = maps.get(tw, map_spec(wo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              {(cuuint64_t)HDO, (cuuint64_t)HD},
                              {(cuuint64_t)HDO * 2}, {64u, 64u},
                              CU_TENSOR_MAP_SWIZZLE_128B));
  if (e == 0) e = x ? btd_map(tx, x, B, T, HD) : btd_map(tx, merged, B, T, HD);
  return e;
}

template <bool PAIR, int FORM = POST>
int launch(const void* q, const void* k, const void* v, long long sb,
           long long sh, long long st, const void* x, const void* wo,
           const void* bo, void* out, int B, int H, int T, int HD,
           float scale_log2, int cs, void* stream) {
  using C = Cfg<PAIR>;
  const int units = PAIR ? H / 2 : H;
  // every rank takes one to MAX_COLS heads (K10: one or two pairs)
  if (B < 1 || T < 1 || H < 1 || HD != H * D || (PAIR && H % 2 != 0) ||
      cs < 1 || cs > units || (units + cs - 1) / cs * C::HEADS > MAX_COLS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, ta, tw, tx;
  const int e = block_maps(&tq, &tk, &tv, &ta, &tw, &tx, q, k, v, sb, sh, st,
                           x, wo, out, B, H, T, HD, C::HEADS);
  if (e != 0) return e;
  const dim3 grid(cs, (T + BM - 1) / BM, B);
  return launch_cluster(kernel_of<PAIR, FORM>(), grid, cs, C::NT, C::SMEM,
                        (cudaStream_t)stream, tq, tk, tv, ta, tw, tx,
                        (const bf16*)bo, (bf16*)out, T, H, scale_log2);
}

// K1p (PAIR false) or K10p (true): K1's or K10's plan rules, and at least
// one of the HDO / 64 output chunks a rank.
template <bool PAIR>
int launch_partial(const void* q, const void* k, const void* v, long long sb,
                   long long sh, long long st, void* merged, const void* wo,
                   void* out, int B, int H, int T, int HDO, float scale_log2,
                   int cs, void* stream) {
  using C = Cfg<PAIR>;
  const int units = PAIR ? H / 2 : H;
  if (B < 1 || T < 1 || H < 1 || (PAIR && H % 2 != 0) || HDO < D ||
      HDO % D != 0 || cs < 1 || cs > units || cs > HDO / D ||
      (units + cs - 1) / cs * C::HEADS > MAX_COLS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, ta, tw, tx;
  const int e = block_maps(&tq, &tk, &tv, &ta, &tw, &tx, q, k, v, sb, sh, st,
                           nullptr, wo, merged, B, H, T, HDO, C::HEADS);
  if (e != 0) return e;
  const dim3 grid(cs, (T + BM - 1) / BM, B);
  return launch_cluster(PAIR ? encoder_block_paired_partial_kernel
                             : encoder_block_partial_kernel,
                        grid, cs, C::NT, C::SMEM, (cudaStream_t)stream, tq, tk,
                        tv, ta, tw, tx, (bf16*)merged, (float*)out, T, H, HDO,
                        scale_log2);
}

}  // namespace

// Raises K1's, K1p's, K10's, K10p's and K11's dynamic shared-memory limits,
// allows their clusters of up to 16 blocks and looks up
// cuTensorMapEncodeTiled. Called once, when the library is loaded.
extern "C" int mas_encoder_block_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const void* fns[6] = {(const void*)encoder_block_kernel,
                        (const void*)encoder_block_paired_kernel,
                        (const void*)encoder_block_ab_kernel<DIV>,
                        (const void*)encoder_block_ab_kernel<NORM>,
                        (const void*)encoder_block_partial_kernel,
                        (const void*)encoder_block_paired_partial_kernel};
  const int smem[6] = {Cfg<false>::SMEM, Cfg<true>::SMEM, Cfg<false>::SMEM,
                       Cfg<false>::SMEM, Cfg<false>::SMEM, Cfg<true>::SMEM};
  for (int i = 0; i < 6; ++i) {
    cudaError_t e = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The clusters of cs K1 (paired = 0; K1p's and K11's blocks are K1's) or
// K10 (1; K10p's blocks are K10's) blocks the card holds at once, into *out. Returns a cudaError_t
// value.
extern "C" int mas_encoder_block_fit(int paired, int cs, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(paired ? Cfg<true>::NT : Cfg<false>::NT);
  cfg.dynamicSmemBytes = paired ? Cfg<true>::SMEM : Cfg<false>::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out,
      paired ? (const void*)encoder_block_paired_kernel
             : (const void*)encoder_block_kernel,
      &cfg);
}

// K1. q/k/v: [B, H, T, 64] bf16 views sharing element strides (sb, sh, st)
// with unit stride on the last dim, each stride a multiple of 8 and each
// base 16-byte aligned (TMA's rules); x/out: [B, T, HD] contiguous bf16;
// wo: [HD, HD] row-major bf16 ([in, out]); bo: [HD] bf16; HD = H * 64;
// cs blocks a cluster, each rank taking one to four heads (H <= 4 cs, cs
// <= H). Returns a cudaError_t value: a plan outside those rules, a
// tensor map the driver refuses, or a launch the card refuses (a cluster
// it cannot place). Safe to call from several threads.
extern "C" int mas_attn_o_residual(const void* q, const void* k,
                                   const void* v, long long sb, long long sh,
                                   long long st, const void* x,
                                   const void* wo, const void* bo, void* out,
                                   int B, int H, int T, int HD,
                                   float scale_log2, int cs, void* stream) {
  return launch<false>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T, HD,
                       scale_log2, cs, stream);
}

// K10: K1's arguments; H even and cs = H / 2 (a pair a rank).
extern "C" int mas_attn_o_residual_paired(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long st, const void* x, const void* wo, const void* bo, void* out,
    int B, int H, int T, int HD, float scale_log2, int cs, void* stream) {
  return launch<true>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T, HD,
                      scale_log2, cs, stream);
}

// K11: K1's arguments, and form, the softmax division (0 = x 1/l after PV,
// "post", K1 itself; 1 = / l after PV, True; 2 = p / l before PV,
// False). The same plans as K1 (cs blocks a cluster). Returns a
// cudaError_t value: a plan or form outside the rules, a tensor map the
// driver refuses, or a launch the card refuses.
extern "C" int mas_attn_o_residual_ab(const void* q, const void* k,
                                      const void* v, long long sb,
                                      long long sh, long long st,
                                      const void* x, const void* wo,
                                      const void* bo, void* out, int B, int H,
                                      int T, int HD, float scale_log2, int cs,
                                      int form, void* stream) {
  switch (form) {
    case POST:
      return launch<false, POST>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T,
                                 HD, scale_log2, cs, stream);
    case DIV:
      return launch<false, DIV>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T,
                                HD, scale_log2, cs, stream);
    case NORM:
      return launch<false, NORM>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T,
                                 HD, scale_log2, cs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1p, K1's partial form on one rank of the model axis: out = (attention
// over the H heads of q/k/v, merged) @ wo in float32. q/k/v as K1's; wo:
// [H * 64, HDO] row-major bf16 (a row shard of the layer's o-projection),
// HDO % 64 == 0 and HDO / 64 >= cs; merged: [B, T, H * 64] bf16 scratch,
// written and read back (16-byte aligned); out: [B, T, HDO] float32,
// rows by 8-byte stores. K1's plans (cs blocks a cluster, one to four
// heads a rank). Returns a cudaError_t value, as mas_attn_o_residual.
extern "C" int mas_attn_o_residual_partial(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long st, void* merged, const void* wo, void* out, int B, int H,
    int T, int HDO, float scale_log2, int cs, void* stream) {
  return launch_partial<false>(q, k, v, sb, sh, st, merged, wo, out, B, H, T,
                               HDO, scale_log2, cs, stream);
}

// K10p, K10's partial form: K1p's arguments; H even, K10's plans (cs blocks
// a cluster over the H / 2 pairs, one or two pairs a rank), HDO / 64 >= cs.
extern "C" int mas_attn_o_residual_paired_partial(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long st, void* merged, const void* wo, void* out, int B, int H,
    int T, int HDO, float scale_log2, int cs, void* stream) {
  return launch_partial<true>(q, k, v, sb, sh, st, merged, wo, out, B, H, T,
                              HDO, scale_log2, cs, stream);
}
