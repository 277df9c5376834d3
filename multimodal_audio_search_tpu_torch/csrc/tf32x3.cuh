// The float32 encoder attention loop shared by K8's float32 form
// (encoder_attention.cu) and K1's (encoder_block_f32.cu): softmax(Q K^T /
// 8) V on Hopper's tensor cores with float32-class accuracy, by splitting
// every operand into two TF32 parts and taking three products.
//
// 3xTF32. A TF32 operand keeps 10 of float32's 23 mantissa bits, so one
// TF32 product misses a float32 tolerance of 2e-5 at T = 1500 (about 1e-4
// off). Each operand x is split into hi = x rounded to TF32 (to nearest,
// ties away from zero: add half a TF32 unit to the bits and clear the 13
// low ones, which is cvt.rna.tf32.f32) and lo = x - hi (exact in float32;
// the tensor cores read its upper 19 bits, so lo enters truncated to
// TF32). Then a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, the dropped term
// lo_a lo_b being 2^-22 of a b; the three go into one float32 accumulator,
// small ones first. The tensor cores' float32 sums do not round to
// nearest: on an H100 one running P V sum over T = 1500 keys (564
// products a row) came out 6.0e-6 off the plain version at B=8, H=6, as
// sums rounded toward zero do on the CPU (4.0e-6 at B=1, H=2; to nearest:
// 2.9e-7). So every sum runs over one tile only (S over 64 head dims, P V
// over 64 keys, K1's o-projection over 64 inputs: 24 products) and the
// tiles' sums are added on the CUDA cores, rounded to nearest: 1.1e-6 on
// the card at the same cost. tests/test_torch_tf32x3.py emulates this
// arithmetic on the CPU, in this order, each product's sum rounded toward
// zero, against the plain versions.
//
// Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. With g =
// lane / 4 and t = lane % 4 (PTX ISA fragment layouts):
//   A (16x8, row): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                  a3 = A[g+8][t+4]
//   B (8x8, col):  b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8):      c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// The S accumulators of 8 keys are P's A fragment for PV as they stand if
// the PV product's k index t stands for key 2t and t + 4 for key 2t + 1 (a
// PV sum may run over its 8 keys in any order): a0 = c0, a1 = c2, a2 = c1,
// a3 = c3, and V's B fragment is read at keys 2t and 2t + 1.
//
// Work split: a block is 64 query rows of one (batch, head), four warps of
// 16 rows; each warp holds its Q rows, scaled by 1/8 (exact), as A
// fragments in registers (32, split again at each tile: 64 split ones
// spilled), its S (32), O (32) and a tile's P V (32) accumulators. K and
// V stream through shared memory in tiles of 64 keys, two stages deep by
// cp.async (zero-filled past T, where the scores are set to -inf), so the
// next tile is in flight while this one is multiplied; each warp splits
// the K and V values it reads (by integer operations: cvt.rna.tf32.f32
// measured 12 % slower). Rows of a staged tile are LD = 68 floats apart,
// which puts the 32 lanes of every fragment read (K's b0 at row g, column
// t; V's at row 2t, column g) on 32 banks.
//
// Softmax, with the plain version's roundings: float32 scores, exp of (s -
// max) by expf, the row sum l over those p, the output row divided by l
// (a true division) before the float32 store. The running max makes it an
// online softmax: O and l are rescaled by exp(m_old - m_new) per tile, O
// as it takes the tile's P V (O c + P V by one FMA).
#pragma once

#include "sm90.cuh"

namespace tf32x3 {

using sm90::cp_async16_zfill;
using sm90::cp_async_commit;
using sm90::cp_async_wait_group;
using sm90::fa::quad_max;
using sm90::fa::quad_sum;

constexpr int D = 64;         // head dim
constexpr int ROWS = 64;      // query rows a block: four warps of 16
constexpr int KEYS = 64;      // keys a K/V tile
constexpr int NT = 128;       // threads a block
constexpr int LD = 68;        // row stride of a staged K/V/A tile, floats
constexpr int LDW = 72;       // row stride of a staged Wo tile (K1)
constexpr int SLOT = 64 * LDW;                  // floats a staged tile
constexpr int SMEM_BYTES = 2 * 2 * SLOT * 4;    // two stages of two tiles

// x rounded to TF32 (to nearest, ties away from zero), as float32 bits
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Marks x as changed here, so the compiler keeps the value and not what it
// computes from it (Q's splits) across the tile loop
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)); }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products: lo_a hi_b, hi_a lo_b, hi_a hi_b
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// rows [r0, r0 + 64) of a [n, 64] float32 matrix (row stride `ld`
// floats) into a staged tile of row stride `lds`; rows at or past n are
// zeros. Every thread of the block issues its share; the caller commits.
__device__ __forceinline__ void stage_rows(float* dst, int lds,
                                           const float* src, long long ld,
                                           int r0, int n) {
#pragma unroll
  for (int u = 0; u < 64 * 16 / NT; ++u) {
    const int i = threadIdx.x + u * NT, r = i >> 4, c = (i & 15) * 4;
    const int row = r0 + r;
    cp_async16_zfill(dst + r * lds + c, src + (row < n ? row : 0) * ld + c,
                     row < n ? 16 : 0);
  }
}

// One 64-key tile of one head's online softmax for a warp's rows g and g
// + 8 (of its 16): S = Q K^T from the warp's Q fragments `qf` (x 1/8) and
// the staged K tile `sk`, the keys at or past T masked, the running max
// (m0, m1) and sum (l0, l1) updated, the tile's P V (V tile `sv`) into its
// own accumulator and O = O c + P V (one rounding to nearest a tile). kv0:
// the tile's first key.
__device__ __forceinline__ void head_tile(float (&qf)[8][4],
                                          const float* sk, const float* sv,
                                          int kv0, int T, float (&o)[8][4],
                                          float& m0, float& m1, float& l0,
                                          float& l1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // S = Q K^T: key n-tile n holds keys 8n + 2t, 8n + 2t + 1
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t qh[4], ql[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      keep(qf[kk][i]);
      split(qf[kk][i], qh[i], ql[i]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* kr = sk + (8 * n + g) * LD + 8 * kk + t;
      mma3(s[n], qh, ql, kr[0], kr[4]);
    }
  }
  if (kv0 + KEYS > T) {  // keys past T: zeros in the tile, never scored
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = kv0 + 8 * n + 2 * t;
      if (key >= T) s[n][0] = s[n][2] = -INFINITY;
      if (key + 1 >= T) s[n][1] = s[n][3] = -INFINITY;
    }
  }

  // online softmax, float32 with expf
  float x0 = m0, x1 = m1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
    x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
  }
  x0 = quad_max(x0);
  x1 = quad_max(x1);
  const float c0 = expf(m0 - x0), c1 = expf(m1 - x1);  // 0 at the start
  m0 = x0;
  m1 = x1;
  l0 *= c0;
  l1 *= c1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = expf(s[n][0] - m0);
    s[n][1] = expf(s[n][1] - m0);
    s[n][2] = expf(s[n][2] - m1);
    s[n][3] = expf(s[n][3] - m1);
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }

  // P V of this tile into its own accumulator: key n-tile kk is P's A
  // fragment (keys 2t -> k t, 2t + 1 -> k t + 4), V's B fragment read at
  // those keys. Then O = O c + P V, one rounding to nearest a tile.
  float pv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ph[4], pl[4];
    split(s[kk][0], ph[0], pl[0]);
    split(s[kk][2], ph[1], pl[1]);
    split(s[kk][1], ph[2], pl[2]);
    split(s[kk][3], ph[3], pl[3]);
    const float* vr = sv + (8 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma3(pv[n], ph, pl, vr[8 * n], vr[LD + 8 * n]);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    o[n][0] = fmaf(o[n][0], c0, pv[n][0]);
    o[n][1] = fmaf(o[n][1], c0, pv[n][1]);
    o[n][2] = fmaf(o[n][2], c1, pv[n][2]);
    o[n][3] = fmaf(o[n][3], c1, pv[n][3]);
  }
}

// A warp's output rows ra = q0 + 16 warp + g and ra + 8, o / l (a true
// division, float32), to dst + r * ld_out for r < T.
__device__ __forceinline__ void store_heads(const float (&o)[8][4], float l0,
                                            float l1, int q0, int T,
                                            float* __restrict__ dst,
                                            long long ld_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (ra < T)
      *reinterpret_cast<float2*>(dst + ra * ld_out + c) =
          make_float2(o[n][0] / l0, o[n][1] / l0);
    if (rb < T)
      *reinterpret_cast<float2*>(dst + rb * ld_out + c) =
          make_float2(o[n][2] / l1, o[n][3] / l1);
  }
}

// Attention of rows [q0, q0 + 64) of one (batch, head) over its T keys.
// q, k, v: the head's [T, 64] rows, row stride st floats; scale = 1/8;
// the output rows (o / l, float32) go to dst + r * ld_out for r < T.
// `smem` holds two stages of a K and a V tile. Every thread of the block
// calls it; it ends with the block synchronised and its shared memory
// free.
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       long long st, int T, int q0,
                                       float scale, float* smem,
                                       float* __restrict__ dst,
                                       long long ld_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const int n_tiles = (T + KEYS - 1) / KEYS;

  stage_rows(smem, LD, k, st, 0, T);
  stage_rows(smem + SLOT, LD, v, st, 0, T);
  cp_async_commit();

  // Q's A fragments x 1/8, split again at each tile (32 registers in
  // place of 64); rows past T are zeros
  float qf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = 8 * kk + t;
    qf[kk][0] = ra < T ? q[ra * st + c] * scale : 0.f;
    qf[kk][1] = rb < T ? q[rb * st + c] * scale : 0.f;
    qf[kk][2] = ra < T ? q[ra * st + c + 4] * scale : 0.f;
    qf[kk][3] = rb < T ? q[rb * st + c + 4] * scale : 0.f;
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g+8

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* nx = smem + ((j + 1) & 1) * 2 * SLOT;
      stage_rows(nx, LD, k, st, (j + 1) * KEYS, T);
      stage_rows(nx + SLOT, LD, v, st, (j + 1) * KEYS, T);
    }
    cp_async_commit();
    cp_async_wait_group<1>();  // tile j has landed for this thread
    __syncthreads();           // ... and for every thread
    const float* sk = smem + (j & 1) * 2 * SLOT;
    head_tile(qf, sk, sk + SLOT, j * KEYS, T, o, m0, m1, l0, l1);
    __syncthreads();  // every warp is done with this stage
  }
  store_heads(o, l0, l1, q0, T, dst, ld_out);
}

// The pair loop (K10's float32 form): attention of rows [q0, q0 + 64) of
// two heads a and b of one batch row over their T keys, tile by tile:
// each stage holds both heads' K and V tiles of one 64-key range (one
// cp.async group), and each warp takes head a's tile and then head b's,
// each with its own online softmax (head_tile, the arithmetic of attend),
// so each head's output is attend's bit for bit. Both heads' Q rows x 1/8
// wait in shared memory (two [64, LD] tiles) and each warp reads its own
// rows' fragments a tile at a time; two heads' outputs in registers are
// as many as one head's Q and O were. q*, k*, v*: the heads' [T, 64] rows
// (row stride st); dst*: their output columns (row stride ld_out).
// `smem`: PAIR_SMEM_BYTES. Ends with the block synchronised and its
// shared memory free.
constexpr int PAIR_STAGE = 4 * SLOT;                  // Ka, Va, Kb, Vb
constexpr int PAIR_SMEM_BYTES = (2 * PAIR_STAGE + 2 * 64 * LD) * 4;

__device__ __forceinline__ void attend_pair(
    const float* __restrict__ qa, const float* __restrict__ ka,
    const float* __restrict__ va, const float* __restrict__ qb,
    const float* __restrict__ kb, const float* __restrict__ vb,
    long long st, int T, int q0, float scale, float* smem,
    float* __restrict__ dsta, float* __restrict__ dstb, long long ld_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (T + KEYS - 1) / KEYS;
  float* sq = smem + 2 * PAIR_STAGE;  // [2][64][LD]: Q x 1/8, both heads
  auto stage = [&](int s, int kv0) {
    float* d = smem + s * PAIR_STAGE;
    stage_rows(d, LD, ka, st, kv0, T);
    stage_rows(d + SLOT, LD, va, st, kv0, T);
    stage_rows(d + 2 * SLOT, LD, kb, st, kv0, T);
    stage_rows(d + 3 * SLOT, LD, vb, st, kv0, T);
  };
  stage(0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * 64 * 64; i += NT) {
    const int h = i >> 12, r = (i >> 6) & 63, c = i & 63;
    const int row = q0 + r;
    sq[(h * 64 + r) * LD + c] =
        row < T ? (h ? qb : qa)[row * st + c] * scale : 0.f;
  }
  // a warp's Q fragments of head h, as attend holds them
  auto load_q = [&](float (&qf)[8][4], int h) {
    const float* r0 = sq + (h * 64 + warp * 16 + g) * LD + t;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qf[kk][0] = r0[8 * kk];
      qf[kk][1] = r0[8 * LD + 8 * kk];
      qf[kk][2] = r0[8 * kk + 4];
      qf[kk][3] = r0[8 * LD + 8 * kk + 4];
    }
  };

  float oa[8][4], ob[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    oa[n][0] = oa[n][1] = oa[n][2] = oa[n][3] = 0.f;
    ob[n][0] = ob[n][1] = ob[n][2] = ob[n][3] = 0.f;
  }
  float ma0 = -INFINITY, ma1 = -INFINITY, la0 = 0.f, la1 = 0.f;
  float mb0 = -INFINITY, mb1 = -INFINITY, lb0 = 0.f, lb1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) stage((j + 1) & 1, (j + 1) * KEYS);
    cp_async_commit();
    cp_async_wait_group<1>();  // tile j of both heads has landed
    __syncthreads();           // ... for every thread (and Q, at j = 0)
    const float* sk = smem + (j & 1) * PAIR_STAGE;
    float qf[8][4];
    load_q(qf, 0);
    head_tile(qf, sk, sk + SLOT, j * KEYS, T, oa, ma0, ma1, la0, la1);
    load_q(qf, 1);
    head_tile(qf, sk + 2 * SLOT, sk + 3 * SLOT, j * KEYS, T, ob, mb0, mb1,
              lb0, lb1);
    __syncthreads();  // every warp is done with this stage
  }
  store_heads(oa, la0, la1, q0, T, dsta, ld_out);
  store_heads(ob, lb0, lb1, q0, T, dstb, ld_out);
}

// The o-projection of K1's, K1p's, K10's, K10p's, K9's and K9p's float32
// forms, one 64-column output chunk c of one (batch, 64-row) tile: y =
// A @ W over n_in 64-column input chunks, A the tile's rows [q0, q0 + 64)
// of the merged float32 attention (`a`: the batch row's [T, n_in * 64]
// rows, row stride lda), W [n_in * 64, ldw] row-major (the chunk's
// columns c * 64 ..). The merged chunk and W's [64 in, 64 out] tile
// stream through two stages by cp.async, in order of the input chunk;
// 3xTF32 products, each input chunk's into its own float32 accumulator,
// added to the row's sum rounded to nearest. PARTIAL: out[r * ldw + col]
// = y (the float32 partial of a rank); else out = x + (y + bo) (x, out:
// the batch row's [T, ldw] rows). Rows past T are not written. Every
// thread of the block calls it with the block synchronised and `smem`'s
// SMEM_BYTES free; it ends so. Each output element is summed in one fixed
// order by one thread.
template <bool PARTIAL>
__device__ __forceinline__ void project_chunk(
    const float* __restrict__ a, long long lda, int n_in,
    const float* __restrict__ w, int ldw, int c, int q0, int T,
    const float* __restrict__ x, const float* __restrict__ bo,
    float* __restrict__ out, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  stage_rows(smem, LD, a, lda, q0, T);
  stage_rows(smem + SLOT, LDW, w + c * D, ldw, 0, D);
  cp_async_commit();
  for (int kc = 0; kc < n_in; ++kc) {
    if (kc + 1 < n_in) {
      float* nx = smem + ((kc + 1) & 1) * 2 * SLOT;
      stage_rows(nx, LD, a + (kc + 1) * D, lda, q0, T);
      stage_rows(nx + SLOT, LDW, w + (long long)(kc + 1) * D * ldw + c * D,
                 ldw, 0, D);
    }
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();
    // A: rows warp * 16 + g (+ 8) of the merged chunk; B: W rows (the
    // chunk's input columns) by 64 output columns
    const float* sa = smem + (kc & 1) * 2 * SLOT + (warp * 16 + g) * LD + t;
    const float* sw = smem + (kc & 1) * 2 * SLOT + SLOT + t * LDW + g;
    // this input chunk's sum in its own accumulator, then added to acc
    // rounded to nearest
    float part[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split(sa[8 * kk], ah[0], al[0]);
      split(sa[8 * LD + 8 * kk], ah[1], al[1]);
      split(sa[8 * kk + 4], ah[2], al[2]);
      split(sa[8 * LD + 8 * kk + 4], ah[3], al[3]);
      const float* wr = sw + 8 * kk * LDW;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma3(part[n], ah, al, wr[8 * n], wr[4 * LDW + 8 * n]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = c * D + 8 * n + 2 * t;
    if (PARTIAL) {
      if (ra < T)
        *reinterpret_cast<float2*>(out + (long long)ra * ldw + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (rb < T)
        *reinterpret_cast<float2*>(out + (long long)rb * ldw + col) =
            make_float2(acc[n][2], acc[n][3]);
      continue;
    }
    // x + (y + bo), float32
    const float2 bb = *reinterpret_cast<const float2*>(bo + col);
    if (ra < T) {
      const long long i = (long long)ra * ldw + col;
      const float2 xx = *reinterpret_cast<const float2*>(x + i);
      *reinterpret_cast<float2*>(out + i) =
          make_float2(xx.x + (acc[n][0] + bb.x), xx.y + (acc[n][1] + bb.y));
    }
    if (rb < T) {
      const long long i = (long long)rb * ldw + col;
      const float2 xx = *reinterpret_cast<const float2*>(x + i);
      *reinterpret_cast<float2*>(out + i) =
          make_float2(xx.x + (acc[n][2] + bb.x), xx.y + (acc[n][3] + bb.y));
    }
  }
}

}  // namespace tf32x3
