// K3's and K4's float32 forms: the fused decoder sub-blocks of one decode
// step on float32 tensors, which the TPU kernels take as they take bf16
// (they cast every weight to x's dtype). The bf16 forms are
// decoder_block.cu's; these compute the same functions:
//
//   K3 (TAIL = K3-q): x_out = x + (single-query attention of LN(x) over
//     the cache rows t < pos + the fresh row, heads merged) @ Wo + bo, k1
//     and v1 written into row pos of the caches; with TAIL also q_cross =
//     LN2(x_out) @ Wcq + bcq. Replaces multimodal_audio_search_tpu/ops/
//     decoder_block.py::fused_self_block (pallas_call :200) and, with
//     TAIL, fused_self_block_q (:272) on float32 inputs.
//   K4 (and K4-o): out = x1 + fc2(gelu(fc1(LN(x1)))), x1 = x, or for
//     K4-o x1 = x + attn @ Wco + bco. Replaces fused_mlp_block (:611)
//     and fused_mlp_block_o (:363) on float32 inputs.
//   K3p, K4p (PARTIAL): the forms of K3 and K4 on one rank of the mesh's
//     model axis (the head shard of fused_self_block, the F / mp column
//     shard of fused_mlp_block, as decoder_block.cu's K3p and K4p): the
//     rank's H heads of a model of width D (Wq/Wk/Wv [D, H * 64], Wo
//     [H * 64, D], caches [B, L, H * 64]) or its F / mp columns of fc1 and
//     rows of fc2, the whole x for the layer norm, and out = the float32
//     o-projection (fc2) sum without x and bo (b2), which parallel/
//     mesh.py::model_sum adds once to the ranks' sum.
//
// Every tensor is float32 and every product is a float32 FFMA on the
// CUDA cores: nothing is rounded to bf16 (the plain versions' roundings
// are no-ops at float32) and no product goes through TF32 (3xTF32 on the
// tensor cores would round its sums toward zero, tf32x3.cuh). The erf of
// the GELU is the TPU kernels' Abramowitz-Stegun 7.1.26 polynomial, as in
// the plain version.
//
// What bounds them on an H100: bytes, and the latency of each step. At
// B=32 and whisper-base width one layer's K3 reads 4.19 MB of Wq/Wk/Wv/Wo
// and up to 8.78 MB of cache rows (pos 67), ~3.9 us at 3.35 TB/s against
// ~1.1 us of FFMA work at 67 TFLOP/s; K4 reads 8.39 MB of fc1/fc2, ~2.5
// us against ~2.0 us of FFMA work. A multiprocessor pulls ~30 GB/s (its
// plain 16-byte loads; cp.async's copies of the short weight rows here
// came at 3-7 GB/s, PERF.md), so the weights are split over every
// multiprocessor, each byte read by one block once a launch, and each
// block covers every row of the batch:
//
//   * Every block streams its share of the weights -- [rows x 8-column
//     groups] rectangles of the [in, out] matrices, cut into tiles of up
//     to 8 KB -- through a ring of STAGES slots filled by cp.async behind
//     the loads of its input rows, ahead across the kernel's phases. A
//     tile's products run over all the rows held in the input window (the
//     block's K columns of every batch row, layer-normed where the
//     function says, in shared memory): a thread a micro-tile of 4 rows x
//     8 columns in registers, the tile's k split over up to 16 thread
//     groups whose partials are added in group order.
//   * K3 runs on a grid of clusters of two blocks, one block a
//     multiprocessor (66 clusters on an H100: all 132), under a
//     cooperative launch, in phases parted by grid barriers: (1) the
//     q/k/v projections, cluster c taking 8-column groups [c n / NC, (c
//     + 1) n / NC) of the 3 H * 64 columns, rank r the rows [r D / 2, (r
//     + 1) D / 2) of Wq/Wk/Wv; the layer norm's row sums of each half
//     (from registers) added over the pair in rank order, the pair's two
//     partial products added in rank order through distributed shared
//     memory; q to a scratch, k1 / v1 into row pos of the caches; (2) the
//     attention, the B x H (row, head) items split over the blocks:
//     logits a (item, key) pair a thread (its key row in flight while q
//     is staged), the softmax a warp an item, p . V the keys split over
//     the 8 warps added in warp order, + pn v1, into a scratch; (3) the
//     o-projection from that scratch, split as (1) over the D columns and
//     the H * 64 rows of Wo, + bo + x (K3p: the sum alone); with TAIL (4)
//     LN2 of x_out and the Wcq projection, split as (1).
//   * K4 runs on a grid of clusters of eight blocks (15 on an H100) under
//     a cooperative launch. Cluster c takes the 8-column groups [c n / NC,
//     (c + 1) n / NC) of fc1's F columns, its ranks a share each; a block
//     layer-norms every row itself (h staged once a block), projects its
//     fc1 columns (+ b1, GELU) into its shared memory, and after a cluster
//     barrier each rank gathers the cluster's whole u through distributed
//     shared memory (rank order = F order) and projects it onto its D / 8
//     columns of fc2's rows of the cluster: the cluster's fc2 sum, one
//     FFMA chain an element, into a global partial [NC, B, D] (0.98 MB at
//     whisper-base, B=32). One grid barrier, then every block adds the NC
//     partials of its share of the outputs in cluster order, + b2 + x1.
//   * K4-o first runs rowproj_f32_kernel from the same C call: x1 = x +
//     (attn @ Wco + bco) into a float32 buffer that K4 reads as its x, on
//     clusters of two split as K3's o-projection (Wco read once).
// Where the rows do not fit beside the weights' micro-tiles (K4 at B x
// D/8 > 16384), K4 walks the batch in passes, each streaming the block's
// tiles again. Every output element is summed in one fixed order, so a
// launch repeats bit for bit. A launch the card refuses returns its
// error; nothing falls back.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

// Phase stamps: empty here; tools/torch_decoder_f32_stamps.py defines it
// in a copy it builds, to record each block's %globaltimer at the marks.
#ifndef F32_STAMP
#define F32_STAMP(i)
#endif

namespace {

using namespace sm90;

constexpr int NT = 256;        // threads a block (8 warps)
constexpr int HDIM = 64;       // head dim of every Whisper preset
constexpr int F3_CS = 2;       // K3's and the row projection's cluster
constexpr int F4_CS = 8;       // K4's cluster
constexpr int SLOT = 2048;     // floats a ring slot (8 KB)
constexpr int STAGES = 11;     // ring slots
constexpr int HBUF = 16896;    // floats of the input window
constexpr int RED = 16384;     // floats of the partials / the logits
constexpr int MAXB = 256;      // batch rows at most
constexpr int MAXMT = 2;       // 4 x 8 micro-tiles a thread at most
constexpr int IB = 8;          // attention items a batch at most
constexpr int F4_MAX_D = 2048;
// dynamic shared memory of every kernel here: 128 bytes to align, the
// ring, the window, the partials and five row-statistics arrays
constexpr size_t SMEM =
    128 + 4 * ((size_t)STAGES * SLOT + HBUF + RED + 5 * MAXB);

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
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
// a float4 of shared memory (glb false) or, through L2 only, of global
// memory another block may just have written
__device__ __forceinline__ float4 ld4(const float* p, bool glb) {
  return glb ? __ldcg(reinterpret_cast<const float4*>(p))
             : *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// erf-GELU with erf from Abramowitz-Stegun 7.1.26, as gelu_as computes it
__device__ __forceinline__ float gelu_as(float u) {
  const float z = u / 1.41421356237309505f;
  const float az = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-az * az);
  const float erf = z > 0.f ? e : z < 0.f ? -e : 0.f;
  return 0.5f * u * (1.f + erf);
}

// Rows a weight tile of nc columns holds when the input window holds rb
// rows (mirrored by ops/decoder_block.py::f32_tile_rows): what a slot
// takes, and no more than a window row of the rb rows, in multiples of 32
// (of 8 below 32). 0: nc does not fit a slot.
__host__ __device__ inline int tile_rows(int nc, int rb) {
  int t = SLOT / nc;
  const int h = HBUF / rb - 4;
  if (h < t) t = h;
  return t >= 32 ? t / 32 * 32 : t / 8 * 8;
}
// Columns of the input a window holds (a multiple of tr, at most the
// segment's nk rounded up to tr), so that rb rows of ceil32(kw) + 4
// floats fit HBUF.
__device__ __forceinline__ int window_cols(int tr, int rb, int nk) {
  const int cap = (HBUF / rb - 4) / 32 * 32;
  const int kw = cap >= tr ? cap / tr * tr : tr;
  const int full = (nk + tr - 1) / tr * tr;
  return kw < full ? kw : full;
}
// Whether a segment of `groups` 8-column groups split over `parts` blocks
// fits a slot and a thread's MAXMT micro-tiles at rb rows.
__host__ __device__ inline bool seg_fits(int groups, int parts, int rb) {
  const int nc = 8 * ((groups + parts - 1) / parts);
  return tile_rows(nc, rb) >= 8 && rb * nc <= MAXMT * NT * 32;
}

// A block's share of a product's weights: its rows [k0, k0 + nk) of the
// [in, out] matrices and its 8-column groups [g0, g0 + ng) of their
// concatenated columns (group g: matrix m[g / per], columns (g % per) * 8
// ..), streamed in tiles of tr rows ([rows][8 ng] floats in a slot). The
// thread's copy plan, resolved once: the 16-byte chunk jc of every row
// it copies (rows r0, r0 + rstep, ..; none where r0 >= rstep), whose
// source at row k0 is src.
struct Seg {
  const float* src;
  int ldw, g0, ng, k0, nk, tr, jc, r0, rstep;
};
__device__ __forceinline__ int seg_tiles(const Seg& s) {
  return s.ng > 0 && s.nk > 0 ? (s.nk + s.tr - 1) / s.tr : 0;
}
__device__ __forceinline__ Seg make_seg(const float* m0, const float* m1,
                                        const float* m2, int per, int ldw,
                                        int groups, int part, int parts,
                                        int g_off, int k0, int nk, int rb) {
  Seg s;
  s.ldw = ldw;
  s.g0 = part * groups / parts;
  s.ng = (part + 1) * groups / parts - s.g0;
  s.g0 += g_off;
  s.k0 = k0;
  s.nk = nk;
  s.tr = s.ng > 0 ? tile_rows(8 * s.ng, rb) : 8;
  const int cpr = 2 * (s.ng > 0 ? s.ng : 1), t = threadIdx.x;
  s.rstep = NT / cpr;
  s.jc = t % cpr;
  s.r0 = t / cpr;
  const int g = s.g0 + s.jc / 2, mi = g / per;
  s.src = (mi == 0 ? m0 : mi == 1 ? m1 : m2) + (long long)k0 * ldw +
          (g - mi * per) * 8 + (s.jc & 1) * 4;
  return s;
}

// tile t of segment s into a slot: the thread's 16-byte chunks
__device__ __forceinline__ void copy_tile(const Seg& s, int t, float* dst) {
  const int r0 = t * s.tr, rows = min(s.tr, s.nk - r0), nc = 8 * s.ng;
  const float* src = s.src + (long long)r0 * s.ldw;
  for (int r = s.r0; r < rows; r += s.rstep)
    cp_async16(dst + r * nc + 4 * s.jc, src + (long long)r * s.ldw);
}

// The block's weight stream: its segments' tiles in order, `cycles` times
// (K4's passes over the batch), tile u into slot u % STAGES, one commit
// group a tile (an empty one past the end).
struct Stream {
  Seg s0, s1, s2;
  int n0, n1, cyc, total, issued;
  float* ring;
  __device__ void init(int nseg, int cycles, float* r) {
    n0 = seg_tiles(s0);
    n1 = nseg > 1 ? seg_tiles(s1) : 0;
    cyc = n0 + n1 + (nseg > 2 ? seg_tiles(s2) : 0);
    total = cyc * cycles;
    issued = 0;
    ring = r;
  }
  __device__ void fill(int upto) {
    for (; issued < upto; ++issued) {
      if (issued < total) {
        const int j = issued % cyc;
        float* dst = ring + (size_t)(issued % STAGES) * SLOT;
        if (j < n0)
          copy_tile(s0, j, dst);
        else if (j < n0 + n1)
          copy_tile(s1, j - n0, dst);
        else
          copy_tile(s2, j - n0 - n1, dst);
      }
      cp_async_commit();
    }
  }
  // tile u has landed, in every thread's view (the slots of tiles before
  // u are free: every caller meets __syncthreads() after its products)
  __device__ const float* acquire(int u) {
    fill(u + STAGES);
    cp_async_wait_group<STAGES - 1>();
    __syncthreads();
    return ring + (size_t)(u % STAGES) * SLOT;
  }
};

// A thread's share of a product over rb rows and ng column groups: the
// micro-tiles (rows rq + a rb / 4 for a < 4, columns 8 cg ..) and, where
// the block has more threads than micro-tiles, its k group ks of KS (up
// to 16).
struct Roles {
  int KS, ks, rq[MAXMT], cg[MAXMT];
  bool act[MAXMT];
};
__device__ __forceinline__ Roles roles(int rb, int ng) {
  Roles o;
  const int nrq = rb / 4, U = nrq * ng, t = threadIdx.x;
  if (U <= NT) {
    const int k = NT / U;
    o.KS = k >= 16 ? 16 : k >= 8 ? 8 : k >= 4 ? 4 : k >= 2 ? 2 : 1;
    o.ks = t / U;
    const int mt = t - o.ks * U;
    o.act[0] = o.ks < o.KS;
    o.rq[0] = mt % nrq;
    o.cg[0] = mt / nrq;
    o.act[1] = false;
    o.rq[1] = o.cg[1] = 0;
  } else {
    o.KS = 1;
    o.ks = 0;
#pragma unroll
    for (int j = 0; j < MAXMT; ++j) {
      const int mt = t + j * NT;
      o.act[j] = mt < U;
      o.rq[j] = mt % nrq;
      o.cg[j] = mt / nrq;
    }
  }
  return o;
}

// acc += the tile's products: rows (from the window, row stride ldh) x
// the tile's nc columns over its `rows` k, k quads ks, ks + KS, .. in
// order
__device__ __forceinline__ void tile_fma(float (&acc)[MAXMT][4][8],
                                         const Roles& ro, const float* w,
                                         int nc, const float* h, int ldh,
                                         int nrq, int rows) {
  const int nq = rows >> 2;
#pragma unroll
  for (int j = 0; j < MAXMT; ++j) {
    if (!ro.act[j]) continue;
    const float* hp = h + ro.rq[j] * ldh;
    const float* wp = w + 8 * ro.cg[j];
    for (int q = ro.ks; q < nq; q += ro.KS) {
      float4 hv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        hv[a] = *reinterpret_cast<const float4*>(hp + a * nrq * ldh + 4 * q);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wa =
            *reinterpret_cast<const float4*>(wp + (4 * q + kk) * nc);
        const float4 wb =
            *reinterpret_cast<const float4*>(wp + (4 * q + kk) * nc + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float hk = comp(hv[a], kk);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[j][a][e] = fmaf(hk, wv[e], acc[j][a][e]);
        }
      }
    }
  }
}

// Where a product's input window lies: kw columns a window (a multiple
// of the tile rows), ldh floats a row (ldh % 32 == 4), and whether the
// window already holds all the segment's columns (full, as ln_rows can
// leave it).
struct Win {
  int kw, ldh;
  bool full;
};
__device__ __forceinline__ Win window_of(const Seg& s, int rb) {
  Win w;
  w.kw = window_cols(s.tr, rb, s.nk);
  w.ldh = (w.kw + 31) / 32 * 32 + 4;
  w.full = false;
  return w;
}

// The block's product over segment s (stream tiles u ..): for rows [0,
// rb) of the window and the segment's 8 ng columns, the sum over its nk
// rows in tile order, left in red[0 .. rb * 8 ng) ([rb][8 ng]). Unless
// wi.full, load(w0, kn, ldh) fills the window with the input's columns
// [w0, w0 + kn) of the segment's rows and meets __syncthreads(); pre()
// runs before red is written (K4: a cluster barrier, so the ranks have
// read the partners' u). With ng == 0 the block has nothing to add.
template <class Load, class Pre>
__device__ void seg_product(Stream& st, int& u, const Seg& s, int rb,
                            const Win& wi, float* hbuf, float* red,
                            Load load, Pre pre) {
  if (s.ng == 0) {
    pre();
    return;
  }
  const int nc = 8 * s.ng, nrq = rb / 4;
  const Roles ro = roles(rb, s.ng);
  float acc[MAXMT][4][8];
#pragma unroll
  for (int j = 0; j < MAXMT; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][a][e] = 0.f;
  const int kw = wi.full ? s.nk : wi.kw;
  for (int w0 = 0; w0 < s.nk; w0 += kw) {
    const int kn = min(kw, s.nk - w0);
    if (!wi.full) load(w0, kn, wi.ldh);
    for (int t0 = w0; t0 < w0 + kn; t0 += s.tr, ++u) {
      const float* w = st.acquire(u);
      F32_STAMP(14)
      tile_fma(acc, ro, w, nc, hbuf + (t0 - w0), wi.ldh, nrq,
               min(s.tr, s.nk - t0));
      __syncthreads();
    }
  }
  F32_STAMP(15)
  pre();
  // the k groups' partials, then added in group order into red[0]
#pragma unroll
  for (int j = 0; j < MAXMT; ++j) {
    if (!ro.act[j]) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* d = red + (size_t)(ro.ks * rb + ro.rq[j] + a * nrq) * nc +
                 8 * ro.cg[j];
      *reinterpret_cast<float4*>(d) =
          make_float4(acc[j][a][0], acc[j][a][1], acc[j][a][2], acc[j][a][3]);
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(acc[j][a][4], acc[j][a][5], acc[j][a][6], acc[j][a][7]);
    }
  }
  __syncthreads();
  if (ro.KS > 1) {
    const int n4 = rb * nc / 4;
    for (int i = threadIdx.x; i < n4; i += NT) {
      float4 v = reinterpret_cast<const float4*>(red)[i];
      for (int k = 1; k < ro.KS; ++k) {
        const float4 p =
            reinterpret_cast<const float4*>(red + (size_t)k * rb * nc)[i];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      reinterpret_cast<float4*>(red)[i] = v;
    }
  }
  __syncthreads();
}

// hbuf[r * ldh + j] = src[r * ld + j] for r < rb, j < kn (rows >= nrows:
// 0), through L2, eight 16-byte loads in flight a thread
__device__ void load_rows(float* hbuf, int ldh, const float* src,
                          long long ld, int nrows, int rb, int kn) {
  const int q4 = kn / 4, n = rb * q4;
  if (n == 0) return;
  // the thread's float4 i = (r, c), stepped by NT without a division
  const int dr = NT / q4, dc = NT - dr * q4;
  int r = threadIdx.x / q4, c = threadIdx.x - r * q4;
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * NT) {
    float4 v[8];
    int at[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in = i0 + k * NT < n;
      at[k] = r * ldh + 4 * c;
      v[k] = in && r < nrows
                 ? __ldcg(reinterpret_cast<const float4*>(src + r * ld) + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      r += dr;
      c += dc;
      if (c >= q4) {
        c -= q4;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k * NT < n) *reinterpret_cast<float4*>(hbuf + at[k]) = v[k];
  }
}

// The layer norm of the window's rows r < nrows in place, columns [0,
// kn) of a row: (v - mu[r]) * rs[r] * g[j] + b[j] (g, b: the window's
// first column's)
__device__ void ln_apply(float* hbuf, int ldh, int nrows, int kn,
                         const float* g, const float* b, const float* mu,
                         const float* rs) {
  const int q4 = kn / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < nrows * q4; i += NT) {
    const int r = i / q4, c = 4 * (i - r * q4);
    float4* p = reinterpret_cast<float4*>(hbuf + r * ldh + c);
    const float4 v = *p, gg = ldg4(g + c), bb = ldg4(b + c);
    const float m = mu[r], s = rs[r];
    *p = make_float4((v.x - m) * s * gg.x + bb.x, (v.y - m) * s * gg.y + bb.y,
                     (v.z - m) * s * gg.z + bb.z, (v.w - m) * s * gg.w + bb.w);
  }
}

// sum over the cluster's ranks k < csk of their p[r], in rank order:
// every rank's value loaded at once (a remote load takes ~1 us on an H100
// when the partner's shared memory is busy), then added
__device__ __forceinline__ float xch_sum(cg::cluster_group& cl, int csk,
                                         float* p, int r) {
  const int me = csk > 1 ? (int)cl.block_rank() : 0;
  float v[F3_CS];
#pragma unroll
  for (int k = 0; k < F3_CS; ++k)
    v[k] = k < csk ? (k == me ? p : cl.map_shared_rank(p, k))[r] : 0.f;
  float t = v[0];
#pragma unroll
  for (int k = 1; k < F3_CS; ++k)
    if (k < csk) t += v[k];
  return t;
}

// Row statistics of a layer norm over D columns, for rows r < rb (rows >=
// nrows: 0): the block holds nk columns of row r at base + r * ld (shared
// memory, or global memory through L2 when glb), and the cluster's ranks
// k < csk hold the row's D between them. A row's nk columns are cut in P
// = NT / rb interleaved pieces (at most 16; piece p the float4s p, p + P,
// ..), a thread a piece, the pieces' sums added in order, then the ranks'
// in rank order. st: the pieces' sums, the row sums of the two passes,
// mu and 1 / sqrt(var + eps), MAXB floats each.
__device__ void ln_stats(cg::cluster_group& cl, int csk, const float* base,
                         long long ld, bool glb, int rb, int nrows, int nk,
                         int D, float eps, float* st) {
  float* ps = st;
  float* mu = st + 3 * MAXB;
  float* rs = st + 4 * MAXB;
  int P = NT / rb;
  P = P >= 16 ? 16 : P >= 8 ? 8 : P >= 4 ? 4 : P >= 2 ? 2 : 1;
  for (int pass = 0; pass < 2; ++pass) {
    float* rp = st + (1 + pass) * MAXB;
    for (int i = threadIdx.x; i < rb * P; i += NT) {
      const int r = i / P;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < nrows) {
        const float* p = base + r * ld;
        const float m = pass ? mu[r] : 0.f;
#pragma unroll 4
        for (int k = 4 * (i - r * P); k < nk; k += 4 * P) {
          const float4 x = ld4(p + k, glb);
          if (pass) {
            v[0] = fmaf(x.x - m, x.x - m, v[0]);
            v[1] = fmaf(x.y - m, x.y - m, v[1]);
            v[2] = fmaf(x.z - m, x.z - m, v[2]);
            v[3] = fmaf(x.w - m, x.w - m, v[3]);
          } else {
            v[0] += x.x;
            v[1] += x.y;
            v[2] += x.z;
            v[3] += x.w;
          }
        }
      }
      ps[i] = (v[0] + v[1]) + (v[2] + v[3]);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rb; r += NT) {
      float t = 0.f;
      for (int k = 0; k < P; ++k) t += ps[r * P + k];
      rp[r] = t;
    }
    if (csk > 1)
      cl.sync();
    else
      __syncthreads();
    for (int r = threadIdx.x; r < rb; r += NT) {
      const float t = xch_sum(cl, csk, rp, r);
      if (pass)
        rs[r] = 1.f / sqrtf(t / D + eps);
      else
        mu[r] = t / D;
    }
    __syncthreads();
  }
}

// The input of a layer-normed product of segment s at rows [0, rb) of src
// ([*, ld], its first column at src; nrows real rows of D columns, the
// cluster's ranks k < csk holding its columns between them), the columns
// normed by
// (g, beta): where the segment's columns of the rb rows fit one window
// they are read once (in registers, ln_regs, up to 32 rows of 512
// columns; else into the window, the statistics taken in shared memory)
// and normed in place (Win.full); else the statistics are read through
// L2 and each window normed as it is loaded (LnIn). The ring is filled
// ahead behind the rows' loads. Returns the window.
struct LnIn {
  const float *src, *g, *beta, *mu, *rs;
  long long ld;
  int nrows, rb, k0;
  float* hbuf;
  __device__ void operator()(int w0, int kn, int ldh) const {
    load_rows(hbuf, ldh, src + k0 + w0, ld, nrows, rb, kn);
    __syncthreads();
    ln_apply(hbuf, ldh, nrows, kn, g + k0 + w0, beta + k0 + w0, mu, rs);
    __syncthreads();
  }
};
// The layer norm in registers, for rb <= 32 rows and nk <= 512 columns
// (LN_R rows a warp: w, w + 8, ..; LN_C float4s a lane: l, l + 32, ..):
// the rows read once, the sums taken from registers (each row's lanes
// in order, then a warp's xor tree, then the ranks k < csk in order),
// and the normed rows written to the window (rows >= nrows: 0). The ring
// is filled to tile `fill` behind the rows' loads.
constexpr int LN_R = 4, LN_C = 4;
__device__ void ln_regs(cg::cluster_group& cl, int csk, Stream& st, int fill,
                        const float* src, long long ld, int k0, int nk,
                        int rb, int nrows, int D, const float* g,
                        const float* beta, float eps, float* hbuf, int ldh,
                        float* stat) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 v[LN_R][LN_C];
#pragma unroll
  for (int j = 0; j < LN_R; ++j)
#pragma unroll
    for (int m = 0; m < LN_C; ++m) {
      const int r = warp + 8 * j, c = 4 * (lane + 32 * m);
      v[j][m] = r < nrows && c < nk
                    ? __ldcg(reinterpret_cast<const float4*>(
                          src + r * ld + k0 + c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  st.fill(fill);
  float mu[LN_R], rs[LN_R];
  for (int pass = 0; pass < 2; ++pass) {
    float* rp = stat + (1 + pass) * MAXB;
#pragma unroll
    for (int j = 0; j < LN_R; ++j) {
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < LN_C; ++m) {
        const float4 x = v[j][m];
        if (4 * (lane + 32 * m) >= nk) continue;
        if (pass) {
          const float a = x.x - mu[j], b = x.y - mu[j];
          const float c = x.z - mu[j], d = x.w - mu[j];
          t = fmaf(a, a, t);
          t = fmaf(b, b, t);
          t = fmaf(c, c, t);
          t = fmaf(d, d, t);
        } else {
          t += (x.x + x.y) + (x.z + x.w);
        }
      }
      t = warp_sum(t);
      const int r = warp + 8 * j;
      if (lane == 0 && r < rb) rp[r] = t;
    }
    if (csk > 1)
      cl.sync();
    else
      __syncthreads();
    float* ms = stat + (3 + pass) * MAXB;  // mu, then 1 / sqrt(var + eps)
    for (int r = threadIdx.x; r < rb; r += NT) {
      const float t = xch_sum(cl, csk, rp, r);
      ms[r] = pass ? 1.f / sqrtf(t / D + eps) : t / D;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < LN_R; ++j) {
      const int r = min(warp + 8 * j, rb - 1);
      if (pass)
        rs[j] = ms[r];
      else
        mu[j] = ms[r];
    }
  }
#pragma unroll
  for (int m = 0; m < LN_C; ++m) {
    const int c = 4 * (lane + 32 * m);
    if (c >= nk) continue;
    const float4 gg = ldg4(g + k0 + c), bb = ldg4(beta + k0 + c);
#pragma unroll
    for (int j = 0; j < LN_R; ++j) {
      const int r = warp + 8 * j;
      if (r >= rb) continue;
      const float4 x = v[j][m];
      const float mm = mu[j], ss = rs[j];
      *reinterpret_cast<float4*>(hbuf + r * ldh + c) =
          r < nrows ? make_float4((x.x - mm) * ss * gg.x + bb.x,
                                  (x.y - mm) * ss * gg.y + bb.y,
                                  (x.z - mm) * ss * gg.z + bb.z,
                                  (x.w - mm) * ss * gg.w + bb.w)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
}

__device__ Win ln_rows(cg::cluster_group& cl, int csk, Stream& st, int u,
                       const Seg& s, const float* src, long long ld, int rb,
                       int nrows, int D, const float* g, const float* beta,
                       float eps, float* hbuf, float* stat, LnIn& in) {
  in = LnIn{src, g, beta, stat + 3 * MAXB, stat + 4 * MAXB, ld, nrows, rb,
            s.k0, hbuf};
  Win wi = window_of(s, rb);
  const int fill = u + STAGES;
  if (wi.kw >= s.nk && rb <= 8 * LN_R && s.nk <= 128 * LN_C) {
    wi.full = true;
    F32_STAMP(12)
    ln_regs(cl, csk, st, fill, src, ld, s.k0, s.nk, rb, nrows, D, g, beta,
            eps, hbuf, wi.ldh, stat);
    F32_STAMP(13)
  } else if (wi.kw >= s.nk) {
    wi.full = true;
    load_rows(hbuf, wi.ldh, src + s.k0, ld, nrows, rb, s.nk);
    __syncthreads();
    F32_STAMP(12)
    ln_stats(cl, csk, hbuf, wi.ldh, false, rb, nrows, s.nk, D, eps, stat);
    F32_STAMP(13)
    st.fill(fill);
    ln_apply(hbuf, wi.ldh, nrows, s.nk, g + s.k0, beta + s.k0, in.mu,
             in.rs);
    __syncthreads();
  } else {
    F32_STAMP(12)
    ln_stats(cl, csk, src + s.k0, ld, true, rb, nrows, s.nk, D, eps, stat);
    F32_STAMP(13)
    st.fill(fill);
  }
  return wi;
}

// The plain product of segment s at rows [0, rb) of src ([*, ld], the
// rows' first column at src; nrows real rows).
__device__ void plain_product(Stream& st, int& u, const Seg& s,
                              const float* src, long long ld, int rb,
                              int nrows, float* hbuf, float* red) {
  seg_product(
      st, u, s, rb, window_of(s, rb), hbuf, red,
      [&](int w0, int kn, int lh) {
        load_rows(hbuf, lh, src + s.k0 + w0, ld, nrows, rb, kn);
        __syncthreads();
      },
      [] {});
}

// The pair's two partials of a [B][nc] product added in rank order, then
// out(row, column, values) four columns at a time, the B * nc / 4 float4s
// split over the two ranks (nc % 8 == 0).
template <class Out>
__device__ void pair_out(cg::cluster_group& cl, float* red, int B, int nc,
                         Out out) {
  cl.sync();
  if (nc == 0) return;
  const int rank = (int)cl.block_rank(), n = B * nc / 4, q4 = nc / 4;
  const float4* own = reinterpret_cast<const float4*>(red);
  const float4* peer =
      reinterpret_cast<const float4*>(cl.map_shared_rank(red, rank ^ 1));
  for (int i = rank * n / 2 + threadIdx.x; i < (rank + 1) * n / 2; i += NT) {
    const float4 a = own[i], b = peer[i];
    const float4 v =
        rank == 0 ? make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w)
                  : make_float4(b.x + a.x, b.y + a.y, b.z + a.z, b.w + a.w);
    out(i / q4, 4 * (i % q4), v);
  }
}

// All G blocks meet here (they are co-resident: the launch is
// cooperative). *c counts arrivals: one thread a block arrives with
// release semantics at GPU scope (after the block's barrier, so its
// threads' stores go first) and spins on acquiring loads.
__device__ __forceinline__ void grid_sync(int* c, int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(c)
                 : "memory");
    int v;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(c)
                   : "memory");
    } while (v < n);
  }
  __syncthreads();
}

// The last block out leaves the counters bar[0..3] zero: every block has
// passed every barrier when it takes its ticket (bar[3]).
__device__ __forceinline__ void leave(int* bar, int G) {
  if (threadIdx.x == 0 && atomicAdd(bar + 3, 1) == G - 1) {
    bar[0] = 0;
    bar[1] = 0;
    bar[2] = 0;
    bar[3] = 0;
  }
}

__device__ __forceinline__ float* smem_base(unsigned char* raw) {
  return reinterpret_cast<float*>(raw + ((128 - (smem_u32(raw) & 127)) & 127));
}

// K3 / K3-q, float32. D is the model width (x, the layer norm, the rows
// of Wq/Wk/Wv, the columns of Wo) and HL = H * 64 the width of the
// block's heads (the columns of Wq/Wk/Wv, the rows of Wo, the caches'
// rows); every weight matrix row-major ([in, out]). K3 and K3-q have D =
// HL; K3p (PARTIAL) is a rank's head shard of the mesh's model axis and
// writes the float32 o-projection sum to xout without x and bo. qa:
// scratch [2, B, HL] (q, then the attention output); bar: four zeroed
// ints, left zero.
template <bool TAIL, bool PARTIAL = false>
__global__ void __launch_bounds__(NT, 1) self_block_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ wq,
    const float* __restrict__ bq, const float* __restrict__ wk,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ g2, const float* __restrict__ b2,
    const float* __restrict__ wcq, const float* __restrict__ bcq, float* kc,
    float* vc, float* xout, float* __restrict__ qcross, float* qa, int* bar,
    int B, int D, int H, int L, int pos, float scale, float eps) {
  static_assert(!(TAIL && PARTIAL), "K3p has no tail");
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int HL = H * HDIM, G = gridDim.x, bid = blockIdx.x;
  const int rank = (int)cl.block_rank(), c = bid / F3_CS, NC = G / F3_CS;
  const int Bp = (B + 3) / 4 * 4;
  float* ring = smem_base(smem_raw);
  float* hbuf = ring + (size_t)STAGES * SLOT;
  float* red = hbuf + HBUF;
  float* stat = red + RED;
  float* qs = qa;
  float* as = qa + (size_t)B * HL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the weight stream: q/k/v (cluster c's groups of the 3 HL columns,
  // rank r's half of the D rows), Wo (c's groups of the D columns, r's
  // half of the HL rows), with TAIL Wcq (as Wo, r's half of the D rows)
  F32_STAMP(0)
  Stream st;
  st.s0 = make_seg(wq, wk, wv, HL / 8, HL, 3 * HL / 8, c, NC, 0,
                   rank * D / 2, D / 2, Bp);
  st.s1 = make_seg(wo, wo, wo, D / 8, D, D / 8, c, NC, 0, rank * HL / 2,
                   HL / 2, Bp);
  st.s2 = make_seg(wcq, wcq, wcq, D / 8, D, D / 8, c, NC, 0, rank * D / 2,
                   D / 2, Bp);
  st.init(TAIL ? 3 : 2, 1, ring);
  int u = 0;

  // 1. q, k1, v1 of every row: LN(x) over the pair's halves of D
  {
    LnIn in;
    const Win wi = ln_rows(cl, F3_CS, st, u, st.s0, x, D, Bp, B,
                           D, g1, b1, eps, hbuf, stat, in);
    seg_product(st, u, st.s0, Bp, wi, hbuf, red, in, [] {});
  }
  F32_STAMP(1)
  {
    const Seg& s = st.s0;
    pair_out(cl, red, B, 8 * s.ng, [&](int b, int col, float4 v) {
      const int gc = s.g0 * 8 + col, m = gc / HL, cc = gc - m * HL;
      if (m == 0) {
        const float4 bb = ldg4(bq + cc);
        v = make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
      } else if (m == 2) {
        const float4 bb = ldg4(bv + cc);
        v = make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
      }
      float* dst = m == 0 ? qs + (long long)b * HL + cc
                          : (m == 1 ? kc : vc) +
                                ((long long)b * L + pos) * HL + cc;
      *reinterpret_cast<float4*>(dst) = v;
    });
  }
  F32_STAMP(2)
  grid_sync(bar, G);
  F32_STAMP(3)

  // 2. the attention, the B x H (row, head) items split over the blocks,
  // at most IB (and RED / L) a batch: logits a (item, key) pair a thread,
  // the softmax with the fresh row in closed form a warp an item, p . V
  // warp w the keys [w kpw, (w + 1) kpw), lane l the columns 2l, 2l + 1,
  // the warps' partials added in warp order, then pn * v1
  {
    const int nI = B * H;
    const int i0 = (int)((long long)bid * nI / G);
    const int i1 = (int)((long long)(bid + 1) * nI / G);
    const int nb = min(IB, RED / L);
    float* sQ = hbuf;
    float* sK = sQ + IB * HDIM;
    float* sV = sK + IB * HDIM;
    float* sPn = sV + IB * HDIM;
    float* sS = red;
    for (int ib = i0; ib < i1; ib += nb) {
      const int ni = min(nb, i1 - ib);
      // the thread's first (item, key) pair's key row is in flight
      // while q, k1 and v1 are staged
      const int npair = ni * pos;
      float4 kv[16];
      auto load_key = [&](int i) {
        const int r = i / pos, t = i - r * pos, it = ib + r, b = it / H;
        const float* kr =
            kc + ((long long)b * L + t) * HL + (it - b * H) * HDIM;
#pragma unroll
        for (int w = 0; w < 16; ++w) kv[w] = ldg4(kr + 4 * w);
      };
      if (tid < npair) load_key(tid);
      for (int e = tid; e < ni * HDIM; e += NT) {
        const int it = ib + e / HDIM, b = it / H;
        const long long col = (it - b * H) * HDIM + e % HDIM;
        sQ[e] = __ldcg(qs + (long long)b * HL + col);
        sK[e] = __ldcg(kc + ((long long)b * L + pos) * HL + col);
        sV[e] = __ldcg(vc + ((long long)b * L + pos) * HL + col);
      }
      __syncthreads();
      for (int i = tid; i < npair; i += NT) {
        if (i != tid) load_key(i);
        const int r = i / pos, t = i - r * pos;
        const float* q = sQ + r * HDIM;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 16; ++w) {
          s = fmaf(q[4 * w], kv[w].x, s);
          s = fmaf(q[4 * w + 1], kv[w].y, s);
          s = fmaf(q[4 * w + 2], kv[w].z, s);
          s = fmaf(q[4 * w + 3], kv[w].w, s);
        }
        sS[r * L + t] = s * scale;
      }
      __syncthreads();
      for (int r = warp; r < ni; r += NT / 32) {
        float* p = sS + r * L;
        const float* q = sQ + r * HDIM;
        const float* k1 = sK + r * HDIM;
        float mx = -INFINITY;
        for (int t = lane; t < pos; t += 32) mx = fmaxf(mx, p[t]);
        const float l_new =
            warp_sum(q[lane] * k1[lane] + q[lane + 32] * k1[lane + 32]) *
            scale;
        mx = fmaxf(warp_max(mx), l_new);
        float sum = 0.f;
        for (int t = lane; t < pos; t += 32) {
          const float e = expf(p[t] - mx);
          p[t] = e;
          sum += e;
        }
        const float pn = expf(l_new - mx);
        const float denom = warp_sum(sum) + pn;
        for (int t = lane; t < pos; t += 32) p[t] = p[t] / denom;
        if (lane == 0) sPn[r] = pn / denom;
      }
      __syncthreads();
      const int kpw = (pos + 7) / 8, ta = warp * kpw;
      const int tb = min(pos, ta + kpw);
      float a[IB][2];
#pragma unroll
      for (int r = 0; r < IB; ++r) {
        a[r][0] = a[r][1] = 0.f;
        if (r >= ni) continue;
        const int it = ib + r, b = it / H;
        const float* vr =
            vc + (long long)b * L * HL + (it - b * H) * HDIM + 2 * lane;
        const float* pr = sS + r * L;
        for (int t = ta; t < tb; t += 8) {
          float2 w8[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            w8[k] = __ldg(reinterpret_cast<const float2*>(
                vr + (long long)min(t + k, tb - 1) * HL));
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float p = t + k < tb ? pr[t + k] : 0.f;
            a[r][0] = fmaf(p, w8[k].x, a[r][0]);
            a[r][1] = fmaf(p, w8[k].y, a[r][1]);
          }
        }
      }
      __syncthreads();  // every warp is done with the logits
#pragma unroll
      for (int r = 0; r < IB; ++r)
        if (r < ni)
          *reinterpret_cast<float2*>(red + (warp * ni + r) * HDIM +
                                     2 * lane) = make_float2(a[r][0], a[r][1]);
      __syncthreads();
      for (int e = tid; e < ni * HDIM; e += NT) {
        const int r = e / HDIM, d = e % HDIM, it = ib + r, b = it / H;
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) o += red[(w * ni + r) * HDIM + d];
        o += sPn[r] * sV[e];
        as[(long long)b * HL + (it - b * H) * HDIM + d] = o;
      }
      __syncthreads();
    }
  }
  F32_STAMP(4)
  grid_sync(bar + 1, G);
  F32_STAMP(5)

  // 3. the o-projection of the attention output (+ bo + x; K3p the sum)
  plain_product(st, u, st.s1, as, HL, Bp, B, hbuf, red);
  F32_STAMP(6)
  {
    const Seg& s = st.s1;
    pair_out(cl, red, B, 8 * s.ng, [&](int b, int col, float4 v) {
      const int n = s.g0 * 8 + col;
      const long long gi = (long long)b * D + n;
      if (!PARTIAL) {
        const float4 xx = ldg4(x + gi), bb = ldg4(bo + n);
        v = make_float4(xx.x + (v.x + bb.x), xx.y + (v.y + bb.y),
                        xx.z + (v.z + bb.z), xx.w + (v.w + bb.w));
      }
      *reinterpret_cast<float4*>(xout + gi) = v;
    });
  }
  F32_STAMP(7)
  if (TAIL) {
    // 4. K3-q's tail: q_cross = LN2(x_out) @ Wcq + bcq
    grid_sync(bar + 2, G);
    F32_STAMP(8)
    {
      LnIn in;
      const Win wi = ln_rows(cl, F3_CS, st, u, st.s2, xout, D,
                             Bp, B, D, g2, b2, eps, hbuf, stat, in);
      seg_product(st, u, st.s2, Bp, wi, hbuf, red, in, [] {});
    }
    F32_STAMP(9)
    const Seg& s = st.s2;
    pair_out(cl, red, B, 8 * s.ng, [&](int b, int col, float4 v) {
      const int n = s.g0 * 8 + col;
      const float4 bb = ldg4(bcq + n);
      *reinterpret_cast<float4*>(qcross + (long long)b * D + n) =
          make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
    });
  }
  cl.sync();  // the partner has read this block's partials
  F32_STAMP(10)
  leave(bar, G);
}

// K4-o's head: x1 = x + (attn @ W + bias), float32, on clusters of two:
// cluster c the 8-column groups [c n / NC, (c + 1) n / NC) of the D
// columns, rank r the rows [r D / 2, (r + 1) D / 2) of W (each byte read
// once), the pair's partials added in rank order.
__global__ void __launch_bounds__(NT, 1) rowproj_f32_kernel(
    const float* __restrict__ attn, const float* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ x,
    float* __restrict__ x1, int B, int D) {
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), c = blockIdx.x / F3_CS;
  const int NC = gridDim.x / F3_CS, Bp = (B + 3) / 4 * 4;
  float* ring = smem_base(smem_raw);
  float* hbuf = ring + (size_t)STAGES * SLOT;
  float* red = hbuf + HBUF;
  Stream st;
  st.s0 = make_seg(W, W, W, D / 8, D, D / 8, c, NC, 0, rank * D / 2, D / 2,
                   Bp);
  st.init(1, 1, ring);
  st.fill(STAGES);
  int u = 0;
  plain_product(st, u, st.s0, attn, D, Bp, B, hbuf, red);
  const Seg& s = st.s0;
  pair_out(cl, red, B, 8 * s.ng, [&](int b, int col, float4 v) {
    const int n = s.g0 * 8 + col;
    const long long gi = (long long)b * D + n;
    const float4 xx = ldg4(x + gi), bb = ldg4(bias + n);
    *reinterpret_cast<float4*>(x1 + gi) =
        make_float4(xx.x + (v.x + bb.x), xx.y + (v.y + bb.y),
                    xx.z + (v.z + bb.z), xx.w + (v.w + bb.w));
  });
  cl.sync();
}

// K4's float32 form (see the file's head). x: [B, D] (K4-o: x1 from
// rowproj_f32_kernel); part: [NC, B, D] scratch, NC = gridDim.x / 8; bar:
// four zeroed ints, left zero; RB: rows a pass (a multiple of 4).
// PARTIAL (K4p, a rank's F columns of fc1 and rows of fc2): out = the
// float32 fc2 sum without x and b2.
template <bool PARTIAL = false>
__global__ void __launch_bounds__(NT, 1) mlp_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ bln, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* part, int* bar,
    float* __restrict__ out, int B, int D, int F, int RB, float eps) {
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int G = gridDim.x, NC = G / F4_CS, c = blockIdx.x / F4_CS;
  const int rank = (int)cl.block_rank();
  const int Bp = (B + 3) / 4 * 4, npass = (Bp + RB - 1) / RB;
  float* ring = smem_base(smem_raw);
  float* hbuf = ring + (size_t)STAGES * SLOT;
  float* red = hbuf + HBUF;
  float* stat = red + RED;
  // the cluster's groups [cf0, cf0 + ncg) of the F / 8; rank r's share of
  // them for fc1 (every row of D), and the rank's D / 8 / 8 groups of
  // fc2's columns over the cluster's F rows
  const int ngF = F / 8;
  const int cf0 = c * ngF / NC, ncg = (c + 1) * ngF / NC - cf0;
  F32_STAMP(0)
  Stream st;
  st.s0 = make_seg(w1, w1, w1, ngF, F, ncg, rank, F4_CS, cf0, 0, D, RB);
  st.s1 = make_seg(w2, w2, w2, D / 8, D, D / 8, rank, F4_CS, 0, cf0 * 8,
                   ncg * 8, RB);
  st.init(2, npass, ring);
  int u = 0;
  const Seg& s1 = st.s0;
  const Seg& s2 = st.s1;
  const int nc1 = 8 * s1.ng, nc2 = 8 * s2.ng;
  for (int p = 0; p < npass; ++p) {
    const int r0 = p * RB, rb = min(RB, Bp - r0), nrows = min(rb, B - r0);
    // fc1 over the rank's columns, + b1, GELU, left in red [rb][8 ng]
    {
      LnIn in;
      const Win wi = ln_rows(cl, 1, st, u, s1,
                             x + (long long)r0 * D, D, rb, nrows, D, g, bln,
                             eps, hbuf, stat, in);
      seg_product(st, u, s1, rb, wi, hbuf, red, in, [] {});
    }
    F32_STAMP(1)
    for (int i = threadIdx.x; i < rb * nc1; i += NT)
      red[i] = gelu_as(red[i] + b1[s1.g0 * 8 + i % nc1]);
    cl.sync();  // every rank's u is whole
    F32_STAMP(2)
    // fc2 over the cluster's u, gathered a window at a time: column k of
    // the cluster's F range from the rank holding its group
    seg_product(
        st, u, s2, rb, window_of(s2, rb), hbuf, red,
        [&](int w0, int kn, int lh) {
          const int q4 = kn / 4, n = rb * q4;
          for (int i0 = threadIdx.x; i0 < n; i0 += 8 * NT) {
            float4 v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int i = i0 + k * NT, r = i / q4;
              const int col = w0 + 4 * (i - r * q4), gi = col / 8;
              const int q = ((gi + 1) * F4_CS - 1) / ncg;
              const int gq0 = q * ncg / F4_CS;
              const int ncq = 8 * ((q + 1) * ncg / F4_CS - gq0);
              v[k] = i < n ? *reinterpret_cast<const float4*>(
                                 cl.map_shared_rank(red, q) + r * ncq +
                                 (col - 8 * gq0))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int i = i0 + k * NT, r = i / q4;
              if (i < n)
                *reinterpret_cast<float4*>(hbuf + r * lh +
                                           4 * (i - r * q4)) = v[k];
            }
          }
          __syncthreads();
        },
        [&] { cl.sync(); });  // every rank has gathered before red changes
    F32_STAMP(3)
    for (int i = threadIdx.x; i < nrows * nc2 / 4; i += NT) {
      const int r = i / (nc2 / 4), col = 4 * (i - r * (nc2 / 4));
      *reinterpret_cast<float4*>(
          part + ((long long)c * B + r0 + r) * D + s2.g0 * 8 + col) =
          reinterpret_cast<const float4*>(red)[i];
    }
  }
  F32_STAMP(4)
  grid_sync(bar, G);
  F32_STAMP(5)
  // the NC cluster partials of the block's share of the outputs, added in
  // cluster order, + b2 + x (K4p: the sum alone)
  const long long total = (long long)B * D;
  const long long e0 = blockIdx.x * total / G;
  const long long e1 = (blockIdx.x + 1) * total / G;
  for (long long i = e0 + threadIdx.x; i < e1; i += NT) {
    const float s = ordered_sum(part + i, total, NC);
    out[i] = PARTIAL ? s : __ldg(x + i) + (s + b2[i % D]);
  }
  F32_STAMP(6)
  cl.sync();
  F32_STAMP(7)
  leave(bar, G);
}

// A launch of `blocks` blocks in clusters of cs (coop: cooperative, every
// block resident at once) with SMEM bytes of dynamic shared memory.
template <typename... Params, typename... Args>
int launch_grid(bool coop, void (*kernel)(Params...), int blocks, int cs,
                cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 2 : 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (e != cudaSuccess) (void)cudaGetLastError();
  return (int)e;
}

// K3 / K3-q (wcq != NULL) / K3p (PARTIAL) at model width D over the
// block's H heads on `clusters` clusters of two (see
// mas_decoder_self_block_f32 and _partial_f32).
int launch_self_f32(bool partial, const void* x, const void* g1,
                    const void* b1, const void* wq, const void* bq,
                    const void* wk, const void* wv, const void* bv,
                    const void* wo, const void* bo, void* kc, void* vc,
                    void* x_out, const void* g2, const void* b2,
                    const void* wcq, const void* bcq, void* q_cross,
                    void* scratch, void* counter, int B, int D, int H, int L,
                    int pos, int clusters, float scale, float eps,
                    void* stream) {
  const bool tail = wcq != nullptr;
  const int HL = H * HDIM, Bp = (B + 3) / 4 * 4;
  if (B < 1 || B > MAXB || H < 1 || D < HDIM || D % HDIM || L < 1 ||
      L > RED || pos < 0 || pos >= L || clusters < 1 || (tail && partial) ||
      (!partial && D != HL) || !seg_fits(3 * HL / 8, clusters, Bp) ||
      !seg_fits(D / 8, clusters, Bp))
    return (int)cudaErrorInvalidValue;
  auto* kernel = tail      ? &self_block_f32_kernel<true>
                 : partial ? &self_block_f32_kernel<false, true>
                           : &self_block_f32_kernel<false>;
  const int e = launch_grid(
      true, kernel, F3_CS * clusters, F3_CS, (cudaStream_t)stream,
      (const float*)x, (const float*)g1, (const float*)b1, (const float*)wq,
      (const float*)bq, (const float*)wk, (const float*)wv, (const float*)bv,
      (const float*)wo, (const float*)bo, (const float*)g2, (const float*)b2,
      (const float*)wcq, (const float*)bcq, (float*)kc, (float*)vc,
      (float*)x_out, (float*)q_cross, (float*)scratch, (int*)counter, B, D, H,
      L, pos, scale, eps);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K4 / K4-o (wco != NULL) / K4p (PARTIAL): see mas_decoder_mlp_block_f32
// and _partial_f32.
int launch_mlp_f32(bool partial, const void* x, const void* g,
                   const void* bln, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* attn,
                   const void* wco, const void* bco, void* x32, void* part,
                   void* counter, void* out, int B, int D, int F, float eps,
                   int clusters, int rows, int proj_clusters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int Bp = (B + 3) / 4 * 4;
  if (B < 1 || B > MAXB || D < HDIM || D % HDIM || D > F4_MAX_D ||
      F < 16 || F % 16 || clusters < 1 || rows < 4 || rows % 4 ||
      rows > MAXB || (partial && wco != nullptr) ||
      !seg_fits(D / 8, F4_CS, rows))
    return (int)cudaErrorInvalidValue;
  if (!seg_fits((F / 8 + clusters - 1) / clusters, F4_CS, rows))
    return (int)cudaErrorInvalidValue;
  const void* xin = x;
  if (wco != nullptr) {
    if (proj_clusters < 1 || !seg_fits(D / 8, proj_clusters, Bp))
      return (int)cudaErrorInvalidValue;
    const int e = launch_grid(false, &rowproj_f32_kernel,
                              F3_CS * proj_clusters, F3_CS, s,
                              (const float*)attn, (const float*)wco,
                              (const float*)bco, (const float*)x, (float*)x32,
                              B, D);
    if (e != 0) return e;
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return (int)le;
    xin = x32;
  }
  auto* kernel = partial ? &mlp_f32_kernel<true> : &mlp_f32_kernel<false>;
  const int e = launch_grid(true, kernel, F4_CS * clusters, F4_CS, s,
                            (const float*)xin, (const float*)g,
                            (const float*)bln, (const float*)w1,
                            (const float*)b1, (const float*)w2,
                            (const float*)b2, (float*)part, (int*)counter,
                            (float*)out, B, D, F, rows, eps);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

}  // namespace

// Raises every float32 decoder kernel's dynamic shared-memory limit to
// SMEM. Called once a device, when the library is set up on it.
extern "C" int mas_decoder_block_f32_init(void) {
  for (const void* fn : {(const void*)self_block_f32_kernel<false>,
                         (const void*)self_block_f32_kernel<true>,
                         (const void*)self_block_f32_kernel<false, true>,
                         (const void*)mlp_f32_kernel<false>,
                         (const void*)mlp_f32_kernel<true>,
                         (const void*)rowproj_f32_kernel}) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The clusters of cs float32 decoder blocks of smem bytes (the kernels'
// SMEM, ops/decoder_block.py::F32_SMEM) the card holds at once: the plans
// of K3 (cs = 2), K4 (8) and K4-o's row projection (2) ask it. Returns a
// cudaError_t value.
extern "C" int mas_decoder_self_block_f32_fit(int cs, int smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)self_block_f32_kernel<true>, &cfg);
}

// K3 / K3-q, float32. x, x_out, q_cross: [B, D] (D = H * 64); g1, b1, bq,
// bv, bo, g2, b2, bcq: [D]; wq, wk, wv, wo, wcq: [D, D] row-major ([in,
// out]); kc, vc: [B, L, D] caches, row pos written; scratch: [2, B, D]
// float32; counter: >= 4 zeroed ints, left zero. wcq == NULL runs K3 (g2,
// b2, bcq, q_cross unused). The plan (ops/decoder_block.py::
// self_block_f32_plan): `clusters` clusters of two blocks, all resident
// (a cooperative launch). Limits: B <= 256, L <= 16384, each phase's
// columns within a block's slot and micro-tiles (seg_fits). Every pointer
// 16-byte aligned. Returns a cudaError_t value: a shape outside these
// limits, a launch the card refuses, or cudaGetLastError() after the
// launch.
extern "C" int mas_decoder_self_block_f32(
    const void* x, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv,
    const void* wo, const void* bo, void* kc, void* vc, void* x_out,
    const void* g2, const void* b2, const void* wcq, const void* bcq,
    void* q_cross, void* scratch, void* counter, int B, int H, int L, int pos,
    int clusters, float scale, float eps, void* stream) {
  return launch_self_f32(false, x, g1, b1, wq, bq, wk, wv, bv, wo, bo, kc,
                         vc, x_out, g2, b2, wcq, bcq, q_cross, scratch,
                         counter, B, H * HDIM, H, L, pos, clusters, scale,
                         eps, stream);
}

// K3p's float32 form, one rank of the mesh's model axis: out = (K3's
// attention over the rank's H heads, merged) @ wo in float32, without x
// and bo. x: [B, D] (the whole row, read by the layer norm); g1, b1: [D];
// wq, wk, wv: [D, H * 64] and wo: [H * 64, D] row-major (the rank's
// column and row shards); bq, bv: [H * 64]; kc, vc: [B, L, H * 64] caches
// of the rank's heads, row pos written; out: [B, D]; scratch: [2, B, H *
// 64]; all float32. D % 64 == 0; the plan is self_block_f32_plan's at
// width D. Returns a cudaError_t value, as mas_decoder_self_block_f32.
extern "C" int mas_decoder_self_block_partial_f32(
    const void* x, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv,
    const void* wo, void* kc, void* vc, void* out, void* scratch,
    void* counter, int B, int D, int H, int L, int pos, int clusters,
    float scale, float eps, void* stream) {
  return launch_self_f32(true, x, g1, b1, wq, bq, wk, wv, bv, wo, bv, kc, vc,
                         out, nullptr, nullptr, nullptr, nullptr, nullptr,
                         scratch, counter, B, D, H, L, pos, clusters, scale,
                         eps, stream);
}

// K4 / K4-o, float32. x, out: [B, D] (D % 64 == 0, D <= 2048); g, bln,
// b2, bco: [D]; w1: [D, F], w2: [F, D], wco: [D, D] row-major (F % 16 ==
// 0); b1: [F]; attn: [B, D]; x32: [B, D] scratch (K4-o's x1); part:
// [clusters, B, D] scratch; counter: >= 4 zeroed ints, left zero. wco ==
// NULL runs K4 (attn, bco, x32, proj_clusters unused). The plan
// (ops/decoder_block.py::mlp_f32_plan): `clusters` clusters of eight
// blocks, all resident, `rows` batch rows a pass; K4-o's row projection
// on `proj_clusters` clusters of two. Returns the first CUDA error of the
// launches (0 = none).
extern "C" int mas_decoder_mlp_block_f32(
    const void* x, const void* g, const void* bln, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* attn,
    const void* wco, const void* bco, void* x32, void* part, void* counter,
    void* out, int B, int D, int F, float eps, int clusters, int rows,
    int proj_clusters, void* stream) {
  return launch_mlp_f32(false, x, g, bln, w1, b1, w2, b2, attn, wco, bco,
                        x32, part, counter, out, B, D, F, eps, clusters, rows,
                        proj_clusters, stream);
}

// K4p's float32 form, one rank of the mesh's model axis: out = gelu(LN(x)
// @ w1 + b1) @ w2 in float32, without x and b2. x: [B, D] (the whole row,
// read by the layer norm); g, bln: [D]; w1: [D, F] and w2: [F, D]
// row-major (the rank's column and row shards of fc1 and fc2, F % 16 ==
// 0); b1: [F]; part, counter: K4's float32 scratch; out: [B, D]; all
// float32. Returns a cudaError_t value, as mas_decoder_mlp_block_f32.
extern "C" int mas_decoder_mlp_block_partial_f32(
    const void* x, const void* g, const void* bln, const void* w1,
    const void* b1, const void* w2, void* part, void* counter, void* out,
    int B, int D, int F, float eps, int clusters, int rows, void* stream) {
  return launch_mlp_f32(true, x, g, bln, w1, b1, w2, nullptr, nullptr,
                        nullptr, nullptr, nullptr, part, counter, out, B, D,
                        F, eps, clusters, rows, 0, stream);
}
