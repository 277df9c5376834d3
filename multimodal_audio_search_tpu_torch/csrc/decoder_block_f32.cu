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
//     mesh.py::model_sum adds once to the ranks' sum. K3p's cluster sums
//     the D / 64 output chunks over its CS ranks (rank r the chunks [r N /
//     CS, (r + 1) N / CS), which for K3 are its heads' columns).
//
// Every tensor is float32 and every product is a float32 FFMA on the
// CUDA cores: nothing is rounded to bf16 (the plain versions' roundings
// are no-ops at float32) and no product goes through TF32. The erf of
// the GELU is the TPU kernels' Abramowitz-Stegun 7.1.26 polynomial, as in
// the plain version.
//
// What bounds them on an H100: weight bytes. At B=32 and whisper-base
// width one layer's K3 reads 4.19 MB of Wq/Wk/Wv/Wo and up to 8.78 MB of
// cache rows (pos 67), ~3.9 us at 3.35 TB/s against ~1.1 us of FFMA work
// at 67 TFLOP/s; K4 reads 8.39 MB of fc1/fc2, ~2.5 us against ~2.0 us of
// FFMA work. Exact float32 FFMA costs nothing against that, where 3xTF32
// on the tensor cores would round its sums toward zero (tf32x3.cuh).
// One multiprocessor pulls ~30 GB/s, so both kernels split the weights
// over many blocks, as the bf16 forms do:
//   * K3: a thread-block cluster of CS = min(H, 16) blocks
//     (ops/decoder_block.py::self_block_f32_plan) over a tile of up to 8
//     batch rows, rank r taking heads [r H / CS, (r + 1) H / CS). Each
//     block streams its heads' 64 columns of Wq/Wk/Wv and 64 rows of Wo
//     (and with TAIL its heads' 64 columns of Wcq) through a ring of
//     16 KB tiles in shared memory, filled by cp.async from the first
//     instruction on, S - 3 to S tiles ahead of the compute (S <= 8
//     slots). A tile's products take a thread a column and every row of
//     the tile, so no product needs a reduction across threads: q/k/v
//     three tiles at a time (one each), the o-projection three 64-column
//     output chunks at a time. The attention reads the cache rows from
//     device memory: logits a (row, key) pair a thread, the softmax a
//     warp a row, p . V the keys split over the 8 warps, added in warp
//     order. Each block keeps its heads' o-projection partials [rows, D];
//     after a cluster barrier rank r adds the CS partials of its heads'
//     columns in rank order through distributed shared memory, then bias
//     and residual. K3-q's tail: the cross layer norm's row sums go round
//     the cluster, each rank gathers the whole h2 rows and projects its
//     heads' columns onto Wcq, three 64-row chunks at a time, the chunks'
//     three partials added in order.
//   * K4: a block per 16 fc1 columns (a slice) and every row, in 32-row
//     blocks, D in 512-column chunks, under a cooperative launch of
//     min(F / 16, what the card holds) blocks (whisper-base: 128): the
//     layer norm once a row over the grid into a transposed float32 h;
//     a grid barrier; per (slice, row block) the slice's fc1 columns and
//     fc2 rows and h by cp.async, fc1 as 4 x 4 register tiles over 8 k
//     slices (a warp each, added in warp order), + b1, GELU, then the
//     slice's share of fc2 as 4 x 8 tiles into partials [S, B, D]; a
//     second grid barrier; each block sums its share of the outputs over
//     the S partials in slice order and adds b2 and the residual.
//   * K4-o first runs rowproj_f32_kernel from the same C call: x1 = x +
//     (attn @ Wco + bco) into a float32 buffer that K4-o reads as its x,
//     a block per (32 output columns, 4 rows), k split over 64 thread
//     slices added in order.
// Every output element is summed in one fixed order, so a launch repeats
// bit for bit. A launch the card refuses returns its error; nothing
// falls back.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int NT = 256;            // threads a block (8 warps)
constexpr int HDIM = 64;           // head dim of every Whisper preset
constexpr int TILE = HDIM * HDIM;  // floats of a streamed weight tile
constexpr int F3_RT = 8;           // rows of a K3 tile at most
constexpr int F3_MAX_STAGES = 8;   // ring slots
constexpr int F3_MIN_STAGES = 4;   // a group of three tiles and one ahead
constexpr int F3_MAX_CS = 16;      // an H100's largest cluster
// an H100 block's shared memory, less 1 KB for the static arrays
constexpr size_t SMEM_MAX = 232448 - 1024;

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

// Layer norm of one row xr[D] by one warp (D % 4 == 0): float32 mean and
// variance, (x - mu) / sqrt(var + eps) * g + b into out[k * os].
__device__ void ln_row_warp(const float* xr, int D, const float* g,
                            const float* b, float eps, float* out, int os) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane * 4; k < D; k += 128) {
    const float4 v = ldg4(xr + k);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int k = lane * 4; k < D; k += 128) {
    const float4 v = ldg4(xr + k);
    q = fmaf(v.x - mu, v.x - mu, q);
    q = fmaf(v.y - mu, v.y - mu, q);
    q = fmaf(v.z - mu, v.z - mu, q);
    q = fmaf(v.w - mu, v.w - mu, q);
  }
  const float rs = 1.f / sqrtf(warp_sum(q) / D + eps);
  for (int k = lane * 4; k < D; k += 128) {
    const float4 v = ldg4(xr + k), gg = ldg4(g + k), bb = ldg4(b + k);
    out[k * os] = (v.x - mu) * rs * gg.x + bb.x;
    out[(k + 1) * os] = (v.y - mu) * rs * gg.y + bb.y;
    out[(k + 2) * os] = (v.z - mu) * rs * gg.z + bb.z;
    out[(k + 3) * os] = (v.w - mu) * rs * gg.w + bb.w;
  }
}

// acc[r] += sum_{k < 64} in[r * ld + k] * w[k * 64] for the rows r < rt:
// one column of a 64 x 64 tile (w: its first row's element) against the
// rows' 64 input values, in order of k.
__device__ __forceinline__ void rows_tile(float acc[F3_RT], const float* w,
                                          const float* in, int ld, int rt) {
#pragma unroll 4
  for (int k = 0; k < HDIM; k += 4) {
    const float w0 = w[k * HDIM], w1 = w[(k + 1) * HDIM];
    const float w2 = w[(k + 2) * HDIM], w3 = w[(k + 3) * HDIM];
#pragma unroll
    for (int r = 0; r < F3_RT; ++r)
      if (r < rt) {
        const float4 h = *reinterpret_cast<const float4*>(in + r * ld + k);
        acc[r] = fmaf(h.x, w0, acc[r]);
        acc[r] = fmaf(h.y, w1, acc[r]);
        acc[r] = fmaf(h.z, w2, acc[r]);
        acc[r] = fmaf(h.w, w3, acc[r]);
      }
  }
}

// cp.async.wait_group with a run-time count (0 .. F3_MAX_STAGES - 1)
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    case 4: cp_async_wait_group<4>(); break;
    case 5: cp_async_wait_group<5>(); break;
    case 6: cp_async_wait_group<6>(); break;
    default: cp_async_wait_group<7>(); break;
  }
}

// floats of the logits / p . V partials / tail scratch region of a K3
// tile of rt rows
__host__ __device__ inline int f3_scores(int rt, int L) {
  const int n = rt * L > 8 * rt * HDIM ? rt * L : 8 * rt * HDIM;
  return (n + 3) / 4 * 4;
}
// K3's float32 form's shared memory (mirrored by ops/decoder_block.py::
// k3_f32_smem): 128 bytes to align the ring, S ring slots, the o-
// projection partials and h [rt][D], q1 / k1 / v1 / the attention output
// [rt][64], the fresh-row weights [8], the scores region.
inline size_t f3_smem(int D, int L, int S, int rt) {
  return 128 + (size_t)S * TILE * 4 +
         4 * ((size_t)2 * rt * D + (size_t)4 * rt * HDIM + F3_RT +
              f3_scores(rt, L));
}

// K3 / K3-q, float32. D is the model width (x, the layer norm, the rows
// of Wq/Wk/Wv, the columns of Wo) and HL = H * 64 the width of the
// block's heads (the columns of Wq/Wk/Wv, the rows of Wo, the caches'
// rows); every weight matrix row-major ([in, out]). K3 and K3-q have D =
// HL; K3p (PARTIAL) is a rank's head shard of the mesh's model axis and
// writes the float32 o-projection sum to xout without x and bo.
template <bool TAIL, bool PARTIAL = false>
__global__ void __launch_bounds__(NT, 1) self_block_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ wq,
    const float* __restrict__ bq, const float* __restrict__ wk,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ g2, const float* __restrict__ b2,
    const float* __restrict__ wcq, const float* __restrict__ bcq, float* kc,
    float* vc, float* __restrict__ xout, float* __restrict__ qcross, int B,
    int D, int H, int L, int pos, int rt, int S, float scale, float eps) {
  static_assert(!(TAIL && PARTIAL), "K3p has no tail");
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int HL = H * HDIM, nkc = D / HDIM;
  const int rank = blockIdx.x, CS = gridDim.x;  // a cluster spans x
  // the rank's heads [h0, h0 + G)
  const int h0 = rank * H / CS, G = (rank + 1) * H / CS - h0;
  // the rank's output chunks of the head sum, [oc0, oc0 + ocn) of the nkc
  // (K3, K3-q: its heads' columns, the same split)
  const int oc0 = rank * nkc / CS, ocn = (rank + 1) * nkc / CS - oc0;
  const int r0 = blockIdx.y * rt, nrows = min(rt, B - r0);
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  float* sPart = ring + (size_t)S * TILE;  // [rt][D]
  float* sH = sPart + rt * D;              // [rt][D]
  float* sQ = sH + rt * D;                 // [rt][64], and sK, sV, sA
  float* sK = sQ + rt * HDIM;
  float* sV = sK + rt * HDIM;
  float* sA = sV + rt * HDIM;
  float* sPn = sA + rt * HDIM;  // [F3_RT]
  float* sS = sPn + F3_RT;      // logits, then the warps' p . V partials
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a product step's thread: tile m of the step (m < 3), its column c
  const int m = tid >> 6, c = tid & 63;
  const float* kcr = kc + (long long)r0 * L * HL;  // the tile's cache rows
  const float* vcr = vc + (long long)r0 * L * HL;

  // The weight stream, tile u into ring slot u % S: for each head of the
  // rank its nkc q/k/v groups (Wq, Wk, Wv rows 64 kc.. and the head's 64
  // columns) and its nkc Wo tiles (the head's 64 rows, columns 64 n..);
  // with TAIL then, for each head, the nkc Wcq tiles of its 64 columns.
  // One commit group a tile (an empty one past the end).
  const int per_head = 4 * nkc, nheads = G * per_head;
  const int ntiles = nheads + (TAIL ? G * nkc : 0);
  int issued = 0;
  auto fill = [&](int upto) {
    for (; issued < upto; ++issued) {
      const int u = issued;
      if (u < ntiles) {
        const float* src;
        int ld = HL;  // Wq/Wk/Wv: [D, HL]; Wo: [HL, D]; Wcq: [D, D], D = HL
        if (u < nheads) {
          const int j = u % per_head, c0 = (h0 + u / per_head) * HDIM;
          if (j < 3 * nkc) {
            src = (j % 3 == 0 ? wq : j % 3 == 1 ? wk : wv) +
                  (long long)(j / 3) * HDIM * HL + c0;
          } else {
            src = wo + (long long)c0 * D + (j - 3 * nkc) * HDIM;
            ld = D;
          }
        } else {
          const int v = u - nheads;
          src = wcq + (long long)(v % nkc) * HDIM * D +
                (h0 + v / nkc) * HDIM;
        }
        float* dst = ring + (size_t)(u % S) * TILE;
        for (int i = tid; i < TILE / 4; i += NT) {
          const int r = i >> 4, q = (i & 15) * 4;
          cp_async16(dst + r * HDIM + q, src + (long long)r * ld + q);
        }
      }
      cp_async_commit();
    }
  };
  // tiles u0 .. u0 + n - 1 have landed (the slots of tiles before u0
  // are free: every caller meets __syncthreads() after its products)
  auto acquire = [&](int u0, int n) {
    fill(u0 + S);
    wait_pending(S - n);
    __syncthreads();
  };
  auto tile = [&](int u) { return ring + (size_t)(u % S) * TILE; };

  fill(S);  // the stream starts before the layer norm
  // 0. h = LN(x) of the tile's rows, a warp a row; rows past B zero
  for (int r = warp; r < rt; r += NT / 32) {
    if (r < nrows)
      ln_row_warp(x + (long long)(r0 + r) * D, D, g1, b1, eps, sH + r * D, 1);
    else
      for (int k = lane; k < D; k += 32) sH[r * D + k] = 0.f;
  }
  __syncthreads();
  int ti = 0;
  for (int g = 0; g < G; ++g) {
    const int c0 = (h0 + g) * HDIM;
    // 1. q1, k1, v1 of the head: thread (m, c) column c of Wq, Wk or Wv
    // over every row, a k chunk's three tiles a step
    float acc[F3_RT];
#pragma unroll
    for (int r = 0; r < F3_RT; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < nkc; ++k0, ti += 3) {
      acquire(ti, 3);
      if (m < 3) rows_tile(acc, tile(ti + m) + c, sH + k0 * HDIM, D, rt);
      __syncthreads();
    }
    if (m < 3) {
      float* dst = m == 0 ? sQ : m == 1 ? sK : sV;
      const float bias = m == 0 ? bq[c0 + c] : m == 2 ? bv[c0 + c] : 0.f;
#pragma unroll
      for (int r = 0; r < F3_RT; ++r) {
        if (r >= rt) break;
        const float v = m == 1 ? acc[r] : acc[r] + bias;
        dst[r * HDIM + c] = v;
        if (m > 0 && r < nrows)
          (m == 1 ? kc : vc)[((long long)(r0 + r) * L + pos) * HL + c0 + c] =
              v;
      }
    }
    __syncthreads();
    // 2. logits of the cache rows t < pos, a (row, key) pair a thread
    const int npair = nrows * pos;
    for (int i = tid; i < npair; i += NT) {
      const int r = i / pos, t = i - r * pos;
      const float* kr = kcr + ((long long)r * L + t) * HL + c0;
      float4 kv[16];
#pragma unroll
      for (int w = 0; w < 16; ++w) kv[w] = ldg4(kr + 4 * w);
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
    // 3. softmax with the fresh row in closed form, a warp a row
    for (int r = warp; r < nrows; r += NT / 32) {
      float* p = sS + r * L;
      const float* q = sQ + r * HDIM;
      const float* k1 = sK + r * HDIM;
      float mx = -INFINITY;
      for (int t = lane; t < pos; t += 32) mx = fmaxf(mx, p[t]);
      const float l_new =
          warp_sum(q[lane] * k1[lane] + q[lane + 32] * k1[lane + 32]) * scale;
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
    // 4. p . V: warp w the keys [w kpw, (w + 1) kpw) of every row, eight
    // keys' loads in flight at once, lane l the columns 2l, 2l + 1; the
    // warps' partials added in warp order, then the fresh row's pn * v1
    const int kpw = (pos + 7) / 8, ta = warp * kpw;
    const int tb = min(pos, ta + kpw);
    float a[F3_RT][2];
#pragma unroll
    for (int r = 0; r < F3_RT; ++r) {
      a[r][0] = a[r][1] = 0.f;
      if (r >= nrows) continue;
      const float* vr = vcr + (long long)r * L * HL + c0 + 2 * lane;
      const float* pr = sS + r * L;
      for (int t = ta; t < tb; t += 8) {
        float2 w8[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          w8[u] = __ldg(reinterpret_cast<const float2*>(
              vr + (long long)min(t + u, tb - 1) * HL));
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float p = t + u < tb ? pr[t + u] : 0.f;
          a[r][0] = fmaf(p, w8[u].x, a[r][0]);
          a[r][1] = fmaf(p, w8[u].y, a[r][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the logits
    float* red = sS;
#pragma unroll
    for (int r = 0; r < F3_RT; ++r)
      if (r < rt)
        *reinterpret_cast<float2*>(red + (warp * rt + r) * HDIM + 2 * lane) =
            make_float2(a[r][0], a[r][1]);
    __syncthreads();
    for (int i = tid; i < rt * HDIM; i += NT) {
      const int r = i / HDIM, d = i % HDIM;
      float o = 0.f;
      if (r < nrows) {
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) o += red[(w * rt + r) * HDIM + d];
        o += sPn[r] * sV[r * HDIM + d];
      }
      sA[r * HDIM + d] = o;
    }
    __syncthreads();  // sA is whole
    // 5. the head's share of the o-projection into sPart (the rank's
    // heads added in order), three 64-column output chunks a step
    for (int n0 = 0; n0 < nkc; n0 += 3) {
      const int k = min(3, nkc - n0);
      acquire(ti, k);
      if (m < k) {
        float o[F3_RT];
#pragma unroll
        for (int r = 0; r < F3_RT; ++r) o[r] = 0.f;
        rows_tile(o, tile(ti + m) + c, sA, HDIM, rt);
#pragma unroll
        for (int r = 0; r < F3_RT; ++r) {
          if (r >= rt) break;
          float* dst = sPart + r * D + (n0 + m) * HDIM + c;
          *dst = g == 0 ? o[r] : *dst + o[r];
        }
      }
      __syncthreads();
      ti += k;
    }
  }
  // 6. the head sum through distributed shared memory: rank r adds the
  // ranks' partials of its ocn * 64 columns in rank order (so the heads in
  // order), 4 columns a thread with every rank's load in flight, then
  // bias and residual (K3p: the sum alone). Every rank stays until all
  // have read.
  cluster.sync();
  const int cw = ocn * HDIM, nq = cw / 4;
  float* sX = sS;  // TAIL: the rank's x_out columns [rt][cw]
  for (int i = tid; i < nrows * nq; i += NT) {
    const int r = i / nq, cc = oc0 * HDIM + (i % nq) * 4;
    float4 pv[F3_MAX_CS];
#pragma unroll
    for (int k = 0; k < F3_MAX_CS; ++k)
      pv[k] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sPart, k < CS ? k : 0) + r * D + cc);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < F3_MAX_CS; ++k)
      if (k < CS) {
        o[0] += pv[k].x;
        o[1] += pv[k].y;
        o[2] += pv[k].z;
        o[3] += pv[k].w;
      }
    const long long gi = (long long)(r0 + r) * D + cc;
    if (PARTIAL) {
      *reinterpret_cast<float4*>(xout + gi) =
          make_float4(o[0], o[1], o[2], o[3]);
      continue;
    }
    const float4 xx = ldg4(x + gi), bb = ldg4(bo + cc);
    const float4 xo = make_float4(xx.x + (o[0] + bb.x), xx.y + (o[1] + bb.y),
                                  xx.z + (o[2] + bb.z), xx.w + (o[3] + bb.w));
    *reinterpret_cast<float4*>(xout + gi) = xo;
    if (TAIL) *reinterpret_cast<float4*>(sX + r * cw + (i % nq) * 4) = xo;
  }
  if (TAIL) {
    // 7. K3-q's tail: the cross layer norm of the x_out rows, whose
    // columns the ranks hold in turn: each rank's row sums, then its sums
    // of squared deviations, added over the ranks in rank order; h2 =
    // LN2(x_out) into the rank's columns of sH, gathered from every rank;
    // then the rank's G * 64 columns of h2 @ Wcq + bcq from the stream's
    // last tiles.
    __shared__ float stat[2][F3_RT];
    __shared__ float row_mu[F3_RT], row_rs[F3_RT];
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {
      for (int r = warp; r < F3_RT; r += NT / 32) {
        float v = 0.f;
        if (r < nrows)
          for (int cc = lane; cc < cw; cc += 32) {
            const float e = sX[r * cw + cc] - (pass ? row_mu[r] : 0.f);
            v = pass ? fmaf(e, e, v) : v + e;
          }
        v = warp_sum(v);
        if (lane == 0) stat[pass][r] = v;
      }
      cluster.sync();
      if (tid < F3_RT) {
        float t = 0.f;
        for (int k = 0; k < CS; ++k)
          t += cluster.map_shared_rank(&stat[pass][0], k)[tid];
        if (pass == 0)
          row_mu[tid] = t / D;
        else
          row_rs[tid] = 1.f / sqrtf(t / D + eps);
      }
      __syncthreads();
    }
    for (int i = tid; i < rt * cw; i += NT) {
      const int r = i / cw, cc = h0 * HDIM + i % cw;
      sH[r * D + cc] =
          r < nrows ? (sX[i] - row_mu[r]) * row_rs[r] * g2[cc] + b2[cc] : 0.f;
    }
    cluster.sync();  // every rank's h2 columns are in place
    for (int i = tid; i < rt * (D / 4); i += NT) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      int k = 0;  // the rank holding head (chunk) c4 / 16
      while ((k + 1) * H / CS <= c4 / 16) ++k;
      if (k != rank)
        *reinterpret_cast<float4*>(sH + r * D + c4 * 4) =
            *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(sH, k) + r * D + c4 * 4);
    }
    __syncthreads();  // the gathered h2 is whole
    for (int gg = 0; gg < G; ++gg) {
      // thread (m, c): the k chunks m, m + 3, ... of column c, then the
      // three partials added in order
      float acc[F3_RT];
#pragma unroll
      for (int r = 0; r < F3_RT; ++r) acc[r] = 0.f;
      for (int k0 = 0; k0 < nkc; k0 += 3) {
        const int k = min(3, nkc - k0);
        acquire(ti, k);
        if (m < k)
          rows_tile(acc, tile(ti + m) + c, sH + (k0 + m) * HDIM, D, rt);
        __syncthreads();
        ti += k;
      }
      float* red = sS;
      if (m < 3)
#pragma unroll
        for (int r = 0; r < F3_RT; ++r)
          if (r < rt) red[(m * rt + r) * HDIM + c] = acc[r];
      __syncthreads();
      for (int i = tid; i < nrows * HDIM; i += NT) {
        const int r = i / HDIM, cc = i % HDIM;
        const int col = (h0 + gg) * HDIM + cc;
        const float s = red[r * HDIM + cc] + red[(rt + r) * HDIM + cc] +
                        red[(2 * rt + r) * HDIM + cc];
        qcross[(long long)(r0 + r) * D + col] = s + bcq[col];
      }
      __syncthreads();
    }
  }
  cluster.sync();
}

// K4-o's head: x1 = x + (attn @ W + bias), float32, a block per (32
// output columns, 4 rows); thread (cg, ks) the 8 columns 8 cg.. over the
// k slice ks, ks + 64, ...; the 64 slices added in order.
constexpr int P_RB = 4, P_NC = 32, P_KS = NT / (P_NC / 8);
inline size_t rowproj_smem(int D) {
  return 4 * ((size_t)P_KS * P_RB * P_NC + (size_t)P_RB * D);
}

__global__ void __launch_bounds__(NT) rowproj_f32_kernel(
    const float* __restrict__ attn, const float* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ x,
    float* __restrict__ x1, int B, int D) {
  extern __shared__ __align__(16) float psm[];
  float* red = psm;                         // [P_KS][P_RB][P_NC]
  float* sIn = red + P_KS * P_RB * P_NC;    // [P_RB][D]
  const int c0 = blockIdx.x * P_NC, r0 = blockIdx.y * P_RB;
  const int nrows = min(P_RB, B - r0);
  const int tid = threadIdx.x;
  for (int i = tid; i < P_RB * D; i += NT)
    sIn[i] = i / D < nrows ? attn[(long long)(r0 + i / D) * D + i % D] : 0.f;
  __syncthreads();
  const int cg8 = tid % (P_NC / 8), ks = tid / (P_NC / 8);
  float acc[P_RB][8];
#pragma unroll
  for (int r = 0; r < P_RB; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  const float* wp = W + c0 + cg8 * 8;
#pragma unroll 4
  for (int k = ks; k < D; k += P_KS) {
    const float4 wa = ldg4(wp + (long long)k * D);
    const float4 wb = ldg4(wp + (long long)k * D + 4);
    const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int r = 0; r < P_RB; ++r) {
      const float hv = sIn[r * D + k];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(hv, w[e], acc[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < P_RB; ++r) {
    float4* dst =
        reinterpret_cast<float4*>(red + (ks * P_RB + r) * P_NC + cg8 * 8);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int i = tid; i < P_RB * P_NC; i += NT) {
    const int r = i / P_NC, cc = i % P_NC;
    if (r >= nrows) continue;
    float s = 0.f;
    for (int q = 0; q < P_KS; ++q) s += red[(q * P_RB + r) * P_NC + cc];
    const long long gi = (long long)(r0 + r) * D + c0 + cc;
    x1[gi] = x[gi] + (s + bias[c0 + cc]);
  }
}

// K4's float32 form (see the file's head). Shared memory of a block: the
// slice's fc1 chunk [DC][16], h's chunk transposed [DC][36] (rows of the
// 32-row block, 4 floats of padding), the slice's fc2 chunk [16][DC + 4],
// u transposed [16][36], the warps' fc1 partials [8][32][16].
constexpr int F4_FS = 16;            // fc1 columns a slice
constexpr int F4_DC = 512;           // D chunk
constexpr int F4_RB = 32;            // rows a row block
constexpr int F4_LDT = F4_RB + 4;    // floats a staged h / u row
constexpr int F4_MAX_D = 2048;

inline int f4_dc(int D) { return D < F4_DC ? D : F4_DC; }
inline size_t f4_smem(int dc) {
  return 4 * ((size_t)dc * F4_FS + (size_t)dc * F4_LDT +
              (size_t)F4_FS * (dc + 4) + F4_FS * F4_LDT +
              (NT / 32) * F4_RB * F4_FS);
}

// All G blocks meet here (they are co-resident: the launch is
// cooperative). *c counts arrivals; the waiting thread spins on it.
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

// x: [B, D] float32 (K4-o: x1 from rowproj_f32_kernel); hT: [D, Bp]
// scratch, Bp = B rounded up to 32; part: [F / 16, B, D] scratch; bar:
// three zeroed ints, left zero. PARTIAL (K4p, a rank's F columns of fc1
// and rows of fc2): out = the float32 fc2 sum without x and b2.
template <bool PARTIAL = false>
__global__ void __launch_bounds__(NT, 1) mlp_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ bln, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* hT, float* part, int* bar,
    float* __restrict__ out, int B, int D, int F, float eps) {
  extern __shared__ __align__(16) float fsm[];
  const int DC = min(D, F4_DC), LDW2 = DC + 4;
  float* sW1 = fsm;                    // [DC][16]
  float* sHT = sW1 + DC * F4_FS;       // [DC][36]
  float* sW2 = sHT + DC * F4_LDT;      // [16][DC + 4]
  float* sUT = sW2 + F4_FS * LDW2;     // [16][36]
  float* sRed = sUT + F4_FS * F4_LDT;  // [8][32][16]
  const int G = gridDim.x, S = F / F4_FS;
  const int nch = (D + DC - 1) / DC;
  const int Bp = (B + F4_RB - 1) / F4_RB * F4_RB, nrb = Bp / F4_RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // copies of fc1 rows [k0, k0 + DC) x slice j's columns into sW1, of
  // slice j's fc2 rows x columns [n0, n0 + DC) into sW2, and of h's rows
  // [k0, k0 + DC) x the row block's 32 columns into sHT
  auto stage_w1 = [&](int j, int c) {
    const int k0 = c * DC, kc = min(DC, D - k0);
    for (int i = tid; i < kc * (F4_FS / 4); i += NT) {
      const int k = i / (F4_FS / 4), q = (i % (F4_FS / 4)) * 4;
      cp_async16(sW1 + k * F4_FS + q,
                 w1 + (long long)(k0 + k) * F + j * F4_FS + q);
    }
  };
  auto stage_w2 = [&](int j, int c) {
    const int n0 = c * DC, cw4 = min(DC, D - n0) / 4;
    for (int i = tid; i < F4_FS * cw4; i += NT) {
      const int r = i / cw4, q = (i % cw4) * 4;
      cp_async16(sW2 + r * LDW2 + q,
                 w2 + (long long)(j * F4_FS + r) * D + n0 + q);
    }
  };
  auto stage_h = [&](int rb, int c) {
    const int k0 = c * DC, kc = min(DC, D - k0);
    for (int i = tid; i < kc * (F4_RB / 4); i += NT) {
      const int k = i / (F4_RB / 4), q = (i % (F4_RB / 4)) * 4;
      cp_async16(sHT + k * F4_LDT + q,
                 hT + (long long)(k0 + k) * Bp + rb * F4_RB + q);
    }
  };

  // 1. the first slice's first chunks in flight through the layer norm:
  // a warp a row, the grid's warps over the rows (the padding rows zero)
  int w1_at = blockIdx.x * nch, w2_at = blockIdx.x * nch;  // slice*nch+chunk
  stage_w1(blockIdx.x, 0);
  stage_w2(blockIdx.x, 0);
  cp_async_commit();
  for (int r = blockIdx.x * (NT / 32) + warp; r < Bp; r += G * (NT / 32)) {
    if (r < B)
      ln_row_warp(x + (long long)r * D, D, g, bln, eps, hT + r, Bp);
    else
      for (int k = lane; k < D; k += 32) hT[(long long)k * Bp + r] = 0.f;
  }
  grid_sync(bar, G);

  // 2. per (slice, row block): u = gelu(h @ W1[:, slice] + b1), then the
  // slice's share of fc2, u @ W2[slice, :], into part[slice]
  const int rq = lane >> 2, cq = lane & 3;  // fc1: rows 4 rq.., cols 4 cq..
  for (int j = blockIdx.x; j < S; j += G) {
    const int f0 = j * F4_FS;
    for (int rb = 0; rb < nrb; ++rb) {
      const int r0 = rb * F4_RB, nrows = min(F4_RB, B - r0);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      for (int c = 0; c < nch; ++c) {
        __syncthreads();  // sHT and sW1 are free
        if (w1_at != j * nch + c) {
          stage_w1(j, c);
          w1_at = j * nch + c;
        }
        stage_h(rb, c);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        // warp w: the chunk's k rows [w kw, (w + 1) kw)
        const int kw = min(DC, D - c * DC) / (NT / 32);
        for (int k = warp * kw; k < (warp + 1) * kw; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(
              sW1 + k * F4_FS + cq * 4);
          const float4 h = *reinterpret_cast<const float4*>(
              sHT + k * F4_LDT + rq * 4);
          const float hv[4] = {h.x, h.y, h.z, h.w};
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[a][e] = fmaf(hv[a], wv[e], acc[a][e]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(
            sRed + (warp * F4_RB + rq * 4 + a) * F4_FS + cq * 4) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      __syncthreads();
      for (int i = tid; i < F4_RB * F4_FS; i += NT) {
        const int r = i / F4_FS, f = i % F4_FS;
        float u = 0.f;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w)
          u += sRed[(w * F4_RB + r) * F4_FS + f];
        sUT[f * F4_LDT + r] = gelu_as(u + b1[f0 + f]);
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
        // warp w: rows 4 w .. 4 w + 3; lane: 8 columns at a time
        const int n0 = c * DC, cw8 = min(DC, D - n0) / 8;
        for (int co = lane; co < cw8; co += 32) {
          float a2[4][8];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 8; ++e) a2[a][e] = 0.f;
#pragma unroll 4
          for (int f = 0; f < F4_FS; ++f) {
            const float4 u4 = *reinterpret_cast<const float4*>(
                sUT + f * F4_LDT + warp * 4);
            const float4 wa = *reinterpret_cast<const float4*>(
                sW2 + f * LDW2 + co * 8);
            const float4 wb = *reinterpret_cast<const float4*>(
                sW2 + f * LDW2 + co * 8 + 4);
            const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                a2[a][e] = fmaf(uv[a], wv[e], a2[a][e]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = warp * 4 + a;
            if (r >= nrows) continue;
            float* pj = part + ((long long)j * B + r0 + r) * D + n0 + co * 8;
            *reinterpret_cast<float4*>(pj) =
                make_float4(a2[a][0], a2[a][1], a2[a][2], a2[a][3]);
            *reinterpret_cast<float4*>(pj + 4) =
                make_float4(a2[a][4], a2[a][5], a2[a][6], a2[a][7]);
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
  for (long long i = blockIdx.x * chunk + tid; i < i1; i += NT) {
    const int cc = (int)(i % D);
    if (PARTIAL)
      out[i] = ordered_sum(part + i, total, S);
    else
      out[i] = x[i] + (ordered_sum(part + i, total, S) + b2[cc]);
  }
  if (tid == 0 && atomicAdd(bar + 2, 1) == G - 1) {
    bar[0] = 0;  // every block has passed both barriers
    bar[1] = 0;
    bar[2] = 0;
  }
}

// K3 / K3-q (wcq != NULL) / K3p (PARTIAL) at model width D over the
// block's H heads (see mas_decoder_self_block_f32 and _partial_f32).
int launch_self_f32(bool partial, const void* x, const void* g1,
                    const void* b1, const void* wq, const void* bq,
                    const void* wk, const void* wv, const void* bv,
                    const void* wo, const void* bo, void* kc, void* vc,
                    void* x_out, const void* g2, const void* b2,
                    const void* wcq, const void* bcq, void* q_cross, int B,
                    int D, int H, int L, int pos, int CS, int rt, int S,
                    float scale, float eps, void* stream) {
  const bool tail = wcq != nullptr;
  if (B < 1 || H < 1 || D < HDIM || D % HDIM || CS < 1 || CS > H ||
      CS > D / HDIM || CS > F3_MAX_CS || rt < 1 || rt > F3_RT ||
      S < F3_MIN_STAGES || S > F3_MAX_STAGES || pos < 0 || pos >= L ||
      f3_smem(D, L, S, rt) > SMEM_MAX || (B + rt - 1) / rt > 65535 ||
      (tail && partial) || (!partial && D != H * HDIM))
    return (int)cudaErrorInvalidValue;
  auto* kernel = tail      ? &self_block_f32_kernel<true>
                 : partial ? &self_block_f32_kernel<false, true>
                           : &self_block_f32_kernel<false>;
  const int e = launch_cluster(
      kernel, dim3(CS, (B + rt - 1) / rt), CS, NT, f3_smem(D, L, S, rt),
      (cudaStream_t)stream, (const float*)x, (const float*)g1,
      (const float*)b1, (const float*)wq, (const float*)bq, (const float*)wk,
      (const float*)wv, (const float*)bv, (const float*)wo, (const float*)bo,
      (const float*)g2, (const float*)b2, (const float*)wcq,
      (const float*)bcq, (float*)kc, (float*)vc, (float*)x_out,
      (float*)q_cross, B, D, H, L, pos, rt, S, scale, eps);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K4 / K4-o (wco != NULL) / K4p (PARTIAL): see mas_decoder_mlp_block_f32
// and _partial_f32.
int launch_mlp_f32(bool partial, const void* x, const void* g,
                   const void* bln, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* attn,
                   const void* wco, const void* bco, void* x32, void* h,
                   void* part, void* counter, void* out, int B, int D, int F,
                   float eps, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || D < HDIM || D % HDIM || D > F4_MAX_D || F < F4_FS ||
      F % F4_FS || sms < 1 || (partial && wco != nullptr))
    return (int)cudaErrorInvalidValue;
  const void* xin = x;
  if (wco != nullptr) {
    rowproj_f32_kernel<<<dim3(D / P_NC, (B + P_RB - 1) / P_RB), NT,
                         rowproj_smem(D), s>>>(
        (const float*)attn, (const float*)wco, (const float*)bco,
        (const float*)x, (float*)x32, B, D);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    xin = x32;
  }
  // blocks a multiprocessor holds, per device, instance and chunk width
  // (read once)
  static int per_sm[MAX_DEVICES][2][F4_DC / HDIM + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  const int dc = f4_dc(D);
  const void* fn = partial ? (const void*)mlp_f32_kernel<true>
                           : (const void*)mlp_f32_kernel<false>;
  int& fit = per_sm[dev][partial][dc / HDIM];
  if (fit == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, fn, NT, f4_smem(dc));
    if (e != cudaSuccess) return (int)e;
    if (fit == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int grid = F / F4_FS < sms * fit ? F / F4_FS : sms * fit;
  void* args[] = {(void*)&xin, (void*)&g,    (void*)&bln,     (void*)&w1,
                  (void*)&b1,  (void*)&w2,   (void*)&b2,      (void*)&h,
                  (void*)&part, (void*)&counter, (void*)&out, (void*)&B,
                  (void*)&D,   (void*)&F,    (void*)&eps};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT), args,
                                          f4_smem(dc), s);
}

}  // namespace

// Raises the float32 K3's dynamic shared-memory limit and allows its
// clusters of up to 16 blocks (every instance), and the float32 K4's (both
// instances) and its head's limits. Called once a device, when the
// library is set up on it.
extern "C" int mas_decoder_block_f32_init(void) {
  for (const void* fn : {(const void*)self_block_f32_kernel<false>,
                         (const void*)self_block_f32_kernel<true>,
                         (const void*)self_block_f32_kernel<false, true>}) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e == cudaSuccess)  // clusters of more than 8 blocks (H = 12, 20)
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  for (const void* fn : {(const void*)mlp_f32_kernel<false>,
                         (const void*)mlp_f32_kernel<true>}) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f4_smem(F4_DC));
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaFuncSetAttribute(rowproj_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)rowproj_smem(F4_MAX_D));
}

// The clusters of cs float32 K3 blocks of smem bytes the card holds at
// once (K3p's plan asks it at the rank's shapes). Returns a cudaError_t
// value.
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
// out]); kc, vc: [B, L, D] caches, row pos written. wcq == NULL runs K3
// (g2, b2, bcq, q_cross unused). The plan (ops/decoder_block.py::
// self_block_f32_plan): CS <= min(H, 16) blocks a cluster, rt <= 8 rows
// a tile, S ring slots (4..8). Every pointer 16-byte aligned. Returns a
// cudaError_t value: a shape outside these limits, a launch the card
// refuses, or cudaGetLastError() after the launch.
extern "C" int mas_decoder_self_block_f32(
    const void* x, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv,
    const void* wo, const void* bo, void* kc, void* vc, void* x_out,
    const void* g2, const void* b2, const void* wcq, const void* bcq,
    void* q_cross, int B, int H, int L, int pos, int CS, int rt, int S,
    float scale, float eps, void* stream) {
  return launch_self_f32(false, x, g1, b1, wq, bq, wk, wv, bv, wo, bo, kc,
                         vc, x_out, g2, b2, wcq, bcq, q_cross, B, H * HDIM,
                         H, L, pos, CS, rt, S, scale, eps, stream);
}

// K3p's float32 form, one rank of the mesh's model axis: out = (K3's
// attention over the rank's H heads, merged) @ wo in float32, without x
// and bo. x: [B, D] (the whole row, read by the layer norm); g1, b1: [D];
// wq, wk, wv: [D, H * 64] and wo: [H * 64, D] row-major (the rank's
// column and row shards); bq, bv: [H * 64]; kc, vc: [B, L, H * 64] caches
// of the rank's heads, row pos written; out: [B, D]; all float32. D % 64
// == 0; CS <= min(H, D / 64, 16); the plan is self_block_f32_plan's at
// width D. Returns a cudaError_t value, as mas_decoder_self_block_f32.
extern "C" int mas_decoder_self_block_partial_f32(
    const void* x, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv,
    const void* wo, void* kc, void* vc, void* out, int B, int D, int H, int L,
    int pos, int CS, int rt, int S, float scale, float eps, void* stream) {
  return launch_self_f32(true, x, g1, b1, wq, bq, wk, wv, bv, wo, bv, kc, vc,
                         out, nullptr, nullptr, nullptr, nullptr, nullptr, B,
                         D, H, L, pos, CS, rt, S, scale, eps, stream);
}

// K4 / K4-o, float32. x, out: [B, D] (D % 64 == 0, D <= 2048); g, bln,
// b2, bco: [D]; w1: [D, F], w2: [F, D], wco: [D, D] row-major (F % 16 ==
// 0); b1: [F]; attn: [B, D]; x32: [B, D] scratch (K4-o's x1); h: [D, Bp]
// scratch, Bp = B rounded up to 32; part: [F / 16, B, D] scratch;
// counter: >= 3 zeroed ints, left zero. wco == NULL runs K4 (attn, bco,
// x32 unused). sms: the card's multiprocessors; the grid is min(F / 16,
// sms x the blocks a multiprocessor holds). Returns the first CUDA error
// of the launches (0 = none).
extern "C" int mas_decoder_mlp_block_f32(
    const void* x, const void* g, const void* bln, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* attn,
    const void* wco, const void* bco, void* x32, void* h, void* part,
    void* counter, void* out, int B, int D, int F, float eps, int sms,
    void* stream) {
  return launch_mlp_f32(false, x, g, bln, w1, b1, w2, b2, attn, wco, bco,
                        x32, h, part, counter, out, B, D, F, eps, sms,
                        stream);
}

// K4p's float32 form, one rank of the mesh's model axis: out = gelu(LN(x)
// @ w1 + b1) @ w2 in float32, without x and b2. x: [B, D] (the whole row,
// read by the layer norm); g, bln: [D]; w1: [D, F] and w2: [F, D]
// row-major (the rank's column and row shards of fc1 and fc2, F % 16 ==
// 0); b1: [F]; h, part, counter: K4's float32 scratch; out: [B, D]; all
// float32. Returns a cudaError_t value, as mas_decoder_mlp_block_f32.
extern "C" int mas_decoder_mlp_block_partial_f32(
    const void* x, const void* g, const void* bln, const void* w1,
    const void* b1, const void* w2, void* h, void* part, void* counter,
    void* out, int B, int D, int F, float eps, int sms, void* stream) {
  return launch_mlp_f32(true, x, g, bln, w1, b1, w2, nullptr, nullptr,
                        nullptr, nullptr, nullptr, h, part, counter, out, B,
                        D, F, eps, sms, stream);
}
