// K1: Whisper encoder self-attention over all heads + o-projection +
// residual, in one kernel:  out = x + (softmax(Q K^T / sqrt(D)) V, heads
// merged) @ Wo + bo.
//
// Replaces the Pallas kernel multimodal_audio_search_tpu/ops/encoder_block.py
// ::fused_attention_o_residual (body _attn_o_kernel, pallas_call at :425).
//
// What bounds it on an H100: tensor-core work. At the main-path shape
// (B=32, T=1500, H=8, D=64) attention is ~147 GFLOP and the o-projection
// ~25 GFLOP, against ~0.15 GB of q/k/v/x/out traffic, far above the
// card's ~295 FLOP/byte balance point.
//
// Design. The TPU kernel keeps full-T K/V of every head in VMEM; one
// head's K alone is 192 KB at T=1500, which does not fit a block's 227 KB
// of shared memory beside V and a query tile. So the structure is not
// carried over: this is a flash-attention loop instead.
//   * One block = 64 query rows of one batch row, 4 warps x 16 rows.
//   * For each head: Q fragments stay in registers; 64-key K/V tiles
//     stream through shared memory; S = Q K^T and O += P V run on
//     mma.sync m16n8k16 bf16 tensor-core tiles with f32 accumulation;
//     the softmax is online (running max and sum in f32, exp2 with
//     log2(e) folded into the scale) and the 1/l division is deferred to
//     the [16, 64] output, as the TPU kernel's defer_div form does.
//     Keys >= T are masked; rows >= T are computed on zero queries and
//     never stored.
//   * P is rounded to bf16 before the PV product, as the TPU kernel casts
//     p to the V dtype.
//   * Each head's normalised output is rounded to bf16 into a [64, H*D]
//     shared-memory tile (the TPU kernel's attn.astype(wo.dtype)). After
//     the last head the same block computes tile @ Wo in 64-column chunks,
//     streaming 64x64 Wo tiles through shared memory, and writes
//     x + y + bo in bf16. Fusing the o-projection keeps the merged
//     attention output out of device memory.
// Shared memory: 2 x 64x72 bf16 K/V tiles + the 64 x (H*D+8) bf16 tile =
// 83 KB at base width (H*D=512), above the 48 KB default, so
// mas_attn_o_residual_init raises the dynamic shared-memory limit once,
// when the library loads. Rows are padded by 8 bf16 so the fragment
// reads are free of bank conflicts.
// Later work (ROADMAP): cp.async/TMA double buffering, wgmma, ldmatrix.
#include "common.cuh"

namespace {

constexpr int D = 64;      // head dim of every Whisper preset
constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per K/V tile
constexpr int LDS = D + 8; // padded row stride of the 64-wide tiles
constexpr int NT = 128;    // 4 warps

// [64 rows x 64 cols] bf16 tile from global (row stride ld elements)
// into shared memory; rows >= nrows are zero-filled.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int nrows) {
  for (int i = threadIdx.x; i < 64 * 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) v = *reinterpret_cast<const uint4*>(g + r * ld + c);
    *reinterpret_cast<uint4*>(s + r * LDS + c) = v;
  }
}

__global__ void __launch_bounds__(NT) attn_o_residual_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long sb, long long sh, long long st,
    const bf16* __restrict__ x, const bf16* __restrict__ wo,
    const bf16* __restrict__ bo, bf16* __restrict__ out, int T, int H,
    int HD, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LDS;
  bf16* sA = sV + BK * LDS;  // [BQ][HD + 8]
  const int HDP = HD + 8;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // this warp's first row in the tile
  const int ra = q0 + r0 + g, rb = ra + 8;
  const int n_tiles = (T + BK - 1) / BK;

  for (int h = 0; h < H; ++h) {
    const long long off = b * sb + h * sh;
    const bf16* qh = q + off;
    const bf16* kh = k + off;
    const bf16* vh = v + off;

    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + t4 * 2;
      qa[kk][0] = ra < T ? ld32(qh + ra * st + c) : 0u;
      qa[kk][1] = rb < T ? ld32(qh + rb * st + c) : 0u;
      qa[kk][2] = ra < T ? ld32(qh + ra * st + c + 8) : 0u;
      qa[kk][3] = rb < T ? ld32(qh + rb * st + c + 8) : 0u;
    }

    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int kv0 = kt * BK;
      __syncthreads();  // the previous tile is consumed
      load_tile(sK, kh + kv0 * st, st, T - kv0);
      load_tile(sV, vh + kv0 * st, st, T - kv0);
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x 64 keys
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const bf16* kr = sK + (j * 8 + g) * LDS + t4 * 2;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_16816(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
      // scale (log2 domain) + key mask + running max
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kv0 + j * 8 + t4 * 2;
        const bool v0 = key < T, v1 = key + 1 < T;
        s[j][0] = v0 ? s[j][0] * scale_log2 : -INFINITY;
        s[j][1] = v1 ? s[j][1] * scale_log2 : -INFINITY;
        s[j][2] = v0 ? s[j][2] * scale_log2 : -INFINITY;
        s[j][3] = v1 ? s[j][3] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every tile holds at least one unmasked key, so mx is finite and
      // exp2(-inf - mx) = 0 rescales the empty first state
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - m0);
        s[j][1] = exp2f(s[j][1] - m0);
        s[j][2] = exp2f(s[j][2] - m1);
        s[j][3] = exp2f(s[j][3] - m1);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
        o[j][0] *= c0;
        o[j][1] *= c0;
        o[j][2] *= c1;
        o[j][3] *= c1;
      }
      l0 = l0 * c0 + rs0;  // per-thread partial sums, quad-reduced below
      l1 = l1 * c1 + rs1;

      // O += P V: the S accumulators are re-read as A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const bf16* vr = sV + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* p = vr + j * 8;
          mma_16816(o[j], pa, pack_raw(p, p + LDS),
                    pack_raw(p + 8 * LDS, p + 9 * LDS));
        }
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    // head output, normalised and rounded to bf16, into the merged tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * D + j * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(sA + (r0 + g) * HDP + col) =
          pack_bf16(o[j][0] * i0, o[j][1] * i0);
      *reinterpret_cast<uint32_t*>(sA + (r0 + g + 8) * HDP + col) =
          pack_bf16(o[j][2] * i1, o[j][3] * i1);
    }
  }

  // epilogue: out = x + attn @ Wo + bo, 64 output columns at a time;
  // Wo is [HD (in), HD (out)] row-major, streamed in 64x64 tiles
  const int n_chunks = HD / 64;
  for (int nc = 0; nc < n_chunks; ++nc) {
    float y[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc) {
      __syncthreads();
      load_tile(sK, wo + (long long)kc * 64 * HD + nc * 64, HD, 64);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* ar = sA + (r0 + g) * HDP + kc * 64 + kk * 16 + t4 * 2;
        uint32_t a[4];
        a[0] = ld32(ar);
        a[1] = ld32(ar + 8 * HDP);
        a[2] = ld32(ar + 8);
        a[3] = ld32(ar + 8 * HDP + 8);
        const bf16* wr = sK + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* p = wr + j * 8;
          mma_16816(y[j], a, pack_raw(p, p + LDS),
                    pack_raw(p + 8 * LDS, p + 9 * LDS));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nc * 64 + j * 8 + t4 * 2;
      const float2 bv = unpack_bf16(ld32(bo + col));
      if (ra < T) {
        const long long i = ((long long)b * T + ra) * HD + col;
        const float2 xv = unpack_bf16(ld32(x + i));
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(xv.x + y[j][0] + bv.x, xv.y + y[j][1] + bv.y);
      }
      if (rb < T) {
        const long long i = ((long long)b * T + rb) * HD + col;
        const float2 xv = unpack_bf16(ld32(x + i));
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(xv.x + y[j][2] + bv.x, xv.y + y[j][3] + bv.y);
      }
    }
  }
}

}  // namespace

// Raises the kernel's dynamic shared-memory limit to the current card's
// opt-in maximum per block. Called once, when the library is loaded.
extern "C" int mas_attn_o_residual_init(void) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_o_residual_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  return (int)e;
}

// q/k/v: [B, H, T, 64] bf16 views sharing strides (sb, sh, st) with unit
// stride on the last dim; x/out: [B, T, HD] contiguous bf16; wo: [HD, HD]
// row-major bf16 ([in, out]); bo: [HD] bf16. HD = H * 64, a multiple of 64.
// Returns cudaGetLastError() after the launch; a width whose shared
// memory exceeds the card's per-block limit fails the launch.
extern "C" int mas_attn_o_residual(const void* q, const void* k,
                                   const void* v, long long sb, long long sh,
                                   long long st, const void* x,
                                   const void* wo, const void* bo, void* out,
                                   int B, int H, int T, int HD,
                                   float scale_log2, void* stream) {
  const int smem = (2 * BK * LDS + BQ * (HD + 8)) * (int)sizeof(bf16);
  dim3 grid((T + BQ - 1) / BQ, B);
  attn_o_residual_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh, st,
      (const bf16*)x, (const bf16*)wo, (const bf16*)bo, (bf16*)out, T, H, HD,
      scale_log2);
  return (int)cudaGetLastError();
}
