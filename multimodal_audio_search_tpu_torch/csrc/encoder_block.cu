// K11: the encoder attention + o-projection with the softmax division
// placed three ways, on a flash loop of mma.sync tiles. Replaces the A/B
// copy tools/profile_encoder_kernel_ab.py::fused_v2 (body _kernel_v2 :48,
// pallas_call :118).
//
// K1 (the default encoder block) and K10 (its head-paired form) ran on
// this loop too; they moved to encoder_block_wgmma.cu (wgmma fed by TMA,
// a thread-block cluster over the heads). K11 is the next kernel to move
// onto that loop.
//
// Function: out = x + (softmax(Q K^T / sqrt(D)) V, heads merged) @ Wo +
// bo, with the softmax division as the form says.
//
// What bounds it on an H100: tensor-core work. At the main-path shape
// (B=32, T=1500, H=8, D=64) attention is ~147 GFLOP and the o-projection
// ~25 GFLOP, against ~0.15-0.2 GB of q/k/v/x/out traffic, far above the
// card's ~295 FLOP/byte balance point.
//
// Design. The TPU kernels keep full-T K/V of every head in VMEM; one
// head's K alone is 192 KB at T=1500, which does not fit a block's 227 KB
// of shared memory beside V and a query tile. So the structure is not
// carried over: this is a flash-attention loop instead.
//   * One block = 64 query rows, 4 warps x 16 rows, every head of one
//     batch row.
//   * For each head: Q fragments stay in registers; 64-key K/V tiles
//     stream through shared memory; S = Q K^T and O += P V run on
//     mma.sync m16n8k16 bf16 tensor-core tiles with f32 accumulation;
//     the softmax is online (running max and sum in f32, exp2 with
//     log2(e) folded into the scale). Keys >= T are masked; rows >= T are
//     computed on zero queries and never stored.
//   * P is rounded to bf16 before the PV product, as the TPU kernels cast
//     p to the V dtype. Where the division by the row sum l goes is the
//     template's Form: RECIP multiplies the [16, 64] output by 1/l (the
//     TPU A/B's "post": x 1/l after the head concat, the same
//     per-element product); DIV divides it by l (the A/B's True); NORM
//     divides P by l before the PV product (the A/B's False, the TPU
//     kernel's default at T=1500), which needs l first: a first pass over
//     K finds the row max and sum, a second recomputes S and forms P / l.
//   * Each head's output is rounded to bf16 into a [64, H*D] shared-memory
//     tile (the TPU kernel's attn.astype(wo.dtype)); after the last head
//     the same block computes tile @ Wo + bo + x (encoder_common.cuh),
//     which keeps the merged attention output out of device memory.
// Shared memory: 2 x 64x72 bf16 K/V tiles + the 64 x (H*D+8) bf16 tile =
// 83 KB at base width (H*D=512), above the 48 KB default, so
// mas_attn_o_residual_init raises the dynamic shared-memory limit once,
// when the library loads. Rows are padded by 8 bf16 so the fragment reads
// are free of bank conflicts.
#include "encoder_common.cuh"

namespace {

using namespace enc;

enum Form { RECIP = 0, DIV = 1, NORM = 2 };

// Q fragments (A operand, 16 rows x 64) of one head for this warp's rows
// ra and rb = ra + 8; zero past T.
__device__ __forceinline__ void load_q(uint32_t qa[4][4], const bf16* qh,
                                       long long st, int T, int ra, int rb,
                                       int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = ra < T ? ld32(qh + ra * st + c) : 0u;
    qa[kk][1] = rb < T ? ld32(qh + rb * st + c) : 0u;
    qa[kk][2] = ra < T ? ld32(qh + ra * st + c + 8) : 0u;
    qa[kk][3] = rb < T ? ld32(qh + rb * st + c + 8) : 0u;
  }
}

// S = Q K^T for the warp's 16 rows x NJ*8 keys of a K tile (row stride
// ld, this head's columns at sK), scaled to the log2 domain, keys >= T
// set to -inf.
template <int NJ>
__device__ __forceinline__ void scores(float s[NJ][4], const uint32_t qa[4][4],
                                       const bf16* sK, int ld, int kv0, int T,
                                       float scale_log2, int g, int t4) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* kr = sK + (j * 8 + g) * ld + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int key = kv0 + j * 8 + t4 * 2;
    const bool v0 = key < T, v1 = key + 1 < T;
    s[j][0] = v0 ? s[j][0] * scale_log2 : -INFINITY;
    s[j][1] = v1 ? s[j][1] * scale_log2 : -INFINITY;
    s[j][2] = v0 ? s[j][2] * scale_log2 : -INFINITY;
    s[j][3] = v1 ? s[j][3] * scale_log2 : -INFINITY;
  }
}

// Row maxima of s (rows g and g + 8), starting from m0/m1, over the quad.
template <int NJ>
__device__ __forceinline__ void row_max(const float s[NJ][4], float& mx0,
                                        float& mx1) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// One online-softmax step: s -> exp2(s - m_new) in place, o rescaled,
// per-thread partial sums l updated (quad-reduced by the caller at the
// end). Every tile holds at least one unmasked key, so the new max is
// finite and exp2(-inf - mx) = 0 rescales the empty first state.
template <int NJ>
__device__ __forceinline__ void online_step(float s[NJ][4], float o[8][4],
                                            float& m0, float& m1, float& l0,
                                            float& l1) {
  float mx0 = m0, mx1 = m1;
  row_max<NJ>(s, mx0, mx1);
  const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = exp2f(s[j][0] - m0);
    s[j][1] = exp2f(s[j][1] - m0);
    s[j][2] = exp2f(s[j][2] - m1);
    s[j][3] = exp2f(s[j][3] - m1);
    rs0 += s[j][0] + s[j][1];
    rs1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j][0] *= c0;
    o[j][1] *= c0;
    o[j][2] *= c1;
    o[j][3] *= c1;
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
}

// O += P V over NJ*8 keys: the S accumulators are re-read as bf16 A
// fragments; V from the tile at sV (row stride ld, this head's columns).
template <int NJ>
__device__ __forceinline__ void pv(float o[8][4], const float s[NJ][4],
                                   const bf16* sV, int ld, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const bf16* vr = sV + (kk * 16 + t4 * 2) * ld + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* p = vr + j * 8;
      mma_16816(o[j], pa, pack_raw(p, p + ld), pack_raw(p + 8 * ld, p + 9 * ld));
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One head's attention for the warp's 16 rows (ra, rb), normalised as
// FORM says; o in the C-fragment layout (rows g / g + 8, cols j*8 + 2t).
// Every thread of the block calls it (it synchronises around the tiles).
template <int FORM>
__device__ __forceinline__ void attend_head(float o[8][4], const bf16* qh,
                                            const bf16* kh, const bf16* vh,
                                            long long st, int T, int ra,
                                            int rb, float scale_log2, bf16* sK,
                                            bf16* sV) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (T + BK - 1) / BK;
  uint32_t qa[4][4];
  load_q(qa, qh, st, T, ra, rb, t4);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (FORM == NORM) {  // pass 1: the row max and sum, no PV
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int kv0 = kt * BK;
      __syncthreads();
      load_tile(sK, kh + kv0 * st, st, T - kv0);
      __syncthreads();
      float s[8][4];
      scores<8>(s, qa, sK, LDS, kv0, T, scale_log2, g, t4);
      online_step<8>(s, o, m0, m1, l0, l1);  // o is zero: rescaling is moot
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    load_tile(sK, kh + kv0 * st, st, T - kv0);
    load_tile(sV, vh + kv0 * st, st, T - kv0);
    __syncthreads();
    float s[8][4];
    scores<8>(s, qa, sK, LDS, kv0, T, scale_log2, g, t4);
    if (FORM == NORM) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - m0) / l0;
        s[j][1] = exp2f(s[j][1] - m0) / l0;
        s[j][2] = exp2f(s[j][2] - m1) / l1;
        s[j][3] = exp2f(s[j][3] - m1) / l1;
      }
    } else {
      online_step<8>(s, o, m0, m1, l0, l1);
    }
    pv<8>(o, s, sV, LDS, g, t4);
  }
  if (FORM == NORM) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (FORM == DIV) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] /= l0;
      o[j][1] /= l0;
      o[j][2] /= l1;
      o[j][3] /= l1;
    }
  } else {
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= i0;
      o[j][1] *= i0;
      o[j][2] *= i1;
      o[j][3] *= i1;
    }
  }
}

// The warp's [16, 64] head output, rounded to bf16, into the merged tile
// at column col0.
__device__ __forceinline__ void store_head(bf16* sA, int HDP, int col0,
                                           const float o[8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(sA + r * HDP + col) =
        pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(sA + (r + 8) * HDP + col) =
        pack_bf16(o[j][2], o[j][3]);
  }
}

// K11, each of its three forms.
template <int FORM>
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
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int ra = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2), rb = ra + 8;
  for (int h = 0; h < H; ++h) {
    const long long off = b * sb + h * sh;
    float o[8][4];
    attend_head<FORM>(o, q + off, k + off, v + off, st, T, ra, rb, scale_log2,
                      sK, sV);
    store_head(sA, HD + 8, h * D, o);
  }
  o_proj_residual(sA, sK, x, wo, bo, out, b, q0, T, HD);
}

template <int FORM>
int launch_attn_o(const void* q, const void* k, const void* v, long long sb,
                  long long sh, long long st, const void* x, const void* wo,
                  const void* bo, void* out, int B, int H, int T, int HD,
                  float scale_log2, void* stream) {
  const int smem = (2 * BK * LDS + BQ * (HD + 8)) * (int)sizeof(bf16);
  dim3 grid((T + BQ - 1) / BQ, B);
  attn_o_residual_kernel<FORM><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh, st,
      (const bf16*)x, (const bf16*)wo, (const bf16*)bo, (bf16*)out, T, H, HD,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Raises K11's dynamic shared-memory limit to the current card's opt-in
// maximum per block. Called once, when the library is loaded.
extern "C" int mas_attn_o_residual_init(void) {
  cudaError_t e = allow_max_smem(attn_o_residual_kernel<RECIP>);
  if (e == cudaSuccess) e = allow_max_smem(attn_o_residual_kernel<DIV>);
  if (e == cudaSuccess) e = allow_max_smem(attn_o_residual_kernel<NORM>);
  return (int)e;
}

// K11. q/k/v: [B, H, T, 64] bf16 views sharing strides (sb, sh, st) with
// unit stride on the last dim; x/out: [B, T, HD] contiguous bf16; wo:
// [HD, HD] row-major bf16 ([in, out]); bo: [HD] bf16. HD = H * 64, a
// multiple of 64. form: the softmax division, 0 = x 1/l after PV
// ("post"), 1 = / l after PV (True), 2 = P / l before PV (False). Returns
// cudaGetLastError() after the launch; a width whose shared memory
// exceeds the card's per-block limit fails the launch.
extern "C" int mas_attn_o_residual_ab(const void* q, const void* k,
                                      const void* v, long long sb,
                                      long long sh, long long st,
                                      const void* x, const void* wo,
                                      const void* bo, void* out, int B, int H,
                                      int T, int HD, float scale_log2,
                                      int form, void* stream) {
  switch (form) {
    case RECIP:
      return launch_attn_o<RECIP>(q, k, v, sb, sh, st, x, wo, bo, out, B, H,
                                  T, HD, scale_log2, stream);
    case DIV:
      return launch_attn_o<DIV>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T,
                                HD, scale_log2, stream);
    case NORM:
      return launch_attn_o<NORM>(q, k, v, sb, sh, st, x, wo, bo, out, B, H, T,
                                 HD, scale_log2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
