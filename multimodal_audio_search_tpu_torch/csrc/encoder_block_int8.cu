// K9: encoder attention over all heads with int8 x int8 -> int32 dots,
// + o-projection + residual. Per head h, for a query row with
// qf = q * scale (scale = 1/sqrt(D), applied before quantizing):
//   qs     = max(max_d |qf|, 1e-12) / 127,   q8 = clip(rint(qf / qs))
//   s[t]   = ((float)(q8 . k8[t]) * qs) * ks[t]          (keys t < T)
//   p[t]   = exp(s[t] - max s) / l,           l = sum_t exp(s[t] - max s)
//   pw[t]  = p[t] * vs[t]
//   ps     = max(max_t |pw|, 1e-30) / 127,   p8 = clip(rint(pw / ps))
//   out_h  = (float)(p8 . v8) * ps
// then x + (out_h, heads merged, in bf16) @ Wo + bo, as K1 ends. k8/v8
// and their per-position scales ks/vs come from quantize_kv outside the
// kernel, as the TPU wrapper quantizes them in XLA. Rounding is rint (half
// to even, as jnp.round), every division a true one and exp is expf, so
// the codes are the TPU kernel's wherever the float32 sum l agrees.
//
// Replaces multimodal_audio_search_tpu/ops/encoder_block.py::
// fused_attention_o_residual with qk_int8=True (body _attn_o_kernel_int8
// :183, pallas_call :319).
//
// What bounds it on an H100: tensor-core work, half of it at the int8
// rate. At B=32, T=1500, H=8 the two attention dots are ~147 G integer
// ops (1,979 TOP/s) and the o-projection ~25 GFLOP bf16 (989 TFLOP/s),
// against ~0.15 GB of q/x/out (bf16) and k8/v8 (int8) traffic.
//
// Design (simple first version). One block = 64 query rows of one batch
// row, 4 warps x 16 rows, every head in turn, as K1:
//   * q is quantized per row in registers (a quad max over the 64
//     columns) into m16n8k32 A fragments.
//   * The per-row p quantization needs the whole softmax row (ps is a max
//     over all T of the normalised p), which an online softmax does not
//     have. So QK^T is recomputed over three passes of 64-key int8 K
//     tiles: (1) the row max m and sum l, online; (2) pw with the final m
//     and l, and its row max -> ps; (3) p8 and the PV product. Keeping a
//     [16, T] float32 score strip per warp would need 4 x 96 KB at
//     T=1500, more than a block's shared memory.
//   * Both dots are mma.sync m16n8k32 s8 x s8 -> s32. For QK^T, k8 rows
//     (D contiguous) are the "col" B operand as stored. For PV the key
//     axis is the contraction: the thread's p8 codes sit where the S
//     accumulators put them (keys 2t, 2t+1 of each 8-key column tile),
//     not where the A fragment wants them (keys 4t..4t+3), so the
//     contraction order is permuted -- the same permutation in A and B,
//     which leaves the integer sum unchanged: A position 4t+i holds key
//     {2t, 2t+1, 8+2t, 9+2t}[i] (and +16 for the upper half), and B reads
//     the V bytes of those keys with four byte loads from the untransposed
//     V tile.
//   * Integer sums are exact; (float)pv rounds as the TPU's int32 ->
//     float32 conversion does (|pv| <= T * 127^2 exceeds 2^24 at T=1500).
//   * Each head's bf16 output goes to the merged [64, H*D] tile; the
//     o-projection + residual epilogue is K1's (encoder_common.cuh).
// Shared memory: K/V tiles 2 x 64x80 bytes, their scales, and the
// 64 x (H*D+8) bf16 tile = 77 KB at base width; the limit is raised when
// the library loads (mas_attn_o_residual_int8_init).
// Later work (ROADMAP): keep the score strip for fewer passes at T <= 512,
// cp.async double buffering, transposed V tiles for word loads.
#include "encoder_common.cuh"

namespace {

using namespace enc;

constexpr int LDB = D + 16;  // padded row stride (bytes) of the int8 tiles

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float code8(float v, float s) {
  return fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

// four codes (lowest index in the lowest byte)
__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c,
                                            float d) {
  return ((uint32_t)(int)a & 0xffu) | (((uint32_t)(int)b & 0xffu) << 8) |
         (((uint32_t)(int)c & 0xffu) << 16) | (((uint32_t)(int)d & 0xffu) << 24);
}

// [64 keys x 64] int8 tile (global rows of 64 bytes) + its 64 scales;
// keys >= nrows are zero-filled.
__device__ __forceinline__ void load_tile_s8(int8_t* s, float* ss,
                                             const int8_t* g, const float* gs,
                                             int nrows) {
  for (int i = threadIdx.x; i < 64 * 4; i += NT) {
    const int r = i >> 2, c = (i & 3) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) v = *reinterpret_cast<const uint4*>(g + r * D + c);
    *reinterpret_cast<uint4*>(s + r * LDB + c) = v;
  }
  const int i = threadIdx.x;
  if (i < 64) ss[i] = i < nrows ? gs[i] : 0.f;
}

// s = ((float)(q8 . k8) * qs) * ks for the warp's 16 rows x 64 keys of
// the K tile, keys >= T set to -inf.
__device__ __forceinline__ void scores_s8(float s[8][4], const uint32_t qa[2][4],
                                          const int8_t* sK, const float* sks,
                                          int kv0, int T, float qs0, float qs1,
                                          int g, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int c[4] = {0, 0, 0, 0};
    const int8_t* kr = sK + (j * 8 + g) * LDB + t4 * 4;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma_s8(c, qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 32),
             *reinterpret_cast<const uint32_t*>(kr + kk * 32 + 16));
    const int kl = j * 8 + t4 * 2;
    const bool v0 = kv0 + kl < T, v1 = kv0 + kl + 1 < T;
    s[j][0] = v0 ? ((float)c[0] * qs0) * sks[kl] : -INFINITY;
    s[j][1] = v1 ? ((float)c[1] * qs0) * sks[kl + 1] : -INFINITY;
    s[j][2] = v0 ? ((float)c[2] * qs1) * sks[kl] : -INFINITY;
    s[j][3] = v1 ? ((float)c[3] * qs1) * sks[kl + 1] : -INFINITY;
  }
}

__global__ void __launch_bounds__(NT) attn_o_residual_int8_kernel(
    const bf16* __restrict__ q, long long sb, long long sh, long long st,
    const int8_t* __restrict__ k8, const float* __restrict__ ks,
    const int8_t* __restrict__ v8, const float* __restrict__ vs,
    const bf16* __restrict__ x, const bf16* __restrict__ wo,
    const bf16* __restrict__ bo, bf16* __restrict__ out, int T, int H,
    int HD, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sK = reinterpret_cast<int8_t*>(smem_raw);  // [64][LDB]
  int8_t* sV = sK + 64 * LDB;                        // [64][LDB]
  float* sks = reinterpret_cast<float*>(sV + 64 * LDB);
  float* svs = sks + 64;
  bf16* sA = reinterpret_cast<bf16*>(svs + 64);  // [BQ][HD + 8]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const int n_tiles = (T + BK - 1) / BK;

  for (int h = 0; h < H; ++h) {
    // ---- q8 and qs for rows ra, rb: columns 4t..4t+3 (+16, +32, +48)
    const bf16* qh = q + b * sb + h * sh;
    float qf[2][16];
    float amax0 = 0.f, amax1 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int c = c4 * 16 + t4 * 4;
#pragma unroll
      for (int hw = 0; hw < 2; ++hw) {
        const float2 va = ra < T ? unpack_bf16(ld32(qh + ra * st + c + 2 * hw))
                                 : make_float2(0.f, 0.f);
        const float2 vb = rb < T ? unpack_bf16(ld32(qh + rb * st + c + 2 * hw))
                                 : make_float2(0.f, 0.f);
        qf[0][c4 * 4 + 2 * hw] = va.x * scale;
        qf[0][c4 * 4 + 2 * hw + 1] = va.y * scale;
        qf[1][c4 * 4 + 2 * hw] = vb.x * scale;
        qf[1][c4 * 4 + 2 * hw + 1] = vb.y * scale;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      amax0 = fmaxf(amax0, fabsf(qf[0][i]));
      amax1 = fmaxf(amax1, fabsf(qf[1][i]));
    }
    amax0 = fmaxf(amax0, __shfl_xor_sync(0xffffffffu, amax0, 1));
    amax0 = fmaxf(amax0, __shfl_xor_sync(0xffffffffu, amax0, 2));
    amax1 = fmaxf(amax1, __shfl_xor_sync(0xffffffffu, amax1, 1));
    amax1 = fmaxf(amax1, __shfl_xor_sync(0xffffffffu, amax1, 2));
    const float qs0 = fmaxf(amax0, 1e-12f) / 127.f;
    const float qs1 = fmaxf(amax1, 1e-12f) / 127.f;
    // A fragments: k-step kk covers columns kk*32 ..; a0/a2 row g, a1/a3
    // row g + 8; a0/a1 columns 4t.., a2/a3 columns 16 + 4t..
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = (kk * 2 + half) * 4;
        qa[kk][half * 2] =
            pack_s8(code8(qf[0][i], qs0), code8(qf[0][i + 1], qs0),
                    code8(qf[0][i + 2], qs0), code8(qf[0][i + 3], qs0));
        qa[kk][half * 2 + 1] =
            pack_s8(code8(qf[1][i], qs1), code8(qf[1][i + 1], qs1),
                    code8(qf[1][i + 2], qs1), code8(qf[1][i + 3], qs1));
      }
    }
    const long long kvoff = ((long long)b * H + h) * T;
    const int8_t* kh = k8 + kvoff * D;
    const int8_t* vh = v8 + kvoff * D;
    const float* ksh = ks + kvoff;
    const float* vsh = vs + kvoff;

    // ---- pass 1: row max m and sum l (online)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int kv0 = kt * BK;
      __syncthreads();
      load_tile_s8(sK, sks, kh + (long long)kv0 * D, ksh + kv0, T - kv0);
      __syncthreads();
      float s[8][4];
      scores_s8(s, qa, sK, sks, kv0, T, qs0, qs1, g, t4);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rs0 += expf(s[j][0] - mx0) + expf(s[j][1] - mx0);
        rs1 += expf(s[j][2] - mx1) + expf(s[j][3] - mx1);
      }
      l0 = l0 * expf(m0 - mx0) + rs0;
      l1 = l1 * expf(m1 - mx1) + rs1;
      m0 = mx0;
      m1 = mx1;
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    // ---- pass 2: pw = (exp(s - m) / l) * vs and its row max -> ps
    float pm0 = 0.f, pm1 = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int kv0 = kt * BK;
      __syncthreads();
      load_tile_s8(sK, sks, kh + (long long)kv0 * D, ksh + kv0, T - kv0);
      const int i = threadIdx.x;
      if (i < 64) svs[i] = kv0 + i < T ? vsh[kv0 + i] : 0.f;
      __syncthreads();
      float s[8][4];
      scores_s8(s, qa, sK, sks, kv0, T, qs0, qs1, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kl = j * 8 + t4 * 2;
        pm0 = fmaxf(pm0, fmaxf((expf(s[j][0] - m0) / l0) * svs[kl],
                               (expf(s[j][1] - m0) / l0) * svs[kl + 1]));
        pm1 = fmaxf(pm1, fmaxf((expf(s[j][2] - m1) / l1) * svs[kl],
                               (expf(s[j][3] - m1) / l1) * svs[kl + 1]));
      }
    }
    pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 1));
    pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 2));
    pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 1));
    pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 2));
    const float ps0 = fmaxf(pm0, 1e-30f) / 127.f;
    const float ps1 = fmaxf(pm1, 1e-30f) / 127.f;

    // ---- pass 3: p8 and the PV product
    int acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int kv0 = kt * BK;
      __syncthreads();
      load_tile_s8(sK, sks, kh + (long long)kv0 * D, ksh + kv0, T - kv0);
      load_tile_s8(sV, svs, vh + (long long)kv0 * D, vsh + kv0, T - kv0);
      __syncthreads();
      float s[8][4];
      scores_s8(s, qa, sK, sks, kv0, T, qs0, qs1, g, t4);
      // p8 codes, in place of the scores
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kl = j * 8 + t4 * 2;
        s[j][0] = code8((expf(s[j][0] - m0) / l0) * svs[kl], ps0);
        s[j][1] = code8((expf(s[j][1] - m0) / l0) * svs[kl + 1], ps0);
        s[j][2] = code8((expf(s[j][2] - m1) / l1) * svs[kl], ps1);
        s[j][3] = code8((expf(s[j][3] - m1) / l1) * svs[kl + 1], ps1);
      }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {  // 32 keys per k-step
        const int j0 = kc * 4;
        uint32_t pa[4];
        pa[0] = pack_s8(s[j0][0], s[j0][1], s[j0 + 1][0], s[j0 + 1][1]);
        pa[1] = pack_s8(s[j0][2], s[j0][3], s[j0 + 1][2], s[j0 + 1][3]);
        pa[2] = pack_s8(s[j0 + 2][0], s[j0 + 2][1], s[j0 + 3][0],
                        s[j0 + 3][1]);
        pa[3] = pack_s8(s[j0 + 2][2], s[j0 + 2][3], s[j0 + 3][2],
                        s[j0 + 3][3]);
        // B rows (keys) in the same order: {2t, 2t+1, 8+2t, 9+2t} (+16)
        const unsigned char* vr = reinterpret_cast<const unsigned char*>(
            sV + (kc * 32 + t4 * 2) * LDB + g);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned char* p = vr + j * 8;
          const uint32_t b0 = (uint32_t)p[0] | ((uint32_t)p[LDB] << 8) |
                              ((uint32_t)p[8 * LDB] << 16) |
                              ((uint32_t)p[9 * LDB] << 24);
          const uint32_t b1 = (uint32_t)p[16 * LDB] |
                              ((uint32_t)p[17 * LDB] << 8) |
                              ((uint32_t)p[24 * LDB] << 16) |
                              ((uint32_t)p[25 * LDB] << 24);
          mma_s8(acc[j], pa, b0, b1);
        }
      }
    }
    // ---- out_h = (float)pv * ps, rounded to bf16 into the merged tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * D + j * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(sA + (warp * 16 + g) * (HD + 8) + col) =
          pack_bf16((float)acc[j][0] * ps0, (float)acc[j][1] * ps0);
      *reinterpret_cast<uint32_t*>(sA + (warp * 16 + g + 8) * (HD + 8) + col) =
          pack_bf16((float)acc[j][2] * ps1, (float)acc[j][3] * ps1);
    }
  }
  // the two 64x80-byte int8 tiles together hold the 64x72 bf16 Wo tile
  o_proj_residual(sA, reinterpret_cast<bf16*>(sK), x, wo, bo, out, b, q0, T,
                  HD);
}

int smem_bytes(int HD) {
  return 2 * 64 * LDB + 2 * 64 * (int)sizeof(float) +
         BQ * (HD + 8) * (int)sizeof(bf16);
}

}  // namespace

// Raises the kernel's dynamic shared-memory limit to the card's opt-in
// maximum per block. Called once, when the library is loaded.
extern "C" int mas_attn_o_residual_int8_init(void) {
  return (int)allow_max_smem(attn_o_residual_int8_kernel);
}

// q: [B, H, T, 64] bf16 view (strides sb, sh, st; unit last stride);
// k8, v8: [B, H, T, 64] int8 contiguous; ks, vs: [B, H, T] float32
// contiguous; x/out: [B, T, HD] contiguous bf16; wo: [HD, HD] bf16 ([in,
// out]); bo: [HD] bf16; HD = H * 64. scale = 1/sqrt(64). Returns
// cudaGetLastError() after the launch.
extern "C" int mas_attn_o_residual_int8(
    const void* q, long long sb, long long sh, long long st, const void* k8,
    const void* ks, const void* v8, const void* vs, const void* x,
    const void* wo, const void* bo, void* out, int B, int H, int T, int HD,
    float scale, void* stream) {
  dim3 grid((T + BQ - 1) / BQ, B);
  attn_o_residual_int8_kernel<<<grid, NT, smem_bytes(HD),
                                (cudaStream_t)stream>>>(
      (const bf16*)q, sb, sh, st, (const int8_t*)k8, (const float*)ks,
      (const int8_t*)v8, (const float*)vs, (const bf16*)x, (const bf16*)wo,
      (const bf16*)bo, (bf16*)out, T, H, HD, scale);
  return (int)cudaGetLastError();
}
