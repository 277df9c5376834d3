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
// to even, as jnp.round) and every division gives a true division's bits
// (div_row), so the codes are the TPU kernel's wherever exp and the
// float32 sum l agree.
//
// Replaces multimodal_audio_search_tpu/ops/encoder_block.py::
// fused_attention_o_residual with qk_int8=True (body _attn_o_kernel_int8
// :183, pallas_call :319).
//
// K9p, K9's partial form on one rank of the mesh's model axis (tensor
// parallelism): q/k8/v8/ks/vs of the rank's H heads (the per-(b, h, t)
// scales of a head shard are the whole layer's, bit for bit) and the
// rank's [H * 64, HDO] row shard of Wo; out32 = (out_h, heads merged, in
// bf16) @ Wo_rows in float32, without x and bo, which parallel/mesh.py::
// model_sum adds once to the ranks' sum (as K1p, encoder_block_wgmma.cu).
// The head shard of the JAX kernel's non-square Wo. The attention is K9's
// loop unchanged; the o-projection's warpgroups take the HDO / 64 output
// chunks in turn, each over the rank's H 64-row chunks of Wo.
//
// K9's and K9p's float32 forms (mas_attn_o_residual_int8_f32, _partial_
// f32): the TPU kernel casts q, Wo and bo to x's dtype, so on float32 q is
// read as float32 and quantized with no bf16 rounding, and the heads'
// outputs (float)pv * ps stay float32 (attn.astype(wo.dtype) is no
// rounding). The merged tile would then not fit where the bf16 one lives:
// 64 x (H*64 + 8) float32 is 322 KB at H*64 = 1280, past a block's 227
// KB. So the C entry makes two launches: (1) K9's loop unchanged (the int8
// dots on wgmma .s32.s8.s8, the same codes) with the F32 flag, which
// stores each head's float32 output to a [B, T, H*64] float32 scratch of
// the wrapper's and stops, its ring taking the shared memory the tile
// left (4 stages at every width); (2) project_f32_kernel, the scratch @
// Wo in 3xTF32 by tf32x3::project_chunk, the o-projection stage of K1's
// float32 form (encoder_block_f32.cu), + bo + x (K9p: the float32 partial
// alone), a block per (64-column output chunk, batch, 64-row tile). A
// second launch, not the stage inside K9's kernel: K9's warpgroups each
// hold 28-36 KB of ring, where project_chunk's two stages take 72 KB, and
// its producer / consumer split would have to be rebuilt around it; as a
// launch of its own it is the very code K1's float32 form runs (the same
// sums in the same order), at three blocks an SM, and reads the scratch
// while L2 still holds most of it.
//
// What bounds it on an H100. Tensor-core work: at B=32, T=1500, H=8 the
// two attention dots are ~147 G integer ops (1,979 TOP/s, 0.074 ms) and
// the o-projection ~25 GFLOP bf16 (989 TFLOP/s); three passes over K make
// the QK^T work three times that. With a head dim of 64 the per-score
// work on the CUDA cores weighs more: as the TPU kernel rounds it, each
// score takes three exp and three true divisions (p / l twice, pw / ps
// once), ~6 MUFU operations with expf and IEEE divisions, so 576 M scores
// are ~3.5 G MUFU operations, 0.8-1 ms on 132 SMs at 1.7-2 GHz. This
// kernel takes exp as one FFMA and the MUFU exp2 (as K8) and each
// division as a row reciprocal with a correction step that gives the
// true division's bits (div_row): three MUFU operations a score and ~37
// instructions over the three passes, ~0.7 ms of issue on 132 SMs.
//
// Design, on K8's skeleton (encoder_attention.cu, sm90.cuh):
//   * A block is 64 query rows of one batch row: NWG consumer warpgroups
//     on the same 64 rows taking heads in turn (warpgroup w the heads w,
//     w + NWG, ...), so the merged [64, H*64] bf16 tile is shared and an
//     SM holds 4 NWG computing warps, and a producer warpgroup (lane w of
//     its first warp feeds warpgroup w's ring). NWG is 4, or 3 where H is
//     a multiple of 3 and not of 4 (H = 6: two heads each, where 4 would
//     leave two warpgroups one head). The consumers take the producers'
//     registers with setmaxnreg: 112 each at NWG = 4 (a block of 640
//     threads otherwise gets 96, and spilled), 160 at 3.
//   * A producer lane keeps its warpgroup's ring of STAGES slots full by
//     TMA: a 64-key int8 K tile (rank-3 map over [B*H, T, 64], 64-byte
//     swizzle), its 64 ks and vs (rank-2 maps over [B*H, Ts] scales; a
//     map's row pitch is a multiple of 16 bytes, so for T % 4 != 0 the
//     wrapper pads the rows to Ts = T rounded up to 4, and a 1-D bulk
//     copy, which wants 16-byte aligned rows too, could not take them)
//     and, in the third pass, the V tile (no swizzle). Rows past T arrive
//     as zeros; the consumers set those keys' scores to -inf. Consumers
//     release a slot per warp, after a proxy fence (release_slot).
//   * QK^T is wgmma.mma_async m64n64k32 .s32.s8.s8: q8 forms the A
//     fragments in registers (m16n8k32 layout per warp), the K tile is the
//     K-major B operand (two k-steps of 32 bytes). 64-key tiles keep the
//     scores in 32 registers, which is what lets four warpgroups fit.
//   * The per-row p quantization needs the whole row's max of pw, which an
//     online softmax does not have, so each head takes three passes over
//     its K tiles, each from the ring: (1) the row max m and sum l, online;
//     (2) pw with the final m and l, and its row max -> ps; (3) p8 and PV.
//   * PV: 8-bit wgmma takes K-major operands only (PTX has no transpose
//     bit for them), so V must sit in shared memory as [64 d-rows x 64
//     keys]. The consumers transpose each V tile once it lands (4 x 4 byte
//     blocks with __byte_perm) into a 64-byte-swizzled buffer, in the
//     contraction order the S accumulators give the p8 codes: A position
//     16 * half + 4t + i of a 32-key step holds key 16 * half + 2t + (i &
//     1) + 8 (i >> 1) (the thread's keys 2t, 2t + 1 of each 8-key column
//     tile), the same permutation in A and B, which leaves the integer sum
//     unchanged. p8 then goes from the S accumulators straight into A
//     fragments, and O += P8 V is two wgmma m64n64k32 .s32.s8.s8. The
//     other way, a v8 written by the wrapper as [B, H, 64, T padded], costs
//     an extra pass over 24.6 MB a layer at base width (PERF.md: that copy
//     alone takes longer than the in-kernel transposes).
//   * Integer sums are exact; (float) of an int32 sum rounds as the TPU's
//     int32 -> float32 conversion does (|pv| <= T * 127^2 exceeds 2^24 at
//     T=1500).
//   * Each head's bf16 output goes to the merged tile; then x + tile @ Wo
//     + bo on mma.sync (K1's epilogue arithmetic), the warpgroups taking
//     64-column chunks of the output in turn, each 64 x 64 Wo tile brought
//     into the warpgroup's ring by its producer (TMA, 128-byte swizzle)
//     while the last head's pass 3 runs.
// Shared memory: NWG x STAGES x 9 KB of ring, NWG x 4 KB of transposed V
// and the 64 x (H*64 + 8) bf16 tile: STAGES is 4 at base width and falls
// to 1 at H*64 = 1280 (the limit: the tile alone is 161 KB there).
#include <type_traits>

#include "encoder_common.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace enc;
using namespace sm90;

constexpr int BN = 64;              // keys a K/V tile
constexpr int KT_BYTES = BN * D;    // an int8 K or V tile
// K, V, ks, vs; 1024-byte aligned (a Wo tile, 8 KB, lands in a slot too)
constexpr int SLOT = 9216;
static_assert(SLOT >= 2 * KT_BYTES + 2 * BN * 4 && SLOT % 1024 == 0, "");
constexpr int WO_BYTES = 64 * 64 * 2;  // a 64 x 64 bf16 Wo tile
constexpr int VT_BYTES = D * BN;    // a transposed V tile
constexpr int MAX_STAGES = 4;
constexpr int MAX_WG = 4;
constexpr int SMEM_OPTIN = 232448;  // an H100 block's shared-memory limit
constexpr int BARS = 2 * MAX_WG * MAX_STAGES * 8;
// registers a consumer thread: a block of 128 (NWG + 1) threads is given
// 65,536 / its size each (96 at NWG = 4, 128 at 3), and the producer
// warpgroup hands all but PRODUCER_REGS of its own to the consumers
// (setmaxnreg.inc waits for the block's own freed registers, so asking
// more than the block holds hangs)
constexpr int PRODUCER_REGS = 32;
template <int NWG>
__host__ __device__ constexpr int consumer_regs() {
  return (65536 / (128 * (NWG + 1)) / 8 * 8 * (NWG + 1) - PRODUCER_REGS) /
         NWG / 8 * 8;
}

// consumer warpgroups: 4, or 3 where H is a multiple of 3 and not of 4
// (H = 6: two heads each)
inline int warpgroups(int H) { return H % 4 != 0 && H % 3 == 0 ? 3 : 4; }
// the merged bf16 tile (none in the float32 form, whose heads go to a
// float32 scratch in device memory)
__host__ __device__ inline int tile_bytes(int HD, bool f32) {
  return f32 ? 0 : BQ * (HD + 8) * 2;
}
inline int stages_for(int HD, int nwg, bool f32) {
  const int s = (SMEM_OPTIN - 1024 - nwg * VT_BYTES - tile_bytes(HD, f32) -
                 BARS) / (nwg * SLOT);
  return s < MAX_STAGES ? s : MAX_STAGES;
}
inline int smem_bytes(int HD, int nwg, int stages, bool f32) {
  return 1024 + nwg * stages * SLOT + nwg * VT_BYTES + tile_bytes(HD, f32) +
         BARS;
}

__device__ __forceinline__ float code8(float v, float s) {
  return fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

// p8 = clip(rint(pw / ps)) for 0 <= pw <= max pw = 127 ps (1 + 2^-24 at
// most, from ps's rounding): the quotient rounds into [0, 127], so the clip
// is the identity and one conversion (round to nearest even) does rint
__device__ __forceinline__ int code8_row(float v, float s, float r) {
  return __float2int_rn(div_row(v, s, r));
}

// four codes (lowest index in the lowest byte)
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return ((uint32_t)a & 0xffu) | (((uint32_t)b & 0xffu) << 8) |
         (((uint32_t)c & 0xffu) << 16) | (((uint32_t)d & 0xffu) << 24);
}

constexpr float L2E = 1.4426950408889634f;  // log2(e)

// exp(s - m) as 2^(s log2(e) - m log2(e)): one FFMA and the SM's MUFU
// exp2 (2 ulp; results below 2^-126 flush to 0, far below any code or
// sum that matters), as K8 takes it; expf spent 8 instructions a score
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp_m(float s, float mL) {
  return ex2(fmaf(s, L2E, -mL));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A warp's release of a ring slot it read with plain loads (scales, Wo):
// the slot's next TMA write is an async-proxy access, which the arrival
// alone does not order after those loads (a Wo tile's last loads were
// still in flight at the arrival and, in about 1 % of launches, read the
// next tile's data); the proxy fence does.
__device__ __forceinline__ void release_slot(uint64_t* bar, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// named barriers: 1 + w the 128 threads of consumer warpgroup w, NWG + 1
// every consumer
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// bf16 element (k, n) of a 64 x 64 Wo tile as TMA wrote it with the
// 128-byte swizzle (rows of 128 bytes, 16-byte chunk c of row k at c ^ (k
// % 8)): the B operand of the o-projection, read without bank conflicts
__device__ __forceinline__ uint32_t ldw(const uint8_t* w, int k, int n) {
  return *reinterpret_cast<const uint16_t*>(
      w + k * 128 + (((n >> 3) ^ (k & 7)) << 4) + ((n & 7) << 1));
}

// S = q8 . K^T over a tile's 64 keys (two 32-byte k-steps). The warp is
// reconverged first: wgmma's .aligned forms need every lane together, and
// the mbarrier spin before a call may leave them apart.
__device__ __forceinline__ void issue_scores(int c[32], const uint32_t qa[2][4],
                                             const int8_t* sK) {
  const uint64_t dk = desc_sw64(sK);
  __syncwarp();
  wg_fence();
  wgmma_m64n64k32_s8_rs<false>(c, qa[0], dk);
  wgmma_m64n64k32_s8_rs<true>(c, qa[1], dk + 2);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(c[i]);
}

// c -> s = ((float)c * qs) * ks in place (the float's bits in c), for rows
// g, g + 8 of the warp, keys kv0 + 8jn + 2t + 0..1; keys >= T set to -inf
// (only the last tile has any). One array of 32 registers holds the
// products, the scores and the codes.
__device__ __forceinline__ void scores(int c[32], const float* sks, int kv0,
                                       int T, float qs0, float qs1, int t4) {
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int kl = jn * 8 + t4 * 2;
    const float2 k2 = *reinterpret_cast<const float2*>(sks + kl);
    c[4 * jn] = __float_as_int(((float)c[4 * jn] * qs0) * k2.x);
    c[4 * jn + 1] = __float_as_int(((float)c[4 * jn + 1] * qs0) * k2.y);
    c[4 * jn + 2] = __float_as_int(((float)c[4 * jn + 2] * qs1) * k2.x);
    c[4 * jn + 3] = __float_as_int(((float)c[4 * jn + 3] * qs1) * k2.y);
  }
  if (kv0 + BN > T) {
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int key = kv0 + jn * 8 + t4 * 2;
      if (key >= T) c[4 * jn] = c[4 * jn + 2] = __float_as_int(-INFINITY);
      if (key + 1 >= T)
        c[4 * jn + 1] = c[4 * jn + 3] = __float_as_int(-INFINITY);
    }
  }
}
#define S(i) __int_as_float(c[i])

// The V tile [64 keys][64] (rows of 64 bytes) -> Vt [64 d][64 keys],
// 64-byte swizzled (16-byte chunk c of row d at c ^ ((d / 2) % 4)), keys in
// the contraction order above. Thread tid of the warpgroup: columns 4 (tid
// / 2 % 16) .. + 3 of the 16-key chunk tid / 32, its words 2 (tid % 2)
// and 2 (tid % 2) + 1; word w of a chunk holds keys 2w, 2w + 1, 2w + 8,
// 2w + 9 of it.
__device__ __forceinline__ void transpose_v(uint8_t* vt, const int8_t* v,
                                            int tid) {
  const int wh = tid & 1, d0 = (tid >> 1 & 15) * 4, c = tid >> 5;
  const int base = c * 16;
  uint32_t o[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int w = 2 * wh + i;
    const int r = base + 2 * w;
    const uint32_t x0 = *reinterpret_cast<const uint32_t*>(v + r * D + d0);
    const uint32_t x1 = *reinterpret_cast<const uint32_t*>(v + (r + 1) * D + d0);
    const uint32_t x2 = *reinterpret_cast<const uint32_t*>(v + (r + 8) * D + d0);
    const uint32_t x3 = *reinterpret_cast<const uint32_t*>(v + (r + 9) * D + d0);
    const uint32_t lo01 = __byte_perm(x0, x1, 0x5140);
    const uint32_t hi01 = __byte_perm(x0, x1, 0x7362);
    const uint32_t lo23 = __byte_perm(x2, x3, 0x5140);
    const uint32_t hi23 = __byte_perm(x2, x3, 0x7362);
    o[0][i] = __byte_perm(lo01, lo23, 0x5410);
    o[1][i] = __byte_perm(lo01, lo23, 0x7632);
    o[2][i] = __byte_perm(hi01, hi23, 0x5410);
    o[3][i] = __byte_perm(hi01, hi23, 0x7632);
  }
#pragma unroll
  for (int dd = 0; dd < 4; ++dd) {
    const int d = d0 + dd;
    *reinterpret_cast<uint2*>(vt + d * BN + ((c ^ ((d >> 1) & 3)) << 4) +
                              8 * wh) = make_uint2(o[dd][0], o[dd][1]);
  }
}

// K9 (PARTIAL false): out = x + tile @ Wo + bo, HDO = HD. K9p (true):
// out32 = tile @ Wo_rows in float32, Wo_rows [HD, HDO]; x, bo, out unread.
// F32 (the float32 forms' first launch): q float32, and each head's
// float32 output (unrounded) stored to out32, a [B, T, HD] scratch that
// project_f32_kernel then projects; Wo, x, bo, out unread, PARTIAL unused.
template <int NWG, bool PARTIAL, bool F32 = false>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    attn_o_residual_int8_kernel(
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tks,
        const __grid_constant__ CUtensorMap tvs,
        const __grid_constant__ CUtensorMap tw, const void* __restrict__ qv,
        long long sb, long long sh, long long st, const bf16* __restrict__ x,
        const bf16* __restrict__ bo, bf16* __restrict__ out,
        float* __restrict__ out32, int T, int H, int HD, int HDO, int stages,
        float scale) {
  extern __shared__ unsigned char smem_raw[];
  using QT = std::conditional_t<F32, float, bf16>;
  const QT* q = static_cast<const QT*>(qv);
  // swizzled tiles start on 1024-byte boundaries
  uint8_t* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base;                              // [NWG][stages][SLOT]
  uint8_t* vts = ring + NWG * stages * SLOT;         // [NWG][VT_BYTES]
  bf16* sA = reinterpret_cast<bf16*>(vts + NWG * VT_BYTES);  // [BQ][HD + 8]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sA) + tile_bytes(HD, F32));  // [NWG][MAX_STAGES]
  uint64_t* empty = full + NWG * MAX_STAGES;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (T + BN - 1) / BN;
  const int n_chunks = HD / 64;   // the merged tile's 64-column chunks
  const int n_out = F32 ? 0 : HDO / 64;  // the output's (F32: none here)
  const int warp_id = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NWG * MAX_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp_id >= NWG * 4) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    const int wg = threadIdx.x - NWG * 128;  // lane w of its first warp
    if (wg < NWG) {                          // feeds ring w
      if (wg == 0) {
        prefetch_map(&tk);
        prefetch_map(&tv);
        prefetch_map(&tks);
        prefetch_map(&tvs);
        prefetch_map(&tw);
      }
      int it = 0;
      for (int h = wg; h < H; h += NWG) {
        const int row = b * H + h;
        for (int pass = 0; pass < 3; ++pass)
          for (int j = 0; j < n_tiles; ++j, ++it) {
            const int s = it % stages;
            uint8_t* slot = ring + (wg * stages + s) * SLOT;
            uint64_t* bar = &full[wg * MAX_STAGES + s];
            mbar_wait(&empty[wg * MAX_STAGES + s], ((it / stages) & 1) ^ 1);
            mbar_expect_tx(bar, KT_BYTES + 2 * BN * 4 +
                                    (pass == 2 ? KT_BYTES : 0));
            tma_load_3d(slot, &tk, bar, 0, j * BN, row);
            tma_load_2d(slot + 2 * KT_BYTES, &tks, bar, j * BN, row);
            tma_load_2d(slot + 2 * KT_BYTES + BN * 4, &tvs, bar, j * BN, row);
            if (pass == 2) tma_load_3d(slot + KT_BYTES, &tv, bar, 0, j * BN, row);
          }
      }
      // then the Wo tiles of the warpgroup's output columns
      for (int nc = wg; nc < n_out; nc += NWG)
        for (int kc = 0; kc < n_chunks; ++kc, ++it) {
          const int s = it % stages;
          uint64_t* bar = &full[wg * MAX_STAGES + s];
          mbar_wait(&empty[wg * MAX_STAGES + s], ((it / stages) & 1) ^ 1);
          mbar_expect_tx(bar, WO_BYTES);
          tma_load_2d(ring + (wg * stages + s) * SLOT, &tw, bar, nc * 64,
                      kc * 64);
        }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows q0 .. q0 + 63, heads wg, wg + NWG, ...
  setmaxnreg_inc<consumer_regs<NWG>()>();
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  uint8_t* vt = vts + wg * VT_BYTES;
  uint64_t* wfull = full + wg * MAX_STAGES;
  uint64_t* wempty = empty + wg * MAX_STAGES;
  int it = 0;

  for (int h = wg; h < H; h += NWG) {
    // ---- q8 and qs for rows ra, rb: columns 4t..4t+3 (+16, +32, +48)
    const QT* qh = q + b * sb + h * sh;
    float qf[2][16];
    float amax0 = 0.f, amax1 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int cc = c4 * 16 + t4 * 4;
#pragma unroll
      for (int hw = 0; hw < 2; ++hw) {
        float2 va = make_float2(0.f, 0.f), vb = va;
        if constexpr (F32) {  // float32 q, quantized as it is
          if (ra < T)
            va = *reinterpret_cast<const float2*>(qh + ra * st + cc + 2 * hw);
          if (rb < T)
            vb = *reinterpret_cast<const float2*>(qh + rb * st + cc + 2 * hw);
        } else {
          if (ra < T) va = unpack_bf16(ld32(qh + ra * st + cc + 2 * hw));
          if (rb < T) vb = unpack_bf16(ld32(qh + rb * st + cc + 2 * hw));
        }
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
    const float qs0 = fmaxf(quad_max(amax0), 1e-12f) / 127.f;
    const float qs1 = fmaxf(quad_max(amax1), 1e-12f) / 127.f;
    // A fragments: k-step kk covers columns kk*32 ..; a0/a2 row g, a1/a3
    // row g + 8; a0/a1 columns 4t.., a2/a3 columns 16 + 4t..
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = (kk * 2 + half) * 4;
        qa[kk][half * 2] = pack_s8(
            (int)code8(qf[0][i], qs0), (int)code8(qf[0][i + 1], qs0),
            (int)code8(qf[0][i + 2], qs0), (int)code8(qf[0][i + 3], qs0));
        qa[kk][half * 2 + 1] = pack_s8(
            (int)code8(qf[1][i], qs1), (int)code8(qf[1][i + 1], qs1),
            (int)code8(qf[1][i + 2], qs1), (int)code8(qf[1][i + 3], qs1));
      }
    }

    int c[32];
    // ---- pass 1: row max m and sum l (online)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int si = it % stages;
      const uint8_t* slot = ring + (wg * stages + si) * SLOT;
      mbar_wait(&wfull[si], (it / stages) & 1);
      issue_scores(c, qa, reinterpret_cast<const int8_t*>(slot));
      scores(c, reinterpret_cast<const float*>(slot + 2 * KT_BYTES), j * BN,
             T, qs0, qs1, t4);
      release_slot(&wempty[si], lane);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        mx0 = fmaxf(mx0, fmaxf(S(4 * jn), S(4 * jn + 1)));
        mx1 = fmaxf(mx1, fmaxf(S(4 * jn + 2), S(4 * jn + 3)));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float mL0 = mx0 * L2E, mL1 = mx1 * L2E;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        rs0 += exp_m(S(4 * jn), mL0) + exp_m(S(4 * jn + 1), mL0);
        rs1 += exp_m(S(4 * jn + 2), mL1) + exp_m(S(4 * jn + 3), mL1);
      }
      l0 = l0 * ex2((m0 - mx0) * L2E) + rs0;
      l1 = l1 * ex2((m1 - mx1) * L2E) + rs1;
      m0 = mx0;
      m1 = mx1;
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float rl0 = 1.f / l0, rl1 = 1.f / l1;
    const float mL0 = m0 * L2E, mL1 = m1 * L2E;

    // ---- pass 2: pw = (exp(s - m) / l) * vs and its row max -> ps
    float pm0 = 0.f, pm1 = 0.f;
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int si = it % stages;
      const uint8_t* slot = ring + (wg * stages + si) * SLOT;
      mbar_wait(&wfull[si], (it / stages) & 1);
      issue_scores(c, qa, reinterpret_cast<const int8_t*>(slot));
      const float* sks = reinterpret_cast<const float*>(slot + 2 * KT_BYTES);
      scores(c, sks, j * BN, T, qs0, qs1, t4);
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(sks + BN + jn * 8 + t4 * 2);
        pm0 = fmaxf(pm0,
                    fmaxf(div_row(exp_m(S(4 * jn), mL0), l0, rl0) * v2.x,
                          div_row(exp_m(S(4 * jn + 1), mL0), l0, rl0) * v2.y));
        pm1 = fmaxf(pm1,
                    fmaxf(div_row(exp_m(S(4 * jn + 2), mL1), l1, rl1) * v2.x,
                          div_row(exp_m(S(4 * jn + 3), mL1), l1, rl1) * v2.y));
      }
      release_slot(&wempty[si], lane);
    }
    const float ps0 = fmaxf(quad_max(pm0), 1e-30f) / 127.f;
    const float ps1 = fmaxf(quad_max(pm1), 1e-30f) / 127.f;
    const float rps0 = 1.f / ps0, rps1 = 1.f / ps1;

    // ---- pass 3: p8 and the PV product
    int o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0;
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int si = it % stages;
      const uint8_t* slot = ring + (wg * stages + si) * SLOT;
      mbar_wait(&wfull[si], (it / stages) & 1);
      // also waits for this warp's share of the last tile's PV product,
      // which read vt (the other warps' shares: the barrier below)
      issue_scores(c, qa, reinterpret_cast<const int8_t*>(slot));
      const float* sks = reinterpret_cast<const float*>(slot + 2 * KT_BYTES);
      scores(c, sks, j * BN, T, qs0, qs1, t4);
      // the p8 codes as ints, in place
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(sks + BN + jn * 8 + t4 * 2);
        c[4 * jn] = code8_row(
            div_row(exp_m(S(4 * jn), mL0), l0, rl0) * v2.x, ps0, rps0);
        c[4 * jn + 1] = code8_row(
            div_row(exp_m(S(4 * jn + 1), mL0), l0, rl0) * v2.y, ps0, rps0);
        c[4 * jn + 2] = code8_row(
            div_row(exp_m(S(4 * jn + 2), mL1), l1, rl1) * v2.x, ps1, rps1);
        c[4 * jn + 3] = code8_row(
            div_row(exp_m(S(4 * jn + 3), mL1), l1, rl1) * v2.y, ps1, rps1);
      }
      // each warp's wgmma share reads the whole of vt, and a warp's
      // wait_group covers the groups its own threads committed: vt is
      // rewritten once every warp has waited for the last tile's product
      bar_sync(1 + wg, 128);
      transpose_v(vt, reinterpret_cast<const int8_t*>(slot + KT_BYTES), tid);
      fence_proxy_async();  // vt for wgmma; the slot's loads before its TMA
      bar_sync(1 + wg, 128);  // vt written, the slot read by every warp
      if (lane == 0) mbar_arrive(&wempty[si]);
      uint32_t pa[2][4];
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {  // 32 keys a k-step
        const int* e = c + 16 * kc;
        pa[kc][0] = pack_s8(e[0], e[1], e[4], e[5]);
        pa[kc][1] = pack_s8(e[2], e[3], e[6], e[7]);
        pa[kc][2] = pack_s8(e[8], e[9], e[12], e[13]);
        pa[kc][3] = pack_s8(e[10], e[11], e[14], e[15]);
      }
      const uint64_t dv = desc_sw64(vt);
      __syncwarp();
      wg_fence();
      wgmma_m64n64k32_s8_rs<true>(o, pa[0], dv);
      wgmma_m64n64k32_s8_rs<true>(o, pa[1], dv + 2);
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(o[i]);
    if constexpr (F32) {
      // ---- out_h = (float)pv * ps, float32, to the scratch's rows < T
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const int col = h * D + jd * 8 + t4 * 2;
        if (ra < T)
          *reinterpret_cast<float2*>(out32 + ((long long)b * T + ra) * HD +
                                     col) =
              make_float2((float)o[4 * jd] * ps0, (float)o[4 * jd + 1] * ps0);
        if (rb < T)
          *reinterpret_cast<float2*>(out32 + ((long long)b * T + rb) * HD +
                                     col) =
              make_float2((float)o[4 * jd + 2] * ps1,
                          (float)o[4 * jd + 3] * ps1);
      }
      continue;
    }
    // ---- out_h = (float)pv * ps, rounded to bf16 into the merged tile
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int col = h * D + jd * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(sA + (warp * 16 + g) * (HD + 8) + col) =
          pack_bf16((float)o[4 * jd] * ps0, (float)o[4 * jd + 1] * ps0);
      *reinterpret_cast<uint32_t*>(sA + (warp * 16 + g + 8) * (HD + 8) + col) =
          pack_bf16((float)o[4 * jd + 2] * ps1, (float)o[4 * jd + 3] * ps1);
    }
  }
#undef S
  if constexpr (F32) return;  // the heads are in the scratch
  bar_sync(NWG + 1, NWG * 128);  // every head's output is in the merged tile

  // ---- out = x + sA @ Wo + bo, 64 output columns a chunk: warpgroup wg
  // the chunks wg, wg + NWG, ..., each of its 64 x 64 Wo tiles from its ring
  // (K9p: out32 = sA @ Wo_rows over the HDO / 64 output chunks)
  const int HDP = HD + 8;
  for (int nc = wg; nc < n_out; nc += NWG) {
    float y[8][4];
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) y[jd][0] = y[jd][1] = y[jd][2] = y[jd][3] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc, ++it) {
      const int si = it % stages;
      const uint8_t* w = ring + (wg * stages + si) * SLOT;
      mbar_wait(&wfull[si], (it / stages) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* ar = sA + (warp * 16 + g) * HDP + kc * 64 + kk * 16 + t4 * 2;
        uint32_t a[4];
        a[0] = ld32(ar);
        a[1] = ld32(ar + 8 * HDP);
        a[2] = ld32(ar + 8);
        a[3] = ld32(ar + 8 * HDP + 8);
        const int k = kk * 16 + t4 * 2;
#pragma unroll
        for (int jd = 0; jd < 8; ++jd) {
          const int n = jd * 8 + g;
          mma_16816(y[jd], a, ldw(w, k, n) | ldw(w, k + 1, n) << 16,
                    ldw(w, k + 8, n) | ldw(w, k + 9, n) << 16);
        }
      }
      release_slot(&wempty[si], lane);
    }
    if constexpr (PARTIAL) {
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const int col = nc * 64 + jd * 8 + t4 * 2;
        if (ra < T)
          *reinterpret_cast<float2*>(out32 + ((long long)b * T + ra) * HDO +
                                     col) = make_float2(y[jd][0], y[jd][1]);
        if (rb < T)
          *reinterpret_cast<float2*>(out32 + ((long long)b * T + rb) * HDO +
                                     col) = make_float2(y[jd][2], y[jd][3]);
      }
      continue;
    }
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int col = nc * 64 + jd * 8 + t4 * 2;
      const float2 bv = unpack_bf16(ld32(bo + col));
      if (ra < T) {
        const long long i = ((long long)b * T + ra) * HD + col;
        const float2 xv = unpack_bf16(ld32(x + i));
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(xv.x + y[jd][0] + bv.x, xv.y + y[jd][1] + bv.y);
      }
      if (rb < T) {
        const long long i = ((long long)b * T + rb) * HD + col;
        const float2 xv = unpack_bf16(ld32(x + i));
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(xv.x + y[jd][2] + bv.x, xv.y + y[jd][3] + bv.y);
      }
    }
  }
}

// The float32 forms' second launch: one (64-column output chunk, batch,
// 64-row) tile of merged @ Wo in 3xTF32 (tf32x3::project_chunk, the
// o-projection of K1's float32 form), merged the [B, T, HD] float32 head
// outputs; + bo + x into out (PARTIAL: the float32 partial alone).
template <bool PARTIAL>
__global__ void __launch_bounds__(tf32x3::NT, 3) project_f32_kernel(
    const float* __restrict__ merged, const float* __restrict__ wo,
    const float* __restrict__ x, const float* __restrict__ bo,
    float* __restrict__ out, int T, int HD, int HDO) {
  extern __shared__ __align__(16) float psmem[];
  const int b = blockIdx.z;
  const long long row0 = (long long)b * T * HDO;
  tf32x3::project_chunk<PARTIAL>(merged + (long long)b * T * HD, HD, HD / D,
                                 wo, HDO, blockIdx.x,
                                 blockIdx.y * tf32x3::ROWS, T,
                                 PARTIAL ? nullptr : x + row0, bo,
                                 out + row0, psmem);
}

MapCache<64> maps;

// div_row against the true division: counts the n quotients x[i] / d[i]
// where they differ in any bit.
__global__ void division_check_kernel(const float* __restrict__ x,
                                      const float* __restrict__ d,
                                      unsigned long long* bad, long long n) {
  unsigned long long k = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float r = 1.f / d[i];
    k += __float_as_uint(div_row(x[i], d[i], r)) !=
         __float_as_uint(x[i] / d[i]);
  }
  if (k) atomicAdd(bad, k);
}

}  // namespace

// Raises the kernel's dynamic shared-memory limit to the card's opt-in
// maximum per block and looks the tensor-map encoder up. Called once,
// when the library is loaded.
extern "C" int mas_attn_o_residual_int8_init(void) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaError_t e = allow_max_smem(attn_o_residual_int8_kernel<3, false>);
  if (e == cudaSuccess) e = allow_max_smem(attn_o_residual_int8_kernel<4, false>);
  if (e == cudaSuccess) e = allow_max_smem(attn_o_residual_int8_kernel<3, true>);
  if (e == cudaSuccess) e = allow_max_smem(attn_o_residual_int8_kernel<4, true>);
  if (e == cudaSuccess)
    e = allow_max_smem(attn_o_residual_int8_kernel<3, false, true>);
  if (e == cudaSuccess)
    e = allow_max_smem(attn_o_residual_int8_kernel<4, false, true>);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(project_f32_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tf32x3::SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(project_f32_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tf32x3::SMEM_BYTES);
  return (int)e;
}

namespace {

// K9 (out32 null: out = x + tile @ Wo + bo, HDO = HD) or K9p (x, bo, out
// null; out32 = tile @ Wo_rows, Wo [HD, HDO]). merged non-null: the
// float32 forms (q, x, wo, bo, out float32; K9p f32: out null, out32 the
// float32 partial), merged their [B, T, HD] float32 scratch of the heads.
int launch_int8(const void* q, long long sb, long long sh, long long st,
                const void* k8, const void* ks, const void* v8, const void* vs,
                const void* x, const void* wo, const void* bo, void* out,
                void* out32, int B, int H, int T, int Ts, int HD, int HDO,
                float scale, void* merged, void* stream) {
  const bool f32 = merged != nullptr;
  const int nwg = warpgroups(H);
  const int stages = stages_for(HD, nwg, f32);
  if (stages < 1 || HD != H * D || T < 1 || Ts < T || Ts % 4 || HDO < 64 ||
      HDO % 64 || (out32 == nullptr && HDO != HD))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t rows = (cuuint64_t)B * H;
  CUtensorMap tk, tv, tks, tvs, tw;
  int e = maps.get(&tk, map_spec(k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                                 {(cuuint64_t)D, (cuuint64_t)T, rows},
                                 {(cuuint64_t)D, (cuuint64_t)T * D},
                                 {(cuuint32_t)D, (cuuint32_t)BN, 1u},
                                 CU_TENSOR_MAP_SWIZZLE_64B));
  if (e == 0)
    e = maps.get(&tv, map_spec(v8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                               {(cuuint64_t)D, (cuuint64_t)T, rows},
                               {(cuuint64_t)D, (cuuint64_t)T * D},
                               {(cuuint32_t)D, (cuuint32_t)BN, 1u},
                               CU_TENSOR_MAP_SWIZZLE_NONE));
  if (e == 0)
    e = maps.get(&tks, map_spec(ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                                {(cuuint64_t)Ts, rows}, {(cuuint64_t)Ts * 4},
                                {(cuuint32_t)BN, 1u},
                                CU_TENSOR_MAP_SWIZZLE_NONE));
  if (e == 0)
    e = maps.get(&tvs, map_spec(vs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                                {(cuuint64_t)Ts, rows}, {(cuuint64_t)Ts * 4},
                                {(cuuint32_t)BN, 1u},
                                CU_TENSOR_MAP_SWIZZLE_NONE));
  if (e == 0 && !f32)  // the float32 forms' Wo is read by project_f32_kernel
    e = maps.get(&tw, map_spec(wo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                               {(cuuint64_t)HDO, (cuuint64_t)HD},
                               {(cuuint64_t)HDO * 2}, {64u, 64u},
                               CU_TENSOR_MAP_SWIZZLE_128B));
  if (e != 0) return e;
  dim3 grid((T + BQ - 1) / BQ, B);
  const size_t smem = smem_bytes(HD, nwg, stages, f32);
  cudaStream_t s = (cudaStream_t)stream;
  const bool partial = out32 != nullptr;
  if (f32) {
    // the heads into merged (tk stands in for the unread Wo map), then
    // merged @ Wo (+ bo + x) in 3xTF32, a block a 64-column output chunk
    // and (batch, 64-row) tile
    auto heads = nwg == 3 ? attn_o_residual_int8_kernel<3, false, true>
                          : attn_o_residual_int8_kernel<4, false, true>;
    heads<<<grid, (nwg + 1) * 128, smem, s>>>(
        tk, tv, tks, tvs, tk, q, sb, sh, st, nullptr, nullptr, nullptr,
        (float*)merged, T, H, HD, HD, stages, scale);
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return (int)e1;
    const dim3 pgrid(HDO / 64, (T + tf32x3::ROWS - 1) / tf32x3::ROWS, B);
    auto project = partial ? project_f32_kernel<true>
                           : project_f32_kernel<false>;
    project<<<pgrid, tf32x3::NT, tf32x3::SMEM_BYTES, s>>>(
        (const float*)merged, (const float*)wo, (const float*)x,
        (const float*)bo, partial ? (float*)out32 : (float*)out, T, HD, HDO);
    return (int)cudaGetLastError();
  }
  auto kernel = nwg == 3 ? (partial ? attn_o_residual_int8_kernel<3, true>
                                    : attn_o_residual_int8_kernel<3, false>)
                         : (partial ? attn_o_residual_int8_kernel<4, true>
                                    : attn_o_residual_int8_kernel<4, false>);
  kernel<<<grid, (nwg + 1) * 128, smem, s>>>(
      tk, tv, tks, tvs, tw, q, sb, sh, st, (const bf16*)x,
      (const bf16*)bo, (bf16*)out, (float*)out32, T, H, HD, HDO, stages,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, H, T, 64] bf16 view (strides sb, sh, st; unit last stride);
// k8, v8: [B, H, T, 64] int8 contiguous; ks, vs: [B, H, Ts] float32
// contiguous (Ts >= T a multiple of 4; entries past T are not read);
// x/out: [B, T, HD] contiguous bf16; wo: [HD, HD] bf16 ([in, out]); bo:
// [HD] bf16; HD = H * 64 <= 1280; every base 16-byte aligned. scale =
// 1/sqrt(64). Returns a cudaError_t value: a tensor map
// cuTensorMapEncodeTiled refuses, a width past 1280, or
// cudaGetLastError() after the launch.
extern "C" int mas_attn_o_residual_int8(
    const void* q, long long sb, long long sh, long long st, const void* k8,
    const void* ks, const void* v8, const void* vs, const void* x,
    const void* wo, const void* bo, void* out, int B, int H, int T, int Ts,
    int HD, float scale, void* stream) {
  return launch_int8(q, sb, sh, st, k8, ks, v8, vs, x, wo, bo, out, nullptr,
                     B, H, T, Ts, HD, HD, scale, nullptr, stream);
}

// K9p: K9's q, k8, ks, v8, vs over the rank's H heads (HD = H * 64); wo:
// [HD, HDO] row-major bf16 (the rank's row shard of the layer's
// o-projection), HDO % 64 == 0; out: [B, T, HDO] float32, contiguous,
// 8-byte aligned. Returns a cudaError_t value, as mas_attn_o_residual_int8.
extern "C" int mas_attn_o_residual_int8_partial(
    const void* q, long long sb, long long sh, long long st, const void* k8,
    const void* ks, const void* v8, const void* vs, const void* wo, void* out,
    int B, int H, int T, int Ts, int HDO, float scale, void* stream) {
  return launch_int8(q, sb, sh, st, k8, ks, v8, vs, nullptr, wo, nullptr,
                     nullptr, out, B, H, T, Ts, H * D, HDO, scale, nullptr,
                     stream);
}

// K9's float32 form: K9's arguments with q, x, wo, bo and out float32
// (out [B, T, HD], x 8-byte and wo 16-byte aligned, bo 8-byte); merged: a
// [B, T, HD] float32 scratch (the heads' unrounded outputs, projected by a
// second launch). Returns a cudaError_t value, as mas_attn_o_residual_int8.
extern "C" int mas_attn_o_residual_int8_f32(
    const void* q, long long sb, long long sh, long long st, const void* k8,
    const void* ks, const void* v8, const void* vs, const void* x,
    const void* wo, const void* bo, void* out, int B, int H, int T, int Ts,
    int HD, float scale, void* merged, void* stream) {
  if (merged == nullptr) return (int)cudaErrorInvalidValue;
  return launch_int8(q, sb, sh, st, k8, ks, v8, vs, x, wo, bo, out, nullptr,
                     B, H, T, Ts, HD, HD, scale, merged, stream);
}

// K9p's float32 form: K9p's arguments with q and wo ([H * 64, HDO])
// float32; merged as K9's float32 form's. Returns a cudaError_t value.
extern "C" int mas_attn_o_residual_int8_partial_f32(
    const void* q, long long sb, long long sh, long long st, const void* k8,
    const void* ks, const void* v8, const void* vs, const void* wo, void* out,
    int B, int H, int T, int Ts, int HDO, float scale, void* merged,
    void* stream) {
  if (merged == nullptr) return (int)cudaErrorInvalidValue;
  return launch_int8(q, sb, sh, st, k8, ks, v8, vs, nullptr, wo, nullptr,
                     nullptr, out, B, H, T, Ts, H * D, HDO, scale, merged,
                     stream);
}

// The count of x[i] / d[i] (i < n, float32 on the card) where K9's
// division by a row's reciprocal differs from the true division, added
// to *bad (a zeroed unsigned 64-bit counter on the card). Returns
// cudaGetLastError() after the launch.
extern "C" int mas_k9_division_check(const void* x, const void* d, void* bad,
                                     long long n, void* stream) {
  division_check_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)d, (unsigned long long*)bad, n);
  return (int)cudaGetLastError();
}
