// The float32 forms of K1, K1p, K10 and K10p: the encoder block's
// attention over every head, its o-projection and the residual in one
// launch, on float32 tensors.
//
// K1: out = x + (softmax(Q K^T / sqrt(64)) V, heads merged) @ Wo + bo, all
//   float32: q/k/v [B, H, T, 64] views with a unit last stride (the
//   head-split views of the q/k/v dense outputs), x and out [B, T, H*64],
//   Wo [H*64, H*64], bo [H*64]. Replaces multimodal_audio_search_tpu/ops/
//   encoder_block.py::fused_attention_o_residual (body _attn_o_kernel,
//   pallas_call :425) on float32 inputs, which the TPU kernel takes as it
//   takes bf16 (a float32 engine's default fused_encoder). The bf16 form is
//   encoder_block_wgmma.cu's K1.
// K10: the same function with the heads taken two at a time, the same
//   wrapper's pair_heads=True form (body _attn_o_kernel_paired, pallas_call
//   :375) on float32. On float32 the TPU body's block-diagonal packing adds
//   exact zeros, so K10 computes K1's function; its loop is the pair loop
//   (tf32x3::attend_pair), each head's arithmetic K1's.
// K1p, K10p (PARTIAL): one rank of the mesh's model axis, the head shard
//   of the JAX kernel's non-square Wo: the rank's H heads (K10p: its pairs;
//   a rank of odd heads takes K1p), Wo the rank's [H*64, HDO] rows, out =
//   the float32 partial [B, T, HDO] without x and bo, which parallel/
//   mesh.py::model_sum adds once to the ranks' sum.
//
// Roundings, as the plain versions' (attention_o_residual_plain,
// _paired_plain): scores, softmax and products in float32, each head's
// output divided by l; the merged attention is float32 (Wo's dtype, so no
// rounding), the o-projection summed in float32, then + bo, then + x.
//
// What bounds them on an H100: TF32 operations. Every product runs as three
// TF32 products (3xTF32, tf32x3.cuh): at B=32, T=1500, H=8 the attention
// is 147 GFLOP and the o-projection 25 GFLOP of float32 work, 518 GFLOP of
// TF32, 1.05 ms at 495 TFLOP/s (float32 on the CUDA cores: 2.58 ms).
//
// Design. A thread-block cluster of CS blocks (launch_cluster) takes one
// (batch, 64-row) tile. K1: CS = ceil(H / ceil(H / 8)) (ops/
// encoder_block.py::f32_cluster), so a block takes one head up to H = 8
// (whisper-tiny 6, -base 8) and two or three past it; K10 the same over
// the H / 2 pairs, a block whole pairs.
//   * Attention: rank r attends its units with K8's float32 loop
//     (tf32x3::attend: four warps of 16 rows, 64-key K/V tiles
//     double-buffered by cp.async, mma.sync m16n8k8 in 3xTF32; K10:
//     tf32x3::attend_pair, both heads' K and V tiles of a key range in one
//     cp.async group, each warp's two online softmaxes alternating tile by
//     tile) and stores each head's 64 columns of the merged float32 tile to
//     a [B, T, H*64] scratch of the wrapper's.
//   * A cluster barrier (release / acquire, after a fence): every head of
//     the tile is in the scratch.
//   * O-projection (tf32x3::project_chunk): rank r projects the 64-column
//     output chunks [rN/CS, (r+1)N/CS) of N = HDO / 64 (K1, K10: N = H):
//     for each, the merged tile's 64-column chunks (cp.async from the
//     scratch, which L2 still holds) and Wo's [64 in, 64 out] tiles stream
//     through the same two stages, in order of the input chunk; 3xTF32
//     products, each chunk's into its own float32 accumulator, added to the
//     row's sum rounded to nearest; then x + (y + bo) to out (K1p, K10p: y
//     alone; rows past T are not written).
// Each output element is summed in one fixed order by one thread, so a
// launch repeats bit for bit. Shared memory: K1, K1p two stages of two
// tiles, 72 KB, three blocks an SM; K10, K10p two stages of four tiles and
// both heads' Q rows, 178 KB, one block an SM (the o-projection reuses the
// first 72 KB). A launch the card refuses returns its error; nothing
// falls back.
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

// K1 (PAIR false) or K10 (true), square (PARTIAL false: out = x + (y +
// bo), HDO = H * 64) or partial (out = y, float32, x and bo unread).
template <bool PAIR, bool PARTIAL>
__global__ void __launch_bounds__(NT, PAIR ? 1 : 3) encoder_block_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, long long sb, long long sh, long long st,
    const float* __restrict__ x, const float* __restrict__ wo,
    const float* __restrict__ bo, float* __restrict__ out,
    float* __restrict__ merged, int T, int H, int HDO, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int cs = gridDim.x, r = blockIdx.x;
  const int b = blockIdx.z, q0 = blockIdx.y * ROWS;
  const int HD = H * D;
  float* tile = merged + (long long)b * T * HD;  // this batch's rows

  // the rank's units: heads, or pairs of heads (2u, 2u + 1)
  const int units = PAIR ? H / 2 : H;
  for (int u = r * units / cs; u < (r + 1) * units / cs; ++u) {
    if constexpr (PAIR) {
      const long long ba = b * sb + 2 * u * sh, bb = ba + sh;
      attend_pair(q + ba, k + ba, v + ba, q + bb, k + bb, v + bb, st, T, q0,
                  scale, smem, tile + 2 * u * D, tile + (2 * u + 1) * D, HD);
    } else {
      const long long base = b * sb + u * sh;
      attend(q + base, k + base, v + base, st, T, q0, scale, smem,
             tile + u * D, HD);
    }
  }
  __threadfence();
  sm90::cluster_arrive();
  sm90::cluster_wait();

  // the rank's output chunks [r N / cs, (r + 1) N / cs) of N = HDO / 64,
  // each over the H input chunks of the merged tile
  const int n_out = HDO / D;
  const long long row0 = (long long)b * T * HDO;
  for (int c = r * n_out / cs; c < (r + 1) * n_out / cs; ++c)
    project_chunk<PARTIAL>(tile, HD, H, wo, HDO, c, q0, T,
                           PARTIAL ? nullptr : x + row0, bo, out + row0,
                           smem);
}

// the kernel's four instances, by [PAIR][PARTIAL]
using Kernel = void (*)(const float*, const float*, const float*, long long,
                        long long, long long, const float*, const float*,
                        const float*, float*, float*, int, int, int, float);
const Kernel FN[2][2] = {{encoder_block_f32_kernel<false, false>,
                          encoder_block_f32_kernel<false, true>},
                         {encoder_block_f32_kernel<true, false>,
                          encoder_block_f32_kernel<true, true>}};

int launch(bool pair, bool partial, const void* q, const void* k,
           const void* v, long long sb, long long sh, long long st,
           const void* x, const void* wo, const void* bo, void* out,
           void* merged, int B, int H, int T, int HDO, float scale, int cs,
           void* stream) {
  const int units = pair ? H / 2 : H;
  if (H < 1 || (pair && H % 2) || cs < 1 || cs > 8 || cs > units ||
      HDO < D || HDO % D || (!partial && HDO != H * D))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cs, (T + ROWS - 1) / ROWS, B);
  const int smem = pair ? PAIR_SMEM_BYTES : SMEM_BYTES;
  const int e = sm90::launch_cluster(
      FN[pair][partial], grid, cs, NT, smem, (cudaStream_t)stream, (const float*)q,
      (const float*)k, (const float*)v, sb, sh, st, (const float*)x,
      (const float*)wo, (const float*)bo, (float*)out, (float*)merged, T, H,
      HDO, scale);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

}  // namespace

// Raises the float32 forms' dynamic shared-memory limits (K1 and K1p
// SMEM_BYTES, K10 and K10p PAIR_SMEM_BYTES). Called once a device, when
// the library is set up on it.
extern "C" int mas_encoder_block_f32_init(void) {
  for (int pair = 0; pair < 2; ++pair)
    for (int partial = 0; partial < 2; ++partial) {
      const cudaError_t e = cudaFuncSetAttribute(
          (const void*)FN[pair][partial],
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          pair ? PAIR_SMEM_BYTES : SMEM_BYTES);
      if (e != cudaSuccess) return (int)e;
    }
  return 0;
}

// K1's float32 form. q/k/v: [B, H, T, 64] float32 views sharing element
// strides (sb, sh, st) with a unit last stride, each stride a multiple of
// 4 and each base 16-byte aligned; x, out: [B, T, HD] contiguous float32
// with HD = H * 64; wo [HD, HD], bo [HD] contiguous float32, 16- and
// 8-byte aligned; merged: a [B, T, HD] float32 scratch; scale = 1/8; cs
// blocks a cluster (1 to 8, at most H). Returns a cudaError_t value: a
// launch the card refuses, or cudaGetLastError() after the launch.
extern "C" int mas_attn_o_residual_f32(const void* q, const void* k,
                                       const void* v, long long sb,
                                       long long sh, long long st,
                                       const void* x, const void* wo,
                                       const void* bo, void* out, int B,
                                       int H, int T, int HD, float scale,
                                       int cs, void* merged, void* stream) {
  if (HD != H * D) return (int)cudaErrorInvalidValue;
  return launch(false, false, q, k, v, sb, sh, st, x, wo, bo, out, merged,
                B, H, T, HD, scale, cs, stream);
}

// K10's float32 form: K1's arguments, H even, cs blocks a cluster (1 to
// 8, at most H / 2), each taking whole pairs (2u, 2u + 1).
extern "C" int mas_attn_o_residual_paired_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long st, const void* x, const void* wo, const void* bo, void* out,
    int B, int H, int T, int HD, float scale, int cs, void* merged,
    void* stream) {
  if (HD != H * D) return (int)cudaErrorInvalidValue;
  return launch(true, false, q, k, v, sb, sh, st, x, wo, bo, out, merged,
                B, H, T, HD, scale, cs, stream);
}

// K1p's and K10p's float32 forms (the latter H even): q/k/v of the rank's
// H heads as K1 takes them; merged: a [B, T, H * 64] float32 scratch; wo:
// [H * 64, HDO] contiguous float32 (the rank's row shard of Wo, HDO % 64
// == 0), 16-byte aligned; out: [B, T, HDO] float32, contiguous. scale =
// 1/8, cs as K1's or K10's. Returns a cudaError_t value, as K1's.
extern "C" int mas_attn_o_residual_partial_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long st, void* merged, const void* wo, void* out, int B, int H,
    int T, int HDO, float scale, int cs, void* stream) {
  return launch(false, true, q, k, v, sb, sh, st, nullptr, wo, nullptr, out,
                merged, B, H, T, HDO, scale, cs, stream);
}

extern "C" int mas_attn_o_residual_paired_partial_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long st, void* merged, const void* wo, void* out, int B, int H,
    int T, int HDO, float scale, int cs, void* stream) {
  return launch(true, true, q, k, v, sb, sh, st, nullptr, wo, nullptr, out,
                merged, B, H, T, HDO, scale, cs, stream);
}
