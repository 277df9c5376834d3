// K1's float32 form: the encoder block's attention over every head, its
// o-projection and the residual in one launch, on float32 tensors.
//
// Function: out = x + (softmax(Q K^T / sqrt(64)) V, heads merged) @ Wo +
// bo, all float32: q/k/v [B, H, T, 64] views with a unit last stride (the
// head-split views of the q/k/v dense outputs), x and out [B, T, H*64], Wo
// [H*64, H*64], bo [H*64]. Replaces multimodal_audio_search_tpu/ops/
// encoder_block.py::fused_attention_o_residual (body _attn_o_kernel,
// pallas_call :425) on float32 inputs, which the TPU kernel takes as it
// takes bf16 (a float32 engine's default fused_encoder). The bf16 form is
// encoder_block_wgmma.cu's K1.
//
// Roundings, as the plain version's (attention_o_residual_plain): scores,
// softmax and products in float32, each head's output divided by l; the
// merged attention is float32 (Wo's dtype, so no rounding), the
// o-projection summed in float32, then + bo, then + x.
//
// What bounds it on an H100: TF32 operations. Every product runs as three
// TF32 products (3xTF32, tf32x3.cuh): at B=32, T=1500, H=8 the attention
// is 147 GFLOP and the o-projection 25 GFLOP of float32 work, 518 GFLOP of
// TF32, 1.05 ms at 495 TFLOP/s (float32 on the CUDA cores: 2.58 ms).
//
// Design. A thread-block cluster of CS blocks (launch_cluster) takes one
// (batch, 64-row) tile; CS = ceil(H / ceil(H / 8)), so a block takes one
// head up to H = 8 (whisper-tiny 6, -base 8) and two or three past it.
//   * Attention: rank r attends the heads [rH/CS, (r+1)H/CS) with K8's
//     float32 loop (tf32x3::attend: four warps of 16 rows, 64-key K/V
//     tiles double-buffered by cp.async, mma.sync m16n8k8 in 3xTF32) and
//     stores each head's 64 columns of the merged float32 tile to a
//     [B, T, H*64] scratch of the wrapper's.
//   * A cluster barrier (release / acquire, after a fence): every head of
//     the tile is in the scratch.
//   * O-projection: rank r projects the 64-column output chunks [rN/CS,
//     (r+1)N/CS) of N = H: for each, the merged tile's 64-column chunks
//     (cp.async from the scratch, which L2 still holds) and Wo's [64 in,
//     64 out] tiles stream through the same two stages, in order of the
//     input chunk; 3xTF32 products, each chunk's into its own float32
//     accumulator, added to the row's sum rounded to nearest; then x +
//     (y + bo) to out (rows past T are not written).
// Each output element is summed in one fixed order by one thread, so a
// launch repeats bit for bit. Shared memory: two stages of two tiles, 72
// KB, three blocks an SM. A launch the card refuses returns its error;
// nothing falls back.
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

__global__ void __launch_bounds__(NT, 3) encoder_block_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, long long sb, long long sh, long long st,
    const float* __restrict__ x, const float* __restrict__ wo,
    const float* __restrict__ bo, float* __restrict__ out,
    float* __restrict__ merged, int T, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int cs = gridDim.x, r = blockIdx.x;
  const int b = blockIdx.z, q0 = blockIdx.y * ROWS;
  const int HD = H * D;
  float* tile = merged + (long long)b * T * HD;  // this batch's rows

  for (int h = r * H / cs; h < (r + 1) * H / cs; ++h) {
    const long long base = b * sb + h * sh;
    attend(q + base, k + base, v + base, st, T, q0, scale, smem, tile + h * D,
           HD);
  }
  __threadfence();
  sm90::cluster_arrive();
  sm90::cluster_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  for (int c = r * H / cs; c < (r + 1) * H / cs; ++c) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    stage_rows(smem, LD, tile, HD, q0, T);
    stage_rows(smem + SLOT, LDW, wo + c * D, HD, 0, HD);
    cp_async_commit();
    for (int kc = 0; kc < H; ++kc) {
      if (kc + 1 < H) {
        float* nx = smem + ((kc + 1) & 1) * 2 * SLOT;
        stage_rows(nx, LD, tile + (kc + 1) * D, HD, q0, T);
        stage_rows(nx + SLOT, LDW, wo + (long long)(kc + 1) * D * HD + c * D,
                   HD, 0, HD);
      }
      cp_async_commit();
      cp_async_wait_group<1>();
      __syncthreads();
      // A: rows warp * 16 + g (+ 8) of the merged chunk; B: Wo rows (the
      // chunk's input columns) by 64 output columns
      const float* sa = smem + (kc & 1) * 2 * SLOT + (warp * 16 + g) * LD + t;
      const float* sw = smem + (kc & 1) * 2 * SLOT + SLOT + t * LDW + g;
      // this input chunk's sum in its own accumulator, then added to acc
      // rounded to nearest (tf32x3.cuh)
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
    // x + (y + bo), float32, rows below T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = c * D + 8 * n + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(bo + col);
      if (ra < T) {
        const long long i = ((long long)b * T + ra) * HD + col;
        const float2 xx = *reinterpret_cast<const float2*>(x + i);
        *reinterpret_cast<float2*>(out + i) =
            make_float2(xx.x + (acc[n][0] + bb.x), xx.y + (acc[n][1] + bb.y));
      }
      if (rb < T) {
        const long long i = ((long long)b * T + rb) * HD + col;
        const float2 xx = *reinterpret_cast<const float2*>(x + i);
        *reinterpret_cast<float2*>(out + i) =
            make_float2(xx.x + (acc[n][2] + bb.x), xx.y + (acc[n][3] + bb.y));
      }
    }
  }
}

}  // namespace

// Raises the float32 K1's dynamic shared-memory limit. Called once a
// device, when the library is set up on it.
extern "C" int mas_encoder_block_f32_init(void) {
  return (int)cudaFuncSetAttribute(encoder_block_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
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
  if (HD != H * D || cs < 1 || cs > 8 || cs > H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cs, (T + ROWS - 1) / ROWS, B);
  const int e = sm90::launch_cluster(
      encoder_block_f32_kernel, grid, cs, NT, SMEM_BYTES,
      (cudaStream_t)stream, (const float*)q, (const float*)k, (const float*)v,
      sb, sh, st, (const float*)x, (const float*)wo, (const float*)bo,
      (float*)out, (float*)merged, T, H, scale);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}
