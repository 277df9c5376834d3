// Hopper (sm_90a) building blocks as inline PTX: mbarriers, TMA tensor
// copies and their tensor maps, asynchronous copies, ldmatrix, the exact
// int8 -> bf16 conversion, the warpgroup matrix products (wgmma) with
// their shared-memory descriptors, and the flash-attention loop's pieces
// on them (namespace fa).
//
// Operands of wgmma live in shared memory in the layout a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes (64 bf16), the
// 16-byte chunks of row r XOR-swizzled by r % 8, so eight rows make one
// 1024-byte atom. A tile must start on a 1024-byte boundary.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <string.h>

#include <initializer_list>
#include <mutex>

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// --------------------------------------------------------------------- TMA
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of a rank-4 tensor map (coordinates innermost first) into shared
// memory; completion is reported to `bar` as transaction bytes. Elements
// outside the map's extents are written as zeros and still counted.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------ cp.async
// 16 bytes global -> shared, through L2 only (streamed data).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The same, reading only the first `src_bytes` (0..16) and writing zeros
// for the rest: no byte past `src + src_bytes` is touched.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into this
// block's shared memory (both 16-byte aligned) as one bulk copy, its
// completion reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of a rank-3 tensor map (coordinates innermost first).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One box of a rank-2 tensor map (coordinates innermost first).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of a rank-3 tensor map from shared memory (a TMA store: parts
// of the box outside the map's extents are not written); the copy joins
// this thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The two halves of a thread-block cluster barrier (every thread of every
// block of the cluster arrives; the wait returns once all have): arrive
// releases this thread's earlier memory operations to the cluster, wait
// acquires the others'. Each is executed by all threads of a warp
// together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Closes this thread's bulk group, then waits until every bulk copy it
// committed has read its shared memory (which may then be reused or
// released).
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Makes this thread's ordinary global-memory stores visible to the async
// proxy, so a TMA load issued after a barrier that orders it behind them
// (a cluster barrier, for a peer block's loads) reads what they wrote.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---------------------------------------------------------------- ldmatrix
// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives row lane / 4, columns 2 (lane % 4) + 0..1
// of matrix i (with .trans: of its transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// Two matrices, transposed: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ----------------------------------------------------- int8 -> bf16, exact
// Four int8 codes (one word, lowest byte first) -> four bf16 in two words.
// b + 128 (an unsigned byte) goes into the low mantissa bits of 2^23 (one
// byte permute) and 2^23 + 128 is taken off, exactly; |b| <= 128 fits
// bf16's 8 significant bits.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float k = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - k;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - k;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - k;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - k;
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

// Moves registers between warpgroups (every warp of the warpgroup runs
// it): a producer gives its registers back, the consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ wgmma
// Descriptor of a 128-byte swizzled operand starting at `p`: `sbo` bytes
// between 8-row groups (1024 for a dense tile), `lbo` bytes between
// 64-element atoms along M/N of an MN-major operand (unused when the tile
// is one atom wide). A K-major operand advances 16 bf16 of K by adding 32
// bytes to the start address (2 in the descriptor's 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The same for a 64-byte swizzled K-major operand (rows of 64 bytes, the
// 16-byte chunks of row r XOR-swizzled by (r / 2) % 4, as TMA's
// CU_TENSOR_MAP_SWIZZLE_64B writes them; 8 rows make one 512-byte atom, so
// a tile starts on a 512-byte boundary). 32 bytes of K are one step.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties a register to this point of the program, so the compiler neither
// reads an accumulator before wgmma.wait_group nor writes one early.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define MAS_D8(C, i)                                                    \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),          \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define MAS_D32(C) MAS_D8(C, 0), MAS_D8(C, 8), MAS_D8(C, 16), MAS_D8(C, 24)
#define MAS_D64(C) MAS_D32(C), MAS_D8(C, 32), MAS_D8(C, 40), MAS_D8(C, 48), \
                   MAS_D8(C, 56)
#define MAS_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define MAS_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x 128] (f32) = A[64 x 16] B[16 x 128], both bf16 K-major operands
// in shared memory; ACC adds to D, else D is overwritten. The accumulator
// layout per warp w of the warpgroup and lane (g = lane / 4, t = lane % 4):
// d[4j + 0..1] = D[16w + g][8j + 2t + 0..1], d[4j + 2..3] = D[16w + g + 8][..].
template <bool ACC>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float d[64], uint64_t da,
                                                    uint64_t db) {
  if (ACC) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MAS_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : MAS_D64("+f")
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MAS_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : MAS_D64("=f")
        : "l"(da), "l"(db), "r"(0));
  }
}

// D[64 x 64] (f32) += A[64 x 16] B[16 x 64]: A bf16 from registers (the
// m16n8k16 A-fragment layout per warp: a[0] rows g, cols 2t..2t+1; a[1]
// rows g + 8; a[2], a[3] the same at cols + 8), B an MN-major bf16
// operand in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float d[32],
                                                      const uint32_t a[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MAS_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MAS_D32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (f32) += A[64 x 16] B[16 x 64]: A a K-major bf16 operand and
// B an MN-major one (one 64-wide swizzle atom, the transpose bit set),
// both in shared memory. D's layout is wgmma_m64n128k16_ss's, 8 columns
// a step of j.
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float d[32], uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MAS_R32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MAS_D32("+f")
      : "l"(da), "l"(db), "r"(1));
}

// Integer products: D (s32) [+]= A (s8) B (s8), 32 of K a step; A from
// registers in the m16n8k32 A-fragment layout per warp (a[0] row g, K
// 4t..4t+3; a[1] row g + 8; a[2], a[3] the same at K + 16), B a K-major
// operand in shared memory. D's layout is the f32 products' (d[4j + 0..1]
// = row g, columns 8j + 2t + 0..1; d[4j + 2..3] = row g + 8). ACC adds to
// D, else D is overwritten. 8-bit operands are K-major only: PTX has no
// transpose bit for them.
template <bool ACC>
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int d[32],
                                                      const uint32_t a[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MAS_R32
      ", {%32, %33, %34, %35}, %37, p;\n}\n"
      : MAS_D32("+r")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(ACC ? 1 : 0),
        "l"(db));
}

__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#undef MAS_D8
#undef MAS_D32
#undef MAS_D64
#undef MAS_R32
#undef MAS_R64

// ---------------------------------------------------------- row division
// x / d rounded to nearest, as a true division gives it, from r = 1 / d
// (itself a true division, once a row): q = x r, then one correction
// step with the exact residual x - q d (an FMA), q + (x - q d) r
// (Markstein). A row's divisor is fixed, so a quotient pays three
// FMA-pipe operations, with no branch, in place of a division's
// reciprocal, refinement and range check (a call with a branch, which
// kept ptxas from interleaving K9's score chains: the stamps in PERF.md).
// K9 divides p / l and pw / ps with it, K11 o / l and p / l; the card
// tests hold it to the true division (mas_k9_division_check: 1.6e7
// quotients x / l with x in [2^-100, 1], l in [1, 12288], pw / ps, and
// K11's o / l with |o| <= 16 l). Below x = 2^-100 the quotient can leave
// the normal range and miss by an ulp there; such a key's weight is
// under 2^-100 and moves no bf16 p and no int8 code.
__device__ __forceinline__ float div_row(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, d, x), r, q);
}

// ----------------------------------------- flash attention on wgmma (fa)
// The pieces of the encoder's attention loop on Hopper (K8 in
// encoder_attention.cu; K1 and K10 in encoder_block_wgmma.cu): a consumer
// warpgroup holds 64 query rows of one head, Q and 128-key K/V tiles
// arrive in shared memory by TMA with the 128-byte swizzle, S = Q K^T is
// four wgmma m64n128k16 from shared memory, the online softmax runs in
// registers in the log2 domain, and P goes back into the tensor cores as
// register A fragments for O += P V (V as the MN-major B operand).
namespace fa {

constexpr int D = 64;       // head dim
constexpr int BM = 128;     // query rows a block (two warpgroups of 64)
constexpr int BN = 128;     // keys a K/V tile
constexpr int NS = BN / 2;  // score accumulators a thread (two rows)

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp2 on the SM's MUFU unit (2 ulp; flushes results below 2^-126 to 0,
// far below what a bf16 p or an f32 row sum resolves)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers 1 and 2 order the two consumer warpgroups' products
// (ping-pong: a warpgroup syncs on 1 + wg before it issues and arrives on
// 2 - wg after, so one's softmax meets the other's products)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q K^T over a tile's BN keys, 16 of the head dim per product.
__device__ __forceinline__ void issue_scores(float s[NS], uint64_t dq,
                                             uint64_t dk) {
  wgmma_m64n128k16_ss<false>(s, dq, dk);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_m64n128k16_ss<true>(s, dq + 2 * kk, dk + 2 * kk);
}

// O += P V over a tile's BN keys: 16 keys (two 1024-byte row groups of
// V) per product.
__device__ __forceinline__ void issue_pv(float o[32], const uint32_t pa[NS / 2],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_m64n64k16_rs_mn(o, &pa[4 * kk], dv + kk * (2048 >> 4));
}

// The tile's scores of keys >= T (keys kv0 ..) set to -inf: TMA fills the
// rows past T with zeros, which would otherwise score 0.
__device__ __forceinline__ void mask_tail(float s[NS], int kv0, int T,
                                          int t4) {
  if (kv0 + BN > T) {
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int key = kv0 + jn * 8 + 2 * t4;
      if (key >= T) s[4 * jn] = s[4 * jn + 2] = -INFINITY;
      if (key + 1 >= T) s[4 * jn + 1] = s[4 * jn + 3] = -INFINITY;
    }
  }
}

// One online-softmax step on the tile's scores (keys kv0 ..): keys >= T
// set to -inf, s -> p = exp2(s * scale_log2 - m_new) in place, the row
// sums l of the unrounded p updated, c = exp2(m_old - m_new) returned for
// the output's rescale. Every tile holds a key < T, so the new maxima are
// finite and exp2(-inf - m) = 0 rescales the empty first state.
__device__ __forceinline__ void softmax_step(float s[NS], int kv0, int T,
                                             int t4, float scale_log2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1) {
  mask_tail(s, kv0, T, t4);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jn], s[4 * jn + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
  const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    s[4 * jn] = ex2(fmaf(s[4 * jn], scale_log2, -m0));
    s[4 * jn + 1] = ex2(fmaf(s[4 * jn + 1], scale_log2, -m0));
    s[4 * jn + 2] = ex2(fmaf(s[4 * jn + 2], scale_log2, -m1));
    s[4 * jn + 3] = ex2(fmaf(s[4 * jn + 3], scale_log2, -m1));
    rs0 += s[4 * jn] + s[4 * jn + 1];
    rs1 += s[4 * jn + 2] + s[4 * jn + 3];
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
}

// P in bf16 as wgmma A fragments: keys 16kk .. 16kk + 15 are the score
// chunks 2kk and 2kk + 1 (the accumulator and A layouts agree).
__device__ __forceinline__ void pack_p(uint32_t pa[NS / 2], const float s[NS]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

}  // namespace fa

// ------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up through the runtime, so
// the library links without -lcuda. Null if the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of any rank (1-5) over `base`: dims and box innermost first,
// strides in bytes for dims 1.., zeros outside the extents. Returns a
// cudaError_t value.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = f(map, type, rank, const_cast<void*>(base), dims, strides,
                       box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A rank-2 map over a row-major [rows, cols] matrix of `type` with a row
// pitch of `pitch` bytes (a multiple of 16): dimensions {cols, rows}, box
// {box_cols, box_rows}, zeros outside. Returns a cudaError_t value.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, long long rows, long long cols,
                     long long pitch, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_map(map, type, 2, base, dims, strides, box, swizzle);
}

// The maps of recent calls, keyed by everything a map describes, so a call
// on buffers seen before encodes none (a map holds addresses and strides
// only, so a hit is valid whatever the memory now holds). Each kernel
// keeps its own cache; the oldest entry makes room for a new one.
struct MapSpec {
  const void* base;
  int type, rank, swizzle;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
};

template <int N>
struct MapCache {
  MapSpec keys[N];
  CUtensorMap vals[N];
  int used = 0, next = 0;
  std::mutex lock;

  int get(CUtensorMap* map, const MapSpec& k) {
    std::lock_guard<std::mutex> guard(lock);
    for (int i = 0; i < used; ++i)
      if (memcmp(&keys[i], &k, sizeof(MapSpec)) == 0) {
        *map = vals[i];
        return 0;
      }
    const int e = encode_map(map, (CUtensorMapDataType)k.type, k.rank, k.base,
                             k.dims, k.strides, k.box,
                             (CUtensorMapSwizzle)k.swizzle);
    if (e == 0) {
      memcpy(&keys[next], &k, sizeof(MapSpec));  // padding bytes too
      vals[next] = *map;
      next = (next + 1) % N;
      if (used < N) ++used;
    }
    return e;
  }
};

// A MapSpec with every unused entry zero (the cache compares bytes).
inline MapSpec map_spec(const void* base, CUtensorMapDataType type, int rank,
                        std::initializer_list<cuuint64_t> dims,
                        std::initializer_list<cuuint64_t> strides,
                        std::initializer_list<cuuint32_t> box,
                        CUtensorMapSwizzle swizzle) {
  MapSpec k;
  memset(&k, 0, sizeof(k));
  k.base = base;
  k.type = (int)type;
  k.rank = rank;
  k.swizzle = (int)swizzle;
  int i = 0;
  for (cuuint64_t v : dims) k.dims[i++] = v;
  i = 0;
  for (cuuint64_t v : strides) k.strides[i++] = v;
  i = 0;
  for (cuuint32_t v : box) k.box[i++] = v;
  return k;
}

// Launches `kernel` as clusters of `cluster` blocks along x (gridDim.x a
// multiple of it). With `early`, the launch is a programmatic dependent of
// the stream's previous kernel: its blocks may start once that kernel's
// blocks have all run griddepcontrol.launch_dependents (or exited), and
// must run griddepcontrol.wait (grid_dependency_wait) before they read
// what it writes. A launch the card refuses (too large a cluster for the
// shared memory each block asks, or more blocks than it allows) returns
// its error, which is then taken off the thread's last error so the next
// launch's cudaGetLastError() does not report it; nothing falls back.
template <typename... Params, typename... Args>
inline int launch_cluster_ex(bool early, void (*kernel)(Params...), dim3 grid,
                             int cluster, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 2 : 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (e != cudaSuccess) (void)cudaGetLastError();
  return (int)e;
}

template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), dim3 grid, int cluster,
                          int threads, size_t smem, cudaStream_t stream,
                          Args... args) {
  return launch_cluster_ex(false, kernel, grid, cluster, threads, smem,
                           stream, args...);
}

// Programmatic dependent launch, device side: a kernel lets the stream's
// next kernel (launched early) start, and the next kernel waits until
// this one has finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace sm90
