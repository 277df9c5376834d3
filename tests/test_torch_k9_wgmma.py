"""K9's operand layout on int8 wgmma, emulated on the CPU.

K9 (csrc/encoder_block_int8.cu) runs both attention products as
wgmma .s32.s8.s8. 8-bit wgmma takes K-major operands only, so PV's B
operand is V transposed: each 64-key V tile is turned into [64 d-rows x
64 keys] in shared memory (64-byte swizzle) by transpose_v, with its
keys in the order the S accumulators give each thread's p8 codes (keys
2t, 2t + 1 of each 8-key column tile): A position 16 * half + 4t + i of a
32-key step holds key 16 * half + 2t + (i & 1) + 8 (i >> 1). The same
permutation in A and B leaves the integer sums unchanged.

Here transpose_v's thread mapping and byte permutes, the swizzled
addresses wgmma reads and the packing of p8 into A fragments are
emulated byte for byte and held to the straight-order sums; K9's
function with 64-key tiles and each thread's order of the softmax sum l
is emulated in float32 and held to the plain twin and to the Pallas
kernel in interpret mode at small widths and ragged T; and chip_smoke's
K1 check (which holds K9) rejects a mis-permuted V tile and a ragged last
tile left unmasked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
from multimodal_audio_search_tpu_torch.ops.cached_attention import (
    quantize_kv)

torch.set_num_threads(1)
TOL = 1e-5   # tests/test_torch_encoder_variants.py's bar for K9
BN = 64      # keys a tile


def key_of_position(p: int) -> int:
    """The key (within a 64-key tile) at contraction position p."""
    kc, q = divmod(p, 32)
    half, r = divmod(q, 16)
    t, i = divmod(r, 4)
    return kc * 32 + 16 * half + 2 * t + (i & 1) + 8 * (i >> 1)


PERM = np.array([key_of_position(p) for p in range(BN)])


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm(x, y, s): byte i of the result is byte
    (s >> 4i) & 7 of the 8 bytes {y, x} (x the low four)."""
    src = (x & 0xffffffff) | ((y & 0xffffffff) << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i)
               for i in range(4))


def word(tile: np.ndarray, r: int, d0: int) -> int:
    return int.from_bytes(tile[r, d0:d0 + 4].tobytes(), "little")


def transpose_v(tile: np.ndarray) -> np.ndarray:
    """transpose_v of the kernel, thread by thread (the 128 threads of a
    warpgroup, two a 16-byte unit): a [64, 64] int8 V tile -> the 4096
    bytes of its 64-byte swizzled [64 d, 64 keys] buffer."""
    vt = np.zeros(64 * BN, np.uint8)
    for tid in range(128):
        wh, d0, c = tid & 1, (tid >> 1 & 15) * 4, tid >> 5
        base = c * 16
        o = [[0] * 2 for _ in range(4)]
        for i in range(2):
            r = base + 2 * (2 * wh + i)
            x0, x1, x2, x3 = (word(tile, rr, d0)
                              for rr in (r, r + 1, r + 8, r + 9))
            lo01, hi01 = byte_perm(x0, x1, 0x5140), byte_perm(x0, x1, 0x7362)
            lo23, hi23 = byte_perm(x2, x3, 0x5140), byte_perm(x2, x3, 0x7362)
            o[0][i] = byte_perm(lo01, lo23, 0x5410)
            o[1][i] = byte_perm(lo01, lo23, 0x7632)
            o[2][i] = byte_perm(hi01, hi23, 0x5410)
            o[3][i] = byte_perm(hi01, hi23, 0x7632)
        for dd in range(4):
            d = d0 + dd
            at = d * BN + ((c ^ ((d >> 1) & 3)) << 4) + 8 * wh
            vt[at:at + 8] = np.frombuffer(
                b"".join(v.to_bytes(4, "little") for v in o[dd]), np.uint8)
    return vt


def read_kmajor_sw64(vt: np.ndarray) -> np.ndarray:
    """The [64 n, 64 k] int8 operand wgmma reads from a 64-byte swizzled
    K-major buffer (TMA's CU_TENSOR_MAP_SWIZZLE_64B layout): element (n, k)
    at n * 64 + ((k / 16) ^ (n / 2 % 4)) * 16 + k % 16."""
    n, k = np.meshgrid(np.arange(64), np.arange(BN), indexing="ij")
    return vt[n * BN + (((k // 16) ^ (n // 2 % 4)) << 4) + k % 16] \
        .view(np.int8)


def a_operand(p8: np.ndarray) -> np.ndarray:
    """The [64 rows, 64] A operand the kernel's pa fragments give, from
    p8 codes [64, 64] laid out as the S accumulators hold them: warp w,
    lane (g, t) holds s[4 jn + e] = p8[16w + g + 8 (e >= 2), 8 jn + 2t + (e
    & 1)]; pa[kc] packs them as the kernel does, read back in the
    m16n8k32 A-fragment layout."""
    a = np.zeros((64, BN), np.int8)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            s = [p8[16 * w + g + 8 * (e >= 2), 8 * jn + 2 * t + (e & 1)]
                 for jn in range(BN // 8) for e in range(4)]
            for kc in range(BN // 32):
                j0 = 4 * kc
                pa = [(s[4 * j0], s[4 * j0 + 1], s[4 * j0 + 4], s[4 * j0 + 5]),
                      (s[4 * j0 + 2], s[4 * j0 + 3], s[4 * j0 + 6],
                       s[4 * j0 + 7]),
                      (s[4 * j0 + 8], s[4 * j0 + 9], s[4 * j0 + 12],
                       s[4 * j0 + 13]),
                      (s[4 * j0 + 10], s[4 * j0 + 11], s[4 * j0 + 14],
                       s[4 * j0 + 15])]
                for reg, (row, col) in enumerate(((g, 0), (g + 8, 0),
                                                  (g, 16), (g + 8, 16))):
                    for i in range(4):
                        a[16 * w + row, 32 * kc + col + 4 * t + i] = pa[reg][i]
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transposed_v_and_p8_fragments_give_straight_sums(seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-127, 128, size=(BN, 64)).astype(np.int8)
    p8 = rng.integers(-127, 128, size=(64, BN)).astype(np.int8)
    b = read_kmajor_sw64(transpose_v(v))               # [64 d, 64 k]
    assert np.array_equal(b, v[PERM].T)                # keys permuted
    a = a_operand(p8)
    assert np.array_equal(a, p8[:, PERM])              # the same order
    got = a.astype(np.int64) @ b.T.astype(np.int64)    # what wgmma sums
    assert np.array_equal(got, p8.astype(np.int64) @ v.astype(np.int64))
    assert sorted(PERM) == list(range(BN))


L2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def exp_m(s, m):
    """The kernel's exp(s - m): 2^(fma(s, log2 e, -m log2 e)) (the FMA's
    product exact in float64; exp2 here is the CPU's, not the MUFU's)."""
    return (s.double() * L2E.double() - (m * L2E).double()).float().exp2()


def emulate_k9(q, k8, ks, v8, vs, x, wo, bo, *, fault=None):
    """K9 as the kernel computes it, float32: 64-key tiles, keys >= T at
    -inf (``fault`` "unmasked tail": the zero-filled keys of the last tile
    scored 0, as TMA delivers them), the row sum l in each thread's order
    (its keys 8 jn + 2t + 0..1 of a tile added in turn, rescaled tile by
    tile, the four threads of a row added as two shuffle steps), p8 from
    (exp_m(s, m) / l) * vs (a true division's bits, as div_row gives), PV
    over the transposed tiles in the permuted
    order (``fault`` "mis-permuted V": the tile read in key order while
    the codes stay permuted; "stale Wo tile": rows 16..31, columns 0..63
    of the o-projection take the next Wo tile in place of the first).
    Returns (out, p8 codes [B, H, T, T])."""
    f32 = torch.float32
    b, h, t, d = q.shape
    nt = -(-t // BN)
    tp = nt * BN
    qf = q.to(f32) * (1.0 / d ** .5)
    q8, qs = EB._quantize_rows_exact(qf, 1e-12)            # [B, H, T, *]
    kp = torch.zeros(b, h, tp, d, dtype=torch.float64)
    kp[:, :, :t] = k8.double()
    vp = torch.zeros(b, h, tp, d, dtype=torch.float64)
    vp[:, :, :t] = v8.double()
    ksp = torch.zeros(b, h, tp, dtype=f32)
    ksp[:, :, :t] = ks
    vsp = torch.zeros(b, h, tp, dtype=f32)
    vsp[:, :, :t] = vs
    c = (q8.double() @ kp.transpose(-1, -2)).to(f32)       # exact integers
    s = (c * qs) * ksp[:, :, None, :]
    if fault != "unmasked tail":
        s[..., t:] = -torch.inf
    # pass 1: threads t4 = 0..3 of a row, keys 8 jn + 2 t4 + e of a tile
    st = s.reshape(b, h, t, nt, BN // 8, 4, 2)
    m = torch.full((b, h, t, 1), -torch.inf)
    lt = torch.zeros(b, h, t, 4)
    for j in range(nt):
        tile = st[:, :, :, j]                              # [.., 8, 4, 2]
        mx = torch.maximum(m, tile.amax((-3, -2, -1))[..., None])
        rs = torch.zeros(b, h, t, 4)
        for jn in range(BN // 8):
            e = exp_m(tile[..., jn, :, :], mx[..., None])
            rs = rs + (e[..., 0] + e[..., 1])
        lt = lt * torch.exp2((m - mx) * L2E) + rs
        m = mx
    l = ((lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3]))[..., None]
    pw = (exp_m(s, m) / l) * vsp[:, :, None, :]
    ps = torch.clamp(pw.amax(-1, keepdim=True), min=1e-30) \
        / torch.tensor(127.0)
    p8 = torch.round(pw / ps).clamp(-127, 127)
    perm = torch.from_numpy(np.concatenate([PERM + j * BN
                                            for j in range(nt)]))
    vb = vp if fault == "mis-permuted V" else vp[:, :, perm]
    pv = (p8.double()[..., perm] @ vb).to(f32)
    out_h = (pv * ps).to(wo.dtype)            # into the merged bf16 tile
    y = EB._merge_o_residual(out_h.float(), x, wo, bo)
    if fault == "stale Wo tile":
        # warp 1's rows (16..31) of the first query block, output columns
        # 0..63: the stage of Wo tile [0:64, 0:64] refilled with the next
        # tile [64:128, 0:64] under the warp's loads
        wf = wo.clone()
        wf[:BN, :BN] = wo[BN:2 * BN, :BN]
        y[:, 16:32, :BN] = EB._merge_o_residual(out_h.float(), x, wf,
                                                bo)[:, 16:32, :BN]
    return y, p8[..., :t]


def _inputs(rng, b, heads, t, d=64):
    hd = heads * d
    q, k, v = (rng.normal(size=(b, heads, t, d)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / np.sqrt(hd)).astype(np.float32)
    bo = (rng.normal(size=(hd,)) * 0.1).astype(np.float32)
    return q, k, v, x, wo, bo


def _codes(q, k8, ks, vs, exp, total):
    """p8 codes [B, H, T, T] from the integer scores with a framework's
    exp and row sum (float32, the kernels' order of operations)."""
    d = q.shape[-1]
    qf = q * np.float32(1 / np.sqrt(d))
    qs = np.maximum(np.abs(qf).max(-1, keepdims=True), np.float32(1e-12)) \
        / np.float32(127)
    q8 = np.clip(np.round(qf / qs), -127, 127)
    s = np.einsum("bhqd,bhtd->bhqt", q8.astype(np.float64),
                  k8.astype(np.float64)).astype(np.float32) * qs \
        * ks[:, :, None, :]
    p = exp(s - s.max(-1, keepdims=True))
    pw = (p / total(p)) * vs[:, :, None, :]
    ps = np.maximum(pw.max(-1, keepdims=True), np.float32(1e-30)) \
        / np.float32(127)
    return np.clip(np.round(pw / ps), -127, 127), ps[..., 0]


@pytest.mark.parametrize("b,heads,t", [(2, 2, 97), (1, 3, 129), (2, 2, 300),
                                       (1, 2, 1)])
def test_k9_emulation_matches_plain_and_pallas(rng, b, heads, t):
    """The emulation against the plain twin and the Pallas kernel (qk_int8,
    interpret mode), within 1e-5 of the output's scale plus what its p8
    codes that differ from each side's (an exp or a sum order moving a
    code across a .5 boundary) can move through Wo."""
    d = 64
    args = _inputs(rng, b, heads, t, d)
    q, k, v, x, wo, bo = args
    kv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    k8, ks, v8, vs = (a.numpy() for a in kv)
    got, p8 = emulate_k9(torch.from_numpy(q), *kv, *map(torch.from_numpy,
                                                       (x, wo, bo)))
    runtime.reset_counts()
    plain = EB.attention_o_residual_int8_plain(
        torch.from_numpy(q), *kv, *map(torch.from_numpy, (x, wo, bo)))
    assert runtime.COUNTS["encoder_attn_o_residual_int8"] == 0
    pallas = np.asarray(JEB.fused_attention_o_residual(
        *(jnp.asarray(a) for a in args), blk_q=32, qk_int8=True,
        interpret=True))
    sides = (
        (plain.numpy(), _codes(q, k8, ks, vs,
                               lambda a: torch.exp(torch.from_numpy(a))
                               .numpy(),
                               lambda a: a.sum(-1, keepdims=True))),
        (pallas, _codes(q, k8, ks, vs,
                        lambda a: np.asarray(jnp.exp(jnp.asarray(a))),
                        lambda a: np.asarray(jnp.sum(jnp.asarray(a), -1,
                                                     keepdims=True)))))
    for ref, (codes, ps) in sides:
        flips = (codes != p8.numpy()).sum(-1)               # [B, H, T]
        assert flips.sum() <= max(2, flips.size // 50)      # rare, if any
        step = (flips * 127 * ps)[..., None] * np.ones(d)
        dy = np.einsum("bhtd,hdj->btj", step,
                       np.abs(wo).reshape(heads, d, heads * d))
        assert np.all(np.abs(got.numpy() - ref)
                      <= TOL * np.abs(ref).max() + dy)


@pytest.mark.parametrize("fault", [None, "mis-permuted V", "unmasked tail",
                                   "stale Wo tile"])
def test_k1_check_rejects_k9_layout_faults(fault):
    """chip_smoke.check_k1 (K9's card check) at the main path's T=1500 on
    the attention input (B=2, H=8): the kernel's arithmetic passes; a V
    tile read in key order against permuted codes, the 36 zero-filled
    keys of the last 64-key tile left unmasked, or one warp's 16 rows x 64
    columns of the o-projection over a Wo stage refilled whole with the
    next tile, fails."""
    gen = torch.Generator().manual_seed(12)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 2, 1500, 8,
                                              residual=False, device="cpu")
    kv = quantize_kv(k, v)
    ref = EB.attention_o_residual_int8_plain(q, *kv, x, wo, bo)
    got, _ = emulate_k9(q, *kv, x, wo, bo, fault=fault)
    if fault is None:
        chip_smoke.check_k1("K9", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(f"K9 {fault}", got, ref, residual=False)


def test_repeat_check_rejects_a_launch_that_differs():
    """The race a proxy fence before each stage's release closes: a Wo
    stage refilled by TMA while a warp's last loads of it were in flight,
    in one launch of many and over as many loads as were late, so
    check_k1 sees only the larger cases. chip_smoke.check_repeats holds
    every further launch on the same inputs bit-equal to the first: it
    passes a deterministic kernel and rejects the one launch that raced."""
    gen = torch.Generator().manual_seed(12)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 1, 300, 2,
                                              residual=False, device="cpu")
    kv = quantize_kv(k, v)
    clean, _ = emulate_k9(q, *kv, x, wo, bo)
    raced, _ = emulate_k9(q, *kv, x, wo, bo, fault="stale Wo tile")
    assert not torch.equal(clean, raced)
    assert chip_smoke.check_repeats("K9", lambda: clean.clone(), clean,
                                    chip_smoke.K9_REPEATS) \
        == chip_smoke.K9_REPEATS
    outs = iter([clean, raced, clean])
    with pytest.raises(AssertionError, match="launch 3 .* differs"):
        chip_smoke.check_repeats("K9", lambda: next(outs), clean, 3)
