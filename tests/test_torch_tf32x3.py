"""The 3xTF32 arithmetic of K8's, K1's, K10's and K9's float32 forms (and
their partial forms), emulated on the CPU.

``csrc/tf32x3.cuh`` runs every float32 product of the two kernels on the
tensor cores as three TF32 products: each operand x split into hi = x
rounded to TF32 (to nearest, ties away from zero) and lo = x - hi (read
by the tensor cores truncated to TF32), then lo_a hi_b, hi_a lo_b and
hi_a hi_b accumulated into one float32 sum, small ones first, eight
products (one m16n8k8 k-step) at a time; each sum runs over one 64-wide
tile (S over the head dim, P V over 64 keys, K1's o-projection over 64
inputs) and the tiles' sums are added rounded to nearest. This file
states that arithmetic in PyTorch: TF32 by integer bit operations, each
k-step's eight exact products summed with the accumulator and rounded
once to float32 toward zero (the tensor cores' sums do not round to
nearest), 64-key tiles of the online softmax in the kernels' order. Held
to the plain versions (``encoder_attention_plain``,
``attention_o_residual_plain``) within chip_smoke's float32 tolerance, at
T = 1500 and at a partial tile; one TF32 pass, in the same loop, misses
that tolerance, so the split is what makes the kernels float32-class;
and a P V sum run over all keys in one accumulator drifts several times
further than the tiles' sums. The orders the later forms add: K10's pair
loop (both heads' tiles of a key range, the heads' steps alternating)
gives K1's per-head arithmetic bit for bit; K1p's and K10p's projection
over a rank's Wo rows, and K9's int8 heads projected from a float32
scratch, each within the same tolerance of its plain version.
"""
import math

import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu_torch.ops import attention as A
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB

# chip_smoke.F32_ATT_ATOL / F32_ATT_RTOL: the card's checks of both kernels
ATOL, RTOL = 2e-5, 2e-5
KEYS = 64    # keys a K/V tile (tf32x3::KEYS)
KSTEP = 8    # the k depth of one mma.sync m16n8k8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 to nearest, ties away from zero: half a TF32 unit
    added to the magnitude bits, the 13 low bits cleared."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from a float32 register: its
    upper 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def to_f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


def mma(c, a, b):
    """One k-step: c + a @ b with a [.., M, 8] and b [.., 8, N] TF32
    values (their products exact in float64), rounded once to float32
    toward zero."""
    return to_f32_toward_zero(c.double() + a.double() @ b.double())


def matmul_tf32(c, a, b, passes: int = 3):
    """c + a @ b in the kernels' order: k ascending in steps of 8, each
    step lo_a hi_b, hi_a lo_b, hi_a hi_b (``passes`` 3) or hi_a hi_b
    alone (1, one TF32 product)."""
    for k0 in range(0, a.shape[-1], KSTEP):
        ak, bk = a[..., k0:k0 + KSTEP], b[..., k0:k0 + KSTEP, :]
        ah, al = split(ak)
        bh, bl = split(bk)
        if passes == 3:
            c = mma(c, al, bh)
            c = mma(c, ah, bl)
        c = mma(c, ah, bh)
    return c


def tile_step(state, qs, kt, vt, passes: int = 3, tile_sums: bool = True):
    """One 64-key tile of K8's float32 loop (tf32x3::head_tile) for the
    heads of ``state`` = (m, l, o): S = Q K^T, the running max and its
    rescale of l and O, p = exp(s - max), l + the tile's sum, O c + the
    tile's P V (``tile_sums`` False: P V added into O's accumulator)."""
    m, l, o = state
    s = matmul_tf32(torch.zeros(*qs.shape[:-1], kt.shape[-2]), qs,
                    kt.transpose(-1, -2), passes)
    mx = torch.maximum(m, s.amax(-1, keepdim=True))
    c = torch.exp(m - mx)
    p = torch.exp(s - mx)
    l = l * c + p.sum(-1, keepdim=True)
    if tile_sums:
        o = torch.addcmul(matmul_tf32(torch.zeros_like(o), p, vt, passes),
                          o, c)
    else:
        o = matmul_tf32(o * c, p, vt, passes)
    return mx, l, o


def attention_tf32(q, k, v, passes: int = 3, tile_sums: bool = True):
    """K8's float32 loop: q x 1/8, then tile_step per 64-key tile, every
    head at once; O / l at the end. [B, H, T, 64] float32."""
    b, h, t, d = q.shape
    qs = q * 0.125
    state = (torch.full((b, h, t, 1), -math.inf), torch.zeros(b, h, t, 1),
             torch.zeros(b, h, t, d))
    for j0 in range(0, t, KEYS):
        state = tile_step(state, qs, k[..., j0:j0 + KEYS, :],
                          v[..., j0:j0 + KEYS, :], passes, tile_sums)
    return state[2] / state[1]


def paired_attention_tf32(q, k, v):
    """K10's float32 pair loop (tf32x3::attend_pair): for each pair of
    heads (2p, 2p + 1) and each 64-key tile staged for both, head 2p's
    tile_step and then head 2p + 1's, each head with its own state."""
    b, h, t, d = q.shape
    qs = q * 0.125
    out = torch.empty(b, h, t, d)
    for p in range(h // 2):
        states = [(torch.full((b, t, 1), -math.inf), torch.zeros(b, t, 1),
                   torch.zeros(b, t, d)) for _ in range(2)]
        for j0 in range(0, t, KEYS):
            for i, hh in enumerate((2 * p, 2 * p + 1)):
                states[i] = tile_step(states[i], qs[:, hh],
                                      k[:, hh, j0:j0 + KEYS],
                                      v[:, hh, j0:j0 + KEYS])
        for i, (_, l, o) in enumerate(states):
            out[:, 2 * p + i] = o / l
    return out


def project_tf32(merged, wo, passes: int = 3):
    """The float32 forms' o-projection (tf32x3::project_chunk, K1's, K10's
    and K9's float32 forms and their partial forms): merged [B, T, n*64]
    times Wo [n*64, N] in the split products, 64 inputs a sum, the sums
    added in input order."""
    b, t, _ = merged.shape
    y = torch.zeros(b, t, wo.shape[1])
    for k0 in range(0, wo.shape[0], KEYS):
        y = y + matmul_tf32(torch.zeros_like(y), merged[..., k0:k0 + KEYS],
                            wo[k0:k0 + KEYS], passes)
    return y


def _merge(attn):
    b, h, t, d = attn.shape
    return attn.transpose(1, 2).reshape(b, t, h * d)


def block_tf32(q, k, v, x, wo, bo, passes: int = 3):
    """K1's float32 form: the merged attention (float32, unrounded) times
    Wo by project_tf32; then x + (y + bo)."""
    return x + (project_tf32(_merge(attention_tf32(q, k, v, passes)), wo,
                             passes) + bo)


def _heads(rng, b, h, t):
    """q, k, v ~ N(0, 1) as chip_smoke._f32_heads makes them: head-split
    views of [B, T, H*64] buffers."""
    return tuple(torch.from_numpy(
        rng.standard_normal((b, t, h * 64), dtype=np.float32)).view(
        b, t, h, 64).transpose(1, 2) for _ in range(3))


def _block_inputs(rng, b, h, t):
    q, k, v = _heads(rng, b, h, t)
    hd = h * 64
    x = torch.from_numpy(rng.standard_normal((b, t, hd), dtype=np.float32))
    wo = torch.from_numpy(
        rng.standard_normal((hd, hd), dtype=np.float32) / math.sqrt(hd))
    bo = torch.from_numpy(0.1 * rng.standard_normal(hd, dtype=np.float32))
    return q, k, v, x, wo, bo


def _err(got, ref):
    """The largest |got - ref| beyond atol + rtol |ref| (<= 0: within)."""
    return float(((got - ref).abs() - ATOL - RTOL * ref.abs()).max())


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),    # 1.0: exact
    (0x3F800FFF, 0x3F800000),    # below half a TF32 unit: down
    (0x3F801000, 0x3F802000),    # half: away from zero
    (0xBF801000, 0xBF802000),    # negative half: away from zero
    (0x3F803000, 0x3F804000),    # odd unit + half: up (no ties-to-even)
    (0x3FFFF000, 0x40000000)])   # carries into the exponent
def test_tf32_round_is_rna(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    got = tf32_round(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want


def test_split_is_exact_to_22_bits():
    """hi + lo is x up to lo's truncation: within 2^-21 of |x|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = split(x)
    assert torch.all(tf32_round(hi) == hi) and torch.all(tf32_trunc(lo) == lo)
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("t", [1500, 100])
def test_k8_float32_emulation_matches_plain(t):
    """K8's float32 loop in 3xTF32 at B=1, H=2 within 2e-5 / 2e-5 of
    encoder_attention_plain: T = 1500 (23 full tiles and one of 28 keys)
    and T = 100 (one full tile and one of 36)."""
    rng = np.random.default_rng(t)
    q, k, v = _heads(rng, 1, 2, t)
    ref = A.encoder_attention_plain(q, k, v)
    got = attention_tf32(q, k, v)
    assert _err(got, ref) <= 0, float((got - ref).abs().max())
    assert float((got - ref).abs().max()) < 2e-6


def test_one_tf32_pass_misses_the_tolerance():
    """The same loop with one TF32 product a k-step (no split) misses
    2e-5 / 2e-5 at T = 1500 for K8 and K1: the split is needed."""
    rng = np.random.default_rng(1500)
    q, k, v = _heads(rng, 1, 2, 1500)
    ref = A.encoder_attention_plain(q, k, v)
    assert _err(attention_tf32(q, k, v, passes=1), ref) > 0
    args = _block_inputs(np.random.default_rng(7), 1, 2, 1500)
    ref = EB.attention_o_residual_plain(*args)
    assert _err(block_tf32(*args, passes=1), ref) > 0


def test_one_accumulator_over_all_keys_drifts():
    """The same loop with P V summed into O's accumulator over all 1500
    keys (564 products a row, each sum rounded toward zero) drifts over
    four times further from the plain version than the 64-key tile sums
    the kernels take."""
    rng = np.random.default_rng(1500)
    q, k, v = _heads(rng, 1, 2, 1500)
    ref = A.encoder_attention_plain(q, k, v)
    tiles = float((attention_tf32(q, k, v) - ref).abs().max())
    running = float((attention_tf32(q, k, v, tile_sums=False) - ref)
                    .abs().max())
    assert running > 4 * tiles, (running, tiles)


@pytest.mark.parametrize("b,h,t", [(1, 2, 1500), (2, 3, 100), (1, 2, 65)])
def test_k1_float32_emulation_matches_plain(b, h, t):
    """K1's float32 form (3xTF32 attention, merged, 3xTF32 o-projection,
    x + (y + bo)) at a narrow width within 2e-5 / 2e-5 of
    attention_o_residual_plain on float32 inputs."""
    args = _block_inputs(np.random.default_rng(t + h), b, h, t)
    ref = EB.attention_o_residual_plain(*args)
    got = block_tf32(*args)
    assert _err(got, ref) <= 0, float((got - ref).abs().max())


def test_f32_bound_takes_the_lesser_rate():
    """chip_smoke.f32_bound: a float32 kernel's bound is the lesser of its
    float32 operations on the CUDA cores and three TF32 products each on
    the tensor cores; K8's float32 form at B=8, T=1500, H=6 is bound by
    3xTF32 operations at ~0.168 ms (float32 cores: ~0.413), a one-query
    attention by its bytes."""
    import chip_smoke
    flops = 4 * 8 * 6 * 1500 ** 2 * 64
    got = chip_smoke.f32_bound(4 * 8 * 6 * 1500 * 64 * 4, flops)
    assert got["bound_rate"] == "3xtf32" and got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(3 * flops / 495e9)
    assert chip_smoke.bound(0, f32=flops)["bound_ms"] == pytest.approx(
        0.41265, abs=1e-4)
    small = chip_smoke.f32_bound(3.35e9, 1.0)
    assert small["bound_by"] == "bytes"
    assert small["bound_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("b,h,t", [(1, 4, 130), (2, 2, 65)])
def test_k10_float32_pair_loop_is_k1s_per_head(b, h, t):
    """K10's float32 form: the pair loop (both heads' tiles of a key range
    staged together, the two heads' steps alternating) gives each head
    the arithmetic of K1's loop bit for bit, and with the same o-
    projection its block lies within 2e-5 / 2e-5 of
    attention_o_residual_paired_plain on float32."""
    args = _block_inputs(np.random.default_rng(50 + t), b, h, t)
    q, k, v, x, wo, bo = args
    pair = paired_attention_tf32(q, k, v)
    assert torch.equal(pair, attention_tf32(q, k, v))
    got = x + (project_tf32(_merge(pair), wo) + bo)
    ref = EB.attention_o_residual_paired_plain(*args)
    assert _err(got, ref) <= 0, float((got - ref).abs().max())


@pytest.mark.parametrize("h,hdo,t", [(2, 256, 300), (3, 384, 65),
                                     (4, 128, 100)])
def test_k1p_k10p_float32_emulation_matches_plain(h, hdo, t):
    """K1p's and K10p's float32 forms on a rank's h heads: the merged
    attention times the rank's Wo rows [h*64, HD_out] in project_tf32's
    order, no x and bo, within 2e-5 / 2e-5 of the plain partial."""
    rng = np.random.default_rng(60 + h + t)
    q, k, v = _heads(rng, 1, h, t)
    wo = torch.from_numpy(rng.standard_normal((h * 64, hdo), dtype=np.float32)
                          / math.sqrt(hdo))
    ref = EB.attention_o_residual_plain(q, k, v, None, wo, None,
                                        partial=True)
    got = project_tf32(_merge(attention_tf32(q, k, v)), wo)
    assert _err(got, ref) <= 0, float((got - ref).abs().max())
    if h % 2 == 0:
        got = project_tf32(_merge(paired_attention_tf32(q, k, v)), wo)
        ref = EB.attention_o_residual_paired_plain(q, k, v, None, wo, None,
                                                   partial=True)
        assert _err(got, ref) <= 0, float((got - ref).abs().max())


@pytest.mark.parametrize("b,h,t", [(1, 2, 300), (2, 3, 65)])
def test_k9_float32_emulation_matches_plain(b, h, t):
    """K9's float32 form computes its int8 heads as the plain version
    does (the same codes from a float32 q) into a float32 scratch, then
    projects it in project_tf32's order: within 2e-5 / 2e-5 of
    attention_o_residual_int8_plain (x + (y + bo)), and K9p's partial
    over a rank's Wo rows of the plain partial."""
    args = _block_inputs(np.random.default_rng(70 + t), b, h, t)
    q, k, v, x, wo, bo = args
    kv = EB.quantize_kv(k, v)
    heads = EB._int8_attention_heads(q, *kv)
    got = x + (project_tf32(_merge(heads), wo) + bo)
    ref = EB.attention_o_residual_int8_plain(q, *kv, x, wo, bo)
    assert _err(got, ref) <= 0, float((got - ref).abs().max())
    wr = wo[:, : wo.shape[1] // 2].contiguous()
    got = project_tf32(_merge(heads), wr)
    ref = EB.attention_o_residual_int8_plain(q, *kv, None, wr, None,
                                             partial=True)
    assert _err(got, ref) <= 0, float((got - ref).abs().max())
