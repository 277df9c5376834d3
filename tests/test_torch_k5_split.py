"""K5's split-K plan and fixed-order reduction, emulated in float64 on the
CPU.

K5 (csrc/quant_matmul.cu) at M <= 64 splits K into ``split_plan``'s
splits of ``steps`` steps of SB_K rows; each block keeps the float32 sums
of its split, and the last block of a tile to arrive adds the splits'
partials in split order and applies the epilogue once (times the scale,
plus the bias, each rounded, then the output dtype). The emulation below
states that arithmetic (each split's sum in float64, the partials added
in order in float32, the epilogue in float32) and is held to the plain
twin and to the JAX Pallas kernel in interpret mode at split edges, a
ragged last split, M = 1 and 33, and an N % 16 != 0 (the vocabulary's
51865 among them), which the plan gives the table kernel, K unsplit.
chip_smoke.py's K5 check is then held to a planted fault, one K split
dropped, at the main path's [2048, 512].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import quant as JQ
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import quant as Q

torch.set_num_threads(1)
TOL = 2e-5


def emulate_k5(x, wq, scale, b, out_dtype, splits=None, drop=None):
    """K5's splits and fixed-order reduction; ``drop``: a split whose
    partial is planted as left out. Returns [M, N] in out_dtype."""
    m, k = x.shape
    n = wq.shape[1]
    regime, _, s, steps = Q.split_plan(m, k, n, splits)
    if regime in ("wide", "table"):
        s, steps = 1, -(-k // Q.SB_K)
    y = torch.zeros(m, n, dtype=torch.float32)
    for i in range(s):
        k0, k1 = i * steps * Q.SB_K, min(k, (i + 1) * steps * Q.SB_K)
        assert k0 < k1, "every split holds a K step"
        if i != drop:
            y = y + (x[:, k0:k1].double() @ wq[k0:k1].double()).float()
    y = y * scale.float()
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


# (M, K, N, forced splits or None for the plan): the plan's own splits at
# a decode step's shapes, a ragged last split (K = 520: 5 steps in 3, the
# last one partial), splits at exact step edges, one split, M = 1 and 33,
# the vocabulary
SPLIT_CASES = [(32, 512, 512, None), (32, 2048, 512, None),
               (32, 512, 2048, None), (32, 1536, 384, None),
               (33, 520, 96, 3), (1, 1024, 130, 8), (8, 256, 64, 1),
               (32, 384, 384, 3), (1, 64, 51865, 2), (33, 96, 515, None)]


@pytest.mark.parametrize("m,k,n,splits", SPLIT_CASES)
def test_k5_split_emulation_matches_twin_and_pallas(m, k, n, splits):
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, s = Q.quantize_weight(rng.normal(size=(k, n)).astype(np.float32))
    xt, wt, st = map(torch.from_numpy, (x, wq, s))
    got = emulate_k5(xt, wt, st, None, torch.float32, splits)
    runtime.reset_counts()
    twin = Q.quant_matmul(xt, wt, st)
    assert runtime.COUNTS["quant_matmul"] == 0
    ref = np.asarray(JQ.quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                     jnp.asarray(s), blk_n=512,
                                     interpret=True))
    for other in (twin.numpy(), ref):
        np.testing.assert_allclose(got.numpy(), other, rtol=TOL,
                                   atol=TOL * np.abs(other).max())


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m, k, n, *_ in
                                   chip_smoke.K5_SHAPES] + [
    (1, 512, 512), (33, 512, 2048), (64, 2048, 512), (65, 512, 515),
    (200, 384, 1000)])
def test_k5_plan_covers_k_once_and_fills_the_card(m, k, n):
    """Every split of the plan holds a K step and together they cover K
    once, in at most MAX_SPLITS splits; K is split only where a block
    would walk SPLIT_MIN_STEPS steps or more and the tiles fill under a
    quarter of the wave, and then the grid fills at least half a wave (or
    K is split as far as it may) and a decode step's layer (M = 32) walks
    at most 2 steps a split; M > 64 with N % 16 == 0 takes the wide
    kernel; an N % 16 != 0 (the vocabulary's) the table kernel, K
    unsplit."""
    regime, bn, s, steps = Q.split_plan(m, k, n)
    if n % 16:
        assert (regime, s) == ("table", 1)
        return
    if m > Q.SMALL_M:
        assert regime == "wide"
        return
    assert regime == "skinny" and bn == Q.SB_N
    nk = -(-k // Q.SB_K)
    assert (s - 1) * steps < nk <= s * steps and s <= Q.MAX_SPLITS
    tiles = -(-n // bn) * -(-m // 32)
    if nk >= Q.SPLIT_MIN_STEPS and tiles < Q.WAVE // 4:
        assert tiles * s >= Q.WAVE // 2 or s == min(nk, Q.MAX_SPLITS)
        assert m != 32 or steps <= 2
    else:
        assert s == 1
    if s > 1:
        assert s * tiles * 32 * bn <= Q.SCRATCH


def test_k5_forced_splits_never_leave_one_empty():
    for k in range(8, 600, 8):
        nk = -(-k // Q.SB_K)
        for forced in range(1, 20):
            _, _, s, steps = Q.split_plan(32, k, 512, forced)
            assert s <= min(forced, nk) and (s - 1) * steps < nk <= s * steps


@pytest.mark.parametrize("drop", [None, 0, 3, 7])
def test_k5_card_check_rejects_a_dropped_split(drop):
    """chip_smoke's K5 check at the main path's [2048, 512] (M = 32, bf16
    out, bias; 8 splits of 2 steps): the kernel's arithmetic passes, a
    kernel that left one split's partial out of the reduction fails."""
    gen = torch.Generator().manual_seed(drop or 0)
    x, wq, scale, b = chip_smoke.k5_inputs(gen, 32, 2048, 512, device="cpu")
    assert Q.split_plan(32, 2048, 512)[2:] == (8, 2)
    ref = chip_smoke.k5_plain(x, wq, scale, b, torch.bfloat16)
    got = emulate_k5(x, wq, scale, b, torch.bfloat16, drop=drop)
    if drop is None:
        chip_smoke.check_k5("K5", got, ref)
    else:
        with pytest.raises(AssertionError, match="outside atol"):
            chip_smoke.check_k5(f"K5 split {drop} dropped", got, ref)


def test_logits_table_is_the_transposed_codes():
    """The device copy the table kernel reads is the quantized logits
    table transposed, bit for bit and contiguous, in place of the leaf's
    codes (the card holds the table once); the scales stay as they are,
    and the CPU path gives the same logits on either leaf."""
    rng = np.random.default_rng(5)
    wq, s = Q.quantize_weight(rng.normal(size=(64, 1027)).astype(np.float32))
    leaf = {"wq": torch.from_numpy(wq), "scale": torch.from_numpy(s)}
    table = Q.logits_table(leaf)
    assert set(table) == {"wq_t", "scale"} and table["scale"] is leaf["scale"]
    assert table["wq_t"].is_contiguous() and table["wq_t"].shape == (1027, 64)
    assert torch.equal(table["wq_t"], leaf["wq"].t())
    assert Q.logits_table(table) is table
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    assert torch.equal(Q.quant_dense_apply(table, x, out_dtype=torch.float32),
                       Q.quant_dense_apply(leaf, x, out_dtype=torch.float32))


@pytest.mark.parametrize("d", [384, 520, 600, 1280, 2048, 2056])
def test_logits_table_only_where_the_table_kernel_fits(d):
    """Every logits width up to TABLE_MAX_K (x's rows and the warps' rings
    fit one SM's shared memory) gets the table, its rows padded with zero
    codes to a multiple of 16 (520 -> 528); a wider one keeps its codes,
    and the plan refuses it an N % 16 != 0."""
    wq = torch.randint(-127, 128, (d, 33), dtype=torch.int8)
    leaf = {"wq": wq, "scale": torch.ones(33)}
    if d > Q.TABLE_MAX_K:
        assert Q.logits_table(leaf) is leaf
        with pytest.raises(ValueError, match="table kernel"):
            Q.split_plan(32, d, 33)
        return
    t = Q.logits_table(leaf)["wq_t"]
    assert t.shape == (33, -(-d // 16) * 16)
    assert torch.equal(t[:, :d], wq.t()) and not t[:, d:].any()
    assert Q.split_plan(32, d, 33) == ("table", 16, 1, -(-d // 16))


def test_table_kernel_k_permutation_is_one_to_one():
    """The table kernel feeds mma.sync's k slots 2t, 2t+1, 2t+8, 2t+9 of
    thread t with the physical k = 4t .. 4t+3 of x and of the table alike;
    that map is a permutation of the 16 k of a step, so the sum over them
    is the same sum."""
    perm = {}
    for t in range(4):
        for e in range(2):
            perm[2 * t + e] = 4 * t + e
            perm[2 * t + 8 + e] = 4 * t + 2 + e
    assert sorted(perm) == sorted(perm.values()) == list(range(16))
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(16, 16)), rng.normal(size=(16, 8))
    idx = [perm[i] for i in range(16)]
    np.testing.assert_allclose(a[:, idx] @ b[idx], a @ b, rtol=1e-12)
