"""K1's and K10's arithmetic on wgmma, emulated on the CPU.

K1 and K10 (csrc/encoder_block_wgmma.cu) spread the heads of one
(batch, 128-row) tile over a thread-block cluster: rank r attends the
heads ops/encoder_block.py::cluster_ranks gives it, one 128-key K/V tile
at a time with an online softmax in the log2 domain (each thread holding
keys 8 jn + 2 t + 0..1 of a tile and summing them in that order, the
four threads of a row added as two shuffle steps), P rounded to bf16
before the PV product, the output x 1/l and rounded to bf16 into the
merged tile; after a cluster barrier it projects its heads' 64-column
output chunks over every chunk of the merged tile in head order, and
adds bo and x in float32.

Here that arithmetic is emulated in float32 and held to the plain twin
and to the Pallas kernel in interpret mode (K10 with pair_heads=True);
the cluster plan is held to its rules at every preset's head count on
the H100's cluster occupancy; chip_smoke's K1 check rejects the planted
faults a cluster can make (a dropped rank's heads, a peer tile read
before the barrier, the pad keys of the last tile left unmasked, K10's
odd head scored against its partner's keys); and the gap between K1's
division form (x 1/l after PV) and the Pallas kernel's at T=1500 (P / l
before PV) is measured on bf16 inputs. K1p, K1's partial form on a rank
of the mesh's model axis, is emulated the same way: the rank's heads
attended, then the HD_out / 64 output chunks (not the rank's heads')
split over the plan's ranks, against the plain twin and Pallas on a
non-square Wo, and its card check rejects a chunk that no rank writes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB

torch.set_num_threads(1)
BN = 128   # keys a K/V tile
D = 64
# the kernel's scale: log2(e) / sqrt(64) as the wrapper hands it over
SL2 = torch.tensor(math.log2(math.e) / math.sqrt(D), dtype=torch.float32)
# clusters of cs blocks an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters through ops/encoder_block.py::
# cluster_fit, PERF.md)
H100_FIT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
            10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}
# float32 emulation against float32 references: only the order of the
# sums differs (a 128-key tile's partial sums, the online rescale, the
# o-projection chunk by chunk): at most 2.7e-7 of the output's scale here
TOL = 1e-5


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _head(q, k, v, t, *, rounding, unmasked_tail=False):
    """One head's attention as a consumer warpgroup computes it: q, k, v
    [B, T, 64] float32 -> (o [B, T, 64] before 1/l, l [B, T])."""
    b = q.shape[0]
    nt = -(-t // BN)
    kp = torch.zeros(b, nt * BN, D)
    vp = torch.zeros(b, nt * BN, D)
    kp[:, :t], vp[:, :t] = k, v
    s_all = q @ kp.transpose(-1, -2)       # TMA's zero rows score 0
    if not unmasked_tail:
        s_all[..., t:] = -torch.inf
    m = torch.full((b, t, 1), -torch.inf)
    lt = torch.zeros(b, t, 4)               # the row's four threads
    acc = torch.zeros(b, t, D)
    pend = None
    for j in range(nt):
        s = s_all[..., j * BN:(j + 1) * BN]
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * SL2)
        c = torch.exp2(m - mn)
        # exp2(fma(s, scale_log2, -m)): the product exact, one rounding
        p = torch.exp2((s.double() * SL2.double() - mn.double()).float())
        pt = p.reshape(b, t, BN // 8, 4, 2)
        rs = torch.zeros(b, t, 4)
        for jn in range(BN // 8):
            rs = rs + (pt[:, :, jn, :, 0] + pt[:, :, jn, :, 1])
        lt = lt * c + rs
        if pend is not None:                # tile j-1's PV product lands,
            acc = acc + pend                # then the rescale by c_j
        acc = acc * c
        pend = (_bf16(p) if rounding else p) @ vp[:, j * BN:(j + 1) * BN]
        m = mn
    acc = acc + pend
    return acc, (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3])


def emulate(q, k, v, x, wo, bo, *, cs, pair=False, rounding=True,
            fault=None):
    """K1 (K10 with ``pair``) on a cluster of ``cs`` blocks, float32.
    ``rounding``: P, each head's output and the result rounded to bf16
    as the kernel rounds them. ``fault``: "dropped rank" (rank 1's heads
    never reach the merged tile), "stale peer" (each rank projects its own
    heads only, its peers' chunks read as zeros before the barrier),
    "unmasked tail" (the last tile's zero pad keys left in the softmax),
    "wrong partner" (K10: each odd head scored against its partner's
    keys)."""
    q, k, v, x, wo, bo = (a.float() for a in (q, k, v, x, wo, bo))
    b, h, t, _ = q.shape
    hd = h * D
    ranks = EB.cluster_ranks(h, cs, pair)
    merged = torch.zeros(b, t, hd)
    for hh in range(h):
        kh = k[:, hh - 1] if fault == "wrong partner" and hh % 2 else k[:, hh]
        o, l = _head(q[:, hh], kh, v[:, hh], t, rounding=rounding,
                     unmasked_tail=fault == "unmasked tail")
        oh = o * (1.0 / l)[..., None]
        merged[..., hh * D:(hh + 1) * D] = _bf16(oh) if rounding else oh
    if fault == "dropped rank":
        for hh in ranks[1]:
            merged[..., hh * D:(hh + 1) * D] = 0
    y = torch.zeros(b, t, hd)
    for own in ranks:
        cols = [c for hh in own for c in range(hh * D, (hh + 1) * D)]
        a = merged.clone()
        if fault == "stale peer":
            for hh in range(h):
                if hh not in own:
                    a[..., hh * D:(hh + 1) * D] = 0
        acc = torch.zeros(b, t, len(cols))
        for kc in range(h):                 # the merged tile's chunks in order
            acc = acc + a[..., kc * D:(kc + 1) * D] @ wo[kc * D:(kc + 1) * D,
                                                          cols]
        y[..., cols] = acc
    out = x + (y + bo)
    return _bf16(out) if rounding else out


def _inputs(rng, b, heads, t, *, residual=True):
    hd = heads * D
    q, k, v = (rng.normal(size=(b, heads, t, D)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / np.sqrt(hd)).astype(np.float32)
    bo = (rng.normal(size=(hd,)) * 0.1).astype(np.float32)
    if not residual:
        x, bo = np.zeros_like(x), np.zeros_like(bo)
    return q, k, v, x, wo, bo


@pytest.mark.parametrize("b,heads,t", [
    (1, 2, 1), (3, 2, 7), (1, 4, 129), (3, 6, 300), (1, 8, 384),
    (3, 8, 129), (1, 3, 7), (1, 20, 129)])
def test_emulation_matches_plain_and_pallas(rng, b, heads, t):
    """The float32 emulation (128-key tiles, the ragged last one masked,
    the threads' order of l, x 1/l, the o-projection chunk by chunk on the
    plan's ranks) against the plain twins and the Pallas kernel in
    interpret mode, K1 and for even H K10, within TOL of the output's
    scale: the three differ only in the order of float32 sums. T = 1, 7,
    129, 300 leave a ragged last tile, 384 fills three."""
    args = _inputs(rng, b, heads, t)
    ta = [torch.from_numpy(a) for a in args]
    kinds = [False] + ([True] if heads % 2 == 0 else [])
    for pair in kinds:
        cs = EB.cluster_plan(heads, b, t, H100_FIT.get, pair)
        got = emulate(*ta, cs=cs, pair=pair, rounding=False)
        runtime.reset_counts()
        plain = (EB.attention_o_residual_paired_plain if pair
                 else EB.attention_o_residual_plain)(*ta)
        assert sum(runtime.COUNTS.values()) == 0   # the CPU takes the twin
        pallas = torch.from_numpy(np.array(JEB.fused_attention_o_residual(
            *(jnp.asarray(a) for a in args), pair_heads=pair,
            interpret=True)))
        for ref in (plain, pallas):
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err < TOL, (pair, err)


@pytest.mark.parametrize("heads", [6, 8, 12, 16, 20])
@pytest.mark.parametrize("b", [32, 3, 1])
def test_cluster_plan_at_every_preset(heads, b):
    """At every Whisper preset's head count (T=1500) the plan gives each
    rank one to four heads (K10: whole pairs), every head and its output
    chunk exactly once and in order, in a cluster the H100 holds; at the
    main path's B=32 it takes the sizes PERF.md times: K1 2 blocks at
    tiny and base, 3 at small, 4 at medium, 5 at large; K10 the same but
    3 at tiny (one pair a block: two blocks would leave one with two
    pairs and one with one)."""
    for pair in (False, True):
        cs = EB.cluster_plan(heads, b, 1500, H100_FIT.get, pair)
        assert 1 <= cs <= EB.MAX_CLUSTER and H100_FIT[cs] >= 1
        ranks = EB.cluster_ranks(heads, cs, pair)
        assert [hh for r in ranks for hh in r] == list(range(heads))
        assert all(1 <= len(r) <= EB.BLOCK_HEADS for r in ranks)
        if pair:
            assert all(len(r) % 2 == 0 and r[0] % 2 == 0 for r in ranks)
        # the kernel's own rule for the same plan
        g = 2 if pair else 1
        units = heads // g
        assert cs <= units and -(-units // cs) * g <= EB.BLOCK_HEADS
        if b == 32:
            assert cs == {6: 3 if pair else 2, 8: 2, 12: 3, 16: 4,
                          20: 5}[heads]


def test_cluster_plan_refuses_what_no_block_takes():
    with pytest.raises(ValueError, match="odd"):
        EB.cluster_plan(7, 32, 1500, H100_FIT.get, True)
    with pytest.raises(ValueError, match="heads"):
        EB.cluster_plan(65, 32, 1500, H100_FIT.get)
    # a card that places no cluster of any allowed size
    with pytest.raises(ValueError, match="heads"):
        EB.cluster_plan(8, 32, 1500, lambda cs: 0)


@pytest.mark.parametrize("fault", [None, "dropped rank", "stale peer",
                                   "unmasked tail", "wrong partner"])
def test_k1_check_rejects_cluster_faults(fault):
    """chip_smoke.check_k1 (K1's and K10's card check) at the main path's
    T=1500 on the attention input (B=1, H=8, the plan's 2 blocks): the
    kernel's arithmetic passes; rank 1's four heads missing from the
    merged tile, a rank that reads its peer's chunks before the barrier
    (zeros), the 36 zero pad keys of the last 128-key tile left in the
    softmax, and K10 scoring each odd head against its partner's keys
    each fail. Readings (max / norm of the term, limits 1 % / 0.7 %): the
    kernel's arithmetic 0.46 % / 0.32 %; the faults 71 % / 72 %, 74 % /
    71 %, 1.37 % / 1.47 % and 83 % / 80 %."""
    gen = torch.Generator().manual_seed(12)
    q, k, v, x, wo, bo = chip_smoke.k1_inputs(gen, 1, 1500, 8,
                                              residual=False, device="cpu")
    pair = fault == "wrong partner"
    ref = (EB.attention_o_residual_paired_plain if pair
           else EB.attention_o_residual_plain)(q, k, v, x, wo, bo)
    got = emulate(q, k, v, x, wo, bo, cs=2, pair=pair, fault=fault)
    if fault is None:
        chip_smoke.check_k1("K1", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(f"K1 {fault}", got, ref, residual=False)


def emulate_partial(q, k, v, wo, *, cs, rounding=True, fault=None):
    """K1p on a cluster of ``cs`` blocks, float32: the heads attended as
    emulate's ranks attend them into the merged tile, then each rank's
    output chunks (EB.output_chunks over HD_out / 64, not its heads)
    projected over every chunk of the merged tile in order, written in
    float32 without x and bo. ``fault="chunk left out"``: each rank
    projects its own heads' chunks (the square form's rule), so the
    chunks past H are never written (zeros)."""
    q, k, v, wo = (a.float() for a in (q, k, v, wo))
    b, h, t, _ = q.shape
    hdo = wo.shape[1]
    merged = torch.zeros(b, t, h * D)
    for hh in range(h):
        o, l = _head(q[:, hh], k[:, hh], v[:, hh], t, rounding=rounding)
        oh = o * (1.0 / l)[..., None]
        merged[..., hh * D:(hh + 1) * D] = _bf16(oh) if rounding else oh
    plan = EB.cluster_ranks(h, cs) if fault == "chunk left out" \
        else EB.output_chunks(hdo // D, cs)
    y = torch.zeros(b, t, hdo)
    for own in plan:
        for c in own:
            cols = slice(c * D, (c + 1) * D)
            acc = torch.zeros(b, t, D)
            for kc in range(h):
                acc = acc + merged[..., kc * D:(kc + 1) * D] @ \
                    wo[kc * D:(kc + 1) * D, cols]
            y[..., cols] = acc
    return y


# (label, a rank's heads, HD_out / 64): whisper-base, -tiny and
# -large-v3 at mp = 2
TP_WIDTHS = [("base", 4, 8), ("tiny", 3, 6), ("large-v3", 10, 20)]


@pytest.mark.parametrize("label,hl,nch", TP_WIDTHS)
@pytest.mark.parametrize("b,t", [(1, 7), (2, 129)])
def test_partial_emulation_matches_plain_and_pallas(rng, label, hl, nch, b,
                                                    t):
    """K1p's arithmetic (a rank's H/mp heads attended as K1 attends them,
    the HD_out / 64 output chunks, H/mp != HD_out / 64, split over the
    plan's ranks) against the plain partial twin and the Pallas kernel in
    interpret mode on the non-square Wo with x = 0, bo = 0, within TOL
    of the output's scale."""
    q, k, v = (rng.normal(size=(b, hl, t, D)).astype(np.float32)
               for _ in range(3))
    wo = (rng.normal(size=(hl * D, nch * D)) / np.sqrt(nch * D)).astype(
        np.float32)
    ta = [torch.from_numpy(a) for a in (q, k, v, wo)]
    cs = EB.cluster_plan(hl, b, t, H100_FIT.get)
    assert all(EB.output_chunks(nch, cs))        # every rank projects
    got = emulate_partial(*ta, cs=cs, rounding=False)
    plain = EB.attention_o_residual_plain(*ta[:3], None, ta[3], None,
                                          partial=True)
    zero_x = np.zeros((b, t, nch * D), np.float32)
    pallas = np.array(JEB.fused_attention_o_residual(
        *(jnp.asarray(a) for a in (q, k, v, zero_x, wo)),
        jnp.zeros(nch * D), interpret=True))
    for ref in (plain.numpy(), pallas):
        err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
        assert err < TOL, (label, err)


@pytest.mark.parametrize("label,hl,nch", TP_WIDTHS)
@pytest.mark.parametrize("b", [32, 1])
def test_output_chunks_cover_every_chunk_once(label, hl, nch, b):
    """At every width's rank the plan's ranks project every output chunk
    exactly once and in order, each rank at least one, where the square
    form's rule (a rank its heads' chunks) leaves HD_out / 64 - H/mp of
    them to no rank."""
    cs = EB.cluster_plan(hl, b, 1500, H100_FIT.get)
    chunks = EB.output_chunks(nch, cs)
    assert [c for r in chunks for c in r] == list(range(nch))
    assert all(chunks) and cs <= min(hl, nch)
    heads = [c for r in EB.cluster_ranks(hl, cs) for c in r]
    assert len(set(range(nch)) - set(heads)) == nch - hl
    # the square form: the two rules agree
    assert EB.output_chunks(hl, cs) == EB.cluster_ranks(hl, cs)


@pytest.mark.parametrize("fault", [None, "chunk left out"])
def test_k1p_check_rejects_a_chunk_left_out(fault):
    """chip_smoke.check_k1 on K1p's attention term at the main path's
    T=1500 (B=1, a whisper-base rank's 4 heads, Wo [256, 512], the plan's
    2 blocks): the kernel's arithmetic passes; the square form's chunk
    rule, which leaves chunks 4-7 to no rank, fails."""
    gen = torch.Generator().manual_seed(13)
    q, k, v, _, _, _ = chip_smoke.k1_inputs(gen, 1, 1500, 4,
                                            residual=False, device="cpu")
    wo = (torch.randn(256, 512, generator=gen) / math.sqrt(512)).to(
        torch.bfloat16)
    ref = EB.attention_o_residual_plain(q, k, v, None, wo, None,
                                        partial=True)
    got = emulate_partial(q, k, v, wo, cs=2, fault=fault)
    if fault is None:
        chip_smoke.check_k1("K1p", got, ref, residual=False)
    else:
        with pytest.raises(AssertionError, match="attention term"):
            chip_smoke.check_k1(f"K1p {fault}", got, ref, residual=False)


def test_k1_division_form_gap_to_pallas(rng):
    """At T=1500 the JAX wrapper divides p by l before the PV product
    (defer_div False: the padded T is past one query block) where K1
    multiplies the PV output by 1/l (a deliberate difference, ROADMAP
    §3). On bf16 inputs of the attention term (x = 0, bo = 0) the
    emulation of K1's roundings stays within 1 % of the output's scale of
    the Pallas kernel in interpret mode: each side rounds its own p to
    bf16 (2^-9 relative), and the bf16 head outputs and results then
    round apart by a step at most. It reads 3.9e-3 here (3.7e-3 of the
    norm)."""
    b, heads, t = 1, 2, 1500
    args = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, _inputs(
        rng, b, heads, t, residual=False))]
    ref = torch.from_numpy(np.asarray(JEB.fused_attention_o_residual(
        *args, interpret=True)).astype(np.float32))
    got = emulate(*(torch.from_numpy(np.asarray(a, dtype=np.float32))
                    for a in args), cs=EB.cluster_plan(
                        heads, b, t, H100_FIT.get))
    gap = float((got - ref).abs().max() / ref.abs().max())
    assert gap < 1e-2
