"""K3's cluster arithmetic, emulated on the CPU.

K3 (csrc/decoder_block.cu, self_block_kernel) runs a thread-block
cluster of CS = min(H, 16) blocks for each tile of up to 16 batch rows
(ops/decoder_block.py::self_block_plan), rank r taking the heads
[r H / CS, (r + 1) H / CS). A block projects its tile's layer-normed
rows onto its heads' 64 columns of Wq/Wk/Wv in 64-row
k-chunks (tile sums added in chunk order), attends each head over the
cache rows t < pos plus the fresh row (p . V split over 8 warps, the
warps' partials added in warp order, then pn * v1), and adds its heads'
shares of the o-projection in head order; rank r of the cluster then
sums the ranks' partials of its heads' columns in rank order and adds
bias and residual. K3-q continues in the same launch with the cross
layer norm (the ranks' row sums added in rank order) and q-projection.

The emulation below states that arithmetic in float32 with a chosen
rounding dtype (float32: none, as the plain twin at float32; bf16: the
kernel's roundings) and is held to the plain twins and to the JAX Pallas
kernels in interpret mode at B = 1, 3, 33 (a ragged tile), H = 2, 3, 4
and pos 0, 1 and L - 1; the plan is held at every Whisper width; and
chip_smoke.py's K3 check rejects a cluster that drops one rank's
partial. K3p, K3's partial form on a rank of the mesh's model axis, is
emulated with its two widths (the model's D for the layer norm and the
head sum, the rank's heads for the attention and the caches) and held
to the partial twin, and summed over the ranks to the square twin and
the Pallas kernel.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import decoder_block as JDB
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB

torch.set_num_threads(1)
TOL = 2e-5   # the float32 bar of tests/test_torch_decoder_block.py
L = 12
EPS = 1e-5


def emulate_k3(x, selfw, kc, vc, pos: int, heads: int, *, tail=None,
               rows: int | None = None, rd=torch.float32, fault=None,
               partial: bool = False):
    """K3 (K3-q with ``tail``) as the cluster computes it, in float32,
    values rounded to ``rd`` where the kernel rounds them. Returns (x_out,
    k1, v1[, q_cross]) in rd. ``fault="rank dropped"`` leaves rank 1's
    partial out of the cluster sum. ``partial`` is K3p: the block's
    ``heads`` are a rank's shard of a wider model (Wq/Wk/Wv [D, heads *
    64], Wo [heads * 64, D], caches of heads * 64 columns), the layer
    norm and the head sum run at the model width D, and x_out is the
    float32 head sum alone (no x, no bo)."""
    f32 = torch.float32

    def r(a):
        return a.to(rd).to(f32)

    g1, b1, wq, bq, wk, wv, bv, wo, bo = (a.to(f32) for a in selfw)
    b, d = x.shape
    hl = wq.shape[1]
    l = kc.shape[1]
    _, cs, rt, tiles, _ = DB.self_block_plan(b, heads, l, rows, d=d)
    scale = 1.0 / math.sqrt(64)
    xo = torch.empty(b, d, dtype=f32)
    k1o, v1o = (torch.empty(b, hl, dtype=f32) for _ in range(2))
    for tile in range(tiles):
        tr = slice(tile * rt, min(b, (tile + 1) * rt))
        xt = x[tr].to(f32)
        nr = xt.shape[0]
        mu = xt.mean(-1, keepdim=True)
        var = (xt - mu).square().mean(-1, keepdim=True)
        h = r((xt - mu) / torch.sqrt(var + EPS) * r(g1) + r(b1))
        parts = []
        for rank in range(cs):
            part = torch.zeros(nr, d, dtype=f32)
            for hh in range(rank * heads // cs, (rank + 1) * heads // cs):
                cols = slice(hh * 64, hh * 64 + 64)

                def proj(w):
                    acc = torch.zeros(nr, 64, dtype=f32)
                    for k0 in range(0, d, 64):       # the tile sums
                        acc = acc + h[:, k0:k0 + 64] @ r(w)[k0:k0 + 64, cols]
                    return acc

                q1 = r(proj(wq) + r(bq)[cols])
                k1 = r(proj(wk))
                v1 = r(proj(wv) + r(bv)[cols])
                k1o[tr, cols], v1o[tr, cols] = k1, v1
                kk = kc[tr, :pos, cols].to(f32)
                vv = vc[tr, :pos, cols].to(f32)
                s = torch.einsum("rd,rtd->rt", q1, kk) * scale
                l_new = r(q1 * k1).sum(-1) * scale
                m = torch.maximum(s.amax(-1), l_new) if pos else l_new
                e, en = torch.exp(s - m[:, None]), torch.exp(l_new - m)
                den = e.sum(-1) + en
                p, pn = r(e / den[:, None]), r(en / den)
                kpw = -(-pos // 8)
                acc = torch.zeros(nr, 64, dtype=f32)
                for w in range(8):                   # the warps, in order
                    ta, tb = w * kpw, min(pos, (w + 1) * kpw)
                    if ta < tb:
                        acc = acc + torch.einsum("rt,rtd->rd", p[:, ta:tb],
                                                 vv[:, ta:tb])
                attn = r(acc + pn[:, None] * v1)
                part = part + attn @ r(wo)[cols]     # the rank's heads
            parts.append(part)
        o = torch.zeros(nr, d, dtype=f32)
        for rank, part in enumerate(parts):          # the ranks, in order
            if not (fault == "rank dropped" and rank == 1):
                o = o + part
        xo[tr] = o if partial else xt + (o + r(bo))
    if partial:
        return xo, k1o.to(rd), v1o.to(rd)
    out = (xo.to(rd), k1o.to(rd), v1o.to(rd))
    if tail is None:
        return out
    g2, b2, wcq, bcq = (a.to(f32) for a in tail)
    mu = xo.mean(-1, keepdim=True)
    var = (xo - mu).square().mean(-1, keepdim=True)
    h2 = r((xo - mu) / torch.sqrt(var + EPS) * r(g2) + r(b2))
    return (*out, (h2 @ r(wcq) + r(bcq)).to(rd))


def _inputs(rng, b, heads, l=L):
    d = heads * 64

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    w = 1 / np.sqrt(d)
    selfw = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, d, s=w), n(d, s=0.1),
             n(d, d, s=w), n(d, d, s=w), n(d, s=0.1), n(d, d, s=w),
             n(d, s=0.1)]
    tail = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, d, s=w), n(d, s=0.1)]
    return n(b, d), selfw, tail, n(b, l, d), n(b, l, d)


def _pallas(x, selfw, tail, kc, vc, pos, heads):
    """The JAX kernel in interpret mode on the rows padded to its 8-row
    blocks (rows are independent), cut back to B."""
    b = x.shape[0]
    pad = -b % 8

    def rows(a):
        return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])

    args = [jnp.asarray(rows(x)), *map(jnp.asarray, selfw)]
    caches = [jnp.asarray(rows(kc)), jnp.asarray(rows(vc))]
    if tail is None:
        out = JDB.fused_self_block(*args, *caches, jnp.int32(pos),
                                   heads=heads, interpret=True)
    else:
        out = JDB.fused_self_block_q(*args, *map(jnp.asarray, tail),
                                     *caches, jnp.int32(pos), heads=heads,
                                     interpret=True)
    return [np.asarray(a)[:b] for a in out]


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("heads", [2, 3, 4])
@pytest.mark.parametrize("b", [1, 3, 33])
@pytest.mark.parametrize("pos", [0, 1, L - 1])
def test_cluster_emulation_matches_plain_and_pallas(rng, tail, heads, b, pos):
    x, selfw, tl, kc, vc = _inputs(rng, b, heads)
    t = [torch.from_numpy(a) for a in (x, *selfw)]
    tt = [torch.from_numpy(a) for a in tl] if tail else None
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    got = emulate_k3(t[0], t[1:], tk, tv, pos, heads, tail=tt)
    runtime.reset_counts()
    if tail:
        plain = DB.self_block_q_plain(*t, *tt, tk, tv, pos, heads=heads)
    else:
        plain = DB.self_block_plain(*t, tk, tv, pos, heads=heads)
    assert set(runtime.COUNTS.values()) == {0}
    pallas = _pallas(x, selfw, tl if tail else None, kc, vc, pos, heads)
    assert len(got) == len(plain) == len(pallas) == (4 if tail else 3)
    for g, p, j in zip(got, plain, pallas):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g.numpy(), j, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("heads,mp", [(4, 2), (6, 2), (8, 2), (8, 4)])
@pytest.mark.parametrize("b", [1, 3, 33])
@pytest.mark.parametrize("pos", [0, 1, L - 1])
def test_partial_two_width_head_sum(rng, heads, mp, b, pos):
    """K3p's cluster on a rank's heads of a wider model: the layer norm,
    the q/k/v k-chunks and the head sum at the model width D = heads * 64,
    the attention and the caches at the rank's heads * 64 / mp columns.
    Each rank's emulation = the plain partial twin (and its cache row);
    the ranks' partials through model_sum = the square twin on the whole
    layer and the JAX kernel in interpret mode, within TOL."""
    from multimodal_audio_search_tpu_torch.parallel.mesh import model_sum
    x, selfw, _, kc, vc = _inputs(rng, b, heads)
    t = [torch.from_numpy(a) for a in (x, *selfw)]
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    g1, b1, wq, bq, wk, wv, bv, wo, bo = t[1:]
    hl = heads // mp

    def cut(a, j, axis):
        return torch.chunk(a, mp, axis)[j].contiguous()
    parts = []
    for j in range(mp):
        rank = [g1, b1, cut(wq, j, 1), cut(bq, j, 0), cut(wk, j, 1),
                cut(wv, j, 1), cut(bv, j, 0), cut(wo, j, 0), bo]
        kcj, vcj = cut(tk, j, 2), cut(tv, j, 2)
        got = emulate_k3(t[0], rank, kcj, vcj, pos, hl, partial=True)
        plain = DB.self_block_plain(t[0], *rank, kcj, vcj, pos, heads=hl,
                                    partial=True)
        assert got[0].shape == (b, heads * 64) and got[1].shape == (b, hl * 64)
        for g, p in zip(got, plain):
            np.testing.assert_allclose(g.numpy(), p.numpy(), atol=TOL,
                                       rtol=TOL)
        parts.append(got[0])
    whole = model_sum(parts, bo, t[0])[0]
    square = DB.self_block_plain(*t, tk, tv, pos, heads=heads)[0]
    pallas = _pallas(x, selfw, None, kc, vc, pos, heads)[0]
    np.testing.assert_allclose(whole.numpy(), square.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(whole.numpy(), pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("heads,want", [(6, (1, 6)), (8, (1, 8)),
                                        (12, (1, 12)), (20, (2, 16)),
                                        (2, (1, 2)), (3, (1, 3)),
                                        (19, (2, 16))])
def test_plan_covers_every_head_at_every_width(heads, want):
    """Whisper-tiny, -base, -small and -large (H = 6, 8, 12, 20), the
    test widths and a prime H (19): the cluster holds at most 16 blocks, the
    ranks' head ranges cover every head once with at most G heads each,
    and the block fits the card's shared memory with at least
    K3_MIN_STAGES ring slots at every cache length up to 448 and any
    batch."""
    for b in (1, 16, 17, 32, 128, 200):
        for l in (1, 68, 448):
            g, cs, rt, tiles, stages = DB.self_block_plan(b, heads, l)
            spans = [(r * heads // cs, (r + 1) * heads // cs)
                     for r in range(cs)]
            assert (g, cs) == want and cs <= 16
            assert [h for a, e in spans for h in range(a, e)] == \
                list(range(heads))
            assert max(e - a for a, e in spans) == g
            # the fewest rows a tile that keep the tiles within the
            # clusters the card holds at once
            assert rt == min(DB.K3_ROWS, -(-b // DB.K3_CLUSTERS))
            assert tiles == -(-b // rt)
            assert tiles <= DB.K3_CLUSTERS or rt == DB.K3_ROWS
            assert DB.K3_MIN_STAGES <= stages <= DB.K3_MAX_STAGES
            assert DB.k3_smem(heads * 64, l, stages, rt) <= DB.K3_SMEM
    assert DB.self_block_plan(32, 8, 68)[2:4] == (3, 11)
    assert DB.self_block_plan(128, 8, 68)[2:4] == (9, 15)
    assert DB.self_block_plan(32, 8, 68, clusters=30)[2:4] == (2, 16)
    assert DB.self_block_plan(32, 8, 68, rows=4)[2:4] == (4, 8)
    with pytest.raises(ValueError):
        DB.self_block_plan(32, 8, 68, rows=17)
    with pytest.raises(ValueError, match="shared memory"):
        DB.self_block_plan(32, 22, 448, rows=16)  # D = 1408: 5 ring slots
    # whisper-large at the longest cache: 3 rows a tile leave 23 slots
    assert DB.self_block_plan(32, 20, 448)[2:] == (3, 11, 23)


@pytest.mark.parametrize("fault", [None, "rank dropped"])
@pytest.mark.parametrize("tail", [False, True])
def test_k3_card_check_rejects_a_dropped_rank(fault, tail):
    """chip_smoke's K3 check on its own bf16 inputs at base width (B=34:
    12 row tiles of 3, the last ragged; pos 67): the cluster's arithmetic
    with the kernel's bf16 roundings passes, and a cluster sum that
    leaves one rank's partial out fails."""
    gen = torch.Generator().manual_seed(7)
    x, selfw, tl, kc, vc = chip_smoke.k3_inputs(gen, 34, 68, 512,
                                                device="cpu")
    pos = 67
    extra = tl if tail else []
    plain = DB.self_block_q_plain if tail else DB.self_block_plain
    ref = plain(x, *selfw, *extra, kc, vc, pos, heads=8)
    got = emulate_k3(x, selfw, kc, vc, pos, 8, tail=tl if tail else None,
                     rd=torch.bfloat16, fault=fault)
    if fault is None:
        chip_smoke.check_k3("K3", got, ref, x)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            chip_smoke.check_k3("K3 rank dropped", got, ref, x)
