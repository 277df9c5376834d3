"""The float32 decoder blocks' grid designs (csrc/decoder_block_f32.cu),
on the CPU.

K3's float32 form (K3-q, K3p) runs on every multiprocessor in clusters of
two and K4's (K4-o, K4p) in clusters of eight; each block streams its
share of the weights once a launch over every batch row. Here:

* the plans' partitions (``self_block_f32_partition``,
  ``mlp_f32_partition``) give every element of Wq/Wk/Wv/Wo/Wcq, fc1, fc2
  and Wco to exactly one block, at every Whisper width, B = 1, 32 and 256
  and a model-axis rank's shard (H / 2 heads of D; F / 2 columns): the
  weights are read once;
* a float32 emulation of the kernels' summation order -- a block's k
  split into its thread groups' quads tile by tile, the groups added in
  order, then K3's pair (and the o-projection's pair) in rank order, K4's
  cluster's u gathered in rank order and its clusters' fc2 partials added
  in cluster order -- stays within chip_smoke's float32 block tolerance
  (F32_BLOCK_ATOL / RTOL, 2e-5) of the plain versions, and a planted fault
  (one rank's partial left out) fails it.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB

torch.set_num_threads(1)
CPU = torch.device("cpu")
# (D, H, F) of whisper-tiny, -base, -small, -medium and -large
WHISPER = [(384, 6, 1536), (512, 8, 2048), (768, 12, 3072),
           (1024, 16, 4096), (1280, 20, 5120)]
TOL = (chip_smoke.F32_BLOCK_ATOL, chip_smoke.F32_BLOCK_RTOL)


def _cover(tiles, shapes):
    """Every element of every matrix in ``shapes`` counted once."""
    count = {m: np.zeros(s, np.int32) for m, s in shapes.items()}
    for _, m, (r0, r1), (c0, c1) in tiles:
        count[m][r0:r1, c0:c1] += 1
    for m, c in count.items():
        assert c.min() == 1 and c.max() == 1, (m, c.min(), c.max())


@pytest.mark.parametrize("d,heads,f", WHISPER)
def test_f32_plans_read_every_weight_once(d, heads, f):
    """Each weight element belongs to exactly one block: K3 (with K3-q's
    Wcq) on the whole layer and K3p on a rank's H / 2 heads of D; K4 (with
    K4-o's Wco on its row projection's clusters) on the whole layer and
    K4p on a rank's F / 2 columns; at B = 1, 32 and 256."""
    for b in (1, 32, 256):
        for hl in (heads, heads // 2):
            plan = DB.self_block_f32_plan(b, hl, 68, d=d)
            hw = hl * 64
            tail = hl == heads
            _cover(DB.self_block_f32_partition(plan, hl, d=d, tail=tail),
                   {"wq": (d, hw), "wk": (d, hw), "wv": (d, hw),
                    "wo": (hw, d), **({"wcq": (d, d)} if tail else {})})
        for ff in (f, f // 2):
            head = ff == f
            plan = DB.mlp_f32_plan(b, d, ff)
            _cover(DB.mlp_f32_partition(plan, d, ff, head=head,
                                        proj=DB.rowproj_f32_plan(b, d)),
                   {"w1": (d, ff), "w2": (ff, d),
                    **({"wco": (d, d)} if head else {})})


# ------------------------------------------------- the kernels' sums, emulated
def _ks(rb: int, ng: int) -> int:
    """A block's k groups (csrc/decoder_block_f32.cu's roles)."""
    u = rb // 4 * ng
    if u > 256:
        return 1
    k = 256 // u
    return 16 if k >= 16 else 8 if k >= 8 else 4 if k >= 4 else \
        2 if k >= 2 else 1


def _block(h, w, rb):
    """A block's product h [rb, nk] @ w [nk, 8 ng] in the kernel's order:
    tiles of f32_tile_rows rows, each thread group ks its k quads ks, ks +
    KS, .. tile by tile, the groups' partials added in group order."""
    nk, nc = w.shape
    tr = DB.f32_tile_rows(nc, rb)
    ks_n = _ks(rb, nc // 8)
    groups = []
    for ks in range(ks_n):
        acc = torch.zeros(h.shape[0], nc)
        for t0 in range(0, nk, tr):
            for q in range(ks, min(tr, nk - t0) // 4, ks_n):
                k = t0 + 4 * q
                acc = acc + h[:, k:k + 4] @ w[k:k + 4]
        groups.append(acc)
    out = groups[0]
    for g in groups[1:]:
        out = out + g
    return out


def _pair(h, w, clusters, drop=None):
    """K3's (and the row projection's) product on clusters of two: cluster
    c the 8-column groups [c n / NC, (c + 1) n / NC), rank r the rows [r K
    / 2, (r + 1) K / 2), the two partials added in rank order. ``drop``:
    (cluster, rank) whose partial is left out."""
    k, n = w.shape
    rb = -(-h.shape[0] // 4) * 4
    hp = torch.zeros(rb, k)
    hp[:h.shape[0]] = h
    out = torch.zeros(rb, n)
    for c in range(clusters):
        g0, g1 = DB._split(n // 8, clusters, c)
        if g0 == g1:
            continue
        cols = slice(8 * g0, 8 * g1)
        parts = []
        for r in range(2):
            rows = slice(*DB._split(k, 2, r))
            p = _block(hp[:, rows], w[rows, cols], rb)
            parts.append(torch.zeros_like(p) if drop == (c, r) else p)
        out[:, cols] = parts[0] + parts[1]
    return out[:h.shape[0]]


def _ln(x, g, b, eps=1e-5, halves=2):
    """The layer norm with each part's sums added in rank order."""
    d = x.shape[1]
    parts = torch.chunk(x, halves, 1)
    mu = sum((p.sum(1) for p in parts[1:]), parts[0].sum(1)) / d
    dev = [((p - mu[:, None]) ** 2).sum(1) for p in parts]
    var = sum(dev[1:], dev[0]) / d
    return (x - mu[:, None]) * (1 / torch.sqrt(var + eps))[:, None] * g + b


def k3_emulated(x, selfw, tail, kc, vc, pos, heads, clusters=66, drop=None):
    """K3 (K3-q with ``tail``) as the grid computes it, in float32."""
    g1, b1, wq, bq, wk, wv, bv, wo, bo = selfw
    b, d = x.shape
    hl = heads * 64
    h = _ln(x, g1, b1)
    qkv = _pair(h, torch.cat([wq, wk, wv], 1), clusters, drop)
    q, k1, v1 = qkv[:, :hl] + bq, qkv[:, hl:2 * hl], qkv[:, 2 * hl:] + bv
    qh, kh, vh = (a.reshape(b, heads, 64) for a in (q, k1, v1))
    kc_, vc_ = (a[:, :pos].reshape(b, pos, heads, 64) for a in (kc, vc))
    scale = 1 / math.sqrt(64)
    logits = torch.einsum("bhd,bthd->bht", qh, kc_) * scale
    l_new = (qh * kh).sum(-1) * scale
    m = torch.maximum(logits.amax(-1), l_new) if pos else l_new
    p = torch.exp(logits - m[..., None])
    pn = torch.exp(l_new - m)
    den = p.sum(-1) + pn
    attn = (torch.einsum("bht,bthd->bhd", p / den[..., None], vc_)
            + (pn / den)[..., None] * vh).reshape(b, hl)
    x_out = x + (_pair(attn, wo, clusters) + bo)
    out = (x_out, k1, v1)
    if tail:
        g2, b2, wcq, bcq = tail
        out += (_pair(_ln(x_out, g2, b2), wcq, clusters) + bcq,)
    return out


def k4_emulated(x, mlp, head=None, clusters=15, drop=None):
    """K4 (K4-o with ``head``) as the grid computes it, in float32: each
    rank of a cluster its share of the cluster's fc1 columns (every row of
    D), u gathered in rank order, its D / 8 / 8 groups of fc2's columns
    over the cluster's F rows, the clusters' partials added in cluster
    order. ``drop``: (cluster, rank) whose fc2 partial is left out."""
    g, bl, w1, b1, w2, b2 = mlp
    if head:
        attn, wco, bco = head
        x = x + (_pair(attn, wco, min(66, x.shape[1] // 8)) + bco)
    b, d = x.shape
    f = w1.shape[1]
    rb = -(-b // 4) * 4
    h = torch.zeros(rb, d)
    h[:b] = _ln(x, g, bl, halves=1)
    total = None
    for c in range(clusters):
        cf0, cf1 = DB._split(f // 8, clusters, c)
        us = []
        for r in range(8):
            q0, q1 = DB._split(cf1 - cf0, 8, r)
            cols = slice(8 * (cf0 + q0), 8 * (cf0 + q1))
            if q1 > q0:
                us.append(DB.gelu_as(_block(h, w1[:, cols], rb) + b1[cols]))
        u = torch.cat(us, 1)
        part = torch.zeros(rb, d)
        for r in range(8):
            g0, g1 = DB._split(d // 8, 8, r)
            cols = slice(8 * g0, 8 * g1)
            if drop != (c, r):
                part[:, cols] = _block(u, w2[8 * cf0:8 * cf1, cols], rb)
        total = part if total is None else total + part
    return x + (total[:b] + b2)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("b,heads,l,pos", [(32, 8, 68, 67), (32, 6, 68, 3),
                                           (1, 8, 68, 0), (9, 20, 448, 447)])
def test_k3_f32_emulated_order_matches_plain(tail, b, heads, l, pos):
    """K3's and K3-q's grid order in float32 within 2e-5 of the plain
    version (x_out, k1, v1 and q_cross), at the float32 engine's widths,
    one row and whisper-large's 20 heads at L=448."""
    gen = torch.Generator().manual_seed(2800 + b + pos)
    x, selfw, tl, kc, vc = chip_smoke.k3_inputs(gen, b, l, heads * 64,
                                                device=CPU,
                                                dtype=torch.float32)
    extra = tl if tail else []
    plain = DB.self_block_q_plain if tail else DB.self_block_plain
    ref = plain(x, *selfw, *extra, kc, vc, pos, heads=heads)
    got = k3_emulated(x, selfw, tl if tail else None, kc, vc, pos, heads)
    for name, gv, rv in zip(("x_out", "k1", "v1", "q_cross"), got, ref):
        chip_smoke.check_close(f"K3 f32 emulated {name}", gv, rv, *TOL)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("b,d,f", [(32, 512, 2048), (32, 384, 1536),
                                   (1, 128, 256)])
def test_k4_f32_emulated_order_matches_plain(head, b, d, f):
    """K4's and K4-o's grid order in float32 within 2e-5 of the plain
    version at the float32 engine's widths and one row."""
    gen = torch.Generator().manual_seed(2900 + b + d)
    x, mlp, hd = chip_smoke.k4_inputs(gen, b, d, f, device=CPU,
                                      dtype=torch.float32)
    if head:
        ref = DB.mlp_block_o_plain(x, *hd, *mlp)
    else:
        ref = DB.mlp_block_plain(x, *mlp)
    got = k4_emulated(x, mlp, hd if head else None)
    chip_smoke.check_close("K4 f32 emulated", got, ref, *TOL)


def test_f32_emulation_sees_a_dropped_rank():
    """The planted faults: K3 f32 at base width with cluster 0's rank-1
    partial of the q/k/v projection left out, and K4 f32 with cluster 0's
    rank-1 fc2 partial left out, each fail the float32 check."""
    gen = torch.Generator().manual_seed(28)
    x, selfw, _, kc, vc = chip_smoke.k3_inputs(gen, 32, 68, 512, device=CPU,
                                               dtype=torch.float32)
    ref = DB.self_block_plain(x, *selfw, kc, vc, 67, heads=8)
    got = k3_emulated(x, selfw, None, kc, vc, 67, 8, drop=(0, 1))
    with pytest.raises(AssertionError, match="outside atol"):
        for gv, rv in zip(got, ref):
            chip_smoke.check_close("K3 f32 rank dropped", gv, rv, *TOL)
    x, mlp, _ = chip_smoke.k4_inputs(gen, 32, 512, 2048, device=CPU,
                                     dtype=torch.float32)
    with pytest.raises(AssertionError, match="outside atol"):
        chip_smoke.check_close("K4 f32 rank dropped",
                               k4_emulated(x, mlp, drop=(0, 1)),
                               DB.mlp_block_plain(x, *mlp), *TOL)
