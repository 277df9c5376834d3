"""K6's split-T cluster arithmetic, emulated on the CPU.

K6 (csrc/cross_attention_int8.cu) gives each (b, G heads) row a cluster
of CS blocks (ops/cross_attention.py::int8_plan); rank r takes the keys
[r * chunk, min(n_valid, (r + 1) * chunk)) and may hold none. The ranks
exchange each head's logit max, then its sum of exp(lg - m) and its max
of pw (both formed with the global m) through distributed shared memory,
so every rank forms pw8 = clip(rint(pw / spw)) with the row's global spw;
each rank's int32 partial of oi is exact, and rank 0 adds them and
writes oi * (spw / l), l summed in rank order.

The emulation below states that arithmetic in float32 and is held to the
plain twin and to the JAX Pallas kernel in interpret mode at T = 1, 7,
1500 and 1501, with and without pos, with the plan's cluster and with 8
blocks forced (ranks without keys), for both head layouts; the plan is
held to cover every key once at every T up to 12288; and chip_smoke's K6
check rejects a cluster that drops one rank's partial, or that forms pw8
with a rank's own max and spw (what a split that merged per-rank outputs
afterwards would compute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import cross_attention as JCX
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
from multimodal_audio_search_tpu_torch.ops import cross_attention as CX

torch.set_num_threads(1)
TOL = 1e-6   # tests/test_torch_int8_attention.py's bar for the twin


def emulate_k6(q_m, k8, ks, v8, vs, *, heads, pos=None, group=None,
               cluster=None, fault=None):
    """K6 as its cluster computes it, float32. ``fault``: "rank dropped"
    (rank 1's partial left out of rank 0's sum) or "local spw" (each
    rank's pw8 formed with its own max and spw, the ranks' outputs then
    merged by their softmax weights)."""
    f32 = torch.float32
    b, hd = q_m.shape
    t = k8.shape[1]
    d = hd // heads
    n_valid = t if pos is None else pos + 1
    _, cs, chunk = CX.int8_plan(n_valid, heads, b, None, group, cluster)
    qf = q_m.to(f32).reshape(b, heads, d)
    qs = CA.div_exact(qf.abs().amax(-1).clamp_min(1e-12), 127.0)
    q8 = torch.round(qf / qs[..., None]).clamp(-127, 127)
    li = torch.einsum("bhd,bthd->bht", q8.double(),
                      k8.reshape(b, t, heads, d).double()).to(f32)
    lg = li * ks.transpose(1, 2) * qs[..., None] * (1.0 / d ** .5)
    vsh = vs.transpose(1, 2)
    v8h = v8.reshape(b, t, heads, d).double()
    spans = [(r * chunk, min(n_valid, (r + 1) * chunk)) for r in range(cs)]
    spans = [(a, e) for a, e in spans if a < e]      # ranks without keys
    m_r = [lg[..., a:e].amax(-1) for a, e in spans]  # add 0 and weigh 0
    m = torch.stack(m_r).amax(0)                     # the cluster's max
    local = fault == "local spw"
    p_r = [torch.exp(lg[..., a:e] - (mr if local else m)[..., None])
           for (a, e), mr in zip(spans, m_r)]
    pw_r = [p * vsh[..., a:e] for p, (a, e) in zip(p_r, spans)]
    l_r = [p.sum(-1) for p in p_r]
    pm_r = [pw.amax(-1) for pw in pw_r]
    spw = CA.div_exact(torch.stack(pm_r).amax(0).clamp_min(1e-20), 127.0)
    l_all = torch.zeros(b, heads, dtype=f32)
    for lr, mr in zip(l_r, m_r):                     # in rank order
        l_all = l_all + (lr * torch.exp(mr - m) if local else lr)
    oi = torch.zeros(b, heads, d, dtype=torch.float64)
    out = torch.zeros(b, heads, d, dtype=f32)
    for r, ((a, e), pw, mr, pm) in enumerate(zip(spans, pw_r, m_r, pm_r)):
        s = CA.div_exact(pm.clamp_min(1e-20), 127.0) if local else spw
        pw8 = torch.round(pw / s[..., None]).clamp(-127, 127)
        part = torch.einsum("bht,bthd->bhd", pw8.double(), v8h[:, a:e])
        if fault == "rank dropped" and r == 1:
            continue
        if local:
            out = out + part.to(f32) * (s * torch.exp(mr - m) / l_all)[
                ..., None]
        else:
            oi = oi + part                           # exact
    if not local:
        out = oi.to(f32) * (spw / l_all)[..., None]
    return out.reshape(b, hd)


@pytest.mark.parametrize("group", ["H", 1])
@pytest.mark.parametrize("cluster", [None, 8])
@pytest.mark.parametrize("pos", [None, "last-1"])
@pytest.mark.parametrize("t", [1, 7, 1500, 1501])
def test_split_emulation_matches_plain_and_pallas(rng, t, pos, cluster,
                                                  group):
    b, heads, d = 2, 3, 64
    hd = heads * d
    pos = None if pos is None or t == 1 else t - 2
    g = heads if group == "H" else group
    q = rng.normal(size=(b, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, hd)).astype(np.float32)
            for _ in range(2))
    tq = CX.quantize_kv_merged(torch.from_numpy(k), torch.from_numpy(v),
                               heads)
    got = emulate_k6(torch.from_numpy(q), *tq, heads=heads, pos=pos,
                     group=g, cluster=cluster)
    runtime.reset_counts()
    plain = CX.fused_single_query_attention_int8(torch.from_numpy(q), *tq,
                                                 heads=heads, pos=pos)
    assert runtime.COUNTS["single_query_attention_int8"] == 0
    assert torch.isfinite(got).all()
    # the same codes (max and spw are exact), l summed in another order
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL * float(plain.abs().max()))
    jq = JCX.quantize_kv_merged(jnp.asarray(k), jnp.asarray(v), heads)
    pallas = np.asarray(JCX.fused_single_query_attention_int8(
        jnp.asarray(q), *jq, heads=heads,
        pos=None if pos is None else jnp.int32(pos), interpret=True))
    # JAX's exp may move a pw8 code one step at a .5 boundary: the most
    # one step moves an output is spw / l * 127 = max(p * vs) / l
    lg = emulate_logits(torch.from_numpy(q), *tq, heads, pos)
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    step = ((p * tq[3].double().transpose(1, 2)).amax(-1) / p.sum(-1)) \
        .repeat_interleave(d, dim=-1).numpy()
    assert np.all(np.abs(got.numpy() - pallas)
                  <= TOL * np.abs(pallas).max() + TOL * np.abs(pallas)
                  + step)


def emulate_logits(q_m, k8, ks, v8, vs, heads, pos):
    """The float64 logits [B, H, T] of K6's codes, keys past pos -inf."""
    b, hd = q_m.shape
    t, d = k8.shape[1], hd // heads
    q8, qs = CA.quantize_rows(q_m.reshape(b, heads, d))
    li = torch.einsum("bhd,bthd->bht", q8.double(),
                      k8.reshape(b, t, heads, d).double())
    lg = li * ks.double().transpose(1, 2) * qs.double()[..., None] / d ** .5
    if pos is not None:
        lg[..., pos + 1:] = -np.inf
    return lg


def test_plan_covers_every_key_once():
    """Every plan's ranks cover 0..n_valid-1 once, with 1-16 blocks, G | H
    heads a block and a block within K6's shared memory (n_valid = 12288,
    the most K6 takes, included); forced counts outside the limits
    raise."""
    for heads in (6, 8, 20):
        for n in [1, 2, 3, 7, 63, 64, 65, 127, 300, 999, 1000, 1499, 1500,
                  1501, 3000, 4096, 12287, 12288]:
            for group, forced in ((None, None), (1, None), (heads, None),
                                  (1, 3), (1, 8), (1, 16), (heads, 8)):
                try:
                    g, cs, chunk = CX.int8_plan(n, heads, 32, None, group,
                                                forced)
                except ValueError as e:
                    # a block too large for shared memory is refused
                    assert "no block" in str(e) and (group == heads or forced)
                    assert CX.int8_smem_bytes(group or 2, -(-n // (
                        forced or 16))) > CX.SMEM_LIMIT
                    continue
                assert g == (group or g) and heads % g == 0
                assert cs == (forced or cs) and 1 <= cs <= CX.MAX_CLUSTER
                assert cs * chunk >= n > (chunk - 1) * cs
                assert CX.int8_smem_bytes(g, chunk) <= CX.SMEM_LIMIT
                covered = [k for r in range(cs)
                           for k in range(r * chunk, min(n, (r + 1) * chunk))]
                assert covered == list(range(n))
    # the fit decides the cluster: the largest whose rows are all resident
    # (an H100's: 132 clusters of 2 blocks of 2 heads, 124 of 3)
    fit = {(2, 2): 132, (2, 3): 124, (1, 2): 264, (1, 3): 248}
    assert CX.int8_plan(1500, 8, 32, lambda g, c, k: fit.get((g, c), 0)) \
        == (2, 2, 750)
    assert CX.int8_plan(1500, 6, 32, lambda g, c, k: fit.get((g, c), 0)) \
        == (2, 3, 500)
    assert CX.int8_plan(1500, 3, 32, lambda g, c, k: fit.get((g, c), 0)) \
        == (1, 3, 500)
    assert CX.int8_plan(1500, 8, 32, lambda g, c, k: 0)[:2] == (2, 16)
    for bad in (0, 12289):
        with pytest.raises(ValueError):
            CX.int8_plan(bad, 8)
    with pytest.raises(ValueError):
        CX.int8_plan(100, 8, cluster=17)
    with pytest.raises(ValueError):
        CX.int8_plan(100, 8, group=3)


@pytest.mark.parametrize("fault", [None, "rank dropped", "local spw"])
def test_k6_card_check_rejects_cluster_faults(fault):
    """chip_smoke's K6 check at the main path's T=1500, H=8 (B=4 here) with
    the plan's layout and cluster at B=32 on an H100: the cluster's
    arithmetic passes; dropping one rank's partial, or forming pw8 with
    each rank's own max and spw, fails."""
    gen = torch.Generator().manual_seed(21)
    args = chip_smoke.k6_inputs(gen, 4, 1500, 8, device="cpu")
    ref = CX.single_query_attention_int8_plain(*args, heads=8)
    g, cs, _ = CX.int8_plan(1500, 8, 32, lambda g, c, k: 1 << 20)
    got = emulate_k6(*args, heads=8, group=g, cluster=cs, fault=fault)
    if fault is None:
        chip_smoke.check_rel("K6", got, ref, chip_smoke.INT8_ATT_MAX,
                             chip_smoke.INT8_ATT_L2)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            chip_smoke.check_rel(f"K6 {fault}", got, ref,
                                 chip_smoke.INT8_ATT_MAX,
                                 chip_smoke.INT8_ATT_L2)
