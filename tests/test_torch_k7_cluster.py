"""K7's split-T cluster arithmetic, emulated on the CPU.

K7 (csrc/cached_attention.cu) gives each (b, h) row a cluster of CS
blocks (ops/cached_attention.py::cluster_plan); rank r takes the keys
[r * chunk, min(T, (r + 1) * chunk)) and may hold none. The ranks
exchange their logits' maxima and then their sums of exp through
distributed shared memory, so every rank forms pw = bf16(p / l * vs)
with the row's global max and sum, at the one-block kernel's rounding
point; rank 0 sums the ranks' float32 partials of out in rank order.

The emulation below states that arithmetic in float32 and is held to the
plain twin and to the JAX Pallas kernel in interpret mode at T = 1, 7,
1500 and 1501, with the plan's cluster and with 8 blocks forced (ranks
without keys); the plan is held at every T up to 12288; and chip_smoke's
K7 check rejects a cluster that drops one rank's partial, or that rounds
pw with a rank's own max and sum (what a split that merged (m, l, acc)
afterwards would round with).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.ops import cached_attention as JCA
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import cached_attention as CA

torch.set_num_threads(1)
TOL = 2e-5   # tests/test_torch_int8_attention.py's bar for the twin


def emulate_k7(q, k8, ks, v8, vs, *, cluster=None, fault=None):
    """K7 as its cluster computes it, float32. ``fault``: "rank dropped"
    (rank 1's partial left out of rank 0's sum) or "local softmax" (each
    rank's pw rounded from its own max and sum, the ranks' outputs then
    merged by their weights, as a split-T merge of (m, l, acc) would)."""
    f32 = torch.float32
    b, h, t, d = k8.shape
    cs, chunk = CA.cluster_plan(t, cluster)
    qb = q.to(torch.bfloat16).to(f32)
    lg = torch.einsum("bhd,bhtd->bht", qb, k8.to(f32)) * ks \
        * (1.0 / math.sqrt(d))
    spans = [(r * chunk, min(t, (r + 1) * chunk)) for r in range(cs)]
    spans = [(a, e) for a, e in spans if a < e]      # ranks without keys
    m_r = [lg[..., a:e].amax(-1) for a, e in spans]  # add 0 and weigh 0
    m = torch.stack(m_r).amax(0)                     # the cluster's max
    l_r = [torch.exp(lg[..., a:e] - (mr if fault == "local softmax" else m)
                     [..., None]).sum(-1) for (a, e), mr in zip(spans, m_r)]
    l_all = torch.zeros(b, h, dtype=f32)
    for x in l_r:                                    # in rank order
        l_all = l_all + x
    out = torch.zeros(b, h, d, dtype=f32)
    for r, ((a, e), mr, lr) in enumerate(zip(spans, m_r, l_r)):
        mm, ll = (mr, lr) if fault == "local softmax" else (m, l_all)
        p = torch.exp(lg[..., a:e] - mm[..., None])
        pw = (p / ll[..., None] * vs[..., a:e]).to(torch.bfloat16).to(f32)
        part = torch.einsum("bht,bhtd->bhd", pw, v8[..., a:e, :].to(f32))
        if fault == "local softmax":
            w = torch.exp(mr - m) * lr
            part = part * (w / sum(torch.exp(x - m) * y
                                   for x, y in zip(m_r, l_r)))[..., None]
        if not (fault == "rank dropped" and r == 1):
            out = out + part                         # in rank order
    return out


@pytest.mark.parametrize("cluster", [None, 8])
@pytest.mark.parametrize("t", [1, 7, 1500, 1501])
def test_split_emulation_matches_plain_and_pallas(rng, t, cluster):
    b, h, d = 2, 3, 64
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
            for _ in range(2))
    tq = CA.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    got = emulate_k7(torch.from_numpy(q), *tq, cluster=cluster)
    runtime.reset_counts()
    plain = CA.int8_cached_attention(torch.from_numpy(q), *tq)
    assert runtime.COUNTS["int8_cached_attention"] == 0
    jq = JCA.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    pallas = np.asarray(JCA.int8_cached_attention(
        jnp.asarray(q, dtype=jnp.bfloat16).astype(jnp.float32), *jq,
        interpret=True))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL * float(plain.abs().max()))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL,
                               atol=TOL * np.abs(pallas).max())


def test_plan_covers_every_key_once():
    """Every plan's ranks cover 0..T-1 once, with at most 8 blocks and at
    most MAX_T / MAX_CLUSTER keys a block (T = 12288, the most K7 takes:
    8 blocks of 1536 keys); a forced count too small for that raises."""
    for t in [1, 2, 3, 4, 5, 7, 8, 127, 128, 129, 300, 1499, 1500, 1501,
              3000, 4096, 12287, 12288]:
        for forced in (None, 1, 3, 8):
            if forced and -(-t // forced) > CA.MAX_T // CA.MAX_CLUSTER:
                with pytest.raises(ValueError, match="blocks hold"):
                    CA.cluster_plan(t, forced)
                continue
            cs, chunk = CA.cluster_plan(t, forced)
            assert cs == (forced or cs) and 1 <= cs <= CA.MAX_CLUSTER
            assert cs * chunk >= t > (chunk - 1) * cs
            covered = [k for r in range(cs)
                       for k in range(r * chunk, min(t, (r + 1) * chunk))]
            assert covered == list(range(t))
            assert chunk <= CA.MAX_T // CA.MAX_CLUSTER
    assert CA.cluster_plan(1500) == (8, 188)
    # the largest cluster whose every row is resident at once: an H100's
    # fit (124, 248 and 264 clusters of 8, 4 and 3 blocks) at B=32
    h100 = {8: 124, 4: 248, 3: 264, 2: 264}.get
    assert CA.cluster_plan(1500, rows=256, fit=lambda c, k: h100(c, 0)) \
        == (3, 500)
    assert CA.cluster_plan(1500, rows=192, fit=lambda c, k: h100(c, 0)) \
        == (4, 375)
    assert CA.cluster_plan(1500, rows=4096, fit=lambda c, k: 1) == (8, 188)
    assert CA.cluster_plan(12288, rows=256, fit=lambda c, k: 1) == (8, 1536)
    assert CA.cluster_plan(12288) == (8, 1536)
    assert CA.cluster_plan(1) == (1, 1)
    for bad in (0, 12289):
        with pytest.raises(ValueError):
            CA.cluster_plan(bad)
    with pytest.raises(ValueError):
        CA.cluster_plan(100, 9)


@pytest.mark.parametrize("fault", [None, "rank dropped", "local softmax"])
def test_k7_card_check_rejects_cluster_faults(fault):
    """chip_smoke's K7 check at the main path's T=1500, H=8 (B=4 here):
    the cluster's arithmetic passes; dropping one rank's partial, or
    rounding pw with each rank's own max and sum, fails."""
    gen = torch.Generator().manual_seed(21)
    args = chip_smoke.k7_inputs(gen, 4, 1500, 8, device="cpu")
    ref = CA.int8_cached_attention_plain(*args)
    got = emulate_k7(*args, fault=fault)
    if fault is None:
        chip_smoke.check_rel("K7", got, ref, chip_smoke.INT8_ATT_MAX,
                             chip_smoke.INT8_ATT_L2)
    else:
        with pytest.raises(AssertionError, match="off its plain version"):
            chip_smoke.check_rel(f"K7 {fault}", got, ref,
                                 chip_smoke.INT8_ATT_MAX,
                                 chip_smoke.INT8_ATT_L2)
