"""The float32 routes of the last encoder variants and of the mesh's model
axis, the port against the JAX package on the CPU.

On the card a float32 engine under ``fused_encoder="paired"`` launches
K10's float32 form, under ``"int8"`` K9's, and any float32 engine with
``model_parallel > 1`` the float32 forms of K1p (K10p, K9p), K3p and K4p.
Here, on the CPU, the same calls run their plain twins; the same
numpy-seeded inputs feed the JAX package:

* K1p, K10p and K9p on a rank's head shard with a non-square Wo [H*64,
  HD_out], against the JAX kernel in interpret mode with x = 0 and bo = 0
  (the shard form its docstring gives every body), at 5e-5; K9p at the
  int8 guardrail of tests/test_torch_encoder_variants.py (1e-5 of the
  output's scale plus what the counted p8 code flips can move through
  the rank's Wo rows);
* K10 on float32 (the whole layer) against JAX's paired body, single-
  and multi-step grids (its division after and before P V), at 5e-5;
* K3p and K4p: the ranks' float32 partials through model_sum against
  the JAX fused_self_block / fused_mlp_block in interpret mode at 5e-5,
  at ranks of whisper-tiny's 6 heads over 3 and a ragged batch, each
  rank's cache row against JAX's k1 / v1 columns.

No kernel launches on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.ops import decoder_block as JDB
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
from multimodal_audio_search_tpu_torch.parallel import mesh as M
from test_torch_encoder_variants import TOL as INT8_TOL, _p8_flips

torch.set_num_threads(1)
TOL = 5e-5
L = 12   # the self cache's rows


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _shard(a: torch.Tensor, j: int, mp: int, axis: int) -> torch.Tensor:
    return torch.chunk(a, mp, axis)[j].contiguous()


def _rank_inputs(seed: int, b: int, hl: int, t: int, hdo: int):
    """A rank's q, k, v [B, hl, T, 64] ~ N(0, 1) and its Wo rows [hl*64,
    hdo] ~ N(0, 1/hdo), float32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, hl, t, 64)).astype(np.float32)
               for _ in range(3))
    wo = (rng.normal(size=(hl * 64, hdo)) / np.sqrt(hdo)).astype(np.float32)
    return q, k, v, wo


def _jax_shard(q, k, v, wo, blk_q, **body):
    """The JAX kernel's shard form: x = 0 and bo = 0 over the rank's heads
    and Wo rows, interpret mode, float32."""
    b, _, t, _ = q.shape
    hdo = wo.shape[1]
    return np.asarray(JEB.fused_attention_o_residual(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.zeros((b, t, hdo), jnp.float32), jnp.asarray(wo),
        jnp.zeros(hdo, jnp.float32), blk_q=blk_q, interpret=True, **body))


# (hl, mp, T, blk_q): a rank's heads, the ranks, T within one q block or
# past it
SHARDS = [(2, 2, 100, 128), (3, 2, 70, 32), (4, 2, 96, 32), (2, 4, 33, 64)]


@pytest.mark.parametrize("body,hl,mp,t,blk_q", [
    ("K1p", *s) for s in SHARDS] + [
    ("K10p", *s) for s in SHARDS if s[0] % 2 == 0])
def test_k1p_k10p_float32_match_jax_shard(body, hl, mp, t, blk_q):
    """K1p's and K10p's float32 routes (K10p where the rank's head count
    is even; a rank of odd heads takes K1p) on a rank's heads and a
    non-square Wo [hl*64, mp*hl*64] against the JAX kernel's shard form
    at 5e-5: a float32 [B, T, HD_out] partial, no launch."""
    pair = body == "K10p"
    q, k, v, wo = _rank_inputs(10 * hl + mp + t, 2, hl, t, mp * hl * 64)
    ref = _jax_shard(q, k, v, wo, blk_q, pair_heads=pair)
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(_t(q), _t(k), _t(v), None, _t(wo),
                                        None, pair_heads=pair, partial=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    assert sum(runtime.COUNTS.values()) == 0


@pytest.mark.parametrize("hl,mp,t", [(2, 2, 100), (3, 2, 70), (4, 2, 40)])
def test_k9p_float32_matches_jax_shard(hl, mp, t):
    """K9p's float32 route on a rank's heads against the JAX int8 body's
    shard form, within the int8 guardrail: 1e-5 of the output's scale
    plus one code step of every counted p8 flip through |Wo rows|."""
    q, k, v, wo = _rank_inputs(20 * hl + t, 2, hl, t, mp * hl * 64)
    kq = EB.quantize_kv(_t(k), _t(v))
    k8, ks, _, vs = (a.numpy() for a in kq)
    flips, ps = _p8_flips(q, k8, ks, vs)
    assert flips.sum() <= max(1, flips.size // 100)     # rare, if any
    step = (flips * 127 * ps)[..., None] * np.ones(64)
    dy = np.einsum("bhtd,hdj->btj", step,
                   np.abs(wo).reshape(hl, 64, wo.shape[1]))
    ref = _jax_shard(q, k, v, wo, 128, qk_int8=True)
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(_t(q), _t(k), _t(v), None, _t(wo),
                                        None, qk_int8=True, partial=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.all(np.abs(got.numpy() - ref)
                  <= INT8_TOL * np.abs(ref).max() + dy)
    assert sum(runtime.COUNTS.values()) == 0


@pytest.mark.parametrize("b,heads,t,blk_q", [(2, 4, 100, 128),
                                             (1, 6, 300, 128),
                                             (2, 2, 65, 32)])
def test_k10_float32_matches_jax_paired_body(b, heads, t, blk_q):
    """K10's float32 route on the whole layer (x + attn @ Wo + bo) against
    JAX's paired body in interpret mode at float32, within 5e-5: T within
    one q block (the body divides P V by l) and past it (p / l before P
    V). On float32 the block-diagonal zeros add exact zeros, so K1's
    float32 route gives the same within the same tolerance."""
    rng = np.random.default_rng(30 + heads + t)
    hd = heads * 64
    q, k, v = (rng.normal(size=(b, heads, t, 64)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / np.sqrt(hd)).astype(np.float32)
    bo = (rng.normal(size=(hd,)) * 0.1).astype(np.float32)
    ref = np.asarray(JEB.fused_attention_o_residual(
        *map(jnp.asarray, (q, k, v, x, wo, bo)), blk_q=blk_q,
        pair_heads=True, interpret=True))
    args = [_t(a) for a in (q, k, v, x, wo, bo)]
    runtime.reset_counts()
    got = EB.fused_attention_o_residual(*args, pair_heads=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        EB.fused_attention_o_residual(*args).numpy(), ref, atol=TOL,
        rtol=TOL)
    assert sum(runtime.COUNTS.values()) == 0


def _block_inputs(rng, b, heads):
    d = heads * 64

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    w = 1 / np.sqrt(d)
    selfw = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, d, s=w), n(d, s=0.1),
             n(d, d, s=w), n(d, d, s=w), n(d, s=0.1), n(d, d, s=w),
             n(d, s=0.1)]
    f = 4 * d
    mlp = [n(d, s=0.2) + 1, n(d, s=0.2), n(d, f, s=w), n(f, s=0.5),
           n(f, d, s=1 / np.sqrt(f)), n(d, s=0.1)]
    return n(b, d), selfw, mlp, n(b, L, d), n(b, L, d)


def _rows(a, pad):
    return jnp.asarray(np.concatenate([a, np.zeros((pad, *a.shape[1:]),
                                                   a.dtype)]))


@pytest.mark.parametrize("heads,mp", [(6, 3), (6, 2)])
@pytest.mark.parametrize("b", [5, 16])
@pytest.mark.parametrize("pos", [0, L - 1])
def test_k3p_k4p_float32_ranks_summed_match_jax(heads, mp, b, pos):
    """K3p's and K4p's float32 routes at whisper-tiny's 6 heads over 3 and
    2 ranks (2 and 3 heads a rank; F/mp MLP columns): the ranks' float32
    partials summed by model_sum equal the JAX float32 fused_self_block /
    fused_mlp_block within 5e-5, each rank's cache row JAX's k1 / v1
    columns; no launch."""
    rng = np.random.default_rng(100 * b + 10 * mp + pos)
    x, selfw, mlp, kc, vc = _block_inputs(rng, b, heads)
    pad = -b % 8
    jxo, jk1, jv1 = (np.asarray(a)[:b] for a in JDB.fused_self_block(
        _rows(x, pad), *map(jnp.asarray, selfw), _rows(kc, pad),
        _rows(vc, pad), jnp.int32(pos), heads=heads, interpret=True))
    jmo = np.asarray(JDB.fused_mlp_block(_rows(x, pad), *map(jnp.asarray,
                                                              mlp),
                                         interpret=True))[:b]
    tx = _t(x)
    g1, b1, wq, bq, wk, wv, bv, wo, bo = map(_t, selfw)
    hl = heads // mp
    runtime.reset_counts()
    parts = []
    for j in range(mp):
        kcj, vcj = (_shard(_t(c), j, mp, 2) for c in (kc, vc))
        out, k1, v1 = DB.fused_self_block(
            tx, g1, b1, _shard(wq, j, mp, 1), _shard(bq, j, mp, 0),
            _shard(wk, j, mp, 1), _shard(wv, j, mp, 1), _shard(bv, j, mp, 0),
            _shard(wo, j, mp, 0), None, kcj, vcj, pos, heads=hl,
            partial=True)
        assert out.dtype == torch.float32 and out.shape == tx.shape
        cols = slice(j * hl * 64, (j + 1) * hl * 64)
        np.testing.assert_allclose(k1.numpy(), jk1[:, cols], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(v1.numpy(), jv1[:, cols], atol=TOL,
                                   rtol=TOL)
        parts.append(out)
    np.testing.assert_allclose(M.model_sum(parts, bo, tx)[0].numpy(), jxo,
                               atol=TOL, rtol=TOL)
    g, bl, w1, b1f, w2, b2 = map(_t, mlp)
    parts = [DB.fused_mlp_block(tx, g, bl, _shard(w1, j, mp, 1),
                                _shard(b1f, j, mp, 0), _shard(w2, j, mp, 0),
                                None, partial=True) for j in range(mp)]
    assert all(p.dtype == torch.float32 for p in parts)
    np.testing.assert_allclose(M.model_sum(parts, b2, tx)[0].numpy(), jmo,
                               atol=TOL, rtol=TOL)
    assert sum(runtime.COUNTS.values()) == 0


def test_chip_smoke_f32_variant_checks_on_cpu(monkeypatch):
    """chip_smoke.py's [f32] checks of K10's and K9's float32 forms run
    whole on the CPU at a small size (the twins stand in for the
    kernels): K10 against its plain version and K1's float32 route, K9 on
    every K1 input with its repeats, and the planted bf16 q fault, which
    the check must catch on the attention input."""
    import chip_smoke as C
    monkeypatch.setattr(C, "time_ms", lambda *a, **k: 0.0)
    k9, k10 = C.f32_variant_checks("cpu", torch.Generator().manual_seed(27),
                                   device="cpu", b=2, t=150)
    assert k9["name"] == "encoder_attn_o_residual_int8_f32"
    assert k10["name"] == "encoder_attn_o_residual_paired_f32"
    assert len(k10["cases"]) == len(C.F32_WIDTHS)
    assert len(k9["cases"]) == len(C.F32_WIDTHS) * len(C.K1_CASES)
    assert all(c["equal_k1_f32"] for c in k10["cases"])
    faulted = [c for c in k9["cases"] if "bf16_q_fault" in c]
    assert len(faulted) == 2 * len(C.F32_WIDTHS)
    assert all(c["bf16_q_fault"]["caught"] for c in faulted
               if c["inputs"] == "attention")
    assert sum(runtime.COUNTS.values()) == 0


def test_chip_smoke_tp_f32_checks_on_cpu(monkeypatch):
    """chip_smoke.py's [tp] checks of the float32 partial forms run whole
    on the CPU at a small size: K1p at every TP_K1_WIDTHS rank, K10p at
    whisper-base's, K9p at base's and tiny's, each with its repeats and
    the ranks' model_sum against the square form; K3p and K4p at
    whisper-base's rank; no launch."""
    import chip_smoke as C
    monkeypatch.setattr(C, "time_ms", lambda *a, **k: 0.0)
    runtime.reset_counts()
    k1p, k10p, k9p, k3p, k4p = C.tp_f32_kernels(
        "cpu", torch.Generator().manual_seed(28), device="cpu", b=2, t=70)
    assert [len(k["cases"]) for k in (k1p, k10p, k9p, k3p, k4p)] == \
        [len(C.TP_K1_WIDTHS) + len(C.TP_ENC_WIDTHS), 2,
         2 * len(C.TP_ENC_WIDTHS), 1, 1]
    assert all(c["repeats_equal"] == C.F32_REPEATS
               for k in (k1p, k10p, k9p, k3p, k4p) for c in k["cases"]
               if "repeats_equal" in c)
    assert k10p["cases"][0]["cluster"] == 2
    assert [c["cluster"] for c in k1p["cases"] if "cluster" in c] == [4, 3, 5]
    assert sum(runtime.COUNTS.values()) == 0


def test_chip_smoke_tp_f32_paths_on_cpu():
    """[tp]'s float32 mesh paths (TP_F32_PATHS: fast_lossless, enc_int8,
    enc_paired) through mesh_ingest_check at (1, 2) on the test presets
    with dtype float32: the split ingest against the unsplit one, every
    expected launch once a rank, none on the CPU."""
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch import config as tcfg
    from test_torch_slice import SR, _pieces
    wave = _pieces(np.random.default_rng(3), 45)
    base = tcfg.EngineConfig(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        embed_dim=64, ingest_batch=16, short_context=True,
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=0.5),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=6),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=6))
    cpu = torch.device("cpu")
    for label, profile, fused, int8, enc, dps in C.TP_F32_PATHS:
        assert label.startswith("f32 ") and dps == (1,)
        cfg = C.tp_config(label[4:], profile, fused, int8, enc, base=base)
        res = C.mesh_ingest_check("cpu", wave[: SR * 7], cfg, [cpu] * 2,
                                  mp=2, dtype=torch.float32)
        assert res["dp"] == 1 and res["mp"] == 2 and res["segments"] == 4
        assert res["dtype"] == "float32"
        assert not any(res["launches"].values())
        key = {"int8": "K9", "paired": "K10"}.get(enc, "K1")
        assert res["expected"][key] > 0
        if fused:
            assert res["expected"]["K3"] == res["expected"]["K4"] > 0
        assert res["top10_equal_unsplit"]
