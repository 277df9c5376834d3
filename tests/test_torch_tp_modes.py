"""The mesh's model axis under every decode option (ROADMAP A13c): the
port against the JAX package on the CPU, at (dp, mp) = (1, 2) and
(2, 2). JAX runs on its 8 virtual devices (tests/conftest.py), each
function on parameters placed by its TP rule over its mesh and inputs
split over "data", which GSPMD partitions; the port runs each data row's
chunk over that row's rank trees (parallel/mesh.py::shard_heads) on
virtual CPU entries, its kernels' plain twins standing in.

* K9p's and K10p's twins rank by rank against the JAX encoder kernel
  (qk_int8=True / pair_heads=True, interpret mode) under shard_map on
  the (4, 2) mesh at whisper-base geometry, each device its H/2 heads
  and the matching row shard of Wo, and the ranks' model_sum against the
  psum: 2e-4 (the K1p test's bar), plus, for int8, what the counted p8
  code flips can move (tests/test_torch_encoder_variants.py);
* encode_tp with fused_blocks "paired" within 5e-5 of JAX's encode on
  its mesh and of the port's one-device encode; "int8" at the encoder
  test's bar (a p8 code that flips at a .5 boundary moves its row by
  one code step: 1 % of the states beyond 5e-5, 1e-3 at most) from
  JAX's one-device encode and the port's (JAX's own mesh run, whose
  partitioned sums flip other codes, is 1.2e-3 from its one-device run
  here, 5.8 % of the states beyond 5e-5: it is held to no bar);
* decode_step_tp for "v2" (the True form over the axis) and an int8
  decoder with bf16 cross K/V: logits within 5e-5 of JAX's and greedy
  tokens identical; the int8 cross K/V (K6's merged format, K7's and
  int8_cross_kv) at JAX's guardrail (first-step logits within 5 % of
  their span, argmax agreement >= 0.9), against JAX, whose CPU twins do
  not round where the kernels do, and against the port's one-device
  decode at every step: the cross query is quantized per head, and the
  model_sum's other order of float32 sums moves it by ~1e-7, enough to
  flip a code at a .5 boundary (2.8e-4 on 6 % of the logits here);
  greedy tokens of both at the same agreement;
* sampled tokens identical to JAX's generate under its key chain
  replayed (tests/test_torch_sampling.py::JaxNoise), unfused and fused;
  beam tokens and lengths identical to JAX's beam_generate, scores 1e-4;
* the engine (make_default_ingest's pipelines at the test preset) under
  parity (sampled ASR, beam-2 captions), "v2", the int8 decoder with K6
  and with K7, and the int8 and paired encoders: segments, texts and
  top-10 identical to the port's one-device engine, and to the JAX
  engine at the same mesh where JAX computes the same function (its
  int8 cross K/V twins and its greedy "beam" excepted: there the same
  segments, and the ASR texts under the replayed noise);
* which kernels the axis runs: "v2" at mp = 2 takes K3p / K4p and never
  K3-q / K4-o; "paired" takes K10p where a rank holds an even head
  count and K1p at whisper-tiny's 3 heads a rank.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.models import beam as JB
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import minilm as JM
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.ops import encoder_block as JEB
from multimodal_audio_search_tpu.ops.quant import (
    quantize_whisper_decoder as jquantize)
from multimodal_audio_search_tpu.parallel import mesh as jmesh
from multimodal_audio_search_tpu.pipelines.embed import (
    TextEmbedder as JEmbedder)
from multimodal_audio_search_tpu.pipelines.ingest import (
    DualPipelineIngest as JIngest)
from multimodal_audio_search_tpu.pipelines.whisper_pipeline import (
    WhisperTextPipeline as JPipe)
from multimodal_audio_search_tpu_torch import AudioSearchEngine, weights
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch.models import beam as BM
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
from multimodal_audio_search_tpu_torch.parallel import mesh as TM
from multimodal_audio_search_tpu_torch.pipelines.embed import TextEmbedder
from multimodal_audio_search_tpu_torch.pipelines.ingest import (
    DualPipelineIngest)
from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
    WhisperTextPipeline)
from multimodal_audio_search_tpu_torch.service.stats import StatsRegistry
from test_torch_encoder_variants import _p8_flips
from test_torch_engine_mesh import QUERIES, _same_search, _same_segments
from test_torch_sampling import JaxNoise
from test_torch_slice import EMB, MEL_S, SR, _np, _pieces

torch.set_num_threads(1)
CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 2)]
TOL = 5e-5
B = 8          # decode rows: the fused gate's 8 (a data row's 4 at dp=2)
STEPS = 3
MAX_NEW = 6
# the JAX guardrail for the int8 cross K/V (tests/test_torch_int8_attention
# .py): first-step logits within this share of their span, argmax agreement
INT8_SPAN, INT8_AGREE = 0.05, 0.9


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------- K9p and K10p twins
@pytest.fixture(scope="module")
def block_case():
    """Whisper-base geometry (H=8, D=64, H*D=512) at T=96, B=4, and the
    JAX kernel under shard_map on the (4, 2) mesh in each body: each
    device's partial (x = 0, bo = 0 on its H/2 heads and Wo rows) and
    the psum of x/mp + partial + bo/mp."""
    from jax.sharding import Mesh
    rng = np.random.default_rng(20)
    b, h, t, d = 4, 8, 96, 64
    hd = h * d
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    x = rng.normal(size=(b, t, hd)).astype(np.float32)
    wo = (rng.normal(size=(hd, hd)) / math.sqrt(hd)).astype(np.float32)
    bo = rng.normal(size=(hd,)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    spec_h = P("data", "model")
    out = {"inputs": (q, k, v, x, wo, bo)}
    for body in ("int8", "paired"):
        kw = dict(qk_int8=body == "int8", pair_heads=body == "paired",
                  blk_q=32, interpret=True)

        def parts(q, k, v, wo, kw=kw):
            zero = jnp.zeros((q.shape[0], q.shape[2], wo.shape[1]), q.dtype)
            return JEB.fused_attention_o_residual(
                q, k, v, zero, wo, jnp.zeros(wo.shape[1], q.dtype),
                **kw)[None]

        def summed(q, k, v, x, wo, bo, kw=kw):
            return jax.lax.psum(JEB.fused_attention_o_residual(
                q, k, v, x / 2, wo, bo / 2, **kw), "model")
        jparts = jax.jit(jax.shard_map(
            parts, mesh=mesh,
            in_specs=(spec_h, spec_h, spec_h, P("model", None)),
            out_specs=P("model", "data"), check_vma=False))(q, k, v, wo)
        jsum = jax.jit(jax.shard_map(
            summed, mesh=mesh,
            in_specs=(spec_h, spec_h, spec_h, P("data", None),
                      P("model", None), P(None)),
            out_specs=P("data", None), check_vma=False))(q, k, v, x, wo, bo)
        out[body] = (np.asarray(jparts), np.asarray(jsum))
    return out


@pytest.mark.parametrize("body", ["int8", "paired"])
def test_partial_twins_match_jax_shard_map(block_case, body):
    """K9p's / K10p's twin on each rank's H/2 heads and Wo rows against
    the JAX kernel's partial on that device, the ranks' model_sum against
    the psum, and against the square twin on the whole layer."""
    q, k, v, x, wo, bo = block_case["inputs"]
    jparts, jsum = block_case[body]
    mp, hl, d = 2, 4, 64
    tq, tk, tv, tx, two, tbo = map(_t, (q, k, v, x, wo, bo))
    kw = dict(qk_int8=body == "int8", pair_heads=body == "paired")
    parts, slack = [], np.zeros_like(jsum)
    for j in range(mp):
        sl = slice(j * hl, (j + 1) * hl)
        wr = torch.chunk(two, mp, 0)[j].contiguous()
        part = EB.fused_attention_o_residual(tq[:, sl], tk[:, sl], tv[:, sl],
                                             None, wr, None, partial=True,
                                             **kw)
        assert part.dtype == torch.float32 and part.shape == tx.shape
        allow = np.zeros(part.shape, np.float32)
        if body == "int8":
            # a flipped p8 code moves its (row, head) by one code step,
            # carried through |Wo| (test_torch_encoder_variants.py)
            k8, ks, v8, vs = (a.numpy() for a in EB.quantize_kv(tk[:, sl],
                                                                tv[:, sl]))
            flips, ps = _p8_flips(q[:, sl], k8, ks, vs)
            assert flips.sum() <= flips.size // 100
            step = (flips * 127 * ps)[..., None] * np.ones(d)
            allow = np.einsum("bhtd,hdj->btj", step,
                              np.abs(wr.numpy()).reshape(hl, d, -1))
        assert np.all(np.abs(part.numpy() - jparts[j])
                      <= 2e-4 * (1 + np.abs(jparts[j])) + allow)
        slack += allow
        parts.append(part)
    out = TM.model_sum(parts, tbo, tx)
    assert np.all(np.abs(out[0].numpy() - jsum)
                  <= 2e-4 * (1 + np.abs(jsum)) + slack)
    whole = EB.fused_attention_o_residual(tq, tk, tv, tx, two, tbo, **kw)
    np.testing.assert_allclose(out[0].numpy(), whole.numpy(), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------------- the models
@pytest.fixture(scope="module")
def models():
    """The test preset's weights (3x the init scale on every matrix, so
    rows decode to distinct tokens), float and with the int8 decoder,
    for JAX and for the port (prepared for the CPU)."""
    cfg = JW.PRESETS["test"]
    jp = jax.tree.map(lambda a: a * 3.0 if a.ndim == 2 else a,
                      JW.init_params(jax.random.PRNGKey(3), cfg))
    out = {}
    for quant, tree in ((False, jp), (True, jquantize(jp))):
        tp = W.prepare_params(weights.whisper_params(_np(tree)),
                              torch.float32, CPU)
        out[quant] = (tree, tp)
    rng = np.random.default_rng(21)
    mel = rng.normal(size=(4, cfg.n_mels, 200)).astype(np.float32)
    enc = rng.normal(size=(B, 100, cfg.d_model)).astype(np.float32)
    return cfg, out, mel, enc


def _jax_mesh(dp: int):
    return jmesh.make_mesh(2 * dp, model_parallel=2)


def _jax_on(tree, x, mesh):
    """JAX's TP placement of ``tree`` and ``x`` split over "data"."""
    return (jmesh.shard_params(tree, mesh),
            jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))))


def _port_rows(tp, dp: int, heads: int) -> list:
    """The port's rank trees, a list a data row."""
    mesh = TM.make_mesh(2 * dp, model_parallel=2, device="cpu")
    return [list(row) for row in TM.shard_heads(tp, mesh, heads)]


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("fused_blocks", ["paired", "int8"])
def test_encode_tp_matches_jax(models, dp, mp, fused_blocks):
    cfg, trees, mel, _ = models
    jp, tp = trees[False]
    jparams, jmel = _jax_on(jp, mel, _jax_mesh(dp))
    ref = np.asarray(jax.jit(lambda p, m: JW.encode(
        p, m, cfg, fused_blocks=fused_blocks))(jparams, jmel))
    rows = _port_rows(tp, dp, cfg.heads)
    got = torch.cat([W.encode_tp(r, m, cfg, fused_blocks=fused_blocks)[0]
                     for r, m in zip(rows, torch.chunk(_t(mel), dp))])
    one = W.encode(tp, _t(mel), cfg, fused_blocks=fused_blocks)
    assert got.shape == ref.shape == (4, 100, cfg.d_model)
    if fused_blocks == "int8":
        jone = np.asarray(JW.encode(jp, jnp.asarray(mel), cfg,
                                    fused_blocks="int8"))
        for other in (jone, one.numpy()):
            err = np.abs(got.numpy() - other)
            assert err.max() < 1e-3 and (err > TOL).mean() < 0.01
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=TOL)


def _modes():
    """(label, int8 decoder, DecodeConfig changes)."""
    return [("v2", False, dict(fused_layer="v2")),
            ("quantize_decoder", True, {}),
            ("int8_fused", True, dict(cross_attn="int8_fused")),
            ("int8", True, dict(cross_attn="int8")),
            ("int8_cross_kv", False, dict(int8_cross_kv=True))]


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("label,quant,change", _modes(),
                         ids=[m[0] for m in _modes()])
def test_decode_tp_modes_match_jax(models, dp, mp, label, quant, change):
    """STEPS teacher-forced decode steps and a greedy generate over the
    axis, against JAX on its mesh and the port's one-device decode."""
    cfg, trees, _, enc = models
    jp, tp = trees[quant]
    dec_t = tcfg.DecodeConfig(max_new_tokens=MAX_NEW, **change)
    dec_j = jcfg.DecodeConfig(max_new_tokens=MAX_NEW, **change)
    int8_cross = dec_t.int8_cross_kv or dec_t.cross_attn.startswith("int8")
    mesh = _jax_mesh(dp)
    jparams, jenc = _jax_on(jp, enc, mesh)
    rows = _port_rows(tp, dp, cfg.heads)
    chunks = torch.chunk(_t(enc), dp)
    toks = np.random.default_rng(22).integers(0, cfg.vocab_size,
                                              size=(B, STEPS))
    # JAX: its decode step on the placed parameters
    jckv = JG._select_cross_kv(jparams, jenc, cfg, dec_j)
    jcache = JW.init_cache(cfg, B, STEPS + 1, jnp.float32)
    # the port: each data row's chunk over its ranks, and one device
    pieces = [(r, G._select_cross_kv(r, [c] * 2, cfg, dec_t, tp=True),
               W.init_cache_tp(r, cfg, c.shape[0], STEPS + 1, torch.float32))
              for r, c in zip(rows, chunks)]
    ckv = G._select_cross_kv(tp, _t(enc), cfg, dec_t)
    cache = W.init_cache(cfg, B, STEPS + 1, torch.float32, CPU)
    for pos in range(STEPS):
        jl, jcache = JW.decode_step(jparams, jnp.asarray(toks[:, pos]),
                                    jnp.int32(pos), jcache, jckv, cfg,
                                    fused_layer=dec_j.fused_layer)
        jl = np.asarray(jl)
        tok = _t(toks[:, pos])
        got = torch.cat([W.decode_step_tp(
            r, t, pos, caches, ckvs, cfg, fused_layer=dec_t.fused_layer)
            for (r, ckvs, caches), t in zip(pieces, torch.chunk(tok, dp))])
        one = W.decode_step(tp, tok, pos, cache, ckv, cfg,
                            fused_layer=dec_t.fused_layer).numpy()
        if not int8_cross:
            np.testing.assert_allclose(got.numpy(), one, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(got.numpy(), jl, atol=TOL, rtol=TOL)
            continue
        for ref in ((one, jl) if pos == 0 else (one,)):
            span = ref.max() - ref.min()
            assert np.abs(got.numpy() - ref).max() <= INT8_SPAN * span
            assert (got.numpy().argmax(-1) == ref.argmax(-1)).mean() >= \
                INT8_AGREE
    # greedy tokens over the axis
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg)), (B, 1))
    kw = dict(cfg=cfg, decode=dec_t, max_new_tokens=MAX_NEW)
    got = [G.generate_tp(r, [c] * 2, p, **kw) for r, c, p in zip(
        rows, chunks, torch.chunk(_t(prefix), dp))]
    got_tokens = torch.cat([o.tokens for o in got])
    one = G.generate(tp, _t(enc), _t(prefix), **kw)
    if int8_cross:
        assert (got_tokens == one.tokens).float().mean() >= INT8_AGREE
        return
    assert torch.equal(got_tokens, one.tokens)
    assert torch.equal(torch.cat([o.lengths for o in got]), one.lengths)
    ref = JG.generate(jparams, jenc, jnp.asarray(prefix), cfg=cfg,
                      decode=dec_j, prefix_len=prefix.shape[1],
                      max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(ref.tokens))


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("fused", [False, True])
def test_sampled_tokens_tp_identical_to_jax(models, monkeypatch, dp, mp,
                                            fused):
    """generate_tp with method="sample" (the noise drawn once a step on
    the first rank's device; at dp = 2 each data row takes its rows of
    the whole batch's noise) = JAX generate on its mesh under the same
    key chain."""
    cfg, trees, _, enc = models
    jp, tp = trees[False]
    kw = dict(max_new_tokens=MAX_NEW, method="sample", temperature=1.0,
              repetition_penalty=1.3, no_repeat_ngram_size=3,
              **({"fused_layer": True} if fused else {}))
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg)), (B, 1))
    jparams, jenc = _jax_on(jp, enc, _jax_mesh(dp))
    for seed in (0, 1):
        ref = JG.generate(jparams, jenc, jnp.asarray(prefix), cfg=cfg,
                          decode=jcfg.DecodeConfig(**kw),
                          prefix_len=prefix.shape[1],
                          max_new_tokens=MAX_NEW,
                          rng=jax.random.PRNGKey(seed))
        noise = JaxNoise()
        monkeypatch.setattr(G, "_gumbel", noise)
        outs, lo = [], 0
        for r, c, p in zip(_port_rows(tp, dp, cfg.heads),
                           torch.chunk(_t(enc), dp),
                           torch.chunk(_t(prefix), dp)):
            outs.append(G.generate_tp(
                r, [c] * 2, p, cfg=cfg, decode=tcfg.DecodeConfig(**kw),
                max_new_tokens=MAX_NEW,
                rng=torch.Generator().manual_seed(seed),
                noise_rows=(lo, B)))
            lo += c.shape[0]
        np.testing.assert_array_equal(
            torch.cat([o.tokens for o in outs]).numpy(),
            np.asarray(ref.tokens))
        np.testing.assert_array_equal(
            torch.cat([o.lengths for o in outs]).numpy(),
            np.asarray(ref.lengths))


@pytest.mark.parametrize("dp,mp", MESHES)
def test_beam_tp_tokens_identical_to_jax(models, dp, mp):
    """beam_generate_tp (B*k rows on every rank, each rank's cache
    reordered by the parents) = JAX beam_generate on its mesh: tokens
    and lengths identical, scores within 1e-4."""
    cfg, trees, _, enc = models
    jp, tp = trees[False]
    kw = dict(max_new_tokens=MAX_NEW, method="beam", num_beams=2,
              repetition_penalty=1.3, no_repeat_ngram_size=3,
              length_penalty=1.0)
    prefix = np.tile(np.asarray([cfg.bos_token_id]), (B, 1))
    jparams, jenc = _jax_on(jp, enc, _jax_mesh(dp))
    ref = JB.beam_generate(jparams, jenc, jnp.asarray(prefix), cfg=cfg,
                           decode=jcfg.DecodeConfig(**kw), prefix_len=1,
                           max_new_tokens=MAX_NEW, num_beams=2)
    outs = [BM.beam_generate_tp(r, [c] * 2, p, cfg=cfg,
                                decode=tcfg.DecodeConfig(**kw),
                                max_new_tokens=MAX_NEW, num_beams=2)
            for r, c, p in zip(_port_rows(tp, dp, cfg.heads),
                               torch.chunk(_t(enc), dp),
                               torch.chunk(_t(prefix), dp))]
    np.testing.assert_array_equal(
        torch.cat([o.tokens for o in outs]).numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(
        torch.cat([o.lengths for o in outs]).numpy(),
        np.asarray(ref.lengths))
    np.testing.assert_allclose(torch.cat([o.scores for o in outs]).numpy(),
                               np.asarray(ref.scores), atol=1e-4)


# ------------------------------------------------------- which kernels
def test_v2_over_the_axis_takes_the_true_form(models, monkeypatch):
    """decode_step_tp with fused_layer="v2" at mp = 2 (8 rows): K3p and
    K4p once a layer and rank (partial=True), K3-q and K4-o never."""
    cfg, trees, _, enc = models
    _, tp = trees[False]
    calls = []
    for name in ("fused_self_block", "fused_self_block_q", "fused_mlp_block",
                 "fused_mlp_block_o"):
        fn = getattr(DB, name)
        monkeypatch.setattr(DB, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("partial", False))), _f(*a, **k))[1])
    rows = _port_rows(tp, 1, cfg.heads)[0]
    ckvs = W.cross_kv_merged_tp(rows, [_t(enc)] * 2, cfg)
    caches = W.init_cache_tp(rows, cfg, B, 4, torch.float32)
    W.decode_step_tp(rows, torch.zeros(B, dtype=torch.long), 0, caches, ckvs,
                     cfg, fused_layer="v2")
    per = 2 * cfg.dec_layers
    assert calls.count(("fused_self_block", True)) == per
    assert calls.count(("fused_mlp_block", True)) == per
    assert len(calls) == 2 * per


@pytest.mark.parametrize("heads,pair", [(4, True), (6, False)])
def test_paired_encoder_rank_heads(monkeypatch, heads, pair):
    """encode_tp(fused_blocks="paired") at mp = 2: a rank of 2 heads
    pairs them (K10p), whisper-tiny's 3 heads a rank take K1p, as encode
    takes K1 for an odd head count; the output = the one-device encode
    (K10 on the whole layer's even heads) within 5e-5."""
    cfg = dataclasses.replace(W.PRESETS["test"], heads=heads,
                              d_model=16 * heads, ffn=32 * heads)
    params = W.prepare_params(
        W.init_params(torch.Generator().manual_seed(9), cfg), torch.float32,
        CPU)
    calls = []
    for name in ("attention_o_residual_plain",
                 "attention_o_residual_paired_plain"):
        fn = getattr(EB, name)
        monkeypatch.setattr(EB, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("partial", False))), _f(*a, **k))[1])
    mel = torch.randn(2, cfg.n_mels, 200, generator=torch.Generator()
                      .manual_seed(10))
    rows = _port_rows(params, 1, heads)[0]
    got = W.encode_tp(rows, mel, cfg, fused_blocks="paired")[0]
    want = ("attention_o_residual_paired_plain" if pair
            else "attention_o_residual_plain", True)
    assert calls == [want] * (2 * cfg.enc_layers)
    calls.clear()
    one = W.encode(params, mel, cfg, fused_blocks="paired")
    assert calls == [("attention_o_residual_paired_plain", False)] * \
        cfg.enc_layers
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=TOL)


# ------------------------------------------------------- the engine
ENGINE_MODES = {
    "parity": dict(asr=dict(method="sample", temperature=1.0,
                            repetition_penalty=1.05, no_repeat_ngram_size=2),
                   cap=dict(method="beam", num_beams=2,
                            repetition_penalty=1.3, no_repeat_ngram_size=3)),
    "v2": dict(both=dict(fused_layer="v2")),
    "int8_fused": dict(quant=True, both=dict(cross_attn="int8_fused")),
    "int8": dict(quant=True, both=dict(cross_attn="int8")),
    "enc_int8": dict(both=dict(fused_encoder="int8")),
    "enc_paired": dict(both=dict(fused_encoder="paired")),
}


@pytest.fixture(scope="module")
def engine_params():
    """The toy weights both packages' engines use (3x the init scale on
    every matrix, so segments decode to distinct texts)."""
    wcfg = JW.PRESETS["test"]
    asr_p, cap_p = (jax.tree.map(
        lambda a: a * 3.0 if a.ndim == 2 else a,
        JW.init_params(jax.random.PRNGKey(s), wcfg)) for s in (0, 1))
    emb_p = JM.init_params(jax.random.PRNGKey(2), JM.MiniLMConfig(**EMB))
    return asr_p, cap_p, emb_p


def _engine(mod, params, dp, mp, mode):
    """The JAX (``mod`` = jcfg) or the port's (tcfg) engine of ``mode``
    at (dp, mp), ingest_batch 4, on the toy weights."""
    spec = ENGINE_MODES[mode]
    asr_p, cap_p, emb_p = params
    if spec.get("quant"):
        asr_p, cap_p = map(jquantize, (asr_p, cap_p))
    cfg = mod.EngineConfig(ingest_batch=4, embed_dim=64, data_parallel=dp,
                           model_parallel=mp)
    decs = [dataclasses.replace(cfg.asr_decode, max_new_tokens=MAX_NEW,
                                **spec.get("both", {}), **spec.get(k, {}))
            for k in ("asr", "cap")]
    wcfg = JW.PRESETS["test"]
    mel = mod.MelConfig(padded_seconds=MEL_S)
    if mod is jcfg:
        pipes = [JPipe(params=p, cfg=wcfg, decode=d, mel_cfg=mel,
                       dtype=jnp.float32, name=n, prefix_ids=pre)
                 for p, d, n, pre in zip((asr_p, cap_p), decs,
                                         ("asr", "caption"),
                                         (None, [wcfg.bos_token_id]))]
        return JEngine(cfg=cfg, ingest_pipeline=JIngest(
            *pipes, JEmbedder(params=emb_p, cfg=JM.MiniLMConfig(**EMB)),
            cfg))
    pipes = [WhisperTextPipeline(
        params=weights.whisper_params(_np(p)), cfg=W.PRESETS["test"],
        decode=d, mel_cfg=mel, name=n, prefix_ids=pre, device="cpu")
        for p, d, n, pre in zip((asr_p, cap_p), decs, ("asr", "caption"),
                                (None, [wcfg.bos_token_id]))]
    emb = TextEmbedder(params=weights.minilm_params(_np(emb_p)),
                       cfg=M.MiniLMConfig(**EMB), device="cpu")
    return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
        *pipes, emb, cfg, StatsRegistry()))


@pytest.fixture(scope="module")
def wave():
    return _pieces(np.random.default_rng(3), 45)      # 5 windows


@pytest.fixture(scope="module")
def single_engines(engine_params, wave):
    """The port's one-device engine of each mode, ingested once (the
    replayed JAX key chain drawing the sampled ASR's noise)."""
    out = {}
    for mode in ENGINE_MODES:
        eng = _engine(tcfg, engine_params, 1, 1, mode)
        with pytest.MonkeyPatch.context() as mpatch:
            mpatch.setattr(G, "_gumbel", JaxNoise())
            out[mode] = (eng, eng.ingest_waveform(wave, SR, "clip"))
    return out


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_tp_modes(engine_params, wave, single_engines, monkeypatch,
                         dp, mp, mode):
    ref, ref_segs = single_engines[mode]
    monkeypatch.setattr(G, "_gumbel", JaxNoise())
    eng = _engine(tcfg, engine_params, dp, mp, mode)
    ing = eng.ingest_pipeline
    assert eng.mesh.shape == {"data": dp, "model": mp}
    assert ing.asr.model_parallel == ing.caption.model_parallel == mp
    segs = eng.ingest_waveform(wave, SR, "clip")
    _same_segments(segs, ref_segs)
    texts = [s["asr_text"] for s in segs if s["asr_text"]]
    assert len(set(texts)) > 1
    queries = [texts[0], texts[-1], *QUERIES]
    _same_search(eng, ref, queries)
    # the JAX engine at the same mesh
    jeng = _engine(jcfg, engine_params, dp, mp, mode)
    jsegs = jeng.ingest_waveform(wave, SR, "clip")
    if mode in ("v2", "enc_int8", "enc_paired"):
        _same_segments(segs, jsegs)
        _same_search(eng, jeng, queries)
        return
    # parity: JAX's engine decodes "beam" greedily (ROADMAP, faults in the
    # reference), so its captions differ; the sampled ASR is the same.
    # int8 cross K/V: JAX's CPU twins round elsewhere (module docstring)
    assert [s["start_time"] for s in segs] == \
        [s["start_time"] for s in jsegs]
    same = sum(s["asr_text"] == j["asr_text"] for s, j in zip(segs, jsegs))
    if mode == "parity":
        assert same == len(segs)
    else:
        assert same >= len(segs) // 2


# ------------------------------------------------------- chip_smoke's [tp]
def test_chip_smoke_tp_variant_checks_on_cpu(wave):
    """chip_smoke.py's new [tp] checks run whole on the CPU: K9p and K10p
    against their twins (with the repeats) and summed against the square
    forms, K5 / K6 / K7 at shard shapes, at a small size; then
    mesh_ingest_check at (1, 2) under every TP_PATHS entry the default
    config does not cover, on the test presets: the split ingest against
    the unsplit one (sampling and beam margins included), no launch on
    the CPU."""
    import chip_smoke as C
    C_time = C.time_ms
    int8k = [{"name": n, "cases": []} for n in (
        "quant_matmul", "single_query_attention_int8",
        "int8_cached_attention")]
    try:
        C.time_ms = lambda *a, **k: 0.0
        k9p, k10p = C.tp_variant_kernels(
            "cpu", torch.Generator().manual_seed(18), int8k, device="cpu",
            b=2, t=70)
    finally:
        C.time_ms = C_time
    # K9p at base and tiny widths, each with its sum; K10p at base only
    assert len(k9p["cases"]) == 4 and len(k10p["cases"]) == 2
    assert k9p["cases"][0]["repeats_equal"] == C.K9_REPEATS
    assert [len(k["cases"]) for k in int8k] == [len(C.TP_K5_SHAPES), 2, 2]
    base = tcfg.EngineConfig(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        embed_dim=64, ingest_batch=16, short_context=True,
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=0.5),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=6),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=6))
    for label, profile, fused, int8, enc, dps in C.TP_PATHS[2:]:
        assert dps == (1,)
        cfg = C.tp_config(label, profile, fused, int8, enc, base=base)
        res = C.mesh_ingest_check("cpu", wave[: SR * 7], cfg,
                                  [CPU] * 2, mp=2)
        assert res["dp"] == 1 and res["mp"] == 2 and res["segments"] == 4
        assert not any(res["launches"].values())
        # what the card must launch: every launch once a rank, the int8
        # decoder's logits once
        exp = res["expected"]
        if label == "v2":
            assert exp["K3"] == exp["K4"] > 0 == exp["K3-q"] == exp["K4-o"]
        if label.startswith("int8"):
            (sa, sc), layers = res["wall"]["steps"], 2
            da, dc = res["dispatches"]["asr"], res["dispatches"]["caption"]
            assert exp["K6" if label == "int8_fused" else "K7"] == \
                2 * layers * (sa + sc) > 0
            # 8 dense layers a decoder layer and step and the 2 cross
            # K/V projections a dispatch on each rank, the logits once
            assert exp["K5"] == 2 * (8 * layers * (sa + sc)
                                     + 2 * layers * (da + dc)) + sa + sc
        if label == "parity":
            assert res["decode"]["asr"]["method"] == "sample"
            assert res["decode"]["caption"]["method"] == "beam"
        assert res["top10_equal_unsplit"]
