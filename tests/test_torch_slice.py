"""The ingest -> search slice of the PyTorch package against the JAX
package, end to end on the CPU at toy widths and the same weights.

* greedy ``generate``: identical tokens, with and without the HF logits
  processors;
* the engine: the same waveform through a JAX AudioSearchEngine and a
  PyTorch one gives the same segments, texts and top-10 ids (float32;
  embeddings and scores within 2e-5);
* the on-disk index: a store saved by either package loads in the other;
* the port imports and runs with jax absent.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.index.store import SegmentStore as JStore
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import minilm as JM
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.pipelines.embed import (
    TextEmbedder as JEmbedder)
from multimodal_audio_search_tpu.pipelines.ingest import (
    DualPipelineIngest as JIngest)
from multimodal_audio_search_tpu.pipelines.whisper_pipeline import (
    WhisperTextPipeline as JPipe)
from multimodal_audio_search_tpu_torch import AudioSearchEngine, weights
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch.audio.decode import load_audio
from multimodal_audio_search_tpu_torch.audio.wav import write_wav
from multimodal_audio_search_tpu_torch.index.store import SegmentStore
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.pipelines.embed import TextEmbedder
from multimodal_audio_search_tpu_torch.pipelines.ingest import (
    DualPipelineIngest, make_default_ingest)
from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
    WhisperTextPipeline)
from multimodal_audio_search_tpu_torch.service.stats import StatsRegistry

torch.set_num_threads(1)
CPU = torch.device("cpu")
SR = 16000


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------- generate
@pytest.mark.parametrize("penalty,ngram", [(1.0, 0), (1.3, 2)])
def test_generate_tokens_identical(rng, penalty, ngram):
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(7), cfg)
    tp = W.prepare_params(weights.whisper_params(_np(jp)), torch.float32,
                          CPU)
    enc = rng.normal(size=(3, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (3, 1))
    jdec = jcfg.DecodeConfig(max_new_tokens=10, repetition_penalty=penalty,
                             no_repeat_ngram_size=ngram)
    tdec = tcfg.DecodeConfig(max_new_tokens=10, repetition_penalty=penalty,
                             no_repeat_ngram_size=ngram)
    ref = JG.generate(jp, jnp.asarray(enc), jnp.asarray(prefix), cfg=cfg,
                      decode=jdec, prefix_len=4, max_new_tokens=10)
    out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=W.PRESETS["test"], decode=tdec, max_new_tokens=10)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert 1 <= out.steps <= 4 + 10 - 1


@pytest.mark.parametrize("fused", [True, "v2"])
@pytest.mark.parametrize("penalty,ngram", [(1.0, 0), (1.3, 2)])
def test_generate_fused_layer_tokens_identical(rng, fused, penalty, ngram):
    """B=8, so the fused sub-blocks run (the plain versions of K3/K4 on
    the CPU; the Pallas kernels in interpret mode in JAX, whose "v2" runs
    its True branch -- ROADMAP, faults in the reference)."""
    cfg = JW.PRESETS["test"]
    jp = JW.init_params(jax.random.PRNGKey(8), cfg)
    tp = W.prepare_params(weights.whisper_params(_np(jp)), torch.float32,
                          CPU)
    enc = rng.normal(size=(8, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (8, 1))
    kw = dict(max_new_tokens=8, repetition_penalty=penalty,
              no_repeat_ngram_size=ngram, fused_layer=fused)
    ref = JG.generate(jp, jnp.asarray(enc), jnp.asarray(prefix), cfg=cfg,
                      decode=jcfg.DecodeConfig(**kw), prefix_len=4,
                      max_new_tokens=8)
    out = G.generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                     cfg=W.PRESETS["test"], decode=tcfg.DecodeConfig(**kw),
                     max_new_tokens=8)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))


@pytest.mark.parametrize("fused,b", [(False, 5), (True, 8), ("v2", 8)])
@pytest.mark.parametrize("penalty,ngram", [(1.0, 0), (1.3, 2)])
def test_generate_early_eos_tokens_identical(fused, b, penalty, ngram):
    """Rows that end early: the test preset's EOS embedding row scaled by
    1, 3, 6 and 10 (the logits are tied, so EOS wins more often) over two
    seeds, unfused at B=5 and with fused_layer True and "v2" at B=8. The
    tokens (the pad after each row's EOS included) and the lengths equal
    JAX's in every decode; across the decodes some rows stop early and
    some batches mix lengths (2, 4 and 10 tokens here)."""
    cfg = JW.PRESETS["test"]
    kw = dict(max_new_tokens=10, repetition_penalty=penalty,
              no_repeat_ngram_size=ngram,
              **({"fused_layer": fused} if fused else {}))
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (b, 1))
    lengths = []
    for seed in (0, 1):
        base = _np(JW.init_params(jax.random.PRNGKey(seed), cfg))
        enc = np.random.default_rng(seed).normal(
            size=(b, 100, cfg.d_model)).astype(np.float32)
        for scale in (1, 3, 6, 10):
            emb = np.array(base["decoder"]["embed_tokens"])
            emb[cfg.eos_token_id] *= scale
            jp = dict(base, decoder=dict(base["decoder"], embed_tokens=emb))
            tp = W.prepare_params(weights.whisper_params(jp), torch.float32,
                                  CPU)
            ref = JG.generate(jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(enc), jnp.asarray(prefix), cfg=cfg,
                              decode=jcfg.DecodeConfig(**kw), prefix_len=4,
                              max_new_tokens=10)
            out = G.generate(tp, torch.from_numpy(enc),
                             torch.from_numpy(prefix), cfg=W.PRESETS["test"],
                             decode=tcfg.DecodeConfig(**kw),
                             max_new_tokens=10)
            np.testing.assert_array_equal(out.tokens.numpy(),
                                          np.asarray(ref.tokens))
            np.testing.assert_array_equal(out.lengths.numpy(),
                                          np.asarray(ref.lengths))
            lengths.append(out.lengths.tolist())
    assert any(min(row) < 10 for row in lengths)
    assert any(len(set(row)) > 1 for row in lengths)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_logits_processors_match(rng, n):
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    tokens = rng.integers(0, 50, size=(4, 12)).astype(np.int32)
    cur = np.array([0, 3, 7, 12], np.int32)
    ref = JG.ban_repeated_ngrams(jnp.asarray(logits), jnp.asarray(tokens),
                                 jnp.asarray(cur), n)
    got = G.ban_repeated_ngrams(torch.from_numpy(logits),
                                torch.from_numpy(tokens).long(),
                                torch.from_numpy(cur).long(), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    valid = np.arange(12)[None, :] < cur[:, None]
    ref = JG.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(valid), 1.2)
    got = G.apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(tokens).long(),
        torch.from_numpy(valid), 1.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


# --------------------------------------------------------------- engine
MEL_S = 2.0           # the "test" preset's 100 encoder positions
EMB = dict(vocab_size=2048, hidden=64, layers=1, heads=2, intermediate=128)


def _make_engines(profile=None, quantize=False, cross_attn="auto",
                  fused_encoder=None, transfer=None):
    """A JAX and a PyTorch engine on the same toy weights; ``profile``
    ("fast_lossless", "fast") is applied to both configs, and its decode
    options reach both pipelines. ``quantize`` gives both Whisper models
    the JAX package's int8 decoder (the port takes the JAX tree through
    weights.py); ``cross_attn`` and ``fused_encoder`` go to both decode
    configs, ``transfer`` (not None) replaces both transfer_dtypes."""
    from multimodal_audio_search_tpu.ops.quant import (
        quantize_whisper_decoder)
    wcfg = JW.PRESETS["test"]
    mcfg_j = JM.MiniLMConfig(**EMB)
    # 3x the init scale on every matrix: at the stock 0.02 the toy
    # decoders ignore their input and every segment gets one text
    asr_p, cap_p = (jax.tree.map(
        lambda a: a * 3.0 if a.ndim == 2 else a,
        JW.init_params(jax.random.PRNGKey(s), wcfg)) for s in (0, 1))
    if quantize:
        asr_p, cap_p = map(quantize_whisper_decoder, (asr_p, cap_p))
    emb_p = JM.init_params(jax.random.PRNGKey(2), mcfg_j)

    def config(mod):
        cfg = mod.EngineConfig(ingest_batch=4, embed_dim=64)
        if profile:
            cfg = mod.apply_profile(cfg, profile)
        if transfer:
            cfg = cfg.replace(transfer_dtype=transfer)
        dec = dataclasses.replace(cfg.asr_decode, max_new_tokens=6,
                                  cross_attn=cross_attn,
                                  fused_encoder=fused_encoder)
        return cfg, dec

    cfg_j, dec_j = config(jcfg)
    mel_j = jcfg.MelConfig(padded_seconds=MEL_S)
    jasr = JPipe(params=asr_p, cfg=wcfg, decode=dec_j, mel_cfg=mel_j,
                 dtype=jnp.float32, name="asr")
    jcap = JPipe(params=cap_p, cfg=wcfg, decode=dec_j, mel_cfg=mel_j,
                 dtype=jnp.float32, name="caption",
                 prefix_ids=[wcfg.bos_token_id])
    jemb = JEmbedder(params=emb_p, cfg=mcfg_j)
    jeng = JEngine(cfg=cfg_j, ingest_pipeline=JIngest(
        jasr, jcap, jemb, cfg_j))

    twcfg = W.PRESETS["test"]
    cfg_t, dec_t = config(tcfg)
    mel_t = tcfg.MelConfig(padded_seconds=MEL_S)
    tasr = WhisperTextPipeline(
        params=weights.whisper_params(_np(asr_p)), cfg=twcfg, decode=dec_t,
        mel_cfg=mel_t, name="asr", device="cpu")
    tcap = WhisperTextPipeline(
        params=weights.whisper_params(_np(cap_p)), cfg=twcfg, decode=dec_t,
        mel_cfg=mel_t, name="caption", prefix_ids=[twcfg.bos_token_id],
        device="cpu")
    temb = TextEmbedder(params=weights.minilm_params(_np(emb_p)),
                        cfg=M.MiniLMConfig(**EMB), device="cpu")
    teng = AudioSearchEngine(cfg=cfg_t, ingest_pipeline=DualPipelineIngest(
        tasr, tcap, temb, cfg_t, StatsRegistry()))
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _make_engines()


def _pieces(rng, seconds):
    """Distinct 10 s pieces (pitch and noise level vary), so segments
    decode to different texts."""
    t = np.arange(10 * SR) / SR
    return np.concatenate([
        0.3 * np.sin(2 * np.pi * 110 * 2 ** (i / 4) * t) * (1 + i % 3) / 3
        + rng.normal(size=t.size) * 0.02 * (1 + i % 5)
        for i in range(-(-seconds // 10))])[: seconds * SR] \
        .astype(np.float32)


def _check_engine_parity(jeng, teng, rng, tmp_path):
    wave = _pieces(rng, 65)            # 7 windows -> 2 batches of <= 4
    p = str(tmp_path / "clip.wav")
    write_wav(p, wave, SR)
    jsegs = jeng.ingest(p, source_name="clip.wav")
    tsegs = teng.ingest(p, source_name="clip.wav")
    assert len(tsegs) == len(jsegs) > 0
    for t, j in zip(tsegs, jsegs):
        for key in ("segment_id", "start_time", "end_time", "asr_text",
                    "audio_description", "asr_success", "audio_success"):
            assert t[key] == j[key], key
        for key in ("asr_embedding", "audio_embedding"):
            if j[key] is None:
                assert t[key] is None
            else:
                np.testing.assert_allclose(t[key], j[key], atol=2e-5)
        np.testing.assert_array_equal(t["audio_data"], j["audio_data"])
    texts = [s["asr_text"] for s in tsegs if s["asr_text"]]
    assert len(set(texts)) > 1        # the queries below are not all ties
    for q in [texts[0], texts[-1], "upbeat music with drums",
              "someone speaking clearly"]:
        th, tinfo = teng.search(q)
        jh, jinfo = jeng.search(q)
        assert [h["index"] for h in th] == [h["index"] for h in jh], q
        assert tinfo["asr_weight"] == jinfo["asr_weight"]
        for a, b in zip(th, jh):
            assert a["fusion_score"] == pytest.approx(b["fusion_score"],
                                                      abs=2e-5)
    own = next(i for i, s in enumerate(tsegs)
               if s["asr_text"] and texts.count(s["asr_text"]) == 1)
    assert teng.search(tsegs[own]["asr_text"])[0][0]["index"] == own
    # the kernels stay plain on CPU tensors: the wrappers counted no launch
    from multimodal_audio_search_tpu_torch import runtime
    assert runtime.COUNTS == dict.fromkeys(
        ("encoder_attn_o_residual", "single_query_attention",
         "decoder_self_block", "decoder_self_block_q", "decoder_mlp_block",
         "decoder_mlp_block_o", "quant_matmul",
         "single_query_attention_int8", "int8_cached_attention",
         "encoder_attention", "encoder_attn_o_residual_int8",
         "encoder_attn_o_residual_paired", "encoder_attn_o_residual_ab",
         "fused_scores", "stream_read", "cross_mlp_block"), 0)
    stats = json.loads(teng.export_stats_json())
    assert stats["database"]["total_segments"] == len(tsegs)


def test_engine_parity(engines, rng, tmp_path):
    _check_engine_parity(*engines, rng, tmp_path)


def test_engine_parity_fast_lossless(rng, tmp_path, monkeypatch):
    """Both engines under apply_profile(..., "fast_lossless"): the fused
    encoder and decode sub-blocks (K1, K3, K4 as plain versions here; the
    Pallas kernels in interpret mode in JAX) and the "auto" transfer
    probe. Same segments, texts, embeddings and top-10."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    calls = []
    fn = DB.fused_self_block
    monkeypatch.setattr(DB, "fused_self_block",
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    jeng, teng = _make_engines("fast_lossless")
    _check_engine_parity(jeng, teng, rng, tmp_path)
    ing = teng.ingest_pipeline
    assert ing.asr.decode.fused_layer is True and calls
    assert ing.last_transfer_resolved in ing.AUTO_TRANSFER_CANDIDATES
    assert set(ing.last_probe) == {"int16", "int16d"}
    assert jeng.ingest_pipeline.last_transfer_resolved in ("int16", "int16d")



def test_engine_parity_quantize_decoder(rng, tmp_path):
    """Both engines on the JAX package's int8 decoders (every dense layer
    and the logits through quant_matmul: K5's plain version here, the
    JAX dequantizing path there) with bf16-style cross K/V: the same
    segments, texts, embeddings and top-10."""
    jeng, teng = _make_engines(quantize=True)
    assert teng.ingest_pipeline.asr.quantized
    assert "embed_tokens_q" in teng.ingest_pipeline.caption.params["decoder"]
    _check_engine_parity(jeng, teng, rng, tmp_path)


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_engine_int8_cross_attn(rng, tmp_path, mode):
    """Both engines on int8 decoders with int8 cross K/V. The JAX engine
    runs its dequantizing CPU twins, the port the kernels' arithmetic
    (q and the probabilities quantized, or rounded to bf16), so texts may
    differ where tokens are near ties (the step-level guardrail is
    tests/test_torch_int8_attention.py's); the segments are the same,
    and each engine finds a segment by its own ASR text first."""
    jeng, teng = _make_engines(quantize=True, cross_attn=mode)
    wave = _pieces(rng, 65)
    p = str(tmp_path / "clip.wav")
    write_wav(p, wave, SR)
    jsegs = jeng.ingest(p, source_name="clip.wav")
    tsegs = teng.ingest(p, source_name="clip.wav")
    assert [s["start_time"] for s in tsegs] == \
        [s["start_time"] for s in jsegs]
    texts = [s["asr_text"] for s in tsegs]
    same = sum(a == s["asr_text"] for a, s in zip(texts, jsegs))
    assert same >= len(texts) // 2, (texts, [s["asr_text"] for s in jsegs])
    own = next(i for i, tx in enumerate(texts) if tx and texts.count(tx) == 1)
    assert teng.search(texts[own])[0][0]["index"] == own


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_int8_engine_launches_what_chip_smoke_expects(monkeypatch, rng,
                                                      mode):
    """The launch counts chip_smoke.py asserts on the card, counted here
    as calls of each kernel's entry point by a config-built engine with
    the int8 memory mode (two batches, so a padded one too)."""
    import chip_smoke
    from multimodal_audio_search_tpu_torch.models import whisper as TW
    from multimodal_audio_search_tpu_torch.ops import (
        cached_attention, cross_attention, encoder_block, quant)
    calls = dict.fromkeys(chip_smoke.KEYS, 0)
    for key, mod, name in (
            ("K1", encoder_block, "fused_attention_o_residual"),
            ("K2", cross_attention, "fused_single_query_attention"),
            ("K5", quant, "quant_dense_apply"),
            ("K6", cross_attention, "fused_single_query_attention_int8"),
            ("K7", cached_attention, "int8_cached_attention")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **k))[1])
    spec = tcfg.ModelSpec(family="whisper", preset="test",
                          quantize_decoder=True)
    base = tcfg.EngineConfig(ingest_batch=4, embed_dim=64,
                             short_context=True).replace(
        asr_model=spec, caption_model=spec,
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=1.0),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=3, cross_attn=mode),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=3, cross_attn=mode))
    eng = AudioSearchEngine(cfg=base, device="cpu")
    ing = eng.ingest_pipeline
    asr, cap = ing.asr, ing.caption
    assert asr.quantized and cap.quantized
    assert isinstance(asr.params["decoder"]["embed_tokens_q"]["wq"],
                      torch.Tensor)
    eng.ingest_waveform(_pieces(rng, 11), SR, "x")
    steps = (asr.total_steps, cap.total_steps)
    disp = (asr.dispatches, cap.dispatches)
    assert disp == (2, 2) and TW.PRESETS["test"].dec_layers == 2
    assert calls == chip_smoke.expected_launches(False, mode, steps, disp,
                                                 asr, cap)


@pytest.mark.parametrize("fused_encoder", [False, "paired", "int8"])
def test_engine_parity_fused_encoder(rng, tmp_path, fused_encoder):
    """Both engines with fused_encoder False (the plain mha encoder on the
    CPU in both; K8 on the card at T >= 512), "paired" (K10's plain
    version here, the Pallas kernel in interpret mode there) and "int8"
    (K9's). Same segments, texts, embeddings and top-10: at these toy
    widths no p8 code flip of the int8 encoder changes a token (the
    module test counts the flips, tests/test_torch_encoder_variants.py)."""
    jeng, teng = _make_engines(fused_encoder=fused_encoder)
    for pipe in (teng.ingest_pipeline.asr, teng.ingest_pipeline.caption):
        # the string is kept, not turned into True
        assert repr(pipe.fused_encoder_resolved) == repr(fused_encoder)
    _check_engine_parity(jeng, teng, rng, tmp_path)


@pytest.mark.parametrize("enc", [False, "int8", "paired"])
def test_encoder_variant_launches_what_chip_smoke_expects(monkeypatch, rng,
                                                          enc):
    """The launch counts chip_smoke.py asserts on the card for its
    enc_attn / enc_int8 / enc_paired engines, counted here as calls of
    each kernel's plain version by a config-built engine (two batches, so
    a padded one too). The toy context is T=50, below K8's T >= 512, so
    the dispatch rule is made true here as the card's T=1500 makes it."""
    import chip_smoke
    from multimodal_audio_search_tpu_torch.models import whisper as TW
    from multimodal_audio_search_tpu_torch.ops import (
        attention, cross_attention, encoder_block)
    calls = dict.fromkeys(chip_smoke.KEYS, 0)
    for key, mod, name in (
            ("K1", encoder_block, "attention_o_residual_plain"),
            ("K2", cross_attention, "fused_single_query_attention"),
            ("K8", attention, "encoder_attention_plain"),
            ("K9", encoder_block, "attention_o_residual_int8_plain"),
            ("K10", encoder_block, "attention_o_residual_paired_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **k))[1])
    monkeypatch.setattr(TW, "use_fused_attention", lambda t, dev: True)
    spec = tcfg.ModelSpec(family="whisper", preset="test")
    dec = tcfg.DecodeConfig(max_new_tokens=3, fused_encoder=enc)
    base = tcfg.EngineConfig(ingest_batch=4, embed_dim=64,
                             short_context=True).replace(
        asr_model=spec, caption_model=spec,
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=1.0),
        asr_decode=dec, caption_decode=dec)
    eng = AudioSearchEngine(cfg=base, device="cpu")
    ing = eng.ingest_pipeline
    asr, cap = ing.asr, ing.caption
    eng.ingest_waveform(_pieces(rng, 11), SR, "x")
    steps = (asr.total_steps, cap.total_steps)
    disp = (asr.dispatches, cap.dispatches)
    assert disp == (2, 2) and TW.PRESETS["test"].enc_layers == 2
    exp = chip_smoke.expected_launches(False, None, steps, disp, asr, cap,
                                       enc)
    assert calls == exp and exp["K1"] == 0
    assert exp[chip_smoke.encoder_kernel(enc, 4)] == 8


@pytest.mark.parametrize("via", ["apply_profile", "MAS_PROFILE"])
def test_fast_lossless_engine_from_config_alone(monkeypatch, rng, via):
    """AudioSearchEngine(cfg=...) under the profile builds the fused
    pipelines with no further argument, and ingests through them."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    base = tcfg.EngineConfig(ingest_batch=4, embed_dim=64,
                             short_context=True).replace(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=1.0),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=4),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=4))
    if via == "MAS_PROFILE":
        monkeypatch.setenv("MAS_PROFILE", "fast_lossless")
        cfg = tcfg.config_from_env(base)
    else:
        cfg = tcfg.apply_profile(base, "fast_lossless")
    calls = []
    for name in ("fused_self_block", "fused_mlp_block"):
        fn = getattr(DB, name)
        monkeypatch.setattr(DB, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    eng = AudioSearchEngine(cfg=cfg, device="cpu")
    ing = eng.ingest_pipeline
    for p in (ing.asr, ing.caption):
        assert p.decode.fused_layer is True and p.fused_encoder_resolved
    segs = eng.ingest_waveform(_pieces(rng, 5), SR, "x")
    assert ing.last_transfer_resolved in ("int16", "int16d")
    assert {"fused_self_block", "fused_mlp_block"} <= set(calls)
    assert len(segs) >= 1


def _captured_codes(monkeypatch, run, module, attr):
    """Arrays handed to ``module.attr`` while ``run()`` runs."""
    seen, fn = [], getattr(module, attr)

    def spy(x, *a, **k):
        seen.append(np.array(x))
        return fn(x, *a, **k)
    with monkeypatch.context() as m:
        m.setattr(module, attr, spy)
        run()
    return seen


@pytest.mark.parametrize("kind", ["noise", "full_scale_square", "nan_peaks"])
def test_int16d_codes_bit_identical(engines, monkeypatch, kind):
    """int16d on the host gives the JAX package's codes bit for bit, and
    the device-side cumsum gives back the int16 codes, including the
    wraparound of a full-scale square wave (peak 0.95, the loudest the
    peak normalization leaves alone: differences of 62256) and of codes
    at +-32767 (differences of 65534)."""
    from multimodal_audio_search_tpu_torch.pipelines import ingest as TI
    jeng, teng = engines
    r = np.random.default_rng(3)
    wave = (r.normal(size=SR * 5) * 0.3).astype(np.float32)
    if kind == "full_scale_square":
        wave = np.where(np.arange(wave.size) % 2, 0.95, -0.95).astype(
            np.float32)
    elif kind == "nan_peaks":
        wave[::997] = np.nan
        wave[1::991] = 4.0
    codes = {}
    for mode in ("int16", "int16d"):
        cfg_j = jcfg.EngineConfig(ingest_batch=4, embed_dim=64,
                                  transfer_dtype=mode)
        ji = jeng.ingest_pipeline
        jing = JIngest(ji.asr, ji.caption, ji.embedder, cfg_j)
        codes["jax", mode] = _captured_codes(
            monkeypatch, lambda: jing.process_waveform(wave, SR), jax,
            "device_put")
        ti = teng.ingest_pipeline
        ting = DualPipelineIngest(ti.asr, ti.caption, ti.embedder,
                                  tcfg.EngineConfig(ingest_batch=4,
                                                    embed_dim=64,
                                                    transfer_dtype=mode))
        codes["port", mode] = _captured_codes(
            monkeypatch, lambda: ting.process_waveform(wave, SR), ting,
            "_device_mel")
    assert len(codes["port", "int16d"]) == len(codes["jax", "int16d"]) >= 1
    for mode in ("int16", "int16d"):
        for got, ref in zip(codes["port", mode], codes["jax", mode]):
            assert got.dtype == ref.dtype == np.int16
            np.testing.assert_array_equal(got, ref)
    for d, q in zip(codes["port", "int16d"], codes["port", "int16"]):
        back = TI.delta_decode_int16(torch.from_numpy(d))
        np.testing.assert_array_equal(back.numpy(), q.astype(np.int64))
    if kind == "full_scale_square":
        q = codes["port", "int16"][0].astype(np.int32)
        assert np.abs(np.diff(q, axis=1)).max() > 32767        # wrapped
        q = np.array([[32767, -32767, 32767, 0, -32767, -32767]], np.int16)
        d = q.copy()
        TI.delta_encode_int16(d)
        assert d[0, 1] == 2 and d[0, 2] == -2
        np.testing.assert_array_equal(
            TI.delta_decode_int16(torch.from_numpy(d)).numpy(), q)


def test_auto_transfer_probes_then_reprobes(engines, monkeypatch, rng):
    """The "auto" probe times both candidates and records its choice;
    the choice holds until AUTO_REPROBE_MB more were shipped; then the
    next ingest probes again."""
    _, teng = engines
    ti = teng.ingest_pipeline
    stats = StatsRegistry()
    ing = DualPipelineIngest(
        ti.asr, ti.caption, ti.embedder,
        tcfg.EngineConfig(ingest_batch=4, embed_dim=64,
                          transfer_dtype="auto"), stats)
    wave = _pieces(rng, 25)
    ing.process_waveform(wave, SR)
    first = ing.last_probe
    assert set(first) == {"int16", "int16d"} and min(first.values()) >= 0
    # the faster (the recorded times are rounded to 0.1 ms)
    assert first[ing.last_transfer_resolved] == min(first.values())
    assert ing.last_trace["probe"] > 0
    ing.process_waveform(wave, SR)        # 2 batches of 4 x 10 s int16
    assert ing.last_probe is first        # < 256 MB shipped: no probe
    monkeypatch.setattr(DualPipelineIngest, "AUTO_REPROBE_MB", 0.1)
    ing.process_waveform(wave, SR)
    assert ing.last_probe is not first
    log = [e for e in stats.log.events
           if e.operation == "transfer_auto_choice"]
    assert len(log) == 2 and log[-1].details["mode"] in first


@pytest.mark.parametrize("mode", ["int16d", "auto"])
def test_lossless_transfers_give_the_int16_texts(engines, rng, mode):
    """int16d and auto are lossless: the same segments and texts as the
    default int16 transfer."""
    _, teng = engines
    ti = teng.ingest_pipeline
    wave = _pieces(rng, 35)

    def texts(m):
        ing = DualPipelineIngest(ti.asr, ti.caption, ti.embedder,
                                 tcfg.EngineConfig(ingest_batch=4,
                                                   embed_dim=64,
                                                   transfer_dtype=m))
        return [(s["start_time"], s["asr_text"], s["audio_description"])
                for s in ing.process_waveform(wave, SR)]
    assert texts(mode) == texts("int16")

# ---------------------------------------------------------------- store
def _fill(store, rng, n=5, d=16):
    for i in range(n):
        store.add({"source": "s", "asr_text": f"t{i}", "start_time": i},
                  rng.normal(size=d) if i % 2 == 0 else None,
                  rng.normal(size=d),
                  rng.normal(size=100 + i).astype(np.float32))


@pytest.mark.parametrize("mmap", [False, True])
def test_store_saved_by_port_loads_in_jax(rng, tmp_path, mmap):
    st = SegmentStore(embed_dim=16)
    _fill(st, rng)
    st.save(tmp_path, mmap=mmap)
    back = JStore.load(tmp_path)
    assert back.meta == st.meta
    np.testing.assert_array_equal(back.embeddings, st.embeddings)
    np.testing.assert_array_equal(back.success, st.success)
    np.testing.assert_array_equal(back.audio(3), st.audio(3))


@pytest.mark.parametrize("mmap", [False, True])
def test_store_saved_by_jax_loads_in_port(rng, tmp_path, mmap):
    st = JStore(embed_dim=16)
    _fill(st, rng)
    st.save(tmp_path, mmap=mmap)
    back = SegmentStore.load(tmp_path)
    assert back.meta == st.meta
    np.testing.assert_array_equal(back.embeddings, st.embeddings)
    np.testing.assert_array_equal(back.success, st.success)
    emb, ok = back.device_index(CPU)
    assert tuple(emb.shape) == (1024, 2, 16) and int(ok.sum()) == \
        int(st.success.sum())


def test_store_sharded_layout_loads_in_port(rng, tmp_path):
    st = JStore(embed_dim=16)
    _fill(st, rng, n=3)
    st.save_incremental(tmp_path)
    _fill(st, rng, n=2)
    st.save_incremental(tmp_path)
    back = SegmentStore.load(tmp_path)
    assert back.meta == st.meta
    np.testing.assert_array_equal(back.embeddings, st.embeddings)


# --------------------------------------------------------- host + policy
def test_wav_decode_and_resample(rng, tmp_path):
    x = (rng.normal(size=8000) * 0.2).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), x, 8000)
    y, sr = load_audio(str(tmp_path / "a.wav"), 16000)
    assert sr == 16000 and y.shape == (16000,) and y.dtype == np.float32
    with pytest.raises(ValueError, match="FLAC decode failed"):
        load_audio(b"fLaC" + bytes(64))
    with pytest.raises(ValueError):
        load_audio(b"not audio at all")


def test_device_policy():
    from multimodal_audio_search_tpu_torch import runtime
    if torch.cuda.is_available():
        assert runtime.select_device("cuda").type == "cuda"
        assert runtime.default_dtype(torch.device("cuda")) == torch.bfloat16
    else:
        with pytest.raises(RuntimeError):
            runtime.select_device("cuda")
    assert runtime.default_dtype(CPU) == torch.float32


@pytest.mark.parametrize("change", [
    dict(asr_model=tcfg.ModelSpec(family="whisper", preset="test",
                                  quantize_decoder=True),
         asr_decode=tcfg.DecodeConfig(fused_layer=True)),
    dict(caption_decode=tcfg.DecodeConfig(fused_encoder="int4")),
    dict(caption_decode=tcfg.DecodeConfig(scan_layers=True)),
    # the mesh's model axis runs these since ROADMAP A13c: each builds at
    # model_parallel=2 and ingests as the one-device engine does
    dict(model_parallel=2, asr_decode=tcfg.DecodeConfig(fused_layer="v2")),
    dict(model_parallel=2,
         asr_model=tcfg.ModelSpec(family="whisper", preset="test",
                                  quantize_decoder=True)),
    dict(model_parallel=2,
         caption_decode=tcfg.DecodeConfig(fused_encoder="int8")),
    dict(model_parallel=2, asr_decode=tcfg.DecodeConfig(method="sample")),
    # training over the model axis runs since ROADMAP A14b: each entry
    # trains at model_parallel=2 as at model_parallel=1
    dict(model_parallel=2, training="finetune_captioner"),
    dict(model_parallel=2, training="train_clap"),
])
def test_unported_modes_raise(change, tmp_path):
    if "training" in change:
        _trains_over_the_model_axis(change["training"], tmp_path)
        return
    cfg = tcfg.EngineConfig().replace(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"))
    cfg = cfg.replace(**change)
    if "model_parallel" not in change:
        with pytest.raises(NotImplementedError):
            make_default_ingest(cfg, device="cpu")
        return
    # ported (ROADMAP A13c): the split engine = the one-device engine
    cfg = cfg.replace(
        embed_dim=64, short_context=True,
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=0.5),
        **{k: dataclasses.replace(getattr(cfg, k), max_new_tokens=6)
           for k in ("asr_decode", "caption_decode")})
    wave = _pieces(np.random.default_rng(7), 6)
    segs = {}
    for mp in (1, 2):
        eng = AudioSearchEngine(cfg=cfg.replace(model_parallel=mp),
                                device="cpu", seed=1)
        eng.load_all_models()
        ing = eng.ingest_pipeline
        assert ing.asr.model_parallel == ing.caption.model_parallel == mp
        segs[mp] = eng.ingest_waveform(wave, SR, "clip")
    keys = ("segment_id", "start_time", "asr_text", "audio_description")
    assert [[s[k] for k in keys] for s in segs[2]] == \
        [[s[k] for k in keys] for s in segs[1]] and segs[1]


def _trains_over_the_model_axis(entry: str, tmp_path) -> None:
    """``entry`` at (2, 2) against (2, 1) over three steps of the same
    batches: the losses within 1e-5 (relative); the parameters, leaving
    out the entries whose RMS gradient (sqrt of the (2, 1) run's Adam nu)
    is under 1e-6 of the tree's largest (tests/test_torch_training.py's
    rule), no further from the (2, 1) run's, as a share of each leaf's
    max, than the farther of two reorderings of the (2, 1) run: on
    permuted parameters (the heads and MLP units reordered: the same
    function with the sums the model axis splits in another order), and
    on the batches' rows reversed. Measured: finetune_captioner 2.32e-5
    (permuted 3.00e-5, reversed 2.11e-5), train_clap 7.86e-6 (6.40e-6,
    9.82e-6); the captioner's first-step gradients agree within 6.2e-7 of
    each leaf's max. 3e-6 cannot hold here: Adam turns a gradient's
    rounding into an update of up to about lr. The (2, 2) run takes the
    TP forward (decode_train_tp or audio_embed_tp) once a data row of
    each step, the (2, 1) run never."""
    from unittest import mock

    from multimodal_audio_search_tpu_torch.models import clap as MC
    from multimodal_audio_search_tpu_torch.training import clap, loop
    from multimodal_audio_search_tpu_torch.utils.tree import (
        path_str, tree_leaves_with_path)
    from test_torch_training_tp import permuted
    rng = np.random.default_rng(3)
    forward = (W, "decode_train_tp") if entry == "finetune_captioner" \
        else (MC, "audio_embed_tp")
    if entry == "finetune_captioner":
        cfg = W.PRESETS["test"]
        init = W.init_params(torch.Generator().manual_seed(0), cfg)
        batches = []
        for _ in range(3):
            mask = np.ones((4, 7), np.float32)
            mask[1, 3:] = mask[2, 5:] = 0.0
            batches.append({
                "mel": rng.normal(size=(4, 80, 200)).astype(np.float32),
                "tokens": rng.integers(0, 500, (4, 8)).astype(np.int32),
                "loss_mask": mask})

        def run(mp, params, name):
            r = loop.finetune_captioner(
                batches, cfg, init_params=params, n_devices=2 * mp,
                model_parallel=mp, device="cpu", log_fn=lambda s: None,
                checkpoint_dir=str(tmp_path / name))
            return r.params, r.losses
    else:
        acfg = MC.ClapConfig(embed_dim=32, d_model=16, layers=1, heads=2,
                             ffn=32, n_mels=8, patch_frames=4,
                             max_patches=16)
        mcfg = M.MiniLMConfig(vocab_size=64, hidden=16, layers=1, heads=2,
                              intermediate=32)
        init = clap.init_clap_params(torch.Generator().manual_seed(0), acfg,
                                     mcfg)
        batches = [{"mel": rng.normal(size=(8, 8, 32)).astype(np.float32),
                    "input_ids": rng.integers(4, 64, (8, 6)),
                    "attention_mask": np.ones((8, 6), np.int64)}
                   for _ in range(3)]

        def run(mp, params, name):
            params, _, losses = clap.train_clap(
                batches, acfg, mcfg, clap.ClapTrainConfig(learning_rate=3e-3),
                init_params=params, n_devices=2 * mp, model_parallel=mp,
                device="cpu", log_fn=lambda s: None,
                checkpoint_dir=str(tmp_path / name))
            return params, losses

    def flat(tree):
        return {path_str(p): x.numpy()
                for p, x in tree_leaves_with_path(tree)}
    calls = []
    for mp, name in ((1, "one"), (2, "tp")):
        with mock.patch.object(*forward, wraps=getattr(*forward)) as f:
            calls.append((run(mp, init, name), f.call_count))
    ((p1, l1), n1), ((p2, l2), n2) = calls
    assert (n1, n2) == (0, 3 * 2)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    z = np.load(tmp_path / "one" / "step_00000003.opt.npz")
    rms = {k[len("1/0/.nu/"):]: np.sqrt(z[k]) for k in z.files
           if k.startswith("1/0/.nu/")}
    top = max(float(r.max()) for r in rms.values())
    want = flat(p1)

    def gap(got):
        assert got.keys() == want.keys()
        worst = 0.0
        for k, w in want.items():
            err = np.abs(got[k] - w)[rms[k] >= 1e-6 * top]
            if err.size:
                worst = max(worst, float(err.max() / np.abs(w).max()))
        return worst
    reordered = [flat(permuted(run(1, permuted(init), "perm")[0], True))]
    batches = [{k: v[::-1].copy() for k, v in b.items()} for b in batches]
    reordered.append(flat(run(1, init, "reversed")[0]))
    witness = [gap(r) for r in reordered]
    print(f"{entry}: (2, 2) {gap(flat(p2)):.3g}, permuted {witness[0]:.3g}, "
          f"rows reversed {witness[1]:.3g}")
    assert 0 < gap(flat(p2)) <= max(witness)


# ------------------------------------------------------- jax not needed
def test_port_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import numpy as np, torch
        torch.set_num_threads(1)
        import multimodal_audio_search_tpu_torch as P
        from multimodal_audio_search_tpu_torch.config import (
            DecodeConfig, EngineConfig, MelConfig)
        from multimodal_audio_search_tpu_torch.models import whisper as W
        from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
        from multimodal_audio_search_tpu_torch.pipelines.embed import (
            TextEmbedder)
        from multimodal_audio_search_tpu_torch.pipelines.ingest import (
            DualPipelineIngest)
        from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline \\
            import WhisperTextPipeline
        from multimodal_audio_search_tpu_torch import cli
        from multimodal_audio_search_tpu_torch.pipelines import (
            longform, streaming)
        from multimodal_audio_search_tpu_torch.service import server
        from multimodal_audio_search_tpu_torch.parallel import (
            distributed, mesh, sharding)
        mel = MelConfig(padded_seconds=2.0)
        w = W.PRESETS["test"]
        d = DecodeConfig(max_new_tokens=4, fused_encoder="int8")
        asr = WhisperTextPipeline(cfg=w, decode=d, mel_cfg=mel,
                                  device="cpu")
        cap = WhisperTextPipeline(cfg=w, decode=d, mel_cfg=mel, seed=1,
                                  prefix_ids=[w.bos_token_id],
                                  device="cpu")
        emb = TextEmbedder(cfg=PRESETS["test"], device="cpu")
        cfg = EngineConfig(ingest_batch=4, embed_dim=64)
        eng = P.AudioSearchEngine(
            cfg=cfg, ingest_pipeline=DualPipelineIngest(asr, cap, emb, cfg))
        x = np.random.default_rng(0).normal(size=16000 * 12) * 0.3
        segs = eng.ingest_waveform(x.astype(np.float32), 16000, "x")
        hits, _ = eng.search(segs[0]["asr_text"])
        live = streaming.StreamingIngest(eng.ingest_pipeline, eng.store,
                                         cfg, source_name="live")
        live.feed(x[: 16000 * 10].astype(np.float32), 16000)
        assert isinstance(longform.transcribe_long(asr, x[: 16000 * 5]),
                          str)
        assert server.serve and cli.main and len(eng.store) >= 1
        assert mesh.make_mesh and sharding.shard_index and \
            distributed.make_dcn_mesh
        # the secondary models (ROADMAP A11) at toy widths
        from multimodal_audio_search_tpu_torch.audio import clap_features
        from multimodal_audio_search_tpu_torch.models import (
            bridge, clap, clap_htsat, mpnet)
        from multimodal_audio_search_tpu_torch.ops import audio_features
        from multimodal_audio_search_tpu_torch.pipelines import clap_ingest
        m = mpnet.MPNetConfig(vocab_size=300, hidden=32, layers=1, heads=2,
                              intermediate=64, max_positions=80)
        e = TextEmbedder(cfg=m, model=mpnet, device="cpu")(["a b", "c"])
        cs = clap_ingest.ClapSearch(
            acfg=clap.ClapConfig(embed_dim=16, d_model=16, layers=1,
                                 heads=2, ffn=32),
            tcfg=PRESETS["test"], chunk_seconds=2.0, device="cpu")
        cs.ingest_waveform(x[: 16000 * 5].astype(np.float32), 16000)
        ac = clap_htsat.HTSATConfig(
            num_mel_bins=16, spec_size=64, patch_embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=4, hidden_size=32,
            projection_dim=24)
        za = clap_htsat.audio_embed(
            clap_htsat.init_audio_params(torch.Generator(), ac),
            torch.zeros(1, 1, 100, 16), ac)
        fm = clap_features.clap_log_mel(x[:48000])
        f = audio_features.audio_feature_vector(
            torch.from_numpy(x[: 16000 * 2].astype(np.float32))[None],
            MelConfig(padded_seconds=2.0))
        zb = bridge.apply(bridge.init_params(torch.Generator()), f)
        assert e.shape == (2, 32) and len(cs.search("a")) == 3
        assert za.shape == (1, 24) and fm.shape == (1001, 64)
        assert zb.shape == (1, 384)
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("OK", len(segs), len(hits))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK 1 ")
