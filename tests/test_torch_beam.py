"""Beam search of the PyTorch package (models/beam.py) against the JAX
package's ``beam_generate`` and HF ``generate`` on the CPU at float32.

* test_beam.py's 2-layer random-init HF Whisper, converted by each
  package's ``convert_whisper``: tokens and lengths identical to JAX's and
  to HF's, scores within 1e-5 of JAX's and, rescaled to HF's length
  normalization, of HF's ``sequences_scores``;
* rows that finish early (the EOS row of the embedding scaled): tokens,
  lengths and scores as JAX's, a finished row's hypothesis frozen;
* ``num_beams=1`` gives greedy; planted ties resolve as ``lax.top_k``
  resolves them; the self cache keeps its addresses;
* ``fused_layer`` True and "v2" at B*k = 8 give JAX's unfused tokens;
* the int8 cross modes run, and their first beam step meets the JAX
  guardrail against the bf16-style cross K/V.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.models import generate as JG
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.models.beam import (
    beam_generate as j_beam_generate)
from multimodal_audio_search_tpu.models.convert import (
    convert_whisper as j_convert_whisper, whisper_config_from_hf)
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.models import beam as B
from multimodal_audio_search_tpu_torch.models import generate as G
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.models.convert import (
    convert_whisper as t_convert_whisper)

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCORE_ATOL = 1e-5

# test_beam.py's three kwarg sets, then the caption_parity_decode knobs
KWARGS = [
    dict(num_beams=2),
    dict(num_beams=2, repetition_penalty=1.3, no_repeat_ngram_size=3),
    dict(num_beams=4, length_penalty=0.8),
    dict(num_beams=2, repetition_penalty=1.3, no_repeat_ngram_size=3,
         length_penalty=1.0),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _decode(mod, kw, **extra):
    return mod.DecodeConfig(
        method="beam", num_beams=kw["num_beams"],
        repetition_penalty=kw.get("repetition_penalty", 1.0),
        no_repeat_ngram_size=kw.get("no_repeat_ngram_size", 0),
        length_penalty=kw.get("length_penalty", 1.0), early_stopping=True,
        **extra)


@pytest.fixture(scope="module")
def hf_whisper():
    from transformers import WhisperConfig as HFC
    from transformers import WhisperForConditionalGeneration
    hf_cfg = HFC(
        vocab_size=120, d_model=48, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=96, decoder_ffn_dim=96, num_mel_bins=80,
        max_source_positions=40, max_target_positions=48,
        decoder_start_token_id=100, eos_token_id=101, pad_token_id=101,
        bos_token_id=101, suppress_tokens=[], begin_suppress_tokens=[],
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(7)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    jc = whisper_config_from_hf(hf_cfg)
    jp = j_convert_whisper(model.state_dict(), jc)
    tc = W.WhisperConfig(**dataclasses.asdict(jc))
    tp = W.prepare_params(weights.whisper_params(
        t_convert_whisper(model.state_dict(), tc)), torch.float32, CPU)
    return model, jc, jp, tc, tp


@pytest.mark.parametrize("kw", KWARGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_beam_matches_jax_and_hf(hf_whisper, rng, kw):
    model, jc, jp, tc, tp = hf_whisper
    b, max_new = 3, 14
    mel = (rng.normal(size=(b, 80, 80)) * 0.5).astype(np.float32)
    with torch.no_grad():
        hf = model.generate(
            input_features=torch.tensor(mel), do_sample=False,
            max_new_tokens=max_new, early_stopping=True, min_length=0,
            return_dict_in_generate=True, output_scores=True, **kw)
    enc = JW.encode(jp, mel, jc)
    prefix = np.full((b, 1), jc.bos_token_id, np.int32)
    ref = j_beam_generate(jp, enc, prefix, cfg=jc, decode=_decode(jcfg, kw),
                          prefix_len=1, max_new_tokens=max_new,
                          num_beams=kw["num_beams"])
    t_enc = W.encode(tp, torch.from_numpy(mel), tc)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(enc), atol=5e-5)
    out = B.beam_generate(tp, torch.from_numpy(np.array(enc)),
                          torch.from_numpy(prefix), cfg=tc,
                          decode=_decode(tcfg, kw), max_new_tokens=max_new,
                          num_beams=kw["num_beams"])
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=SCORE_ATOL, rtol=0)
    assert 1 <= out.steps <= max_new
    # HF: the sequence without its decoder-start token, EOS included
    seqs = hf.sequences.numpy()
    lp = kw.get("length_penalty", 1.0)
    for i in range(b):
        n = int(out.lengths[i])
        np.testing.assert_array_equal(out.tokens[i, 1:1 + n].numpy(),
                                      seqs[i, 1:1 + n], err_msg=f"row {i}")
        assert (seqs[i, 1 + n:] == jc.pad_token_id).all()
        # JAX normalizes by the whole hypothesis (prefix counted), HF
        # 4.57 by the generated tokens alone
        np.testing.assert_allclose(
            float(out.scores[i]) * ((n + 1) / n) ** lp,
            float(hf.sequences_scores[i]), atol=SCORE_ATOL, rtol=0)


def _eos_heavy(seed: int, scale: float):
    """The test preset's params with the EOS embedding row scaled (the
    logits are tied, so EOS wins more often and rows finish early)."""
    cfg = JW.PRESETS["test"]
    base = _np(JW.init_params(jax.random.PRNGKey(seed), cfg))
    emb = np.array(base["decoder"]["embed_tokens"])
    emb[cfg.eos_token_id] *= scale
    return dict(base, decoder=dict(base["decoder"], embed_tokens=emb))


@pytest.mark.parametrize("scale", [1, 3, 6])
@pytest.mark.parametrize("penalty,ngram,lp", [(1.0, 0, 1.0), (1.3, 3, 1.0),
                                              (1.05, 2, 0.8)])
def test_beam_early_finish_matches_jax(scale, penalty, ngram, lp):
    """Rows whose hypotheses fill early stop changing (frozen) while the
    others decode on: tokens, lengths and scores equal JAX's, with the
    whisper prompt of 4 forced tokens (the prefix steps' host branch)."""
    cfg = JW.PRESETS["test"]
    b, max_new = 5, 10
    jp = _eos_heavy(0, scale)
    tp = W.prepare_params(weights.whisper_params(jp), torch.float32, CPU)
    enc = np.random.default_rng(scale).normal(
        size=(b, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (b, 1))
    kw = dict(num_beams=2, repetition_penalty=penalty,
              no_repeat_ngram_size=ngram, length_penalty=lp)
    ref = j_beam_generate(jax.tree.map(jnp.asarray, jp), jnp.asarray(enc),
                          jnp.asarray(prefix), cfg=cfg,
                          decode=_decode(jcfg, kw), prefix_len=4,
                          max_new_tokens=max_new, num_beams=2)
    out = B.beam_generate(tp, torch.from_numpy(enc),
                          torch.from_numpy(prefix), cfg=W.PRESETS["test"],
                          decode=_decode(tcfg, kw), max_new_tokens=max_new,
                          num_beams=2)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=SCORE_ATOL, rtol=0)
    if scale == 6:
        assert int(out.lengths.min()) < max_new


def test_finished_row_is_frozen(monkeypatch):
    """Once a row holds k hypotheses its beams are fed the pad token on
    every later step (they keep their tokens and scores), while another
    row decodes on; the result equals JAX's. Pad = EOS in the test
    preset, and a live beam never continues with EOS, so a row's fed
    tokens are real tokens up to the step it finished and pads after."""
    cfg = W.PRESETS["test"]
    b, max_new = 5, 10
    jp = _eos_heavy(0, 3)
    tp = W.prepare_params(weights.whisper_params(jp), torch.float32, CPU)
    enc = np.random.default_rng(0).normal(
        size=(b, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(W.forced_prefix(cfg), np.int32), (b, 1))
    fed = []
    step = B.decode_step
    monkeypatch.setattr(B, "decode_step", lambda p, tok, pos, *a, **k: (
        fed.append(tok.clone()), step(p, tok, pos, *a, **k))[1])
    kw = dict(num_beams=2, repetition_penalty=1.3, no_repeat_ngram_size=3)
    out = B.beam_generate(tp, torch.from_numpy(enc),
                          torch.from_numpy(prefix), cfg=cfg,
                          decode=_decode(tcfg, kw), max_new_tokens=max_new)
    ref = j_beam_generate(jax.tree.map(jnp.asarray, jp), jnp.asarray(enc),
                          jnp.asarray(prefix), cfg=JW.PRESETS["test"],
                          decode=_decode(jcfg, kw), prefix_len=4,
                          max_new_tokens=max_new, num_beams=2)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    pads = (torch.stack(fed).reshape(len(fed), b, 2)
            == cfg.pad_token_id).all(dim=2)              # [steps, B]
    frozen_at = []
    for r in range(b):
        col = pads[:, r].tolist()
        first = col.index(True) if True in col else len(col)
        assert all(col[first:]) and not any(col[:first]), (r, col)
        frozen_at.append(first)
    assert min(frozen_at) < len(fed) - 1     # a row froze early ...
    assert max(frozen_at) == len(fed)        # ... while one decoded on


def test_num_beams_one_is_greedy(rng):
    """k=1: the top candidate each step is greedy's argmax, an EOS
    finalizes the row's one hypothesis. The n-gram ban acts alike on
    logits and log-probabilities, the repetition penalty does not (its
    sign rule), so the runs use penalty 1.0."""
    cfg = JW.PRESETS["test"]
    jp = _np(JW.init_params(jax.random.PRNGKey(3), cfg))
    tp = W.prepare_params(weights.whisper_params(jp), torch.float32, CPU)
    enc = torch.from_numpy(rng.normal(size=(3, 100, cfg.d_model))
                           .astype(np.float32))
    prefix = torch.tensor([W.forced_prefix(W.PRESETS["test"])] * 3)
    for ngram in (0, 2):
        dec = tcfg.DecodeConfig(no_repeat_ngram_size=ngram)
        g = G.generate(tp, enc, prefix, cfg=W.PRESETS["test"], decode=dec,
                       max_new_tokens=10)
        bm = B.beam_generate(tp, enc, prefix, cfg=W.PRESETS["test"],
                             decode=dataclasses.replace(dec, method="beam"),
                             max_new_tokens=10, num_beams=1)
        np.testing.assert_array_equal(bm.tokens.numpy(), g.tokens.numpy())
        np.testing.assert_array_equal(bm.lengths.numpy(), g.lengths.numpy())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_top_k_ties_resolve_as_lax_top_k(rng, k):
    """Planted ties: many entries at exactly -1e9 (banned n-grams) and
    repeated values across the row; indices as ``lax.top_k`` gives."""
    x = rng.normal(size=(6, 40)).astype(np.float32).round(1)
    x[:, ::3] = -1e9
    x[0, :] = -1e9                          # a whole row tied
    x[1, 5] = x[1, 17] = x[1, 30] = 9.0     # a tie at the top
    x[2, :] = 0.5
    x[2, 20:] = 0.25
    vals, idx = B.top_k_stable(torch.from_numpy(x), 2 * k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 2 * k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_beam_with_tied_scores_matches_jax():
    """A decoder whose logits do not depend on the input (zero output
    layer norm: every logit 0): every candidate ties, and the beams,
    tokens and lengths follow lax.top_k's lower-index rule as JAX's do,
    through n-gram bans that plant -1e9 ties as well."""
    cfg = JW.PRESETS["test"]
    jp = _np(JW.init_params(jax.random.PRNGKey(4), cfg))
    ln = dict(jp["decoder"]["ln"])
    ln["scale"] = np.zeros_like(ln["scale"])
    ln["bias"] = np.zeros_like(ln["bias"])
    jp = dict(jp, decoder=dict(jp["decoder"], ln=ln))
    tp = W.prepare_params(weights.whisper_params(jp), torch.float32, CPU)
    enc = np.random.default_rng(0).normal(
        size=(2, 100, cfg.d_model)).astype(np.float32)
    prefix = np.full((2, 1), cfg.bos_token_id, np.int32)
    kw = dict(num_beams=2, repetition_penalty=1.3, no_repeat_ngram_size=2)
    ref = j_beam_generate(jax.tree.map(jnp.asarray, jp), jnp.asarray(enc),
                          jnp.asarray(prefix), cfg=cfg,
                          decode=_decode(jcfg, kw), prefix_len=1,
                          max_new_tokens=8, num_beams=2)
    out = B.beam_generate(tp, torch.from_numpy(enc), torch.from_numpy(prefix),
                          cfg=W.PRESETS["test"], decode=_decode(tcfg, kw),
                          max_new_tokens=8, num_beams=2)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=SCORE_ATOL, rtol=0)


def test_cache_addresses_kept(monkeypatch, rng):
    """The self cache is reordered in place: every decode step sees the
    same tensors (the fused kernels write them at pos and key their
    tensor maps by address)."""
    cfg = W.PRESETS["test"]
    tp = W.prepare_params(weights.whisper_params(_np(JW.init_params(
        jax.random.PRNGKey(5), JW.PRESETS["test"]))), torch.float32, CPU)
    enc = torch.from_numpy(rng.normal(size=(3, 100, cfg.d_model))
                           .astype(np.float32))
    ptrs = []
    step = B.decode_step
    monkeypatch.setattr(B, "decode_step", lambda p, tok, pos, cache, *a, **k:
                        (ptrs.append([(c["k"].data_ptr(), c["v"].data_ptr())
                                      for c in cache]),
                         step(p, tok, pos, cache, *a, **k))[1])
    out = B.beam_generate(tp, enc, torch.tensor([W.forced_prefix(cfg)] * 3),
                          cfg=cfg, decode=tcfg.DecodeConfig(method="beam"),
                          max_new_tokens=8)
    assert len(ptrs) == out.steps >= 4 and all(p == ptrs[0] for p in ptrs)


@pytest.mark.parametrize("fused", [True, "v2"])
@pytest.mark.parametrize("penalty,ngram", [(1.0, 0), (1.3, 3)])
def test_fused_layer_beam_matches_jax_unfused(rng, fused, penalty, ngram):
    """B=4 rows x k=2 beams = 8 decode rows, so the fused sub-blocks run
    (K3/K4, or K3-q + K2 + K4-o for "v2"; their plain versions here);
    JAX's beam_generate calls the unfused step. Same tokens and
    lengths, scores within 1e-5."""
    cfg = JW.PRESETS["test"]
    jp = _np(JW.init_params(jax.random.PRNGKey(8), cfg))
    tp = W.prepare_params(weights.whisper_params(jp), torch.float32, CPU)
    enc = rng.normal(size=(4, 100, cfg.d_model)).astype(np.float32)
    prefix = np.tile(np.asarray(JW.forced_prefix(cfg), np.int32), (4, 1))
    kw = dict(num_beams=2, repetition_penalty=penalty,
              no_repeat_ngram_size=ngram)
    ref = j_beam_generate(jax.tree.map(jnp.asarray, jp), jnp.asarray(enc),
                          jnp.asarray(prefix), cfg=cfg,
                          decode=_decode(jcfg, kw), prefix_len=4,
                          max_new_tokens=8, num_beams=2)
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    calls = []
    name = "fused_self_block_q" if fused == "v2" else "fused_self_block"
    fn = getattr(DB, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DB, name, lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
        out = B.beam_generate(tp, torch.from_numpy(enc),
                              torch.from_numpy(prefix), cfg=W.PRESETS["test"],
                              decode=_decode(tcfg, kw, fused_layer=fused),
                              max_new_tokens=8, num_beams=2)
    assert len(calls) == out.steps * cfg.dec_layers
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=SCORE_ATOL, rtol=0)


# the JAX guardrail for the int8 cross modes (tests/test_int8_fused_
# cross.py, tests/test_torch_int8_attention.py): first-step logits within
# 5 % of the span of the bf16-style cross K/V's, argmax agreement >= 0.9
INT8_SPAN_MAX = 0.05
INT8_AGREE_MIN = 0.9


@pytest.mark.parametrize("mode", ["int8_fused", "int8"])
def test_int8_cross_beam_runs_within_guardrail(rng, monkeypatch, mode):
    """A quantized decoder with int8 cross K/V under beam-2: the first
    beam step's log-probabilities (B*k rows) against the same step over
    the einsum cross K/V meet the guardrail, and the decode gives
    well-formed outputs (finite scores, lengths in range)."""
    from multimodal_audio_search_tpu.ops.quant import (
        quantize_whisper_decoder)
    cfg = JW.PRESETS["test"]
    jp = quantize_whisper_decoder(JW.init_params(jax.random.PRNGKey(9), cfg))
    tp = W.prepare_params(weights.whisper_params(_np(jp)), torch.float32,
                          CPU)
    enc = torch.from_numpy(rng.normal(size=(4, 100, cfg.d_model))
                           .astype(np.float32))
    prefix = torch.full((4, 1), cfg.bos_token_id)
    firsts = {}
    step = B.decode_step
    for cross in (mode, "einsum"):
        def spy(p, tok, pos, cache, ckv, *a, _c=cross, **k):
            lg = step(p, tok, pos, cache, ckv, *a, **k)
            firsts.setdefault(_c, lg)
            return lg
        monkeypatch.setattr(B, "decode_step", spy)
        out = B.beam_generate(
            tp, enc, prefix, cfg=W.PRESETS["test"],
            decode=tcfg.DecodeConfig(method="beam", cross_attn=cross),
            max_new_tokens=6)
        assert torch.isfinite(out.scores).all()
        assert ((out.lengths >= 1) & (out.lengths <= 6)).all()
    lq, le = firsts[mode], firsts["einsum"]
    assert lq.shape == (8, cfg.vocab_size)
    span = float(le.max() - le.min())
    assert float((lq - le).abs().max()) / span < INT8_SPAN_MAX
    agree = float((lq.argmax(-1) == le.argmax(-1)).float().mean())
    assert agree >= INT8_AGREE_MIN


def test_generate_refuses_beam():
    cfg = W.PRESETS["test"]
    tp = W.prepare_params(W.init_params(torch.Generator().manual_seed(0),
                                        cfg), torch.float32, CPU)
    with pytest.raises(ValueError, match="beam_generate"):
        G.generate(tp, torch.zeros(1, 100, cfg.d_model),
                   torch.full((1, 1), cfg.bos_token_id), cfg=cfg,
                   decode=tcfg.DecodeConfig(method="beam"),
                   max_new_tokens=2)
    with pytest.raises(ValueError, match="method="):
        G.check_supported(tcfg.DecodeConfig(method="topk"))


def _spy_dispatch(pipe, out: list):
    """Record each dispatch's (mel, tokens, lengths) as numpy arrays."""
    real = pipe.dispatch_mel

    def spy(mel):
        tokens, lengths = real(mel)
        out.append(tuple(np.array(a.cpu() if hasattr(a, "cpu") else a)
                         for a in (mel, tokens, lengths)))
        return tokens, lengths
    pipe.dispatch_mel = spy


def test_caption_parity_engine_matches_jax_beam(rng, tmp_path):
    """A JAX and a port engine on the same toy weights with the captioner
    on ``caption_parity_decode()`` (beam-2, penalty 1.3, n-gram 3; 6
    tokens here). Every caption dispatch of the port gives the texts that
    JAX ``beam_generate`` gives on JAX's encoder output of the same
    segments; the JAX engine's captions are the JAX greedy texts of the
    same mel (the reference's pipeline never reaches beam search,
    ROADMAP known faults), and differ from beam-2 here."""
    import test_torch_slice as S
    from multimodal_audio_search_tpu.pipelines.whisper_pipeline import (
        WhisperTextPipeline as JPipe)
    from multimodal_audio_search_tpu_torch.audio.wav import write_wav
    jeng, teng = S._make_engines()
    jcap0, tcap = jeng.ingest_pipeline.caption, teng.ingest_pipeline.caption
    jdec = dataclasses.replace(jcfg.caption_parity_decode(), max_new_tokens=6)
    jcap = JPipe(params=jcap0.params, cfg=jcap0.cfg, decode=jdec,
                 mel_cfg=jcap0.mel_cfg, dtype=jnp.float32, name="caption",
                 prefix_ids=jcap0.prefix_ids)
    jeng.ingest_pipeline.caption = jcap
    tcap.decode = dataclasses.replace(tcfg.caption_parity_decode(),
                                      max_new_tokens=6)
    jrec, trec = [], []
    _spy_dispatch(jcap, jrec)
    _spy_dispatch(tcap, trec)
    p = str(tmp_path / "clip.wav")
    write_wav(p, S._pieces(rng, 65), S.SR)
    jsegs = jeng.ingest(p, source_name="clip.wav")
    tsegs = teng.ingest(p, source_name="clip.wav")
    assert [s["start_time"] for s in tsegs] == \
        [s["start_time"] for s in jsegs]
    assert len(jrec) == len(trec) == tcap.dispatches == 2
    cfg = jcap.cfg
    differ = 0
    for (mel, jtok, jlen), (_, ttok, tlen) in zip(jrec, trec):
        b = mel.shape[0]
        enc = JW.encode(jcap.params, jnp.asarray(mel), cfg,
                        fused_blocks=jcap.fused_encoder_resolved)
        prefix = jnp.full((b, 1), cfg.bos_token_id, jnp.int32)
        beam = j_beam_generate(jcap.params, enc, prefix, cfg=cfg,
                               decode=jdec, prefix_len=1, max_new_tokens=6,
                               num_beams=2)
        greedy = JG.generate(jcap.params, enc, prefix, cfg=cfg,
                             decode=dataclasses.replace(jdec,
                                                        method="greedy"),
                             prefix_len=1, max_new_tokens=6)
        texts = {name: jcap.texts_from_tokens(np.asarray(o.tokens),
                                              np.asarray(o.lengths), b)
                 for name, o in (("beam", beam), ("greedy", greedy))}
        assert tcap.texts_from_tokens(ttok, tlen, b) == texts["beam"]
        assert jcap.texts_from_tokens(jtok, jlen, b) == texts["greedy"]
        differ += sum(a != g for a, g in zip(texts["beam"],
                                             texts["greedy"]))
    assert differ > 0
    # the stored captions are the port's beam texts
    port_texts = {tx for _, ttok, tlen in trec
                  for tx in tcap.texts_from_tokens(ttok, tlen,
                                                   ttok.shape[0])}
    assert {s["audio_description"] for s in tsegs} <= port_texts | {""}


def _parity_engine_cfg(profile=None):
    """chip_smoke.parity_config's decodes on the toy presets (3 tokens;
    the test preset holds 32 decoder positions)."""
    spec = tcfg.ModelSpec(family="whisper", preset="test")
    cfg = tcfg.EngineConfig(ingest_batch=4, embed_dim=64,
                            short_context=True).replace(
        asr_model=spec, caption_model=spec,
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=1.0),
        asr_decode=dataclasses.replace(tcfg.asr_parity_decode(),
                                       method="sample", max_new_tokens=3),
        caption_decode=dataclasses.replace(tcfg.caption_parity_decode(),
                                           max_new_tokens=3))
    return tcfg.apply_profile(cfg, profile) if profile else cfg


@pytest.mark.parametrize("profile,fused", [(None, False),
                                           ("fast_lossless", True)])
def test_parity_engine_launches_what_chip_smoke_expects(monkeypatch, rng,
                                                        profile, fused):
    """The launch counts chip_smoke.py's [parity] phase asserts, counted
    here as calls of each kernel's entry point by a config-built engine
    with beam-2 captions and sampled ASR (two batches, so a padded one
    too): K2 twice a decoder layer and step, or once beside K3 and K4
    under fast_lossless, whatever the rows (B*k under beam)."""
    import chip_smoke
    import test_torch_slice as S
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from multimodal_audio_search_tpu_torch.ops import (
        cross_attention, decoder_block, encoder_block)
    calls = dict.fromkeys(chip_smoke.KEYS, 0)
    rows = []
    for key, mod, name in (
            ("K1", encoder_block, "fused_attention_o_residual"),
            ("K2", cross_attention, "fused_single_query_attention"),
            ("K3", decoder_block, "fused_self_block"),
            ("K4", decoder_block, "fused_mlp_block")):
        fn = getattr(mod, name)

        def counted(*a, _f=fn, _k=key, **k):
            calls[_k] += 1
            if _k == "K3":
                rows.append(a[0].shape[0])
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    eng = AudioSearchEngine(cfg=_parity_engine_cfg(profile), device="cpu")
    asr, cap = eng.ingest_pipeline.asr, eng.ingest_pipeline.caption
    assert (asr.decode.method, cap.decode.method) == ("sample", "beam")
    assert asr.decode.fused_layer is cap.decode.fused_layer is fused
    eng.ingest_waveform(S._pieces(rng, 11), S.SR, "x")
    steps = (asr.total_steps, cap.total_steps)
    disp = (asr.dispatches, cap.dispatches)
    assert disp == (2, 2)
    assert calls == chip_smoke.expected_launches(fused, None, steps, disp,
                                                 asr, cap)
    if fused:       # the captioner's K3 calls take B x 2 beam rows
        assert set(rows) == {8, 16}


def test_parity_engine_keeps_decodes_on_reconfigure(rng):
    """reconfigure rebuilds the pipelines with the engine's decode
    configs: a parity engine stays a parity engine."""
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    cfg = _parity_engine_cfg()
    eng = AudioSearchEngine(cfg=cfg, device="cpu")
    eng.reconfigure(segment_seconds=2.0, asr_preset="test")
    ing = eng.ingest_pipeline
    assert ing.asr.decode == cfg.asr_decode
    assert ing.caption.decode == cfg.caption_decode
    assert len(eng.ingest_waveform((rng.normal(size=4 * 16000) * 0.3)
                                   .astype(np.float32), 16000, "w")) == 2


def test_chip_smoke_parity_invariants_on_cpu(monkeypatch, rng):
    """chip_smoke.parity_invariants' own logic on a toy CPU engine (the
    card's synchronise made a no-op): every invariant holds and the
    timed decodes report their steps."""
    import chip_smoke
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, **kv: printed.append((name, kv)))
    eng = AudioSearchEngine(cfg=_parity_engine_cfg(), device="cpu")
    chip_smoke.parity_invariants("cpu", eng.ingest_pipeline, rng)
    (name, out), = printed
    assert name == "parity" and out["beam1_equals_greedy"]
    assert out["cache_addresses_kept"] and out["seeds_differ"]
    assert set(out["decode_32_segments"]) == {
        "beam:beam", "beam:greedy", "sample:sample", "sample:greedy"}
    assert out["decode_32_segments"]["beam:beam"]["rows"] == 64


@pytest.mark.parametrize("profile", [None, "fast_lossless"])
def test_chip_smoke_parity_shapes_are_the_paths(monkeypatch, rng, profile):
    """chip_smoke.parity_shapes names the shapes the [parity] path gives
    its decode kernels, counted here on a toy engine's full batches: K2
    over the self cache (unfused) or K3 (fused) at (rows, L) of a shape
    and a position no later than its last; K4 at a shape's rows; and
    the shape's positions reach the last position decoded."""
    import chip_smoke
    import test_torch_slice as S
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from multimodal_audio_search_tpu_torch.ops import (
        cross_attention, decoder_block)
    seen = {"self": set(), "mlp": set()}
    k2, k3 = (cross_attention.fused_single_query_attention,
              decoder_block.fused_self_block)
    k4 = decoder_block.fused_mlp_block

    def self_k2(q, k, v, *, heads, pos=None):
        if pos is not None:
            seen["self"].add((q.shape[0], k.shape[1], pos))
        return k2(q, k, v, heads=heads, pos=pos)

    def self_k3(*a, **k):
        seen["self"].add((a[0].shape[0], a[-3].shape[1], a[-1]))
        return k3(*a, **k)

    def mlp_k4(x, *a, **k):
        seen["mlp"].add(x.shape[0])
        return k4(x, *a, **k)
    monkeypatch.setattr(cross_attention, "fused_single_query_attention",
                        self_k2)
    monkeypatch.setattr(decoder_block, "fused_self_block", self_k3)
    monkeypatch.setattr(decoder_block, "fused_mlp_block", mlp_k4)
    eng = AudioSearchEngine(cfg=_parity_engine_cfg(profile), device="cpu")
    eng.ingest_waveform(S._pieces(rng, 16), S.SR, "x")  # two full batches
    shapes = chip_smoke.parity_shapes(eng.ingest_pipeline)
    assert [s[1] for s in shapes] == [16, 8]   # 8 segments x 2 beams, 8
    by_rows = {s[1]: s for s in shapes}
    assert {r for r, _, _ in seen["self"]} == set(by_rows)
    for rows, l, pos in seen["self"]:
        assert l == by_rows[rows][2] and pos <= by_rows[rows][6][-1]
    for _, rows, l, _, _, _, positions in shapes:
        reached = max(p for r, _, p in seen["self"] if r == rows)
        assert reached in positions and positions[-1] == l - 1
    assert seen["mlp"] == (set(by_rows) if profile else set())


def test_chip_smoke_parity_kernel_phase_on_cpu(monkeypatch, rng):
    """chip_smoke.parity_kernel_phase's own logic on a toy CPU engine's
    shapes (inputs on the CPU, where each wrapper is its plain version;
    the card's timers and synchronise made no-ops): every shape's cross,
    self and MLP cases are checked and join their kernels' cases."""
    import functools
    import types
    import chip_smoke
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "phase", lambda name, **kv: None)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn: 0.0)
    monkeypatch.setattr(chip_smoke, "load_tool", lambda name:
                        types.SimpleNamespace(queued_ms=lambda fn: 0.0))
    for name in ("k2_inputs", "k3_inputs", "k4_inputs"):
        monkeypatch.setattr(chip_smoke, name, functools.partial(
            getattr(chip_smoke, name), device="cpu"))
    eng = AudioSearchEngine(cfg=_parity_engine_cfg(), device="cpu")
    ing = eng.ingest_pipeline
    k2 = {"name": "single_query_attention",
          "cases": [{"shape": "kernel phase", "ms": 1.0, "device_ms": 1.0}]}
    dec = [{"name": n, "cases": []} for n in (
        "decoder_self_block", "decoder_self_block_q", "decoder_mlp_block",
        "decoder_mlp_block_o")]
    chip_smoke.parity_kernel_phase("cpu", ing, k2, dec)
    shapes = chip_smoke.parity_shapes(ing)
    n_pos = sum(len(s[6]) for s in shapes)
    assert len(k2["cases"]) == 1 + len(shapes) + n_pos
    assert [len(k["cases"]) for k in dec] == [n_pos, 0, len(shapes), 0]
    for k in (k2, *dec):
        for case in k["cases"][1 if k is k2 else 0:]:
            assert case["shape"].startswith("parity ")
            assert case["max_abs_err"] == 0.0
    assert all(c["bound_ms"] > 0 for c in k2["cases"][1:]
               if "device_ms" in c)
