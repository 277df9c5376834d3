"""Checkpoint conversion in the PyTorch package (models/convert.py, a copy
of the JAX module) and ``ModelSpec.weights_path`` on the CPU at float32.

* random-init HF ``WhisperForConditionalGeneration`` and ``BertModel``,
  saved by ``save_pretrained`` as ``pytorch_model.bin`` and as
  safetensors, load through ``load_state_dict_from_dir`` and convert: the
  port's encoder output and decode-step logits, and its MiniLM hidden
  states, within 5e-5 of HF torch;
* an engine built with ``weights_path`` on all three models gives the
  segments, texts, embeddings and top-10 of the JAX engine built from the
  same directories (the hash tokenizer, as the directories have no
  tokenizer assets).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.pipelines.ingest import (
    make_default_ingest as j_make_default_ingest)
from multimodal_audio_search_tpu_torch import AudioSearchEngine, weights
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.models.convert import (
    bert_config_from_hf, convert_bert, convert_whisper,
    load_state_dict_from_dir, whisper_config_from_hf)
from multimodal_audio_search_tpu_torch.pipelines.ingest import (
    make_default_ingest)

torch.set_num_threads(1)
CPU = torch.device("cpu")
ATOL = 5e-5
SAFETENSORS = [False] + ([True] if __import__("importlib").util.find_spec(
    "safetensors") else [])


def hf_whisper(seed: int, init_std: float = 0.02):
    """A random-init HF Whisper with the port's "test" preset's shapes
    and special ids."""
    from transformers import WhisperConfig as HFC
    from transformers import WhisperForConditionalGeneration
    p = W.PRESETS["test"]
    hf_cfg = HFC(
        vocab_size=p.vocab_size, d_model=p.d_model,
        encoder_layers=p.enc_layers, decoder_layers=p.dec_layers,
        encoder_attention_heads=p.heads, decoder_attention_heads=p.heads,
        encoder_ffn_dim=p.ffn, decoder_ffn_dim=p.ffn, num_mel_bins=p.n_mels,
        max_source_positions=p.enc_positions,
        max_target_positions=p.dec_positions,
        decoder_start_token_id=p.bos_token_id, eos_token_id=p.eos_token_id,
        pad_token_id=p.pad_token_id, bos_token_id=p.eos_token_id,
        suppress_tokens=[], begin_suppress_tokens=[], init_std=init_std,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(seed)
    return WhisperForConditionalGeneration(hf_cfg).eval()


def hf_bert(seed: int, init_std: float = 0.02):
    """A random-init HF BertModel with the MiniLM "test" preset's shapes."""
    from transformers import BertConfig, BertModel
    p = M.PRESETS["test"]
    hf_cfg = BertConfig(
        vocab_size=p.vocab_size, hidden_size=p.hidden,
        num_hidden_layers=p.layers, num_attention_heads=p.heads,
        intermediate_size=p.intermediate,
        max_position_embeddings=p.max_positions,
        type_vocab_size=p.type_vocab, layer_norm_eps=p.ln_eps,
        initializer_range=init_std, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    return BertModel(hf_cfg).eval()


def _save(model, path, safe: bool) -> str:
    model.save_pretrained(str(path), safe_serialization=safe)
    want = "model.safetensors" if safe else "pytorch_model.bin"
    assert (path / want).exists(), sorted(p.name for p in path.iterdir())
    return str(path)


@pytest.mark.parametrize("safe", SAFETENSORS)
def test_whisper_checkpoint_matches_hf(tmp_path, rng, safe):
    model = hf_whisper(0)
    path = _save(model, tmp_path / "whisper", safe)
    p = W.PRESETS["test"]
    # the prompt ids are not in an HF config: the preset's stand
    assert dataclasses.replace(
        whisper_config_from_hf(model.config),
        no_timestamps_id=p.no_timestamps_id, transcribe_id=p.transcribe_id,
        lang_en_id=p.lang_en_id) == p
    tp = W.prepare_params(weights.whisper_params(convert_whisper(
        load_state_dict_from_dir(path), W.PRESETS["test"])), torch.float32,
        CPU)
    cfg = W.PRESETS["test"]
    mel = torch.from_numpy((rng.normal(size=(2, 80, 200)) * 0.5)
                           .astype(np.float32))
    dec_ids = torch.tensor([[cfg.bos_token_id, 7, 300, 42, 99, 5]] * 2)
    with torch.no_grad():
        ref = model(input_features=mel, decoder_input_ids=dec_ids)
    enc = W.encode(tp, mel, cfg)
    np.testing.assert_allclose(enc.numpy(),
                               ref.encoder_last_hidden_state.numpy(),
                               atol=ATOL, rtol=0)
    ckv = W.cross_kv_merged(tp, enc, cfg)
    cache = W.init_cache(cfg, 2, dec_ids.shape[1], torch.float32, CPU)
    for pos in range(dec_ids.shape[1]):
        lg = W.decode_step(tp, dec_ids[:, pos], pos, cache, ckv, cfg)
        np.testing.assert_allclose(lg.numpy(), ref.logits[:, pos].numpy(),
                                   atol=ATOL, rtol=0, err_msg=f"pos {pos}")


@pytest.mark.parametrize("safe", SAFETENSORS)
def test_bert_checkpoint_matches_hf(tmp_path, rng, safe):
    model = hf_bert(1)
    path = _save(model, tmp_path / "bert", safe)
    cfg = bert_config_from_hf(model.config)
    assert cfg == M.PRESETS["test"]
    tp = weights.minilm_params(convert_bert(load_state_dict_from_dir(path),
                                            cfg))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 9)))
    mask = torch.ones(3, 9, dtype=torch.long)
    mask[1, 6:] = 0
    with torch.no_grad():
        ref = model(input_ids=ids, attention_mask=mask).last_hidden_state
    got = M.encode_tokens(tp, ids, mask, cfg)
    keep = mask.bool()
    np.testing.assert_allclose(got[keep].numpy(), ref[keep].numpy(),
                               atol=ATOL, rtol=0)


def test_missing_checkpoint_raises(tmp_path):
    cfg = tcfg.EngineConfig().replace(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test",
                                 weights_path=str(tmp_path / "none")),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"))
    with pytest.raises(FileNotFoundError):
        make_default_ingest(cfg, device="cpu")


def _engine_cfg(mod, asr_dir, cap_dir, emb_dir, quantize=False):
    spec = dict(family="whisper", preset="test", quantize_decoder=quantize)
    return mod.EngineConfig(ingest_batch=4, embed_dim=64,
                            short_context=True).replace(
        asr_model=mod.ModelSpec(weights_path=asr_dir, **spec),
        caption_model=mod.ModelSpec(weights_path=cap_dir, **spec),
        text_embedder=mod.ModelSpec(family="minilm", preset="test",
                                    weights_path=emb_dir),
        segment=mod.SegmentConfig(segment_seconds=2.0,
                                  min_segment_seconds=1.0),
        asr_decode=mod.DecodeConfig(max_new_tokens=6),
        caption_decode=mod.DecodeConfig(max_new_tokens=6))


@pytest.mark.parametrize("quantize", [False, True])
def test_weights_path_engine_matches_jax(tmp_path, rng, quantize):
    """Both packages' make_default_ingest on the same three checkpoint
    directories (the HF Whisper init at 0.3, so the toy decoders tell
    segments apart: 10 distinct ASR texts over 33); with ``quantize``
    the converted decoders are quantized, as the JAX package does."""
    import test_torch_slice as S
    dirs = [_save(m, tmp_path / name, False) for name, m in (
        ("asr", hf_whisper(2, 0.3)), ("cap", hf_whisper(3, 0.3)),
        ("emb", hf_bert(4, 0.06)))]
    jc = _engine_cfg(jcfg, *dirs, quantize=quantize)
    tc = _engine_cfg(tcfg, *dirs, quantize=quantize)
    jeng = JEngine(cfg=jc, ingest_pipeline=j_make_default_ingest(
        jc, dtype=jnp.float32))
    teng = AudioSearchEngine(cfg=tc, ingest_pipeline=make_default_ingest(
        tc, dtype=torch.float32, device="cpu"))
    asr = teng.ingest_pipeline.asr
    assert asr.quantized == quantize
    assert type(asr.tokenizer).__name__ == "HashWordTokenizer"
    S._check_engine_parity(jeng, teng, rng, tmp_path)
