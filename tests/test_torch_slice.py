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


@pytest.fixture(scope="module")
def engines():
    wcfg = JW.PRESETS["test"]
    mcfg_j = JM.MiniLMConfig(**EMB)
    # 3x the init scale on every matrix: at the stock 0.02 the toy
    # decoders ignore their input and every segment gets one text
    asr_p, cap_p = (jax.tree.map(
        lambda a: a * 3.0 if a.ndim == 2 else a,
        JW.init_params(jax.random.PRNGKey(s), wcfg)) for s in (0, 1))
    emb_p = JM.init_params(jax.random.PRNGKey(2), mcfg_j)

    cfg_j = jcfg.EngineConfig(ingest_batch=4, embed_dim=64)
    dec_j = jcfg.DecodeConfig(max_new_tokens=6)
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
    cfg_t = tcfg.EngineConfig(ingest_batch=4, embed_dim=64)
    dec_t = tcfg.DecodeConfig(max_new_tokens=6)
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
        tasr, tcap, temb, cfg_t))
    return jeng, teng


def _pieces(rng, seconds):
    """Distinct 10 s pieces (pitch and noise level vary), so segments
    decode to different texts."""
    t = np.arange(10 * SR) / SR
    return np.concatenate([
        0.3 * np.sin(2 * np.pi * 110 * 2 ** (i / 4) * t) * (1 + i % 3) / 3
        + rng.normal(size=t.size) * 0.02 * (1 + i % 5)
        for i in range(-(-seconds // 10))])[: seconds * SR] \
        .astype(np.float32)


def test_engine_parity(engines, rng, tmp_path):
    jeng, teng = engines
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
    # K1/K2 stay plain on CPU tensors: the wrappers counted no launch
    from multimodal_audio_search_tpu_torch import runtime
    assert runtime.COUNTS == {"encoder_attn_o_residual": 0,
                              "single_query_attention": 0}
    stats = json.loads(teng.export_stats_json())
    assert stats["database"]["total_segments"] == len(tsegs)


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
    with pytest.raises(NotImplementedError):
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
    dict(transfer_dtype="mulaw8"),
    dict(asr_decode=tcfg.DecodeConfig(method="beam")),
    dict(asr_decode=tcfg.DecodeConfig(fused_layer=True)),
    dict(asr_decode=tcfg.DecodeConfig(fused_encoder="int8")),
    dict(caption_decode=tcfg.DecodeConfig(cross_attn="int8_fused")),
    dict(data_parallel=2),
])
def test_unported_modes_raise(change):
    cfg = tcfg.EngineConfig(**change)
    cfg = cfg.replace(asr_model=tcfg.ModelSpec(family="whisper",
                                               preset="test"),
                      caption_model=tcfg.ModelSpec(family="whisper",
                                                   preset="test"),
                      text_embedder=tcfg.ModelSpec(family="minilm",
                                                   preset="test"))
    with pytest.raises(NotImplementedError):
        make_default_ingest(cfg, device="cpu")


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
        mel = MelConfig(padded_seconds=2.0)
        w = W.PRESETS["test"]
        d = DecodeConfig(max_new_tokens=4)
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
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("OK", len(segs), len(hits))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK 1 ")
