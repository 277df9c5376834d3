"""The engine over the mesh's model axis (Megatron tensor parallelism),
the port against the JAX package on the CPU (JAX on its 8 virtual
devices, the port on virtual CPU entries).

* (dp, mp) = (4, 2) and (2, 4) engines at the test preset and the same
  weights, under the default config and under fast_lossless: the same
  segments and texts as the JAX engine at the same mesh and as the
  port's one-device engine, embeddings and fusion scores within 2e-5,
  the same top-10; at mp = 4 the embedder's 2 heads do not divide the
  axis and it runs whole on each row's first model device;
* make_default_ingest at the shipped presets (whisper-base ASR, H = 8;
  whisper-tiny captions, H = 6; MiniLM-L6, H = 12) at (4, 2) and (2, 4)
  against the one-device engine: at mp = 4 whisper-tiny's 6 heads do not
  divide and the captioner runs unsharded on each row's first model
  device;
* chip_smoke.py's [tp] checks rehearsed on the CPU (the partial kernels'
  twins at a small size, the split ingest against the unsplit one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
from multimodal_audio_search_tpu import config as jcfg
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
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.pipelines.embed import TextEmbedder
from multimodal_audio_search_tpu_torch.pipelines.ingest import (
    DualPipelineIngest)
from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
    WhisperTextPipeline)
from multimodal_audio_search_tpu_torch.service.stats import StatsRegistry
from test_torch_engine_mesh import QUERIES, _same_search, _same_segments
from test_torch_slice import EMB, MEL_S, SR, _np, _pieces

torch.set_num_threads(1)
MESHES = [(4, 2), (2, 4)]
PROFILES = [None, "fast_lossless"]


@pytest.fixture(scope="module")
def params():
    """The toy weights both packages' engines use: 3x the init scale on
    every matrix, so segments decode to distinct texts."""
    wcfg = JW.PRESETS["test"]
    asr_p, cap_p = (jax.tree.map(
        lambda a: a * 3.0 if a.ndim == 2 else a,
        JW.init_params(jax.random.PRNGKey(s), wcfg)) for s in (0, 1))
    emb_p = JM.init_params(jax.random.PRNGKey(2), JM.MiniLMConfig(**EMB))
    return asr_p, cap_p, emb_p


def _decode(cfg):
    return dataclasses.replace(cfg.asr_decode, max_new_tokens=6)


def _jax_engine(params, dp, mp, profile):
    asr_p, cap_p, emb_p = params
    wcfg = JW.PRESETS["test"]
    cfg = jcfg.EngineConfig(ingest_batch=4, embed_dim=64, data_parallel=dp,
                            model_parallel=mp)
    if profile:
        cfg = jcfg.apply_profile(cfg, profile)
    dec, mel = _decode(cfg), jcfg.MelConfig(padded_seconds=MEL_S)
    asr = JPipe(params=asr_p, cfg=wcfg, decode=dec, mel_cfg=mel,
                dtype=jnp.float32, name="asr")
    cap = JPipe(params=cap_p, cfg=wcfg, decode=dec, mel_cfg=mel,
                dtype=jnp.float32, name="caption",
                prefix_ids=[wcfg.bos_token_id])
    return JEngine(cfg=cfg, ingest_pipeline=JIngest(
        asr, cap, JEmbedder(params=emb_p, cfg=JM.MiniLMConfig(**EMB)), cfg))


def _port_engine(params, dp, mp, profile):
    asr_p, cap_p, emb_p = params
    wcfg = W.PRESETS["test"]
    cfg = tcfg.EngineConfig(ingest_batch=4, embed_dim=64, data_parallel=dp,
                            model_parallel=mp)
    if profile:
        cfg = tcfg.apply_profile(cfg, profile)
    dec, mel = _decode(cfg), tcfg.MelConfig(padded_seconds=MEL_S)
    asr = WhisperTextPipeline(
        params=weights.whisper_params(_np(asr_p)), cfg=wcfg, decode=dec,
        mel_cfg=mel, name="asr", device="cpu")
    cap = WhisperTextPipeline(
        params=weights.whisper_params(_np(cap_p)), cfg=wcfg, decode=dec,
        mel_cfg=mel, name="caption", prefix_ids=[wcfg.bos_token_id],
        device="cpu")
    emb = TextEmbedder(params=weights.minilm_params(_np(emb_p)),
                       cfg=M.MiniLMConfig(**EMB), device="cpu")
    return AudioSearchEngine(cfg=cfg, ingest_pipeline=DualPipelineIngest(
        asr, cap, emb, cfg, StatsRegistry()))


@pytest.fixture(scope="module")
def wave():
    return _pieces(np.random.default_rng(3), 45)      # 5 windows


def _ingest(eng, wave):
    return eng.ingest_waveform(wave, SR, "clip")


@pytest.fixture(scope="module")
def singles(params, wave):
    """The port's one-device engine under each profile, ingested."""
    out = {}
    for profile in PROFILES:
        eng = _port_engine(params, 1, 1, profile)
        out[profile] = (eng, _ingest(eng, wave))
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("dp,mp", MESHES)
def test_engine_tp_matches_jax_mesh_and_single_device(params, wave, singles,
                                                      dp, mp, profile):
    ref, ref_segs = singles[profile]
    jeng = _jax_engine(params, dp, mp, profile)
    jsegs = _ingest(jeng, wave)
    eng = _port_engine(params, dp, mp, profile)
    assert eng.mesh.shape == {"data": dp, "model": mp}
    ing = eng.ingest_pipeline
    assert ing.asr.model_parallel == ing.caption.model_parallel == mp
    # the toy embedder's 2 heads split over 2 ranks, not over 4
    assert (ing.embedder._shards is not None) == (mp == 2)
    segs = _ingest(eng, wave)
    _same_segments(segs, ref_segs)
    _same_segments(segs, jsegs)
    texts = [s["asr_text"] for s in segs if s["asr_text"]]
    assert len(set(texts)) > 1
    queries = [texts[0], texts[-1], *QUERIES]
    _same_search(eng, ref, queries)
    _same_search(eng, jeng, queries)
    # the index stays split over the data axis only
    assert eng._searcher.mesh is eng.mesh
    assert len(eng.store.device_index(eng.device, mesh=eng.mesh)[0]) == dp
    # one encoder run a data row, as without a model axis
    assert ing.asr.dispatches == dp * ref.ingest_pipeline.asr.dispatches


@pytest.mark.parametrize("dp,mp", [(2, 1), (2, 2), (4, 2)])
def test_fast_lossless_chunks_take_the_fused_blocks(params, wave,
                                                    monkeypatch, dp, mp):
    """Under fast_lossless every data chunk keeps decode_step's 8-row gate
    (the bucket's floor is 8 a data row), so each chunk's decode takes the
    fused sub-blocks, as JAX's engine does on its whole batch: one K3 and
    one K4 call a layer, a decode step and a rank."""
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    rows = {"self": [], "mlp": []}

    def counted(name, fn):
        def call(x, *a, **k):
            rows[name].append(x.shape[0])
            return fn(x, *a, **k)
        return call
    monkeypatch.setattr(DB, "fused_self_block",
                        counted("self", DB.fused_self_block))
    monkeypatch.setattr(DB, "fused_mlp_block",
                        counted("mlp", DB.fused_mlp_block))
    eng = _port_engine(params, dp, mp, "fast_lossless")
    ing = eng.ingest_pipeline
    assert ing.batch_floor() == ing.asr.batch_floor() == 8 * dp
    _ingest(eng, wave)
    calls = (ing.asr.total_steps + ing.caption.total_steps) * mp * \
        W.PRESETS["test"].dec_layers
    for name in rows:
        assert len(rows[name]) == calls > 0
        assert all(r == 8 for r in rows[name])
    # without fused_layer the floor stays max(8, dp)
    assert _port_engine(params, dp, mp, None).ingest_pipeline \
        .batch_floor() == 8


def _shipped(dp, mp):
    cfg = tcfg.EngineConfig(
        ingest_batch=8, short_context=True, data_parallel=dp,
        model_parallel=mp,
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=0.5),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=4),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=4))
    eng = AudioSearchEngine(cfg=cfg, keep_audio=False, seed=3, device="cpu")
    eng.load_all_models()
    return eng


@pytest.fixture(scope="module")
def shipped_single():
    w = (np.random.default_rng(11).normal(size=SR * 5) * 0.3).astype(
        np.float32)
    eng = _shipped(1, 1)
    return w, eng, eng.ingest_waveform(w, SR, "clip")


@pytest.mark.parametrize("dp,mp", MESHES)
def test_shipped_presets_over_the_model_axis(shipped_single, dp, mp):
    """make_default_ingest at whisper-base / whisper-tiny / MiniLM-L6
    over (dp, mp) = the one-device engine; whisper-tiny's 6 heads split
    over 2 ranks and run whole over 4."""
    w, ref, ref_segs = shipped_single
    eng = _shipped(dp, mp)
    ing = eng.ingest_pipeline
    assert ing.asr.cfg.heads == 8 and ing.caption.cfg.heads == 6
    assert ing.asr.model_parallel == mp
    assert ing.caption.model_parallel == (2 if mp == 2 else 1)
    assert ing.embedder._shards.shape == (dp, mp)
    _same_segments(eng.ingest_waveform(w, SR, "clip"), ref_segs)
    _same_search(eng, ref, QUERIES)


def test_chip_smoke_tp_checks_on_cpu(wave):
    """chip_smoke.py's [tp] checks run whole on the CPU: the partial
    kernels' twins and their sums at a small size, and the split ingest
    of a (2, 2) mesh against the unsplit one, with its launch counts
    (none on the CPU)."""
    import chip_smoke as C
    C_time = C.time_ms
    k1, k2 = {"cases": []}, {"cases": []}
    dec = [{"name": n, "cases": []} for n in ("decoder_self_block",
                                               "decoder_mlp_block")]
    try:
        C.time_ms = lambda *a, **k: 0.0
        C.tp_kernel_phase("cpu", torch.Generator().manual_seed(18), k1, k2,
                          dec, device="cpu", b=2, t=70)
    finally:
        C.time_ms = C_time
    assert len(k1["cases"]) == 5 and len(k2["cases"]) == 4
    assert [len(d["cases"]) for d in dec] == [1, 1]
    assert dec[0]["cases"][0]["repeats_equal"] == C.K3_REPEATS
    cfg = tcfg.EngineConfig(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        embed_dim=64, ingest_batch=16, short_context=True,
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=0.5),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=6),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=6))
    res = C.mesh_ingest_check("cpu", wave[: SR * 7], cfg,
                              [torch.device("cpu")] * 4, mp=2)
    assert res["dp"] == 2 and res["mp"] == 2 and res["segments"] == 4
    assert res["decode"]["asr"]["model_parallel"] == 2
    assert res["decode"]["asr"]["rows_differing"] == 0
    assert not any(res["launches"].values())    # plain twins on the CPU
