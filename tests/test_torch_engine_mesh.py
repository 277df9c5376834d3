"""The engine over a mesh's data axis, the port against the JAX package
on the CPU (JAX on its 8 virtual devices, the port on virtual CPU
entries), at the test preset and the same weights.

* EngineConfig(data_parallel=8 / 2) engines ingest the same waveform as
  the port's one-device engine and the JAX (8, 1) engine: the same
  segments and texts, embeddings within 2e-5, the same top-10 (scores
  within 2e-5), search_batch = the singles;
* the int12 and the mel16 / mel8 transfers split over dp=8 give the
  one-device texts;
* a whisper-base / whisper-tiny / MiniLM-L6 geometry engine at dp=8 =
  the same engine at dp=1;
* sampled decoding split over the data axis = the whole batch's;
* the mesh IVF searcher (per-shard buckets) at a full probe = the exact
  mesh searcher, rebuilt when the store changes;
* the refusal of a data axis of 6, and the decode options the model
  axis refused before ROADMAP A13c building at (dp, 2);
* chip_smoke.py's [mesh] checks rehearsed on the CPU, and failing on a
  planted fault.
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
from multimodal_audio_search_tpu_torch.index.search import FusionSearcher
from multimodal_audio_search_tpu_torch.models import minilm as M
from multimodal_audio_search_tpu_torch.models import whisper as W
from multimodal_audio_search_tpu_torch.parallel.mesh import make_mesh
from multimodal_audio_search_tpu_torch.pipelines.embed import TextEmbedder
from multimodal_audio_search_tpu_torch.pipelines.ingest import (
    DualPipelineIngest, make_default_ingest)
from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
    WhisperTextPipeline)
from multimodal_audio_search_tpu_torch.service.stats import StatsRegistry
from test_torch_slice import EMB, MEL_S, SR, _np, _pieces

torch.set_num_threads(1)
QUERIES = ("upbeat music with drums", "someone speaking clearly")


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


def _jax_engine(params, dp):
    asr_p, cap_p, emb_p = params
    wcfg = JW.PRESETS["test"]
    cfg = jcfg.EngineConfig(ingest_batch=4, embed_dim=64, data_parallel=dp)
    dec, mel = _decode(cfg), jcfg.MelConfig(padded_seconds=MEL_S)
    asr = JPipe(params=asr_p, cfg=wcfg, decode=dec, mel_cfg=mel,
                dtype=jnp.float32, name="asr")
    cap = JPipe(params=cap_p, cfg=wcfg, decode=dec, mel_cfg=mel,
                dtype=jnp.float32, name="caption",
                prefix_ids=[wcfg.bos_token_id])
    return JEngine(cfg=cfg, ingest_pipeline=JIngest(
        asr, cap, JEmbedder(params=emb_p, cfg=JM.MiniLMConfig(**EMB)), cfg))


def _port_engine(params, dp, transfer="int16", method="greedy"):
    asr_p, cap_p, emb_p = params
    wcfg = W.PRESETS["test"]
    cfg = tcfg.EngineConfig(ingest_batch=4, embed_dim=64, data_parallel=dp,
                            transfer_dtype=transfer)
    dec = dataclasses.replace(_decode(cfg), method=method)
    mel = tcfg.MelConfig(padded_seconds=MEL_S)
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
def single(params, wave):
    eng = _port_engine(params, 1)
    return eng, _ingest(eng, wave)


@pytest.fixture(scope="module")
def jax_mesh(params, wave):
    eng = _jax_engine(params, 8)
    return eng, _ingest(eng, wave)


def _same_segments(segs, ref, emb_tol=2e-5):
    assert len(segs) == len(ref) > 0
    for s, r in zip(segs, ref):
        for key in ("segment_id", "start_time", "end_time", "asr_text",
                    "audio_description", "asr_success", "audio_success"):
            assert s[key] == r[key], key
        for key in ("asr_embedding", "audio_embedding"):
            if r[key] is None:
                assert s[key] is None
            else:
                np.testing.assert_allclose(s[key], r[key], atol=emb_tol)


def _same_search(eng, ref, queries):
    for q in queries:
        rows, info = eng.search(q)
        ref_rows, ref_info = ref.search(q)
        assert info["asr_weight"] == ref_info["asr_weight"]
        assert [r["index"] for r in rows] == [r["index"] for r in ref_rows]
        np.testing.assert_allclose([r["fusion_score"] for r in rows],
                                   [r["fusion_score"] for r in ref_rows],
                                   atol=2e-5)


@pytest.mark.parametrize("dp", [8, 2])
def test_engine_mesh_matches_single_device_and_jax(params, wave, single,
                                                   jax_mesh, dp):
    ref, ref_segs = single
    jeng, jsegs = jax_mesh
    eng = _port_engine(params, dp)
    assert eng.mesh.shape == {"data": dp, "model": 1}
    assert eng.ingest_pipeline.mesh is eng.mesh
    assert eng.ingest_pipeline.asr.batch_floor() == max(8, dp)
    segs = _ingest(eng, wave)
    _same_segments(segs, ref_segs)
    _same_segments(segs, jsegs)
    texts = [s["asr_text"] for s in segs if s["asr_text"]]
    assert len(set(texts)) > 1
    queries = [texts[0], texts[-1], *QUERIES]
    _same_search(eng, ref, queries)
    _same_search(eng, jeng, queries)
    # the sharded searcher took the search, and search_batch = singles
    assert eng._searcher.mesh is eng.mesh
    for (rows, _), q in zip(eng.search_batch(queries), queries):
        assert [r["index"] for r in rows] == \
            [r["index"] for r in eng.search(q)[0]]
    # one encoder run a chunk: dp of them a batch
    assert eng.ingest_pipeline.asr.dispatches == \
        dp * ref.ingest_pipeline.asr.dispatches


@pytest.mark.parametrize("transfer", ["int12", "mel16", "mel8"])
def test_engine_mesh_transfers_match_single_device(params, wave, transfer):
    """The packed int12 rows and the host-mel codes (mel8 with its
    per-row float32 tail) split over the data axis by rows."""
    ref = _port_engine(params, 1, transfer)
    eng = _port_engine(params, 8, transfer)
    _same_segments(_ingest(eng, wave), _ingest(ref, wave))


def test_sampled_decode_split_matches_whole_batch(params, wave):
    """Each chunk draws the whole batch's Gumbel noise and takes its rows:
    the sampled texts under dp=4 are the one-device ones."""
    ref = _port_engine(params, 1, method="sample")
    eng = _port_engine(params, 4, method="sample")
    _same_segments(_ingest(eng, wave), _ingest(ref, wave))


def test_base_geometry_engine_mesh_matches_single_device():
    """The shipped presets (whisper-base ASR, whisper-tiny captions,
    MiniLM-L6) at dp=8 against dp=1, random init from one seed; 2 s
    segments and a 2 s mel context keep it short."""
    def engine(dp):
        cfg = tcfg.EngineConfig(
            ingest_batch=8, short_context=True, data_parallel=dp,
            segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                       min_segment_seconds=0.5),
            asr_decode=tcfg.DecodeConfig(max_new_tokens=4),
            caption_decode=tcfg.DecodeConfig(max_new_tokens=4))
        eng = AudioSearchEngine(cfg=cfg, keep_audio=False, seed=3,
                                device="cpu")
        eng.load_all_models()
        return eng
    w = (np.random.default_rng(11).normal(size=SR * 5) * 0.3).astype(
        np.float32)
    ref, eng = engine(1), engine(8)
    assert eng.ingest_pipeline.asr.cfg.d_model == 512
    _same_segments(eng.ingest_waveform(w, SR, "clip"),
                   ref.ingest_waveform(w, SR, "clip"))
    _same_search(eng, ref, QUERIES)


def test_mesh_ivf_searcher_matches_exact(params, rng):
    """Per-shard buckets at a full probe = the exact mesh searcher, and
    the layout follows the store's version."""
    eng = _port_engine(params, 4)
    emb = eng.embedder
    store = eng.store
    vecs = rng.normal(size=(90, 2, 64)).astype(np.float32)
    for r in range(90):
        store.add({"segment_id": f"s{r}", "asr_text": f"t{r}"},
                  vecs[r, 0] if r % 3 else None, vecs[r, 1])
    exact = FusionSearcher(store, emb, mesh=eng.mesh)
    approx = FusionSearcher(store, emb, mesh=eng.mesh)
    approx.enable_ivf(n_probe=1_000_000)
    for q in ("t3 rain", "t50", *QUERIES):
        e_rows, _ = exact(q)
        a_rows, info = approx(q)
        assert info["ann"]["sharded"] is True
        assert [r["index"] for r in a_rows] == [r["index"] for r in e_rows]
        for g, e in zip(a_rows, e_rows):
            assert abs(g["fusion_score"] - e["fusion_score"]) < 1e-5
    layout = approx._ivf
    assert layout.centroids.shape[0] == 4
    store.delete_where(lambda m: m["segment_id"] == "s7")
    approx("t50")
    assert approx._ivf is not layout and \
        approx._ivf_key[0] == store.version


def test_use_mesh_rejects_non_power_of_two_data_axis():
    mesh = make_mesh(6, device="cpu")
    emb = TextEmbedder(cfg=M.PRESETS["test"], device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        emb.use_mesh(mesh)
    pipe = WhisperTextPipeline(cfg=W.PRESETS["test"], device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        pipe.use_mesh(mesh)


def test_model_parallel_refused_naming_a13b():
    """The model axis builds at (dp, 2) under the default config (ROADMAP
    A13b) and, since A13c, under what it refused before: sampling through
    make_default_ingest and the engine, "v2" through a pipeline's
    use_mesh, each model split by heads over every data row."""
    cfg = tcfg.EngineConfig(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        embed_dim=64)
    sample = dataclasses.replace(cfg.asr_decode, method="sample")
    for dp in (1, 2):
        c = cfg.replace(data_parallel=dp, model_parallel=2)
        ing = make_default_ingest(c, device="cpu")
        assert ing.mesh.shape == {"data": dp, "model": 2}
        assert ing.asr.model_parallel == ing.caption.model_parallel == 2
        c = c.replace(asr_decode=sample)
        ing = make_default_ingest(c, device="cpu")
        assert ing.asr.decode.method == "sample"
        assert ing.asr._shards.shape == (dp, 2)
        eng = AudioSearchEngine(cfg=c, device="cpu")
        eng.load_all_models()
        assert eng.ingest_pipeline.asr.model_parallel == 2
    pipe = WhisperTextPipeline(cfg=W.PRESETS["test"], device="cpu",
                               decode=tcfg.DecodeConfig(fused_layer="v2"))
    pipe.use_mesh(make_mesh(8, model_parallel=2, device="cpu"))
    assert pipe._shards.shape == (4, 2) and pipe.model_parallel == 2
    emb = TextEmbedder(cfg=M.PRESETS["test"], device="cpu")
    emb.use_mesh(make_mesh(8, model_parallel=2, device="cpu"))
    assert emb._shards.shape == (4, 2)


def test_chip_smoke_mesh_checks_on_cpu(params, wave):
    """chip_smoke.py's [mesh] checks run whole on the CPU: the sharded,
    IVF and hierarchical searches (a Gloo group of one) over 4 shards of
    a small index, and the split ingest against the unsplit one."""
    import chip_smoke as C
    tool = C.load_tool("torch_bench_ivf")
    emb, ok, qs = tool.make_data(4096, d=32, queries=4)
    out = C.mesh_search_check("cpu", emb, ok, qs, [torch.device("cpu")] * 4)
    assert out["ivf"]["recall_at_10"] > 0.5
    assert out["hierarchical"]["backend"] == "gloo"
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
                              [torch.device("cpu")] * 2)
    assert res["segments"] == 4 and res["texts_equal"] == 4
    assert res["dispatches"] == {"asr": 2, "caption": 2}
    assert res["decode"]["asr"]["rows_differing"] == 0
    assert not any(res["launches"].values())    # plain twins on the CPU


@pytest.mark.parametrize("fault", ["shard_left_out", "split_token_flipped"])
def test_chip_smoke_mesh_checks_reject_planted_faults(monkeypatch, wave,
                                                      fault):
    """The [mesh] checks are not vacuous: a sharded search that never
    scores its last shard, and a split captioner whose first generated
    token of row 0 differs (a row the unsplit decode chose clearly),
    each fail."""
    import chip_smoke as C
    from multimodal_audio_search_tpu_torch.parallel import sharding
    if fault == "shard_left_out":
        real = sharding.sharded_fused_search_impl

        def dropping(mesh, k=10, threshold=0.1):
            fn = real(mesh, k=k, threshold=threshold)
            return lambda q, e, o, wa, wb: fn(q, e[:-1], o[:-1], wa, wb)
        monkeypatch.setattr(sharding, "sharded_fused_search_impl", dropping)
        emb, ok, qs = C.load_tool("torch_bench_ivf").make_data(
            4096, d=32, queries=4)
        with pytest.raises(AssertionError, match="exact"):
            C.mesh_search_check("cpu", emb, ok, qs, [torch.device("cpu")] * 4)
        return
    real = WhisperTextPipeline.dispatch_mel

    def flipping(self, mel):
        tokens, lengths = real(self, mel)
        if self.mesh is not None and self.name == "caption":
            tokens = tokens.clone()
            p = len(self.prefix_ids)
            tokens[0, p] = (tokens[0, p] + 1) % self.cfg.vocab_size
        return tokens, lengths
    monkeypatch.setattr(WhisperTextPipeline, "dispatch_mel", flipping)
    cfg = tcfg.EngineConfig(
        asr_model=tcfg.ModelSpec(family="whisper", preset="test"),
        caption_model=tcfg.ModelSpec(family="whisper", preset="test"),
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        embed_dim=64, ingest_batch=16, short_context=True,
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=0.5),
        asr_decode=tcfg.DecodeConfig(max_new_tokens=6),
        caption_decode=tcfg.DecodeConfig(max_new_tokens=6))
    with pytest.raises(AssertionError, match="caption"):
        C.mesh_ingest_check("cpu", wave[: SR * 7], cfg,
                            [torch.device("cpu")] * 2)
