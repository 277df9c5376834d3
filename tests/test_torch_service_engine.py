"""The port's AudioSearchEngine service members against the JAX engine's,
on the CPU at toy widths and the same weights (tests/test_torch_slice.py
::_make_engines): ingest_many with a broken file, transcribe_long,
search_strategy, search_combined, delete_source (and a delete followed by
an ingest of equal size), reconfigure/describe_config under every
transfer and every embedder choice (MiniLM-L6, all-mpnet-base-v2 and the
clip-ViT-B-32-multilingual-v1 text tower, at small widths put into both
packages' presets; engines built from their configs alone hold the same
weights through carry_inits), load_all_models(warmup=True)."""
import jax
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.index.combined import (
    CombinedTextSearcher as JCombined)
from multimodal_audio_search_tpu_torch import AudioSearchEngine
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch.audio.wav import write_wav
from multimodal_audio_search_tpu_torch.index.combined import (
    CombinedTextSearcher)
from multimodal_audio_search_tpu_torch.index.strategies import STRATEGIES
from tests.test_torch_slice import SR, _make_engines, _pieces

torch.set_num_threads(1)
QUERIES = ["upbeat music with drums", "someone speaking clearly"]
EMBEDDERS = ["all-mpnet-base-v2", "clip-ViT-B-32-multilingual-v1",
             "all-MiniLM-L6-v2"]
# the embedder choices' presets at test width (max_positions above the
# 64 tokens + 1 the hash tokenizer's id-0 padding reaches in MPNet)
SMALL_MPNET = dict(vocab_size=512, hidden=32, layers=2, heads=4,
                   intermediate=128, max_positions=80)
SMALL_CLIP = dict(vocab_size=600, hidden=48, layers=2, heads=4,
                  intermediate=96, type_vocab=0)


def small_embedder_presets(monkeypatch):
    """mpnet "base" and minilm "clip512_text" at test width, in both
    packages' PRESETS (the engine's EMBEDDER_CHOICES name them)."""
    from multimodal_audio_search_tpu.models import minilm as jml
    from multimodal_audio_search_tpu.models import mpnet as jmp
    from multimodal_audio_search_tpu_torch.models import minilm as tml
    from multimodal_audio_search_tpu_torch.models import mpnet as tmp
    for mod in (jmp, tmp):
        monkeypatch.setitem(mod.PRESETS, "base",
                            mod.MPNetConfig(**SMALL_MPNET))
    for mod in (jml, tml):
        monkeypatch.setitem(mod.PRESETS, "clip512_text",
                            mod.MiniLMConfig(**SMALL_CLIP))


def carry_inits(monkeypatch):
    """small_embedder_presets, and the port's random inits (Whisper,
    MiniLM, MPNet) replaced by the JAX package's from the same seed,
    carried by weights.py; Whisper's matrices scaled by 3 in both (at the
    stock 0.02 the toy decoders give every segment one text). Engines
    built from their configs alone then hold the same weights."""
    from multimodal_audio_search_tpu.models import minilm as jml
    from multimodal_audio_search_tpu.models import mpnet as jmp
    from multimodal_audio_search_tpu.models import whisper as jw
    from multimodal_audio_search_tpu_torch import weights
    from multimodal_audio_search_tpu_torch.models import minilm as tml
    from multimodal_audio_search_tpu_torch.models import mpnet as tmp
    from multimodal_audio_search_tpu_torch.models import whisper as tw
    small_embedder_presets(monkeypatch)
    jw_init = jw.init_params

    def jw_scaled(key, cfg):
        return jax.tree.map(lambda a: a * 3.0 if a.ndim == 2 else a,
                            jw_init(key, cfg))

    def carried(jinit, jcfg, carry):
        def init(gen, cfg):
            tree = jinit(jax.random.PRNGKey(gen.initial_seed()),
                         jcfg(**cfg.__dict__))
            return carry(jax.tree.map(np.asarray, tree))
        return init

    monkeypatch.setattr(jw, "init_params", jw_scaled)
    monkeypatch.setattr(tw, "init_params", carried(
        jw_scaled, jw.WhisperConfig, weights.whisper_params))
    monkeypatch.setattr(tml, "init_params", carried(
        jml.init_params, jml.MiniLMConfig, weights.minilm_params))
    monkeypatch.setattr(tmp, "init_params", carried(
        jmp.init_params, jmp.MPNetConfig, weights.mpnet_params))


@pytest.fixture(scope="module")
def engines():
    return _make_engines()


def _wav(tmp_path, name, seconds, seed):
    p = tmp_path / name
    write_wav(str(p), _pieces(np.random.default_rng(seed), seconds), SR)
    return str(p)


def _ingest_both(jeng, teng, path, name):
    js = jeng.ingest(path, source_name=name)
    ts = teng.ingest(path, source_name=name)
    assert [s["asr_text"] for s in ts] == [s["asr_text"] for s in js]
    return ts


def _texts(h):
    return h["asr_text"], h["audio_description"]


def _same_hits(th, jh, score="fusion_score", tol=1e-5):
    """The same ranked rows: equal indices, texts and scores within
    ``tol``. Rows with the same texts score the same up to the
    embedder's rounding (its batch position), so where two of them tie,
    either may come first or take the last place."""
    assert len(th) == len(jh)
    for a, b in zip(th, jh):
        assert _texts(a) == _texts(b)
        assert a[score] == pytest.approx(b[score], abs=tol)
    same = [a["index"] == b["index"] for a, b in zip(th, jh)]
    assert sum(same) >= len(same) - sum(
        [_texts(h) for h in th].count(_texts(h)) > 1 for h in th)


def _queries(teng):
    texts = [m["asr_text"] for m in teng.store.meta if m["asr_text"]]
    return [texts[0], texts[-1], *QUERIES]


def test_ingest_many_skip_and_raise(engines, tmp_path):
    jeng, teng = engines
    for e in engines:
        e.reset_index()
    good = [_wav(tmp_path, "a.wav", 25, 0), _wav(tmp_path, "c.wav", 15, 1)]
    bad = tmp_path / "b.wav"
    bad.write_bytes(b"RIFF not a wave at all" * 4)
    files = [good[0], str(bad), good[1]]
    names = ["a.wav", "b.wav", "c.wav"]
    js = jeng.ingest_many(files, names, on_error="skip")
    ts = teng.ingest_many(files, names, on_error="skip")
    assert len(ts) == len(js) > 0
    for t, j in zip(ts, js):
        for key in ("segment_id", "source", "start_time", "asr_text",
                    "audio_description"):
            assert t[key] == j[key], key
    assert {s["source"] for s in ts} <= {"a.wav", "c.wav"}
    errs = [e for e in teng.stats.log.events
            if e.operation == "ingest_error"]
    assert errs[-1].details["source"] == "b.wav"
    assert len(teng.store) == len(jeng.store) == len(ts)
    # "raise": the good file before the broken one is in, then the error
    n = len(teng.store)
    with pytest.raises(ValueError):
        teng.ingest_many(files, names, on_error="raise", retries=0)
    with pytest.raises(ValueError):
        jeng.ingest_many(files, names, on_error="raise", retries=0)
    assert len(teng.store) == len(jeng.store) > n


def test_transcribe_long_matches_jax(engines, tmp_path):
    jeng, teng = engines
    path = _wav(tmp_path, "long.wav", 40, 2)
    got = teng.transcribe_long(path)
    assert isinstance(got, str) and got
    assert got == jeng.transcribe_long(path)


def test_search_strategy_every_strategy(engines, tmp_path):
    jeng, teng = engines
    for e in engines:
        e.reset_index()
    _ingest_both(jeng, teng, _wav(tmp_path, "s.wav", 65, 3), "s.wav")
    for q in _queries(teng):
        for strategy in STRATEGIES:
            th, tinfo = teng.search_strategy(q, strategy)
            jh, jinfo = jeng.search_strategy(q, strategy)
            _same_hits(th, jh)
            assert tinfo.keys() == jinfo.keys()
            assert tinfo["strategy"] == strategy
            for key, v in jinfo.items():
                assert tinfo[key] == (pytest.approx(v, abs=1e-6)
                                      if isinstance(v, float) else v)
        th, tinfo = teng.search_strategy(q, "compare_all")
        jh, jinfo = jeng.search_strategy(q, "compare_all")
        _same_hits(th, jh)
        per_t, per_j = tinfo["per_strategy"], jinfo["per_strategy"]
        assert set(per_t) == set(per_j) == set(STRATEGIES)
        for s in STRATEGIES:
            assert per_t[s]["top"] == per_j[s]["top"]
            assert per_t[s]["texts"] == per_j[s]["texts"]
            np.testing.assert_allclose(per_t[s]["scores"],
                                       per_j[s]["scores"], atol=1e-5)
        # the production path stays the fusion searcher
        assert teng.search_strategy(q, "fusion")[1]["asr_weight"] == \
            teng.search(q)[1]["asr_weight"]


@pytest.mark.parametrize("mode", ["combined", "asr", "caption"])
def test_search_combined_modes(engines, tmp_path, mode):
    jeng, teng = engines
    if not len(teng.store):
        _ingest_both(jeng, teng, _wav(tmp_path, "s.wav", 65, 3), "s.wav")
    k = 4
    for q in _queries(teng):
        th = teng.search_combined(q, mode, k)
        jh = jeng.search_combined(q, mode, k)
        assert len(th) == len(jh) <= k
        _same_hits(th, jh, score="score")
        assert all(h["mode"] == mode for h in th)
    with pytest.raises(ValueError):
        teng.search_combined("x", "nope")


def test_delete_source_then_equal_size_ingest(engines, tmp_path):
    """Search after a delete returns JAX's rows and none of the deleted
    source; then an ingest of the same size as the deleted one (the
    row count, the capacity bucket and so the device index's cache key
    all come back to what they were) still gives JAX's rows."""
    jeng, teng = engines
    for e in engines:
        e.reset_index()
    a = _wav(tmp_path, "a.wav", 35, 4)
    _ingest_both(jeng, teng, a, "a.wav")
    _ingest_both(jeng, teng, _wav(tmp_path, "b.wav", 25, 5), "b.wav")
    for q in _queries(teng):
        _same_hits(teng.search(q)[0], jeng.search(q)[0], tol=2e-5)
        teng.search_combined(q, "combined")
    before = len(teng.store)
    removed = teng.delete_source("a.wav")
    assert removed == jeng.delete_source("a.wav") > 0
    assert len(teng.store) == len(jeng.store) == before - removed
    assert teng.delete_source("a.wav") == 0
    for q in _queries(teng):
        th = teng.search(q)[0]
        _same_hits(th, jeng.search(q)[0], tol=2e-5)
        assert all(h["source"] != "a.wav" for h in th)
        for row in th:
            assert teng.store.meta[row["index"]]["segment_id"] == \
                row["segment_id"]
    # an ingest of a's size brings the row count back
    segs = _ingest_both(jeng, teng, _wav(tmp_path, "c.wav", 35, 6), "c.wav")
    assert len(segs) == removed and len(teng.store) == before
    for q in _queries(teng):
        _same_hits(teng.search(q)[0], jeng.search(q)[0], tol=2e-5)
        _same_hits(teng.search_strategy(q, "fixed_5050")[0],
                   jeng.search_strategy(q, "fixed_5050")[0])
        # the combined matrix follows the rows (a searcher built on the
        # store now gives the same answer as the engine's)
        got = teng.search_combined(q, "combined", 5)
        _same_hits(got, CombinedTextSearcher(teng.store, teng.embedder)(
            q, "combined", 5), score="score")
        _same_hits(got, JCombined(jeng.store, jeng.embedder)(
            q, "combined", 5), score="score")


def _cfg(mod):
    return mod.EngineConfig(
        asr_model=mod.ModelSpec(family="whisper", preset="test"),
        caption_model=mod.ModelSpec(family="whisper", preset="test"),
        text_embedder=mod.ModelSpec(family="minilm", preset="test"),
        embed_dim=64, ingest_batch=4, short_context=True,
        segment=mod.SegmentConfig(segment_seconds=2.0,
                                  min_segment_seconds=0.5),
        asr_decode=mod.DecodeConfig(max_new_tokens=3),
        caption_decode=mod.DecodeConfig(max_new_tokens=3))


def test_reconfigure_and_describe_config(rng, monkeypatch):
    small_embedder_presets(monkeypatch)
    jeng = JEngine(cfg=_cfg(jcfg), keep_audio=False)
    teng = AudioSearchEngine(cfg=_cfg(tcfg), keep_audio=False, device="cpu")
    assert teng.describe_config() == jeng.describe_config()
    wave = (rng.normal(size=SR * 4) * 0.3).astype(np.float32)
    assert len(teng.ingest_waveform(wave, SR, "w")) == 2
    # every transfer builds and ingests with it (the two engines' random
    # weights differ, so their texts do; their segments do not)
    for t in ("int12", "mel16", "mel12", "mel8", "mulaw8"):
        got = teng.reconfigure(transfer_dtype=t)
        assert got == jeng.reconfigure(transfer_dtype=t)
        assert got["transfer_dtype"] == t and len(teng.store) == 0
        tsegs = teng.ingest_waveform(wave, SR, "w")
        jsegs = jeng.ingest_waveform(wave, SR, "w")
        assert [s["start_time"] for s in tsegs] == \
            [s["start_time"] for s in jsegs] and len(tsegs) == 2
        assert teng.ingest_pipeline.last_transfer_resolved == t
        assert len(teng.store) == 2 and teng.search("tok")[0]
    # every embedder choice builds, as in JAX: the index resets to its
    # width, and the new engine ingests
    for name in EMBEDDERS[:2]:
        old = teng._ingest
        got = teng.reconfigure(embedder=name, segment_seconds=1.5)
        assert got == jeng.reconfigure(embedder=name, segment_seconds=1.5)
        assert got["embedder"] == name and len(teng.store) == 0
        assert got["embed_dim"] == teng.embedder.dim == \
            teng.store.embed_dim and teng._ingest is not old
        assert [s["start_time"] for s in teng.ingest_waveform(
            wave, SR, "w")] == [s["start_time"] for s in
                                jeng.ingest_waveform(wave, SR, "w")]
    # an embedder that fails to build raises, and the engine keeps its
    # state (the build comes before the commit)
    from multimodal_audio_search_tpu_torch.models import mpnet as tmp

    def broken(gen, cfg):
        raise RuntimeError("no memory for this embedder")
    monkeypatch.setattr(tmp, "init_params", broken)
    teng.reconfigure(embedder=EMBEDDERS[1])
    state = (teng.cfg, teng._ingest, teng.store, len(teng.store))
    with pytest.raises(RuntimeError, match="no memory"):
        teng.reconfigure(embedder=EMBEDDERS[0], segment_seconds=1.5)
    assert (teng.cfg, teng._ingest, teng.store, len(teng.store)) == state
    jeng.reconfigure(embedder=EMBEDDERS[1])
    # values outside the choices are a ValueError, as in JAX
    for bad in (dict(segment_seconds=99), dict(asr_preset="nope"),
                dict(transfer_dtype="int9"), dict(embedder="x")):
        with pytest.raises(ValueError):
            teng.reconfigure(**bad)
        with pytest.raises(ValueError):
            jeng.reconfigure(**bad)
    for change in (dict(segment_seconds=1.5), dict(transfer_dtype="int16d"),
                   dict(embedder="all-MiniLM-L6-v2",
                        transfer_dtype="float32")):
        got = teng.reconfigure(**change)
        assert got == jeng.reconfigure(**change) == teng.describe_config()
        assert len(teng.store) == 0 and teng._ingest is not state[1]
    assert teng.describe_config()["embed_dim"] == 384
    assert teng.cfg.segment.segment_seconds == 1.5


@pytest.mark.parametrize("name", EMBEDDERS)
def test_reconfigured_embedder_engine_matches_jax(monkeypatch, tmp_path,
                                                  name):
    """Each embedder choice, reached by reconfigure from a default-built
    engine: the same describe_config and embed_dim as JAX, and after an
    ingest identical segments and texts and the same top-10 for each
    query (MPNet's position ids count the hash tokenizer's id-0 padding
    as tokens, as JAX's do)."""
    carry_inits(monkeypatch)
    jeng = JEngine(cfg=_cfg(jcfg), keep_audio=False)
    teng = AudioSearchEngine(cfg=_cfg(tcfg), keep_audio=False, device="cpu")
    got = teng.reconfigure(embedder=name)
    assert got == jeng.reconfigure(embedder=name) == teng.describe_config()
    assert got["embedder"] == name and len(teng.store) == 0
    assert got["embed_dim"] == jeng.embedder.dim == teng.embedder.dim
    segs = _ingest_both(jeng, teng, _wav(tmp_path, "e.wav", 25, 4), "e.wav")
    assert len(segs) == len(teng.store) == len(jeng.store) > 1
    assert len({s["asr_text"] for s in segs}) > 1
    for q in _queries(teng):
        _same_hits(teng.search(q)[0], jeng.search(q)[0])


def test_load_all_models_warmup(rng):
    teng = AudioSearchEngine(cfg=_cfg(tcfg), device="cpu")
    assert teng.load_all_models(warmup=True) is True
    ops = [e.operation for e in teng.stats.log.events]
    assert ops[-1] == "warmup" and len(teng.store) == 0
    assert teng.ingest_pipeline.asr.dispatches >= 1
    wave = (rng.normal(size=SR * 4) * 0.3).astype(np.float32)
    segs = teng.ingest_waveform(wave, SR, "w")
    assert segs and teng.search(segs[0]["asr_text"] or "x")[0]
