"""IVF candidate generation of the PyTorch package (index/ivf.py, the
searcher's enable_ivf and the engine's ann="ivf") against the JAX package
on the CPU.

The same numpy inputs (d = 8-48, N <= 3000) go through both packages.
Tolerances: k-means centroids within 1e-5 (float32 sums in another
order); buckets identical given the same centroids, and from a cold
build identical except for vectors whose top-2 centroid margin is below
1e-5; query ids, ``valid`` and ``num_valid`` identical, scores, sims
and effective weights within 1e-5; searcher and engine rows equal the
JAX package's (ids identical, scores within 1e-5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.index import ivf as JI
from multimodal_audio_search_tpu.index.search import (
    FusionSearcher as JSearcher)
from multimodal_audio_search_tpu.index.store import SegmentStore as JStore
from multimodal_audio_search_tpu_torch.index import ivf as TI
from multimodal_audio_search_tpu_torch.index import search as TS
from multimodal_audio_search_tpu_torch.index.search import FusionSearcher
from multimodal_audio_search_tpu_torch.index.store import SegmentStore

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-5


def _mk_index(rng, n, d, missing=0.2):
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    success = rng.random((n, 2)) > missing
    emb[~success] = 0.0
    return emb, success


def _unit(rng, d):
    q = rng.normal(size=d).astype(np.float32)
    return q / np.linalg.norm(q)


def _vectors(emb, success):
    flat = emb.reshape(-1, emb.shape[-1])
    return flat[success.reshape(-1) & (np.linalg.norm(flat, axis=1) > 0)]


# ------------------------------------------------------------- k-means
@pytest.mark.parametrize("n,d,c,sample", [(1000, 48, 20, 32768),
                                          (3000, 48, 40, 1024),
                                          (40, 16, 64, 32768)])
def test_spherical_kmeans_matches_jax(rng, n, d, c, sample):
    """The subsample and the initial centroids come from the same numpy
    calls; after 10 steps the centroids agree within 1e-5 (also with a
    subsample, and with more clusters than vectors)."""
    x = _vectors(*_mk_index(rng, n, d))
    ref = np.asarray(JI.spherical_kmeans(x, c, seed=3, sample=sample))
    got = TI.spherical_kmeans(x, c, seed=3, sample=sample, device=CPU)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)


def test_spherical_kmeans_empty_matches_jax():
    x = np.zeros((0, 8), np.float32)
    np.testing.assert_array_equal(
        TI.spherical_kmeans(x, 4, device=CPU).numpy(),
        np.asarray(JI.spherical_kmeans(x, 4)))


def test_kmeans_sums_are_deterministic(rng):
    """The cluster sums are a one-hot matmul, not scattered atomics: two
    runs give the same bits."""
    x = _vectors(*_mk_index(rng, 2000, 32))
    a = TI.spherical_kmeans(x, 30, device=CPU)
    b = TI.spherical_kmeans(x, 30, device=CPU)
    assert torch.equal(a, b)


# ---------------------------------------------------------- assignment
@pytest.mark.parametrize("cap_factor", [4.0, 0.3])
def test_build_from_jax_centroids_identical(rng, cap_factor):
    """Given JAX's centroids the port's buckets are JAX's exactly (spill
    forced at cap_factor 0.3)."""
    emb, success = _mk_index(rng, 2000, 48)
    ref = JI.build_ivf(emb, success, n_clusters=30, cap_factor=cap_factor,
                       seed=1)
    got = TI.build_ivf(emb, success, cap_factor=cap_factor,
                       centroids=np.asarray(ref.centroids), device=CPU)
    np.testing.assert_array_equal(got.members.numpy(),
                                  np.asarray(ref.members))
    np.testing.assert_array_equal(got.spill.numpy(), np.asarray(ref.spill))
    assert got.n_rows == ref.n_rows and got.n_clusters == ref.n_clusters
    if cap_factor < 1:
        assert got.spill.numel() > 0
    assert set(got.build_s) == {"select", "kmeans", "assign", "pack"}


@pytest.mark.parametrize("seed", [0, 1])
def test_cold_build_matches_jax(rng, seed):
    """A cold build's centroids are JAX's within 1e-5, and its buckets
    are JAX's except where a vector's top-2 centroid margin is below
    1e-5 (there the two float32 matmuls may pick either)."""
    emb, success = _mk_index(rng, 3000, 48)
    ref = JI.build_ivf(emb, success, seed=seed)
    got = TI.build_ivf(emb, success, seed=seed, device=CPU)
    cj = np.asarray(ref.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), cj, atol=TOL)
    members, jm = got.members.numpy(), np.asarray(ref.members)
    if not np.array_equal(members, jm):
        sims = np.sort(_vectors(emb, success) @ cj.T, axis=1)
        close = sims[:, -1] - sims[:, -2] < TOL
        assert close.any(), "buckets differ with no near-tie vector"
        rows = np.repeat(np.arange(len(emb)), 2)[
            success.reshape(-1) & (np.linalg.norm(
                emb.reshape(-1, emb.shape[-1]), axis=1) > 0)]
        differ = {c for c in range(len(jm))
                  if not np.array_equal(members[c], jm[c])}
        near = set(rows[close].tolist())
        for c in differ:
            assert set(members[c].tolist()) ^ set(jm[c].tolist()) <= \
                near | {-1}
    else:
        np.testing.assert_array_equal(got.spill.numpy(),
                                      np.asarray(ref.spill))


# --------------------------------------------------------------- query
def _case(rng, name):
    """(emb, success, build kwargs, weights, k, query, rows) of one of
    tests/test_ivf.py's situations; ``rows`` < len(emb) marks capacity
    padding."""
    if name == "random":
        emb, ok = _mk_index(rng, 300, 16)
        return emb, ok, dict(n_clusters=10, seed=1), (0.6, 0.4), 10, \
            _unit(rng, 16), 300
    if name == "spill":
        emb, ok = _mk_index(rng, 200, 8)
        return emb, ok, dict(n_clusters=8, cap_factor=0.3, seed=2), \
            (0.6, 0.4), 10, _unit(rng, 8), 200
    if name == "both_slots":
        d = 8
        a, b = np.eye(d, dtype=np.float32)[:2]
        emb = np.zeros((40, 2, d), np.float32)
        ok = np.zeros((40, 2), bool)
        emb[0, 0], emb[0, 1] = a, b
        ok[0] = True
        pts = rng.normal(size=(39, d)).astype(np.float32)
        emb[1:, 0] = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        ok[1:, 0] = True
        q = ((a + b) / np.linalg.norm(a + b)).astype(np.float32)
        return emb, ok, dict(n_clusters=6, seed=4), (0.5, 0.5), 40, q, 40
    if name == "padded":
        emb, ok = _mk_index(rng, 37, 8)
        pe = np.zeros((64, 2, 8), np.float32)
        po = np.zeros((64, 2), bool)
        pe[:37], po[:37] = emb, ok
        return pe, po, dict(n_clusters=5, seed=6), (0.6, 0.4), 10, \
            _unit(rng, 8), 37
    assert name == "more_clusters"
    emb, ok = _mk_index(rng, 5, 8, missing=0.0)
    return emb, ok, dict(n_clusters=64, seed=5), (0.6, 0.4), 5, \
        _unit(rng, 8), 5


CASES = ["random", "spill", "both_slots", "padded", "more_clusters"]


@pytest.mark.parametrize("n_probe", [1, 2, None])
@pytest.mark.parametrize("case", CASES)
def test_ivf_query_matches_jax(rng, case, n_probe):
    """_ivf_query (through IVFIndex.search_fn) == JAX's at n_probe 1, 2
    and full, on the same layout (built from JAX's centroids): ids,
    valid and num_valid identical, scores, sims and effective weights
    within 1e-5. Covers spill, a row reachable through both slots,
    capacity-padded operands and more clusters than points."""
    emb, ok, kw, w, k, q, rows = _case(rng, case)
    ref_ivf = JI.build_ivf(emb[:rows], ok[:rows], **kw)
    ivf = TI.build_ivf(emb[:rows], ok[:rows],
                       cap_factor=kw.get("cap_factor", 4.0),
                       centroids=np.asarray(ref_ivf.centroids), device=CPU)
    npb = n_probe or ivf.n_clusters
    ref = ref_ivf.search_fn(k=k, n_probe=npb)(
        jnp.asarray(q), jnp.float32(w[0]), jnp.float32(w[1]),
        jnp.asarray(emb), jnp.asarray(ok))
    got = ivf.search_fn(k=k, n_probe=npb)(
        torch.from_numpy(q), w[0], w[1], torch.from_numpy(emb),
        torch.from_numpy(ok))
    assert set(got) == set(ref)
    for key in ("indices", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    assert int(got["num_valid"]) == int(ref["num_valid"])
    for key in ("scores", "sims", "effective_weights"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=TOL, rtol=0)
    hits = got["indices"].numpy()[got["valid"].numpy()]
    assert len(set(hits.tolist())) == len(hits)   # each row once
    assert (hits < rows).all()
    if case == "both_slots" and n_probe is None:
        assert np.count_nonzero(hits == 0) == 1


def test_full_probe_equals_port_exact(rng):
    """With every cluster probed, IVF equals the port's exact fused_topk
    (spill included)."""
    from multimodal_audio_search_tpu_torch.index.fusion import fused_topk
    emb, ok = _mk_index(rng, 400, 16)
    ivf = TI.build_ivf(emb, ok, n_clusters=12, cap_factor=0.5, seed=2,
                       device=CPU)
    assert ivf.spill.numel() > 0
    e, o = torch.from_numpy(emb), torch.from_numpy(ok)
    for _ in range(3):
        q = torch.from_numpy(_unit(rng, 16))
        out = ivf.search_fn(k=10, n_probe=ivf.n_clusters)(q, 0.6, 0.4, e, o)
        ref = fused_topk(q, e, o, 0.6, 0.4, k=10)
        keep = ref["valid"].numpy()
        np.testing.assert_array_equal(out["indices"].numpy()[keep],
                                      ref["indices"].numpy()[keep])
        np.testing.assert_allclose(out["scores"].numpy()[keep],
                                   ref["scores"].numpy()[keep], atol=TOL)
        assert int(out["num_valid"]) == int(ref["num_valid"])


def test_empty_clusters_rank_below_negative_sims():
    """tests/test_ivf.py's case: a memberless cluster never wins a probe
    slot over a real one with negative similarity; the port's candidate
    scores and rows equal JAX's."""
    d = 8
    v = np.zeros(d, np.float32)
    v[0] = 1.0
    cent = np.stack([v, np.zeros(d, np.float32)])
    members = np.array([[0, -1], [-1, -1]], np.int32)
    emb = np.zeros((1, 2, d), np.float32)
    emb[0, 0] = -v
    success = np.array([[True, False]])
    ref = JI.local_candidate_scores(
        jnp.asarray(-v), jnp.asarray(cent), jnp.asarray(members),
        jnp.zeros(0, jnp.int32), jnp.asarray(emb), jnp.asarray(success),
        jnp.float32(1.0), jnp.float32(0.0), n_probe=1, threshold=0.1)
    got = TI.local_candidate_scores(
        torch.from_numpy(-v), torch.from_numpy(cent),
        torch.from_numpy(members), torch.zeros(0, dtype=torch.int32),
        torch.from_numpy(emb), torch.from_numpy(success), 1.0, 0.0,
        n_probe=1, threshold=0.1)
    assert float(got[0].max()) == pytest.approx(1.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_calibrate_n_probe_matches_jax(rng):
    """tests/test_ivf.py's clustered data: the port picks JAX's n_probe,
    and an unreachable target gives a full probe in both."""
    d, per = 16, 30
    centers = rng.normal(size=(8, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    pts = (centers[:, None, :] + (0.2 / np.sqrt(d)) * rng.normal(
        size=(8, per, d))).reshape(-1, d).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    emb = np.stack([pts, pts], axis=1)
    success = np.ones((len(pts), 2), bool)
    ref_ivf = JI.build_ivf(emb, success, n_clusters=8, seed=8)
    ivf = TI.build_ivf(emb, success, centroids=np.asarray(ref_ivf.centroids),
                       device=CPU)
    qs = (centers[:4] + (0.3 / np.sqrt(d)) * rng.normal(
        size=(4, d))).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    for target in (0.9, 1.01):
        ref = JI.calibrate_n_probe(ref_ivf, emb, success, qs,
                                   target_overlap=target)
        got = TI.calibrate_n_probe(ivf, emb, success, qs,
                                   target_overlap=target)
        assert got == ref
    assert got == ivf.n_clusters


# ------------------------------------------------------------ searcher
def _segments(rng, n, d=48, source=None):
    """tests/test_fusion_search.py's segments (every availability)."""
    segs = []
    for i in range(n):
        has_asr, has_audio = rng.random() > 0.25, rng.random() > 0.25
        if not (has_asr or has_audio):
            has_asr = True

        def emb():
            e = rng.normal(size=d).astype(np.float32)
            return e / np.linalg.norm(e)
        segs.append({
            "segment_id": f"seg_{i}", "start_time": 10.0 * i,
            "asr_text": "hello world" if has_asr else "",
            "audio_description": "music playing" if has_audio else "",
            "asr_embedding": emb() if has_asr else None,
            "audio_embedding": emb() if has_audio else None,
            "asr_success": has_asr, "audio_success": has_audio,
            **({"source": source} if source else {})})
    return segs


class FixedEmbedder:
    """Every text embeds to one vector (the JAX tests' tile embed_fn)."""

    device = CPU

    def __init__(self, q):
        self.q = q

    def __call__(self, texts):
        return np.tile(self.q, (len(texts), 1))

    def embed_device(self, texts):
        return torch.from_numpy(self(texts))


def _pair(rng, segs, d=48, n_probe=1_000_000):
    """A JAX and a port store with ``segs``, and an IVF searcher on each
    with one query vector."""
    js, ts = JStore(embed_dim=d, keep_audio=False), \
        SegmentStore(embed_dim=d, keep_audio=False)
    js.extend(segs)
    ts.extend(segs)
    emb = FixedEmbedder(_unit(rng, d))
    j, t = JSearcher(js, embed_fn=emb), FusionSearcher(ts, emb)
    for s in (j, t):
        s.enable_ivf(n_probe=n_probe)
    return j, t


def _same_rows(got, ref):
    assert [r["index"] for r in got] == [r["index"] for r in ref]
    for g, e in zip(got, ref):
        for key in ("fusion_score", "asr_similarity", "audio_similarity",
                    "effective_asr_weight"):
            assert g[key] == pytest.approx(e[key], abs=TOL)


@pytest.mark.parametrize("n_probe", [2, 1_000_000])
def test_searcher_ivf_matches_jax_and_rebuilds_after_growth(rng, n_probe):
    """FusionSearcher with IVF gives JAX's rows and ann info; growth
    within rebuild_growth rebuilds the layout with the same centroids,
    and the rows are still JAX's."""
    j, t = _pair(rng, _segments(rng, 120), n_probe=n_probe)
    jr, ji = j("some query")
    tr, ti = t("some query")
    _same_rows(tr, jr)
    assert ti["ann"] == ji["ann"] and ti["ann"]["mode"] == "ivf"
    built = t._ivf
    more = _segments(rng, 20)
    j.store.extend(more)
    t.store.extend(more)
    jr, ji = j("grown")
    tr, ti = t("grown")
    assert t._ivf is not built and t._ivf.n_rows == 140
    assert torch.equal(t._ivf.centroids, built.centroids)   # reused
    assert ti["ann"] == ji["ann"]
    _same_rows(tr, jr)


def test_searcher_ivf_rebuilds_after_same_count_mutation(rng):
    """delete + ingest of equal size shifts row ids without changing the
    count: the layout rebuilds (keyed on store.version) and the rows are
    JAX's."""
    segs = _segments(rng, 80)
    for s in segs[:20]:
        s["source"] = "doomed"
    j, t = _pair(rng, segs)
    t("warm build")
    j("warm build")
    built = t._ivf
    more = _segments(rng, 20)
    for s in (j, t):
        s.store.delete_source("doomed")
        s.store.extend(more)
    assert len(t.store) == 80
    tr, _ = t("after churn")
    assert t._ivf is not built
    _same_rows(tr, j("after churn")[0])


def test_searcher_disable_ivf_and_search_batch(rng):
    """search_batch under IVF = singles = JAX's search_batch; disable_ivf
    returns to the exact path (no "ann" in the info)."""
    j, t = _pair(rng, _segments(rng, 90), n_probe=2)
    queries = ["music with drums", "someone speaking", "guitar"]
    tb, jb = t.search_batch(queries, k=5), j.search_batch(queries, k=5)
    for q, (rows, info), (jrows, jinfo) in zip(queries, tb, jb):
        _same_rows(rows, jrows)
        assert info["ann"] == jinfo["ann"] and info["query"] == q
        _same_rows(rows, t(q, 5)[0])
    t.prewarm()
    assert t._ivf_key == t.store.version
    t.disable_ivf()
    j.disable_ivf()
    rows, info = t("back to exact")
    assert "ann" not in info and t._ivf is None
    _same_rows(rows, j("back to exact")[0])
    t.prewarm()                      # no-op without enable_ivf
    assert t._ivf is None


def test_config_ann_no_longer_refused(rng):
    """FusionConfig(ann="ivf") builds a searcher (the engine enables IVF
    from it); the port no longer raises."""
    from multimodal_audio_search_tpu_torch.config import FusionConfig
    store = SegmentStore(embed_dim=8, keep_audio=False)
    store.add({"segment_id": "a"}, np.ones(8, np.float32), None)
    s = FusionSearcher(store, FixedEmbedder(np.ones(8, np.float32) / 8 ** .5),
                       cfg=FusionConfig(ann="ivf"))
    assert s._ivf_cfg is None and len(s("query")[0]) == 1


# -------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def ivf_engines():
    """A JAX and a port engine with fusion.ann="ivf" on the test presets'
    shared toy weights, each on a fresh store."""
    from test_torch_slice import _make_engines
    from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    jeng, teng = _make_engines()

    def ivf_cfg(cfg):
        return cfg.replace(fusion=dataclasses.replace(cfg.fusion, ann="ivf"))
    return (JEngine(cfg=ivf_cfg(jeng.cfg),
                    ingest_pipeline=jeng.ingest_pipeline),
            AudioSearchEngine(cfg=ivf_cfg(teng.cfg),
                              ingest_pipeline=teng.ingest_pipeline))


def test_engine_ivf_matches_jax_and_builds_once(ivf_engines, monkeypatch):
    """ingest_many on both engines: the same segments, the layout built
    once at the end of the port's ingest_many (on the write path, before
    any query), and every query's top-10 equal to the JAX engine's, with
    weight_info["ann"]."""
    from test_torch_slice import _pieces
    jeng, teng = ivf_engines
    rng = np.random.default_rng(5)
    clips = [chip_smoke.wav_bytes(_pieces(rng, s)) for s in (45, 25)]
    builds = []
    real = TS.build_ivf
    monkeypatch.setattr(TS, "build_ivf", lambda *a, **kw: builds.append(1)
                        or real(*a, **kw))
    tsegs = teng.ingest_many(clips, ["a.wav", "b.wav"], on_error="raise")
    assert len(builds) == 1 and teng._searcher._ivf is not None
    jsegs = jeng.ingest_many(clips, ["a.wav", "b.wav"], on_error="raise")
    assert [(s["source"], s["start_time"], s["asr_text"],
             s["audio_description"]) for s in tsegs] == \
        [(s["source"], s["start_time"], s["asr_text"],
          s["audio_description"]) for s in jsegs]
    ops = [e.operation for e in teng.stats.log.events]
    assert "ivf_prewarm_failed" not in ops
    texts = [m["asr_text"] for m in teng.store.meta]
    queries = [texts[0], texts[-1], "upbeat music with drums",
               "someone speaking clearly"]
    for q in queries:
        (th, ti), (jh, ji) = teng.search(q), jeng.search(q)
        assert ti["ann"] == ji["ann"]
        assert [h["index"] for h in th] == [h["index"] for h in jh], q
        assert [h["fusion_score"] for h in th] == pytest.approx(
            [h["fusion_score"] for h in jh], abs=2e-5)
    for (th, ti), (jh, _) in zip(teng.search_batch(queries),
                                 jeng.search_batch(queries)):
        assert "ann" in ti
        assert [h["index"] for h in th] == [h["index"] for h in jh]
    assert len(builds) == 1          # no query rebuilt it


def test_engine_prewarm_failure_is_logged(ivf_engines, monkeypatch):
    """A failing prewarm is logged as ivf_prewarm_failed and swallowed;
    the query path rebuilds."""
    _, teng = ivf_engines
    monkeypatch.setattr(FusionSearcher, "prewarm",
                        lambda self: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    teng._prewarm_searcher()
    ev = teng.stats.log.events[-1]
    assert ev.operation == "ivf_prewarm_failed" and ev.details["error"] \
        == "boom"


def test_chip_smoke_ann_engine_check_on_cpu(ivf_engines, monkeypatch):
    """chip_smoke.ann_engine_check passes on a CPU engine of the test
    presets, and rejects one whose write path skips the prewarm."""
    from test_torch_slice import _pieces
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    _, teng = ivf_engines
    cfg = teng.cfg
    rng = np.random.default_rng(7)
    clips = [("long.wav", _pieces(rng, 45)), ("short.wav", _pieces(rng, 25))]
    eng = AudioSearchEngine(cfg=cfg, ingest_pipeline=teng.ingest_pipeline)
    out = chip_smoke.ann_engine_check(eng, clips)
    assert out["segments"] == len(eng.store) and out["n_clusters"] >= 1
    bad = AudioSearchEngine(cfg=cfg, ingest_pipeline=teng.ingest_pipeline)
    monkeypatch.setattr(bad, "_prewarm_searcher", lambda: None)
    with pytest.raises(AssertionError, match="no IVF layout"):
        chip_smoke.ann_engine_check(bad, clips)
