"""The search side of the PyTorch package against the JAX package on the
CPU: K12's plain version (ops/fused_search.py) against the Pallas kernel
B10 in interpret mode, the bfloat16 device index, batched queries and
the index_dtype plumbing, and chip_smoke's K12 checks held to a planted
fault.

Inputs come from numpy with a seed and feed both packages. Tolerances:
1e-5 on scores (the JAX package's own bar in tests/test_fused_search_
kernel.py: float32 dot products summed in another order); top-10 ids
identical wherever the plain scores' neighbouring gaps exceed 1e-5; the
bf16 index codes bit-equal (both round to nearest even).
"""
import dataclasses
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.index import fusion as JF
from multimodal_audio_search_tpu.index.store import SegmentStore as JStore
from multimodal_audio_search_tpu.ops.fused_search import pallas_fused_scores
from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.config import FusionConfig
from multimodal_audio_search_tpu_torch.index import fusion as F
from multimodal_audio_search_tpu_torch.index.search import FusionSearcher
from multimodal_audio_search_tpu_torch.index.store import SegmentStore
from multimodal_audio_search_tpu_torch.ops import fused_search as FS

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-5


def _index(rng, n, d, p_ok=0.3):
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb, rng.random((n, 2)) > p_ok


# ------------------------------------------------------------ K12 twin
@pytest.mark.parametrize("n,d,q_row", [(1024, 128, 11), (2048, 384, 11),
                                       (1027, 64, 1026)])
def test_k12_plain_matches_pallas(rng, n, d, q_row):
    """The JAX tests' shapes (tests/test_fused_search_kernel.py and the odd
    N=1027 of tests/test_review_fixes.py, its tail row the query)."""
    emb, ok = _index(rng, n, d)
    q = emb[q_row, 0]
    ref = np.asarray(pallas_fused_scores(
        jnp.asarray(q), jnp.asarray(emb), jnp.asarray(ok),
        jnp.float32(0.7), jnp.float32(0.3), threshold=0.1,
        blk=256, interpret=True))
    got = FS.fused_scores_plain(torch.from_numpy(q), torch.from_numpy(emb),
                                torch.from_numpy(ok), 0.7, 0.3)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_k12_plain_validity_rules_match_pallas():
    """The validity cases of tests/test_fused_search_kernel.py, and
    chip_smoke's rule rows (a score exactly at the threshold among them):
    the twin, the CPU wrapper and the Pallas kernel give the same scores
    exactly."""
    d, n = 64, 256
    emb = np.zeros((n, 2, d), np.float32)
    ok = np.zeros((n, 2), bool)
    q = np.zeros(d, np.float32)
    q[0] = 1.0
    emb[0, 0, 0] = 1.0; ok[0, 0] = True          # noqa: E702 valid
    emb[1, 0, 0] = 0.05; ok[1, 0] = True         # noqa: E702 below
    emb[2, 0, 0] = -1.0; ok[2, 0] = True         # noqa: E702 negative
    emb[3, 0, 0] = 1.0                           # no weight
    got = FS.fused_scores_plain(*map(torch.from_numpy, (q, emb, ok)),
                                0.5, 0.5).numpy()
    assert got[0] == pytest.approx(1.0, abs=1e-6)
    assert np.all(got[1:] < -1e29)
    for dtype in ("float32", "bfloat16"):
        q, e, ok, want = chip_smoke.k12_rule_inputs(dtype, device="cpu")
        thr = chip_smoke.K12_RULE_THRESHOLD
        ref = np.asarray(pallas_fused_scores(
            jnp.asarray(q.numpy()), jnp.asarray(e.float().numpy(),
                                                dtype), jnp.asarray(
                ok.numpy()), jnp.float32(0.5), jnp.float32(0.5),
            threshold=thr, blk=128, interpret=True))
        np.testing.assert_array_equal(ref, want.numpy())
        runtime.reset_counts()
        chip_smoke.check_k12_rules(dtype, FS.fused_scores_kernel(
            q, e, ok, 0.5, 0.5, threshold=thr), want)
        assert set(runtime.COUNTS.values()) == {0}


def _emulate_k12(q, emb, ok, wa, wb, threshold, fault=None):
    """K12's arithmetic in float64 sums (so only the order and precision
    of the dot products differ from the plain version), and on request
    the fault ">=": the threshold compared with >=."""
    sims = torch.einsum("npd,d->np", emb.double(), q.double()).float()
    w = torch.tensor([wa, wb], dtype=torch.float32)
    eff = w * ok.float()
    total = eff.sum(-1)
    eff = eff / total.clamp(min=1e-30)[:, None]
    score = (eff * sims).sum(-1)
    over = score >= threshold if fault == ">=" else score > threshold
    valid = (sims > 0).any(-1) & (total > 0) & over
    return torch.where(valid, score, torch.full_like(score, -1e30))


@pytest.mark.parametrize("fault", [None, ">="])
def test_k12_card_checks_reject_the_ge_fault(fault):
    """chip_smoke's K12 checks: float64 sums with the kernel's rules pass
    on random rows (N=20000, both dtypes) and on the rule rows; a kernel
    comparing with >= fails on the rule rows (random rows almost never
    land exactly on the threshold)."""
    for dtype in ("float32", "bfloat16"):
        q, e, ok = chip_smoke.k12_inputs(20000, dtype, device="cpu")
        chip_smoke.check_k12(dtype, _emulate_k12(q, e, ok, 0.6, 0.4, 0.1,
                                                 fault), q, e, ok, 0.6, 0.4)
        q, e, ok, want = chip_smoke.k12_rule_inputs(dtype, device="cpu")
        got = _emulate_k12(q, e, ok, 0.5, 0.5,
                           chip_smoke.K12_RULE_THRESHOLD, fault)
        if fault is None:
            chip_smoke.check_k12_rules(dtype, got, want)
        else:
            with pytest.raises(AssertionError, match="validity rules"):
                chip_smoke.check_k12_rules(dtype, got, want)


def test_k12_check_rejects_scores_and_order_off():
    """check_k12 rejects a score 2e-5 off on a valid row, and check_topk a
    swap of two well-separated ranks."""
    q, e, ok = chip_smoke.k12_inputs(5000, "float32", device="cpu")
    ref = FS.fused_scores_plain(q, e, ok, 0.6, 0.4)
    bad = ref.clone()
    i = int(torch.argmax(ref))
    bad[i] += 2e-5
    with pytest.raises(AssertionError, match="score err"):
        chip_smoke.check_k12("K12", bad, q, e, ok, 0.6, 0.4)
    order = torch.sort(ref, descending=True, stable=True)[1]
    bad = ref.clone()
    bad[order[0]], bad[order[1]] = ref[order[1]], ref[order[0]]
    with pytest.raises(AssertionError, match="rank"):
        chip_smoke.check_topk("K12", bad, ref)


# ------------------------------------------------ index dtype, batches
def _stores(rng, n=300, d=32):
    """A JAX store and a port store with the same rows."""
    stores = JStore(embed_dim=d, keep_audio=False), \
        SegmentStore(embed_dim=d, keep_audio=False)
    for i in range(n):
        a = rng.normal(size=d) if i % 5 else None
        b = rng.normal(size=d) if i % 7 else None
        for st in stores:
            st.add({"segment_id": f"s{i}", "asr_text": f"t{i}"}, a, b)
    return stores


def test_bf16_device_index_bit_equal_to_jax(rng):
    jst, st = _stores(rng)
    jemb, jok = jst.device_index("bfloat16")
    emb, ok = st.device_index(CPU, torch.bfloat16)
    assert emb.dtype == torch.bfloat16 and emb.shape == jemb.shape
    np.testing.assert_array_equal(emb.view(torch.int16).numpy(),
                                  np.asarray(jemb).view(np.int16))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_host_index_matches_jax(rng):
    jst, st = _stores(rng, n=40)
    for padded in (False, True):
        for a, b in zip(st.host_index(padded), jst.host_index(padded)):
            np.testing.assert_array_equal(a, b)
    assert st.host_index()[0].shape == (40, 2, 32)


def test_normalize_matches_jax(rng):
    x = rng.normal(size=(5, 7)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(
        F.normalize(torch.from_numpy(x)).numpy(),
        np.asarray(JF.normalize(jnp.asarray(x))), atol=1e-7)


def test_bf16_fused_topk_matches_jax(rng):
    """fused_topk over the bf16 index (3000 rows): scores within 1e-5 of
    the JAX package's, the top-10 identical where the gaps allow."""
    jst, st = _stores(rng, n=3000, d=64)
    q = rng.normal(size=64).astype(np.float32)
    q /= np.linalg.norm(q)
    jemb, jok = jst.device_index("bfloat16")
    emb, ok = st.device_index(CPU, torch.bfloat16)
    ref = JF.fused_topk(jnp.asarray(q), jemb, jok, jnp.float32(0.6),
                        jnp.float32(0.4), k=10)
    got = F.fused_topk(torch.from_numpy(q), emb, ok, 0.6, 0.4, k=10)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=TOL)
    jmask = np.asarray(JF.fused_scores(jnp.asarray(q), jemb, jok,
                                       jnp.float32(0.6),
                                       jnp.float32(0.4))[0])
    full = F.fused_scores(torch.from_numpy(q), emb, ok, 0.6, 0.4)[0]
    chip_smoke.check_topk("bf16 top-10", full, torch.tensor(jmask))
    np.testing.assert_allclose(got["sims"].numpy(), np.asarray(ref["sims"]),
                               atol=TOL)
    assert int(got["num_valid"]) == int(ref["num_valid"])


class HashEmbedder:
    """tests/test_fusion_search.py's hash embedding, as a device embedder:
    each text maps to one stored ASR row."""

    device = CPU

    def __init__(self, emb):
        self.emb = emb

    def embed_device(self, texts):
        return torch.from_numpy(np.stack(
            [self.emb[zlib.crc32(t.encode()) % len(self.emb), 0]
             for t in texts]))


def test_search_batch_matches_singles(rng):
    """Batched queries == single searches (the port's mirror of
    tests/test_fusion_search.py::test_search_batch_matches_singles)."""
    d = 32
    store = SegmentStore(embed_dim=d, keep_audio=False)
    emb = rng.normal(size=(40, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    for i in range(40):
        store.add({"segment_id": f"s{i}"}, emb[i, 0], emb[i, 1])
    s = FusionSearcher(store, HashEmbedder(emb))
    queries = ["music with drums", "someone speaking", "guitar solo"]
    batch = s.search_batch(queries, k=5)
    assert len(batch) == 3
    for q, (results, info) in zip(queries, batch):
        single, sinfo = s(q, 5)
        assert [r["index"] for r in results] == [r["index"] for r in single]
        assert [r["fusion_score"] for r in results] == pytest.approx(
            [r["fusion_score"] for r in single])
        assert info["asr_weight"] == sinfo["asr_weight"]
        assert info["query"] == q
    assert s.search_batch([]) == []
    assert FusionSearcher(SegmentStore(embed_dim=d), HashEmbedder(emb)) \
        .search_batch(["x", "y"]) == [([], {}), ([], {})]


def test_index_dtype_plumbing(rng):
    """FusionConfig.index_dtype routes the searcher's device index (the
    port's mirror of tests/test_fusion_search.py::
    test_index_dtype_plumbing); any other value is refused."""
    d = 16
    store = SegmentStore(embed_dim=d, keep_audio=False)
    for i in range(12):
        e = rng.normal(size=d)
        store.add({"asr_text": f"t{i}", "audio_description": f"c{i}",
                   "start_time": float(i), "source": "s"}, e, e)
    rows = store.embeddings[:, 0]

    class Embed:
        device = CPU

        def embed_device(self, texts):
            return torch.from_numpy(np.stack([rows[3]] * len(texts)))

    s16 = FusionSearcher(store, Embed(),
                         cfg=FusionConfig(index_dtype="bfloat16"))
    hits, _ = s16("query words")
    emb, _ = store.device_index(CPU, torch.bfloat16)
    assert emb.dtype == torch.bfloat16 and s16.index_dtype == torch.bfloat16
    assert len(hits) > 0 and hits[0]["index"] == 3
    s32 = FusionSearcher(store, Embed())
    hits32, _ = s32("query words")
    emb32, _ = store.device_index(CPU, torch.float32)
    assert emb32.dtype == torch.float32 and len(hits32) > 0
    with pytest.raises(NotImplementedError, match="index_dtype"):
        FusionSearcher(store, Embed(), cfg=FusionConfig(index_dtype="int8"))


@pytest.fixture(scope="module")
def engines():
    from test_torch_slice import _make_engines
    return _make_engines()


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_engine_search_batch_matches_jax(engines, rng, tmp_path,
                                         index_dtype):
    """A toy JAX engine and the port's on the same weights ingest the same
    clip; engines on their pipelines and stores with ``index_dtype`` then
    answer search_batch alike (ids equal, scores within 2e-5, the
    engines' own bar), and each batch row equals the engine's search."""
    from test_torch_slice import SR, _pieces
    from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    jeng, teng = engines
    if len(teng.store) == 0:
        wave = _pieces(rng, 65)
        jeng.ingest_waveform(wave, SR, "clip")
        teng.ingest_waveform(wave, SR, "clip")
    j = JEngine(cfg=jeng.cfg.replace(fusion=dataclasses.replace(
        jeng.cfg.fusion, index_dtype=index_dtype)),
        ingest_pipeline=jeng.ingest_pipeline, store=jeng.store)
    t = AudioSearchEngine(cfg=teng.cfg.replace(fusion=dataclasses.replace(
        teng.cfg.fusion, index_dtype=index_dtype)),
        ingest_pipeline=teng.ingest_pipeline, store=teng.store)
    texts = [m["asr_text"] for m in t.store.meta if m["asr_text"]]
    queries = [texts[0], texts[-1], "upbeat music with drums",
               "someone speaking clearly"]
    tb, jb = t.search_batch(queries), j.search_batch(queries)
    assert len(tb) == len(jb) == len(queries)
    for q, (th, ti), (jh, ji) in zip(queries, tb, jb):
        assert [h["index"] for h in th] == [h["index"] for h in jh], q
        assert [h["fusion_score"] for h in th] == pytest.approx(
            [h["fusion_score"] for h in jh], abs=2e-5)
        assert ti["asr_weight"] == ji["asr_weight"] and ti["query"] == q
        single, _ = t.search(q)
        assert [h["index"] for h in single] == [h["index"] for h in th]
    stats = t.stats.pipelines["search_pipeline"]
    assert stats.total_items >= len(queries)


def test_bench_tool_needs_a_card():
    """tools/torch_bench_search_scale.py defaults to cuda and raises
    without a card (here: no CUDA); the launches chip_smoke expects from
    it follow from its constants."""
    tool = chip_smoke.load_tool("torch_bench_search_scale")
    with pytest.raises(RuntimeError):
        tool.run(sizes=[1000], dtypes=["float32"], emit=lambda s: None)
    assert tool.K12_LAUNCHES_PER_ROW == 2 * (tool.WARMUP + tool.REPS)
    e, ok = tool.make_index(50, torch.bfloat16, "cpu")
    assert e.dtype == torch.bfloat16 and ok.dtype == torch.bool
    np.testing.assert_allclose(e.float().norm(dim=-1).numpy(), 1.0,
                               atol=1e-2)
    assert math.isclose(float(ok.float().mean()), 0.8, abs_tol=0.15)
