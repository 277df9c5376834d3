"""The port's v1 CLAP path (models/clap.py, pipelines/clap_ingest.py) and
the bridge's forward pass (ops/audio_features.py, models/bridge.py)
against the JAX package's, on the CPU at float32 and the same weights
(the JAX init carried by weights.py): the ViT-on-mel audio tower, the
MiniLM text tower with its projection and the InfoNCE loss (value and
gradient) within 5e-5; ClapSearch on both packages over the same audio
(resampled input included): the same rows and times, embeddings and
scores within 1e-5, top-k indices identical, and the store saved by one
package loaded by the other; the DSP feature vector and the bridge
(dropout off) within 5e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.config import MelConfig as JMelConfig
from multimodal_audio_search_tpu.index.store import (
    SegmentStore as JSegmentStore)
from multimodal_audio_search_tpu.models import bridge as JB
from multimodal_audio_search_tpu.models import clap as JC
from multimodal_audio_search_tpu.models.minilm import (
    MiniLMConfig as JMiniLMConfig)
from multimodal_audio_search_tpu.ops.audio_features import (
    audio_feature_vector as j_features)
from multimodal_audio_search_tpu.pipelines.clap_ingest import (
    ClapSearch as JClapSearch)
from multimodal_audio_search_tpu_torch import weights
from multimodal_audio_search_tpu_torch.config import MelConfig
from multimodal_audio_search_tpu_torch.index.store import SegmentStore
from multimodal_audio_search_tpu_torch.models import bridge as B
from multimodal_audio_search_tpu_torch.models import clap as C
from multimodal_audio_search_tpu_torch.models.minilm import MiniLMConfig
from multimodal_audio_search_tpu_torch.ops.audio_features import (
    FEATURE_DIM, audio_feature_vector)
from multimodal_audio_search_tpu_torch.pipelines.clap_ingest import (
    ClapSearch)

torch.set_num_threads(1)
ACFG = dict(embed_dim=32, d_model=32, layers=2, heads=2, ffn=64,
            patch_frames=10, max_patches=1000)
TCFG = dict(vocab_size=256, hidden=32, layers=1, heads=2, intermediate=64)
QUERIES = ["loud music with drums", "someone speaking", "rain", "birds"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def towers():
    acfg = JC.ClapConfig(**ACFG)
    tcfg = JMiniLMConfig(**TCFG)
    from multimodal_audio_search_tpu.models.minilm import init_params
    return (JC.init_audio_tower(jax.random.PRNGKey(0), acfg),
            init_params(jax.random.PRNGKey(1), tcfg),
            JC.init_text_projection(jax.random.PRNGKey(2), tcfg, acfg))


def test_audio_tower_matches_jax(towers, rng):
    ja, _, _ = towers
    mel = rng.normal(size=(3, 80, 405)).astype(np.float32)   # 40 patches
    got = C.audio_embed(weights.clap_tower_params(_np(ja)),
                        torch.from_numpy(mel), C.ClapConfig(**ACFG)).numpy()
    want = np.asarray(JC.audio_embed(ja, jnp.asarray(mel),
                                     JC.ClapConfig(**ACFG)))
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_text_tower_and_loss_match_jax(towers, rng):
    """text_embed, contrastive_loss and its gradient (autograd against
    jax.grad) on the carried towers."""
    _, jt, jp = towers
    tt = weights.minilm_params(_np(jt))
    tp = weights.tree_to_torch(_np(jp))
    ids = rng.integers(0, 256, size=(4, 9))
    mask = np.ones_like(ids)
    mask[2, 5:] = 0
    tz = C.text_embed(tt, tp, torch.from_numpy(ids), torch.from_numpy(mask),
                      MiniLMConfig(**TCFG), C.ClapConfig(**ACFG))
    jz = JC.text_embed(jt, jp, jnp.asarray(ids), jnp.asarray(mask),
                       JMiniLMConfig(**TCFG), JC.ClapConfig(**ACFG))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=5e-5)
    az = rng.normal(size=(4, 32)).astype(np.float32)
    az /= np.linalg.norm(az, axis=-1, keepdims=True)
    a = torch.from_numpy(az).requires_grad_(True)
    loss = C.contrastive_loss(a, tz)
    loss.backward()
    jloss, jgrad = jax.value_and_grad(JC.contrastive_loss)(
        jnp.asarray(az), jz)
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=5e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgrad), atol=5e-5)
    logits = torch.from_numpy(rng.normal(size=(5, 5)).astype(np.float32))
    labels = torch.tensor([0, 3, 2, 1, 4])
    assert float(C.optax_softmax_ce(logits, labels)) == pytest.approx(
        float(JC.optax_softmax_ce(jnp.asarray(logits.numpy()),
                                  jnp.asarray(labels.numpy()))), abs=5e-5)


@pytest.fixture(scope="module")
def searches(towers):
    ja, jt, jp = towers
    kw = dict(chunk_seconds=4.0, min_seconds=1.0)
    js = JClapSearch(audio_params=ja, text_params=jt, proj_params=jp,
                     acfg=JC.ClapConfig(**ACFG), tcfg=JMiniLMConfig(**TCFG),
                     **kw)
    ts = ClapSearch(audio_params=weights.clap_tower_params(_np(ja)),
                    text_params=weights.minilm_params(_np(jt)),
                    proj_params=weights.tree_to_torch(_np(jp)),
                    acfg=C.ClapConfig(**ACFG), tcfg=MiniLMConfig(**TCFG),
                    device="cpu", **kw)
    rng = np.random.default_rng(7)
    t = np.arange(16000 * 10) / 16000
    clips = [
        ("a", (0.3 * np.sin(2 * np.pi * 220 * t[: int(16000 * 9.5)])
               + rng.normal(size=int(16000 * 9.5)) * 0.05), 16000),
        ("b", rng.normal(size=int(16000 * 8.5)) * 0.3, 16000),
        ("8k", rng.normal(size=8000 * 5) * 0.2, 8000)]     # resampled
    rows = [(ts.ingest_waveform(x.astype(np.float32), sr, name),
             js.ingest_waveform(x.astype(np.float32), sr, name))
            for name, x, sr in clips]
    return js, ts, rows


def test_clap_search_rows_match_jax(searches):
    """The >= 1 s keep rule (9.5 s -> 3 chunks, 8.5 s -> 2, 5 s at 8 kHz
    -> 2), the same rows, times and metadata, 512-D-style rows in the
    AUDIO slot within 1e-5 of JAX's."""
    js, ts, rows = searches
    assert [len(t) for t, _ in rows] == [3, 2, 2]
    assert [t for t, _ in rows] == [j for _, j in rows]
    assert ts.store.meta == js.store.meta
    assert ts.store.meta[2]["end_time"] == pytest.approx(9.5)
    np.testing.assert_array_equal(ts.store.success, js.store.success)
    assert not ts.store.success[:, 0].any() and ts.store.success[:, 1].all()
    np.testing.assert_allclose(ts.store.embeddings, js.store.embeddings,
                               atol=1e-5)


@pytest.mark.parametrize("query", QUERIES)
def test_clap_search_matches_jax(searches, query):
    js, ts, _ = searches
    got, want = ts.search(query, k=5), js.search(query, k=5)
    assert [h["index"] for h in got] == [h["index"] for h in want]
    for a, b in zip(got, want):
        assert a["similarity"] == pytest.approx(b["similarity"], abs=1e-5)
        assert {k: v for k, v in a.items() if k != "similarity"} == \
            {k: v for k, v in b.items() if k != "similarity"}
    # the plain scoring of the store's rows (a stable descending sort)
    q = ts.embed_query(query).numpy()
    scores = ts.store.embeddings[:, 1] @ q
    assert [h["index"] for h in got] == \
        [int(i) for i in np.argsort(-scores, kind="stable")[:5]]


def test_clap_search_ties_keep_index_order(searches):
    """Equal scores rank by index, lax.top_k's rule: a store holding one
    row three times returns the three copies in order."""
    js, ts, _ = searches
    st = SegmentStore(embed_dim=32, keep_audio=False)
    e = ts.store.embeddings[0, 1]
    for i in range(3):
        st.add({"source": "x", "start_time": float(i), "end_time": 1.0,
                "duration": 1.0, "asr_text": "", "audio_description": ""},
               None, e)
    ts2 = ClapSearch(audio_params=ts.audio_params, text_params=ts.text_params,
                     proj_params=ts.proj_params, acfg=ts.acfg, tcfg=ts.tcfg,
                     store=st, device="cpu")
    assert [h["index"] for h in ts2.search("anything", k=3)] == [0, 1, 2]


def test_clap_store_crosses_packages(searches, tmp_path):
    """A store saved by one package, loaded by the other, searched there,
    gives the saving package's hits."""
    js, ts, _ = searches
    ts.store.save(tmp_path / "t")
    js.store.save(tmp_path / "j")
    jload = JSegmentStore.load(tmp_path / "t")
    tload = SegmentStore.load(tmp_path / "j")
    np.testing.assert_array_equal(jload.embeddings, ts.store.embeddings)
    np.testing.assert_array_equal(tload.embeddings, js.store.embeddings)
    jx = JClapSearch(audio_params=js.audio_params,
                     text_params=js.text_params,
                     proj_params=js.proj_params, acfg=js.acfg,
                     tcfg=js.tcfg, store=jload)
    tx = ClapSearch(audio_params=ts.audio_params, text_params=ts.text_params,
                    proj_params=ts.proj_params, acfg=ts.acfg, tcfg=ts.tcfg,
                    store=tload, device="cpu")
    for q in QUERIES:
        assert [h["index"] for h in tx.search(q)] == \
            [h["index"] for h in js.search(q)]
        assert [h["index"] for h in jx.search(q)] == \
            [h["index"] for h in ts.search(q)]


def test_clap_search_empty_and_random_init():
    cs = ClapSearch(acfg=C.ClapConfig(**ACFG), tcfg=MiniLMConfig(**TCFG),
                    chunk_seconds=2.0, device="cpu")
    assert cs.search("x") == []
    assert cs.ingest_waveform(np.zeros(8000, np.float32), 16000) == []
    rows = cs.ingest_waveform(np.random.default_rng(0).normal(
        size=16000 * 3).astype(np.float32), 16000)
    assert rows == [0, 1] and len(cs.search("x")) == 2
    with pytest.raises(RuntimeError):
        ClapSearch(acfg=C.ClapConfig(**ACFG), tcfg=MiniLMConfig(**TCFG))


def test_audio_feature_vector_matches_jax(rng):
    """A tone, noise and a tone in noise at 2 s: the 13 MFCCs, centroid,
    bandwidth and ZCR within 5e-5 (relative for the Hz-valued ones), zero
    padding past 17, and the features that must separate tone from noise
    do. Two features are ill-conditioned in float32 and held as stated:
    the pure tone's bandwidth weighs the far bins' magnitudes -- the
    float32 DFT's rounding, ~1e-7 of the peak -- by (f - centroid)^2 up
    to 6e7 Hz^2, and the two packages' DFT products round differently
    (1e-2 relative); the rolloff is a mean over frames of an argmax of a
    float32 cumulative sum against 0.85 of its total, summed in different
    orders, so a frame whose crossing lies within that rounding moves one
    bin (held to one bin in one frame)."""
    cfg = MelConfig(padded_seconds=2.0)
    t = np.arange(cfg.n_samples) / 16000
    tone = 0.5 * np.sin(2 * np.pi * 440 * t)
    noise = rng.normal(size=cfg.n_samples)
    x = np.stack([tone, 0.3 * noise, tone + 0.05 * noise]).astype(np.float32)
    got = audio_feature_vector(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(j_features(jnp.asarray(x),
                                 JMelConfig(padded_seconds=2.0)))
    assert got.shape == (3, FEATURE_DIM) and np.all(got[:, 17:] == 0)
    bandwidth, rolloff = 14, 15
    tol = np.full(got.shape, 5e-5)
    tol[0, bandwidth] = 1e-2
    err = np.abs(got - want) - tol * np.maximum(np.abs(want), 1.0)
    err[:, rolloff] = 0.0
    assert (err <= 0).all(), np.argwhere(err > 0)
    n_freqs, frames = cfg.n_fft // 2 + 1, cfg.n_samples // cfg.hop_length + 1
    one_bin = 8000.0 / (n_freqs - 1) / frames
    assert np.abs(got[:, rolloff] - want[:, rolloff]).max() <= \
        one_bin * (1 + 1e-4)
    assert got[0, 13] < got[1, 13] and got[0, 16] < got[1, 16]


def test_bridge_matches_jax(rng):
    """apply (dropout off) on JAX's init with a fitted scaler; dropout on
    draws from the caller's generator: reproducible, and off without
    one."""
    cfg = B.BridgeConfig()
    jp = JB.init_params(jax.random.PRNGKey(0), JB.BridgeConfig())
    jp["feat_mean"] = jnp.asarray(rng.normal(size=128).astype(np.float32))
    jp["feat_std"] = jnp.asarray(
        rng.uniform(0.5, 2.0, size=128).astype(np.float32))
    tp = weights.bridge_params(_np(jp))
    x = rng.normal(size=(4, 128)).astype(np.float32)
    got = B.apply(tp, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JB.apply(jp, jnp.asarray(x), JB.BridgeConfig())),
        atol=5e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert np.array_equal(
        B.apply(tp, torch.from_numpy(x), cfg, train=True).numpy(), got)
    d1, d2 = (B.apply(tp, torch.from_numpy(x), cfg, train=True,
                      generator=torch.Generator().manual_seed(3)).numpy()
              for _ in range(2))
    assert np.array_equal(d1, d2) and not np.allclose(d1, got)
    mine = B.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), mine)
    with pytest.raises(ValueError, match="top-level keys"):
        weights.bridge_params({"layers": tp["layers"]})
