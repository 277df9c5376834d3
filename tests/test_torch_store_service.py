"""The port's SegmentStore deletion and append-only persistence against
the JAX package's, on the CPU.

Counterparts of tests/test_store_delete.py and
tests/test_incremental_save.py on the port's store (compaction order,
the cached device index dropped by a delete, crash between shard and
manifest, orphan meta lines, a legacy manifest, the compaction refusal),
each also run on the JAX store with the same rows so the two must agree;
and the sharded directory written by either package loaded by the other.
"""
import json

import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.index.store import SegmentStore as JStore
from multimodal_audio_search_tpu_torch.index.store import SegmentStore

torch.set_num_threads(1)
CPU = torch.device("cpu")
STORES = {"port": SegmentStore, "jax": JStore}


def _store_with(cls, sources, seed=0):
    rng = np.random.default_rng(seed)
    st = cls(embed_dim=8)
    for i, src in enumerate(sources):
        e1 = rng.normal(size=8)
        e2 = rng.normal(size=8) if i % 3 else None
        st.add({"source": src, "start_time": float(i)}, e1, e2,
               audio_data=np.full(4, i, np.float32))
    return st


def _add(st, n, rng, src="s"):
    for _ in range(n):
        st.add({"source": src, "start_time": float(len(st))},
               rng.normal(size=8), rng.normal(size=8),
               audio_data=np.full(3, len(st), np.float32))


def _same_rows(a, b):
    assert a.meta == b.meta
    np.testing.assert_array_equal(a.embeddings, b.embeddings)
    np.testing.assert_array_equal(a.success, b.success)
    for i in range(len(a)):
        x, y = a.audio(i), b.audio(i)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- delete
def test_delete_source_compacts_and_preserves_order():
    srcs = ["a.wav", "b.wav", "a.wav", "c.wav", "b.wav", "a.wav"]
    st, ref = (_store_with(c, srcs) for c in (SegmentStore, JStore))
    survivors_emb = st.embeddings[[1, 3, 4]].copy()
    survivors_ok = st.success[[1, 3, 4]].copy()
    v0, c0 = st.version, st._compactions
    assert st.delete_source("a.wav") == ref.delete_source("a.wav") == 3
    assert len(st) == 3 and st.version == v0 + 1
    assert st._compactions == c0 + 1 == ref._compactions
    assert [r["source"] for r in st.meta] == ["b.wav", "c.wav", "b.wav"]
    np.testing.assert_array_equal(st.embeddings, survivors_emb)
    np.testing.assert_array_equal(st.success, survivors_ok)
    assert [int(st.audio(i)[0]) for i in range(3)] == [1, 3, 4]
    _same_rows(st, ref)
    assert st.version == ref.version
    assert st.delete_source("nope.wav") == 0 and st.version == v0 + 1


def test_delete_drops_the_cached_device_index():
    """A delete keeps the capacity bucket, the device index's cache key:
    the cached view must go, or a search after the delete scores the old
    rows against the new meta."""
    st = _store_with(SegmentStore, ["x", "y", "x", "y", "z"])
    emb0, ok0 = st.device_index(CPU)
    assert st.device_index(CPU)[0] is emb0          # cached
    st.delete_source("x")
    emb, ok = st.device_index(CPU)
    assert emb is not emb0 and emb.shape == emb0.shape
    np.testing.assert_array_equal(emb[:3].numpy(), st.embeddings)
    assert int(ok[3:].sum()) == 0
    # an equal-size regrow after the delete: the view follows the rows
    _add(st, 2, np.random.default_rng(1), src="w")
    emb, _ = st.device_index(CPU)
    np.testing.assert_array_equal(emb[:5].numpy(), st.embeddings)


def test_delete_then_save_load_roundtrip(tmp_path):
    st = _store_with(SegmentStore, ["x", "y", "x", "y"])
    st.delete_source("x")
    st.save(tmp_path / "idx")
    for cls in (SegmentStore, JStore):
        back = cls.load(tmp_path / "idx")
        assert [r["source"] for r in back.meta] == ["y", "y"]
        _same_rows(back, st)


# --------------------------------------------------- incremental save
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_incremental_roundtrip_both_ways(tmp_path, writer):
    """A sharded directory written by one package loads in the other, and
    the manifests agree field for field."""
    rng = np.random.default_rng(0)
    st = STORES[writer](embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 5, rng)
    assert st.save_incremental(p) == 5
    _add(st, 3, rng)
    assert st.save_incremental(p) == 3
    assert st.save_incremental(p) == 0
    manifest = json.loads((p / "manifest.json").read_text())
    assert manifest["rows"] == 8 and manifest["shards"] == 2
    assert manifest["meta_bytes"] == (p / "meta.jsonl").stat().st_size
    for cls in STORES.values():
        _same_rows(cls.load(p), st)
    # the same rows through the other package give the same manifest
    rng = np.random.default_rng(0)
    other = STORES["jax" if writer == "port" else "port"](embed_dim=8)
    q = tmp_path / "other"
    _add(other, 5, rng)
    other.save_incremental(q)
    _add(other, 3, rng)
    other.save_incremental(q)
    assert json.loads((q / "manifest.json").read_text()) == manifest
    assert (q / "meta.jsonl").read_bytes() == (p / "meta.jsonl").read_bytes()


def test_load_shards_restores_compactions(tmp_path):
    """A store reloaded from a sharded directory keeps the compaction
    count its manifest recorded, so its next incremental save matches."""
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    _add(st, 3, rng, src="a")
    _add(st, 2, rng, src="b")
    st.delete_source("a")
    p = tmp_path / "idx"
    assert st.save_incremental(p) == 2
    for cls in STORES.values():
        back = cls.load(p)
        assert back._compactions == 1
        _add(back, 1, rng, src="c")
        assert back.save_incremental(tmp_path / cls.__module__) == 3


def test_crash_between_shard_and_manifest(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 4, rng)
    st.save_incremental(p)
    _add(st, 2, rng)
    np.save(p / "emb.shard-00001.npy", st.embeddings[4:6])
    np.save(p / "success.shard-00001.npy", st.success[4:6])
    with open(p / "meta.jsonl", "a") as f:
        for row in st.meta[4:6]:
            f.write(json.dumps(row) + "\n")
    assert len(SegmentStore.load(p)) == len(JStore.load(p)) == 4
    assert st.save_incremental(p) == 2
    _same_rows(SegmentStore.load(p), st)
    _same_rows(JStore.load(p), st)


def test_orphan_meta_never_shadows_new_rows(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 4, rng, src="before")
    st.save_incremental(p)
    _add(st, 2, rng, src="orphan")
    np.save(p / "emb.shard-00001.npy", st.embeddings[4:6])
    np.save(p / "success.shard-00001.npy", st.success[4:6])
    with open(p / "meta.jsonl", "a") as f:
        for row in st.meta[4:6]:
            f.write(json.dumps(row) + "\n")
    st2 = SegmentStore.load(p)
    assert len(st2) == 4
    _add(st2, 3, rng, src="after")
    assert st2.save_incremental(p) == 3
    st3 = SegmentStore.load(p)
    assert [r["source"] for r in st3.meta] == ["before"] * 4 + ["after"] * 3
    np.testing.assert_array_equal(st3.embeddings, st2.embeddings)
    _same_rows(JStore.load(p), st3)


def test_legacy_manifest_without_meta_bytes(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 3, rng, src="a")
    st.save_incremental(p)
    manifest = p / "manifest.json"
    state = json.loads(manifest.read_text())
    del state["meta_bytes"]
    manifest.write_text(json.dumps(state))
    with open(p / "meta.jsonl", "a") as f:
        f.write(json.dumps({"source": "orphan"}) + "\n")
    _add(st, 2, rng, src="b")
    assert st.save_incremental(p) == 2
    st2 = SegmentStore.load(p)
    assert [r["source"] for r in st2.meta] == ["a"] * 3 + ["b"] * 2
    assert "meta_bytes" in json.loads(manifest.read_text())


def test_meta_shorter_than_manifest_refused(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 3, rng)
    st.save_incremental(p)
    data = (p / "meta.jsonl").read_bytes()
    (p / "meta.jsonl").write_bytes(data[: len(data) // 2])
    _add(st, 1, rng)
    with pytest.raises(ValueError, match="lost data"):
        st.save_incremental(p)


def test_full_save_clears_stale_audio(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    _add(st, 2, rng, src="a")
    p = tmp_path / "idx"
    st.save(p)
    assert (p / "audio.npz").exists()
    st.delete_source("a")
    for _ in range(2):
        st.add({"source": "b"}, rng.normal(size=8), rng.normal(size=8),
               audio_data=None)
    st.save(p)
    assert not (p / "audio.npz").exists()
    st2 = SegmentStore.load(p)
    assert len(st2) == 2 and st2.audio(0) is None


@pytest.mark.parametrize("cls", ["port", "jax"])
def test_delete_then_regrow_refuses_incremental(tmp_path, cls):
    """Save 4 rows, delete 2, add 3: the store is larger than the saved
    prefix but its early rows no longer match the disk. Both packages
    refuse, and a full save recovers."""
    rng = np.random.default_rng(0)
    st = STORES[cls](embed_dim=8)
    _add(st, 2, rng, src="a")
    _add(st, 2, rng, src="b")
    p = tmp_path / "idx"
    st.save_incremental(p)
    st.delete_source("a")
    _add(st, 3, rng, src="c")
    with pytest.raises(ValueError, match="compacted"):
        st.save_incremental(p)
    st.save(p)
    assert [r["source"] for r in SegmentStore.load(p).meta] == \
        ["b", "b", "c", "c", "c"]
    p2 = tmp_path / "idx2"
    assert st.save_incremental(p2) == 5
    _add(st, 1, rng, src="d")
    assert st.save_incremental(p2) == 1
    assert len(SegmentStore.load(p2)) == len(JStore.load(p2)) == 6


def test_full_save_supersedes_shards(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 4, rng)
    st.save_incremental(p)
    st.delete_source("s")
    with pytest.raises(ValueError):
        st.save_incremental(p)
    st.save(p)
    assert not (p / "manifest.json").exists()
    assert not list(p.glob("*.shard-*.np*"))
    assert len(SegmentStore.load(p)) == 0


def test_incremental_refuses_full_layout(tmp_path):
    rng = np.random.default_rng(0)
    st = SegmentStore(embed_dim=8)
    p = tmp_path / "idx"
    _add(st, 2, rng)
    st.save(p)
    with pytest.raises(ValueError, match="full-save layout"):
        st.save_incremental(p)
