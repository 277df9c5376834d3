"""The memory-mapped host index of the PyTorch package (index/bigindex.py)
against the JAX package on the CPU, and tools/torch_bench_ivf.py's logic.

A directory written by either package opens in the other, for float32,
bfloat16 and int8: ``emb.dat`` (and ``scale.dat``, ``success.dat``) bytes
identical, ``ivf.npz`` loaded across. Searches equal JAX's (ids
identical, scores at rtol 1e-6), the streamed search equals the port's
in-memory fused_topk, and ``search_ivf`` equals JAX's. The port needs no
``ml_dtypes``: a subprocess with it (and jax) blocked writes, reads and
searches a bfloat16 index.
"""
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.index import bigindex as JB
from multimodal_audio_search_tpu.index.fusion import fused_topk as j_topk
from multimodal_audio_search_tpu.index.store import SegmentStore as JStore
from multimodal_audio_search_tpu_torch.index import bigindex as TB
from multimodal_audio_search_tpu_torch.index.fusion import fused_topk
from multimodal_audio_search_tpu_torch.index.store import SegmentStore

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = ["float32", "bfloat16", "int8"]
FILES = ["emb.dat", "success.dat", "meta.jsonl"]


def make_stores(rng, n=700, d=48):
    """tests/test_bigindex.py's store, in both packages."""
    stores = JStore(embed_dim=d, keep_audio=False), \
        SegmentStore(embed_dim=d, keep_audio=False)
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ok = rng.random((n, 2)) > 0.25
    for i in range(n):
        for st in stores:
            st.add({"segment_id": f"s{i}", "asr_text": f"t{i}",
                    "start_time": float(i)},
                   emb[i, 0] if ok[i, 0] else None,
                   emb[i, 1] if ok[i, 1] else None)
    return stores, emb


def _files(p: pathlib.Path, dtype: str) -> list[str]:
    return FILES + (["scale.dat"] if dtype == "int8" else [])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_layout_both_ways(rng, tmp_path, dtype, writer):
    """A directory written by one package's build_host_index opens in the
    other: files byte-identical to the other's own build, searches equal
    (multi-chunk streams), and the writer's ivf.npz serves the reader's
    search_ivf with JAX's results."""
    (js, ts), emb = make_stores(rng)
    JB.build_host_index(js, tmp_path / "j", dtype=dtype)
    TB.build_host_index(ts, tmp_path / "t", dtype=dtype, device=CPU)
    for f in _files(tmp_path, dtype):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    src = tmp_path / ("j" if writer == "jax" else "t")
    jx = JB.HostIndex(src, chunk=256)
    pt = TB.HostIndex(src, chunk=256, device=CPU)
    assert len(pt) == len(jx) == 700 and pt.meta == jx.meta
    q = emb[123, 0]
    (s1, i1), (s2, i2) = pt.search(q, 0.7, 0.3), jx.search(q, 0.7, 0.3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    # the layout: built by the writer's package, read by both
    (jx if writer == "jax" else pt).build_ivf(n_clusters=12, seed=1)
    jx, pt = JB.HostIndex(src), TB.HostIndex(src, device=CPU)
    assert jx._ivf is not None and pt._ivf is not None
    for n_probe in (3, 12):
        a = pt.search_ivf(q, 0.6, 0.4, n_probe=n_probe)
        b = jx.search_ivf(q, 0.6, 0.4, n_probe=n_probe)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
        assert pt.last_query_candidates == jx.last_query_candidates


@pytest.mark.parametrize("dtype", DTYPES)
def test_streamed_equals_in_memory(rng, tmp_path, dtype):
    """The port's streamed search (4 chunks, the staging slots reused)
    equals its in-memory fused_topk over the same stored values, and JAX's
    in-memory search in float32."""
    (js, ts), emb = make_stores(rng)
    idx = TB.build_host_index(ts, tmp_path / "b", dtype=dtype, device=CPU)
    idx.chunk = 200
    if dtype == "bfloat16":
        e = torch.from_numpy(np.array(idx.emb).view(np.int16)) \
            .view(torch.bfloat16).float()
        ref_e, _ = ts.device_index(CPU, torch.bfloat16)
        assert torch.equal(e, ref_e[:700].float())   # the store's codes
    elif dtype == "int8":
        e = torch.from_numpy(np.array(idx.emb)).float() * \
            torch.from_numpy(np.array(idx.scale))[..., None]
    else:
        e = torch.from_numpy(np.array(idx.emb))
    ok = torch.from_numpy(np.array(idx.success))
    for row in (123, 9):
        q = emb[row, 0]
        ref = fused_topk(torch.from_numpy(q), e, ok, 0.7, 0.3, k=10)
        s, i = idx.search(q, 0.7, 0.3, k=10)
        np.testing.assert_array_equal(i, ref["indices"].numpy())
        np.testing.assert_allclose(s, ref["scores"].numpy(), rtol=1e-6)
    if dtype == "float32":
        jref = j_topk(jnp.asarray(q), jnp.asarray(js.embeddings),
                      jnp.asarray(js.success), jnp.float32(0.7),
                      jnp.float32(0.3), k=10)
        np.testing.assert_array_equal(i, np.asarray(jref["indices"]))
    recs = idx.records(i, s)
    assert recs[0]["segment_id"] == f"s{int(i[0])}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_writer_both_ways(rng, tmp_path, dtype):
    """HostIndexWriter: the port's and JAX's write the same bytes as
    build_host_index, chunk by uneven chunk, and a port-written index
    searches as JAX's writer's does."""
    (js, ts), emb = make_stores(rng, n=200)
    ok = np.asarray(ts.success[:200])
    full = np.asarray(ts.embeddings[:200], np.float32)
    TB.build_host_index(ts, tmp_path / "ref", dtype=dtype, device=CPU)
    w_t = TB.HostIndexWriter(tmp_path / "t", 200, 48, dtype=dtype)
    w_j = JB.HostIndexWriter(tmp_path / "j", 200, 48, dtype=dtype)
    for lo in range(0, 200, 64):
        for w in (w_t, w_j):
            w.append(full[lo:lo + 64], ok[lo:lo + 64],
                     ts.meta[lo:min(lo + 64, 200)])
    pt = w_t.finalize(chunk=64, device=CPU)
    jx = w_j.finalize(chunk=64)
    for f in _files(tmp_path, dtype):
        ref = (tmp_path / "ref" / f).read_bytes()
        assert (tmp_path / "t" / f).read_bytes() == ref, f
        assert (tmp_path / "j" / f).read_bytes() == ref, f
    q = emb[11, 0]
    (s1, i1), (s2, i2) = pt.search(q, 0.6, 0.4), jx.search(q, 0.6, 0.4)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    assert pt.meta[11]["segment_id"] == "s11"
    with pytest.raises(ValueError, match="sized for"):
        TB.HostIndexWriter(tmp_path / "x", 2, 48).append(full[:3], ok[:3])


def test_build_ivf_matches_jax(rng, tmp_path):
    """HostIndex.build_ivf on the same memmaps: JAX's buckets and spill,
    centroids within 1e-5."""
    (js, _), _ = make_stores(rng, n=400)
    JB.build_host_index(js, tmp_path / "b", dtype="int8")
    jx, pt = JB.HostIndex(tmp_path / "b"), \
        TB.HostIndex(tmp_path / "b", device=CPU)
    jx.build_ivf(n_clusters=12, seed=2, save=False)
    pt.build_ivf(n_clusters=12, seed=2, save=False)
    np.testing.assert_allclose(pt._ivf[0], np.asarray(jx._ivf[0]), atol=1e-5)
    np.testing.assert_array_equal(pt._ivf[1], jx._ivf[1])
    np.testing.assert_array_equal(pt._ivf[2], jx._ivf[2])


def test_stale_layout_rejected(rng, tmp_path):
    """A same-size rebuild at the same path drops the previous ivf.npz
    (build_id), in either package's reader."""
    (_, st_a), _ = make_stores(rng, n=200)
    TB.build_host_index(st_a, tmp_path / "b", device=CPU).build_ivf(
        n_clusters=8, seed=3)
    assert (tmp_path / "b" / "ivf.npz").exists()
    assert TB.HostIndex(tmp_path / "b", device=CPU)._ivf is not None
    (_, st_b), emb_b = make_stores(rng, n=200)
    TB.build_host_index(st_b, tmp_path / "b", device=CPU)
    assert not (tmp_path / "b" / "ivf.npz").exists()
    idx = TB.HostIndex(tmp_path / "b", device=CPU)
    idx.build_ivf(n_clusters=8, seed=4)
    # a layout of another build at this path is ignored by both readers
    saved = (tmp_path / "b" / "ivf.npz").read_bytes()
    (tmp_path / "b" / "index.json").write_text(
        (tmp_path / "b" / "index.json").read_text().replace(
            idx.build_id, "0" * 32))
    assert (tmp_path / "b" / "ivf.npz").read_bytes() == saved
    assert TB.HostIndex(tmp_path / "b", device=CPU)._ivf is None
    assert JB.HostIndex(tmp_path / "b")._ivf is None


def test_large_probe_falls_back_to_stream(rng, tmp_path):
    """Past max_candidate_bytes search_ivf is the chunk-streamed exact
    search, and reports the whole index as shipped."""
    (_, ts), emb = make_stores(rng, n=300)
    idx = TB.build_host_index(ts, tmp_path / "b", device=CPU)
    idx.chunk = 128
    idx.build_ivf(n_clusters=10, seed=5)
    idx.max_candidate_bytes = 1
    q = emb[9, 0]
    se, ie = idx.search(q, 0.6, 0.4, k=10)
    sa, ia = idx.search_ivf(q, 0.6, 0.4, k=10, n_probe=10)
    np.testing.assert_array_equal(ia, ie)
    np.testing.assert_allclose(sa, se, rtol=1e-6)
    assert idx.last_query_candidates == 300
    assert idx.last_query_bytes == idx.emb.nbytes + idx.success.nbytes


def test_candidate_bytes_exact(rng, tmp_path):
    """tests/test_bigindex.py's byte bound, with the port's exact count:
    last_query_bytes = the candidate rows x the bytes a row (no
    power-of-two padding), within JAX's padded bound, far under the
    index; the result equals JAX's search_ivf on the same layout."""
    n, d = 20_000, 48
    emb = rng.normal(size=(n, 2, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ok = rng.random((n, 2)) > 0.25
    emb[~ok] = 0.0
    w = TB.HostIndexWriter(tmp_path / "bb", n, d, dtype="int8")
    w.append(emb, ok)
    idx = w.finalize(chunk=4096, device=CPU)
    idx.build_ivf(n_clusters=64, seed=3)
    _, members, spill = idx._ivf
    s, gi = idx.search_ivf(emb[5, 0], 0.6, 0.4, k=10, n_probe=2)
    assert s.size and gi.size
    assert idx.row_bytes == 2 * d + 2 + 8          # int8 rows, ok, scales
    assert idx.last_query_bytes == idx.last_query_candidates * idx.row_bytes
    worst = 2 * members.shape[1] + spill.size
    b = 1024
    while b < worst:
        b *= 2
    assert idx.last_query_candidates <= worst
    assert idx.last_query_bytes <= b * (2 * d + 1 + 8)
    full = idx.emb.nbytes + idx.success.nbytes + idx.scale.nbytes
    assert idx.last_query_bytes < 0.05 * full
    jx = JB.HostIndex(tmp_path / "bb")
    assert jx._ivf is not None
    js, jgi = jx.search_ivf(emb[5, 0], 0.6, 0.4, k=10, n_probe=2)
    np.testing.assert_array_equal(gi, jgi)
    np.testing.assert_allclose(s, js, rtol=1e-6)
    assert jx.last_query_candidates == idx.last_query_candidates


def test_threshold_and_meta(rng, tmp_path):
    (_, ts), emb = make_stores(rng, n=64)
    idx = TB.build_host_index(ts, tmp_path / "b", device=CPU)
    s, i = idx.search(emb[0, 0], 0.5, 0.5, k=10, threshold=0.999)
    assert all(r["fusion_score"] > 0.999 for r in idx.records(i, s))
    assert "audio_data" not in idx.meta[0]


def test_host_index_refuses_a_missing_card(tmp_path, rng):
    """The default device is cuda; without a card opening raises, with no
    move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    (_, ts), _ = make_stores(rng, n=10)
    TB.build_host_index(ts, tmp_path / "b", device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.HostIndex(tmp_path / "b")


def test_bf16_without_ml_dtypes(tmp_path):
    """With ml_dtypes and jax blocked, the port writes, reads and searches
    a bfloat16 host index, its bits those of torch's round to nearest
    even."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None
        sys.modules["jax"] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        from multimodal_audio_search_tpu_torch.index import bigindex as TB
        rng = np.random.default_rng(0)
        emb = rng.normal(size=(300, 2, 16)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        ok = rng.random((300, 2)) > 0.2
        w = TB.HostIndexWriter({str(tmp_path / 'h')!r}, 300, 16,
                               dtype="bfloat16")
        w.append(emb, ok)
        idx = w.finalize(chunk=128, device="cpu")
        bits = torch.from_numpy(emb).to(torch.bfloat16).view(torch.int16)
        assert np.array_equal(np.asarray(idx.emb).view(np.int16),
                              bits.numpy())
        r = int(np.flatnonzero(ok.all(axis=1))[0])
        s, i = idx.search(emb[r, 0], 0.6, 0.4)
        sa, ia = idx.search_ivf(emb[r, 0], 0.6, 0.4, n_probe=1000)
        assert int(i[0]) == r and np.array_equal(i, ia)
        assert {{"ml_dtypes", "jax"}}.isdisjoint(
            m.split(".")[0] for m in sys.modules
            if sys.modules[m] is not None)
        print("OK", int(i[0]) == r)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK True")


# ---------------------------------------------------- the card's tool
def test_bench_tool_needs_a_card():
    """tools/torch_bench_ivf.py defaults to cuda and raises without one."""
    tool = chip_smoke.load_tool("torch_bench_ivf")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tool.run(rows=1000, emit=lambda s: None)


def test_bench_tool_logic_on_cpu():
    """The tool's two halves and checks, run on the CPU at 6000 rows (the
    5 % byte bound needs the card's 1M rows: lifted here)."""
    tool = chip_smoke.load_tool("torch_bench_ivf")
    lines = []
    with torch.inference_mode():
        res = tool.measure(lines.append, CPU, rows=6000, check_rows=2000,
                           chunk=1024, small_chunk=512, bytes_frac_max=1.0)
    assert res["full_probe"]["builds_identical"]
    assert res["full_probe"]["max_abs_err"]["bfloat16"] <= tool.TOL
    mem = res["in_memory"]
    assert [r["n_probe"] for r in mem["ivf"]] == list(tool.N_PROBES)
    assert all(0 <= r["recall10_vs_exact"] <= 1 for r in mem["ivf"])
    host = res["host_index"]
    assert set(host) == set(tool.STORAGE)
    f32 = host["float32"]
    assert f32["small_chunk_chunks"] == 12
    assert [r["n_probe"] for r in f32["ivf"]] == list(tool.HOST_PROBES)
    assert all(r["last_query_bytes"] == r["last_query_candidates"] * (
        2 * tool.DIM * 4 + 2) for r in f32["ivf"])
    assert host["int8"]["recall10_vs_float32"] >= 0.5
    assert len(lines) == 6


def test_same_topk_rejects_swaps_and_score_errors():
    """The tool's comparison: a swap of two well-separated ranks and a
    score 2e-5 off are caught; a swap inside a near tie is allowed."""
    tool = chip_smoke.load_tool("torch_bench_ivf")
    ref_s = np.array([0.9, 0.8, 0.700001, 0.700000, 0.5], np.float32)
    ref_i = np.array([4, 3, 2, 1, 0])
    tool.same_topk("tie", ref_s[:4], np.array([4, 3, 1, 2]), ref_s, ref_i,
                   k=4)
    with pytest.raises(AssertionError, match="rank 0"):
        tool.same_topk("swap", ref_s[:4], np.array([3, 4, 2, 1]), ref_s,
                       ref_i, k=4)
    bad = ref_s[:4].copy()
    bad[1] += 2e-5
    with pytest.raises(AssertionError, match="score err"):
        tool.same_topk("score", bad, ref_i[:4], ref_s, ref_i, k=4)
