"""Streaming ingest, the CLI and the server under load, on the port, at
toy widths on the CPU (the weights of tests/test_torch_slice.py::
_make_engines).

* a stream fed in uneven chunks commits the one-shot path's windows on
  the port, and the same records as the JAX package's stream; its
  autosave writes the sharded layout both packages load;
* ``cli.main`` (``_engine`` patched to a CPU engine): ingest, search,
  search --strategy, delete and stats on one --index directory;
* concurrent ingest, search and delete through the port's server;
* bounded memory: 30 ingest/delete cycles through the server, traced
  with tracemalloc.
"""
import io
import json
import pathlib
import sys
import threading
import tracemalloc
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.index.store import SegmentStore as JStore
from multimodal_audio_search_tpu.pipelines.streaming import (
    StreamingIngest as JStream)
from multimodal_audio_search_tpu_torch import AudioSearchEngine, cli
from multimodal_audio_search_tpu_torch.audio.wav import write_wav
from multimodal_audio_search_tpu_torch.index.store import SegmentStore
from multimodal_audio_search_tpu_torch.pipelines.streaming import (
    StreamingIngest)
from multimodal_audio_search_tpu_torch.service.server import serve
from tests.test_torch_slice import SR, _make_engines, _pieces

torch.set_num_threads(1)
# bytes a cycle the traced heap may grow over the last 20 of 30 ingest/
# delete cycles: the operation log gains one event a cycle (~0.7 KB; it
# is capped at 100k events by design), nothing else should stay
GROWTH_BYTES_PER_CYCLE = 4096


@pytest.fixture(scope="module")
def engines():
    return _make_engines()


def _engine_like(teng):
    """A port engine on ``teng``'s pipelines with an empty store."""
    return AudioSearchEngine(
        cfg=teng.cfg, ingest_pipeline=teng.ingest_pipeline,
        store=SegmentStore(embed_dim=teng.cfg.embed_dim))


def _stream(cls, ing, store, cfg, wave, cuts, **kw):
    s = cls(ing, store, cfg, source_name="live", **kw)
    got = []
    for lo, hi in zip(cuts, cuts[1:]):
        got += s.feed(wave[lo:hi], SR)
    return got, s.flush()


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_matches_one_shot_and_jax(engines, seed):
    jeng, teng = engines
    wave = np.clip(_pieces(np.random.default_rng(seed), 35), -0.9, 0.9)
    r = np.random.default_rng(10 + seed)
    cuts = np.unique(np.concatenate([[0, len(wave)], r.integers(
        1, len(wave), size=6)])).tolist()
    ing = teng.ingest_pipeline
    ref = ing.process_waveform(wave[: 3 * 10 * SR], SR, "live")
    # the same one-shot call on JAX keeps the segment counters in step
    jeng.ingest_pipeline.process_waveform(wave[: 3 * 10 * SR], SR, "live")
    got, tail = _stream(StreamingIngest, ing, SegmentStore(embed_dim=64),
                        teng.cfg, wave, cuts)
    jgot, jtail = _stream(JStream, jeng.ingest_pipeline, JStore(
        embed_dim=64), jeng.cfg, wave, cuts)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        for key in ("start_time", "end_time", "asr_text",
                    "audio_description"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["asr_embedding"], b["asr_embedding"],
                                   atol=1e-6)
    assert [t["start_time"] for t in tail] == [30.0]
    for a, b in zip(got + tail, jgot + jtail):
        for key in ("segment_id", "start_time", "end_time", "asr_text",
                    "audio_description"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["asr_embedding"], b["asr_embedding"],
                                   atol=2e-5)


def test_stream_autosave_loads_in_both(engines, tmp_path):
    _, teng = engines
    store = SegmentStore(embed_dim=64)
    p = tmp_path / "auto"
    wave = _pieces(np.random.default_rng(3), 25)
    got, tail = _stream(StreamingIngest, teng.ingest_pipeline, store,
                        teng.cfg, wave, [0, 7 * SR, 21 * SR, len(wave)],
                        autosave_path=p, autosave_every=1)
    assert len(store) == len(got) + len(tail) == 3
    # one shard for the two windows the second chunk completes, one for
    # the tail the close commits
    assert json.loads((p / "manifest.json").read_text())["shards"] == 2
    for cls in (SegmentStore, JStore):
        back = cls.load(p)
        assert back.meta == store.meta
        np.testing.assert_array_equal(back.embeddings, store.embeddings)


def test_cli_roundtrip_strategy_and_delete(engines, tmp_path, monkeypatch,
                                          capsys):
    _, teng = engines

    def cpu_engine(args):
        eng = _engine_like(teng)
        if args.index and any((pathlib.Path(args.index) / f).exists() for f
                              in ("embeddings.npz", "emb.npy",
                                  "manifest.json")):
            eng.load_index(args.index)
        return eng

    monkeypatch.setattr(cli, "_engine", cpu_engine)
    wavs = []
    for name, seconds in (("a.wav", 25), ("b.wav", 15)):
        p = tmp_path / name
        write_wav(str(p), _pieces(np.random.default_rng(len(wavs)),
                                  seconds), SR)
        wavs.append(str(p))
    idx = str(tmp_path / "idx")
    assert cli.main(["--index", idx, "ingest", *wavs]) == 0
    out = capsys.readouterr().out
    assert "2 file(s): 5 segments (index total 5)" in out
    assert (pathlib.Path(idx) / "embeddings.npz").exists()
    # --index after the subcommand, and the mmap layout
    SegmentStore.load(idx).save(idx, mmap=True)
    assert cli.main(["search", "music", "-k", "3", "--index", idx]) == 0
    res = json.loads(capsys.readouterr().out)
    assert "asr_weight" in res["weight_info"] and len(res["results"]) <= 3
    assert cli.main(["--index", idx, "search", "music",
                     "--strategy", "fixed_5050"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["weight_info"]["strategy"] == "fixed_5050"
    assert {r["source"] for r in res["results"]} <= set(wavs)
    assert cli.main(["--index", idx, "delete", wavs[0]]) == 0
    assert "removed 3 segment(s) (index total 2)" in capsys.readouterr().out
    back = SegmentStore.load(idx)
    assert len(back) == 2 and {r["source"] for r in back.meta} == {wavs[1]}
    assert cli.main(["--index", idx, "stats"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["database"]["total_segments"] == 2
    with pytest.raises(SystemExit):
        with redirect_stdout(io.StringIO()):
            cli.main(["nope"])


def _server(teng, tmp_path):
    eng = _engine_like(teng)
    srv = serve(eng, host="127.0.0.1", port=0, block=False,
                data_root=tmp_path)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, eng, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_concurrent_ingest_search_delete(engines, tmp_path):
    """Ingests, deletes and searches racing through the port's server:
    every request answers, the store's arrays and meta agree, and the
    count is exact (the engine is only called under the server's
    lock)."""
    _, teng = engines
    srv, eng, url = _server(teng, tmp_path)
    data = [None] * 4
    for i in range(4):
        p = tmp_path / f"w{i}.wav"
        write_wav(str(p), _pieces(np.random.default_rng(i), 12), SR)
        data[i] = p.read_bytes()
    errors, kept = [], []
    victims = sum(len(_post(f"{url}/api/ingest?name=victim{i}", data[i])
                      ["segments"]) for i in range(2))
    removed = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — collected and asserted
            errors.append(repr(e))

    def ingest(i):
        kept.append(len(_post(f"{url}/api/ingest?name=keep{i}",
                              data[i])["segments"]))

    def delete(i):
        removed.append(_post(f"{url}/api/delete?source=victim{i}")
                       ["removed"])

    def search(i):
        with urllib.request.urlopen(f"{url}/api/search?q=probe+{i}",
                                    timeout=300) as r:
            for hit in json.loads(r.read())["results"]:
                assert hit["segment_id"].startswith("seg_")

    jobs = [lambda i=i: ingest(i) for i in range(4)]
    jobs += [lambda i=i: delete(i) for i in range(2)]
    jobs += [lambda i=i: search(i) for i in range(8)]
    before = len(eng.store)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.shutdown()
    assert not errors, errors
    assert sum(removed) == victims
    assert len(eng.store) == before - victims + sum(kept)
    assert eng.store.embeddings.shape[0] == len(eng.store.meta)
    assert not any(r["source"].startswith("victim") for r in eng.store.meta)


def test_ingest_delete_cycles_bounded_memory(engines, tmp_path):
    """30 cycles of an HTTP ingest and a delete of the same file: the
    traced heap grows by at most GROWTH_BYTES_PER_CYCLE a cycle over the
    last 20 (the first 10 settle caches and buffers)."""
    _, teng = engines
    srv, eng, url = _server(teng, tmp_path)
    p = tmp_path / "cycle.wav"
    write_wav(str(p), _pieces(np.random.default_rng(5), 25), SR)
    data = p.read_bytes()
    sizes = []
    tracemalloc.start()
    try:
        for _ in range(30):
            n = len(_post(f"{url}/api/ingest?name=cycle.wav", data)
                    ["segments"])
            assert _post(f"{url}/api/delete?source=cycle.wav")["removed"] \
                == n == 3
            sizes.append(tracemalloc.get_traced_memory()[0])
    finally:
        tracemalloc.stop()
        srv.shutdown()
    assert len(eng.store) == 0
    per_cycle = (sizes[-1] - sizes[9]) / 20
    assert per_cycle <= GROWTH_BYTES_PER_CYCLE, (per_cycle, sizes)
