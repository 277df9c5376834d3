"""The port's HTTP server against the JAX package's, on the CPU at toy
widths and the same weights (tests/test_torch_slice.py::_make_engines).

Both servers run on port 0 over their engine and receive the same
request sequence: ingest (sync, async with its job record), single,
batched and strategy searches, segments, audio, the config, delete,
save, load and reset, a stream's open/chunk/close, the metrics routes
and the bad requests (junk upload, unknown route, a path outside the
data root, a missing token while one is set, a full queue). Status codes
must be identical, and the JSON bodies the same once timing fields, ids
and data-root paths are taken out: texts identical, top-10 indices
identical (rows with the same texts may trade places), scores within
2e-5; an error's message is only required to be there. POST /api/config
with each embedder choice answers 200 on both servers, which then
ingest and search alike."""
import csv
import io
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.service import server as jserver
from multimodal_audio_search_tpu_torch.audio.wav import write_wav
from multimodal_audio_search_tpu_torch.index.strategies import STRATEGIES
from multimodal_audio_search_tpu_torch.service import server as tserver
from tests.test_torch_service_engine import EMBEDDERS, _cfg, carry_inits
from tests.test_torch_slice import SR, _make_engines, _pieces

torch.set_num_threads(1)
TOL = 2e-5
# fields that hold a time, an id, a path under the server's data root or
# the process's garbage-collector count
VOLATILE = {"latency_s", "submitted", "started", "finished", "job",
            "session", "id", "trace_dir", "saved", "loaded", "gc_collected"}
# messages may name each package's own limits (the port reads WAV only,
# ROADMAP A16): an error is compared by its presence and status
MESSAGES = {"error"}


class Pair:
    """One JAX and one port server; ``call`` sends a request to both."""

    def __init__(self, tmp_path_factory, engines=None):
        self.engines = engines or _make_engines()
        self.servers, self.roots = [], []
        for mod, eng in zip((jserver, tserver), self.engines):
            root = tmp_path_factory.mktemp("root")
            srv = mod.serve(eng, host="127.0.0.1", port=0, block=False,
                            data_root=root)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.servers.append(srv)
            self.roots.append(root)

    def urls(self):
        return [f"http://127.0.0.1:{s.server_address[1]}"
                for s in self.servers]

    def call(self, path, data=None, method=None, headers=None, raw=False):
        """[(status, body)] from the JAX then the port server."""
        out = []
        for base in self.urls():
            req = urllib.request.Request(
                base + path, data=data, headers=headers or {},
                method=method or ("POST" if data is not None else "GET"))
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    status, body = r.status, r.read()
            except urllib.error.HTTPError as e:
                status, body = e.code, e.read()
            out.append((status, body if raw else json.loads(body)))
        return out

    def same(self, path, data=None, method=None, headers=None,
             status=200):
        (js, jb), (ts, tb) = self.call(path, data, method, headers)
        assert js == ts == status, (path, js, ts, jb, tb)
        _same(tb, jb, path)
        return tb

    def set_handler(self, **attrs):
        for srv in self.servers:
            for k, v in attrs.items():
                setattr(srv.RequestHandlerClass, k, v)

    def shutdown(self):
        for srv in self.servers:
            srv.shutdown()
            srv.RequestHandlerClass.jobs_q.put(None)   # stop the worker


def _texts(h):
    return h.get("asr_text"), h.get("audio_description")


def _same(got, ref, where):
    """Equal JSON up to VOLATILE keys, floats within TOL; in a list of
    hits, two rows with the same texts may trade places."""
    if isinstance(ref, dict):
        keys = set(ref) - VOLATILE
        assert set(got) - VOLATILE == keys, (where, set(got) ^ set(ref))
        for k in keys:
            if k in MESSAGES:
                assert got[k] and isinstance(got[k], str), where
                continue
            _same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), (where, len(got), len(ref))
        for i, (g, r) in enumerate(zip(got, ref)):
            if isinstance(r, dict) and "index" in r and \
                    g.get("index") != r["index"]:
                assert _texts(g) == _texts(r), (where, i)
                score = "fusion_score" if "fusion_score" in r else "score"
                assert g[score] == pytest.approx(r[score], abs=TOL)
                continue
            _same(g, r, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, abs=TOL), where
    else:
        assert got == ref, (where, got, ref)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory)
    yield p
    p.shutdown()


def _wav(tmp_path, seconds, seed):
    p = tmp_path / f"w{seconds}_{seed}.wav"
    write_wav(str(p), _pieces(np.random.default_rng(seed), seconds), SR)
    return p.read_bytes()


def _q(text):
    return urllib.parse.quote(text)


def test_ingest_search_and_strategies(pair, tmp_path):
    (js, jhtml), (ts, thtml) = pair.call("/", raw=True)
    assert js == ts == 200
    assert b"'PyTorch',s.torch_version" in thtml
    assert thtml.replace(b"'PyTorch',s.torch_version",
                         b"'JAX',s.jax_version") == jhtml
    pair.same("/api/config")
    body = pair.same("/api/ingest?name=clip.wav", _wav(tmp_path, 65, 0))
    assert body["total"] == len(body["segments"]) == 7
    texts = [s["asr_text"] for s in body["segments"] if s["asr_text"]]
    assert len(set(texts)) > 1
    queries = [texts[0], texts[-1], "upbeat music with drums",
               "someone speaking clearly"]
    singles = [pair.same(f"/api/search?q={_q(q)}") for q in queries]
    assert singles[0]["results"][0]["asr_text"] == texts[0]
    pair.same(f"/api/search?q={_q(queries[1])}&k=3")
    batch = pair.same("/api/search?" + "&".join(
        f"q={_q(q)}" for q in queries))["batch"]
    for b, s in zip(batch, singles):
        assert [h["index"] for h in b["results"]] == \
            [h["index"] for h in s["results"]]
    for q in queries[:2]:
        for strategy in (*STRATEGIES, "compare_all", "fusion"):
            out = pair.same(f"/api/search?q={_q(q)}&strategy={strategy}")
            if strategy == "compare_all":
                assert set(out["weight_info"]["per_strategy"]) == \
                    set(STRATEGIES)
    pair.same("/api/search?q=a&q=b&strategy=audio_only", status=400)
    seg = pair.same("/api/segments")
    assert seg["total"] == 7
    (js, ja), (ts, ta) = pair.call("/api/audio/3", raw=True)
    assert js == ts == 200 and ta == ja and ta[:4] == b"RIFF"
    for i in (-1, 10_000):
        pair.same(f"/api/audio/{i}", status=404)


def test_bad_requests(pair, tmp_path):
    pair.same("/api/ingest?name=junk", b"\0" * 32, status=400)
    pair.same("/api/nope", status=404)
    pair.same("/api/nope", b"", status=404)
    pair.same("/api/jobs/nope", status=404)
    pair.same("/api/stream/nope/chunk", b"", status=404)
    pair.same("/api/delete", b"", status=400)
    for bad in ("../escape", "/etc/pwned", str(tmp_path / "evil")):
        pair.same(f"/api/save?path={_q(bad)}", b"", status=403)
        pair.same(f"/api/load?path={_q(bad)}", b"", status=403)
    pair.same("/api/config", b"42", status=400)
    pair.same("/api/config", json.dumps({"bogus": 1}).encode(), status=400)
    pair.same("/api/config", json.dumps(
        {"segment_seconds": 99}).encode(), status=400)
    # a token set: the state-changing routes answer 401 without it
    pair.set_handler(api_token="s3cret")
    try:
        for route in ("/api/reset", "/api/save", "/api/load",
                      "/api/delete?source=x", "/api/config",
                      "/api/profile"):
            pair.same(route, b"", status=401)
        pair.same("/api/delete?source=nobody", b"",
                  headers={"X-API-Token": "s3cret"})
    finally:
        pair.set_handler(api_token=None)
    # a full queue: the async path answers 429, the sync path still works
    pair.set_handler(max_queued_jobs=0)
    try:
        pair.same("/api/ingest?name=q.wav&async=1", _wav(tmp_path, 12, 9),
                  status=429)
    finally:
        pair.set_handler(max_queued_jobs=tserver.AudioSearchHandler
                         .max_queued_jobs)


def test_jobs_delete_persistence_and_stream(pair, tmp_path):
    (js, jb), (ts, tb) = pair.call("/api/ingest?name=b.wav&async=1",
                                   _wav(tmp_path, 25, 1))
    assert js == ts == 202 and tb["state"] == jb["state"] == "queued"
    import time
    for _ in range(600):
        jobs = [pair.call(f"/api/jobs/{b['job']}")[i][1]
                for i, b in enumerate((jb, tb))]
        if all(j["state"] in ("done", "failed") for j in jobs):
            break
        time.sleep(0.1)
    _same(jobs[1], jobs[0], "job")
    assert jobs[1]["state"] == "done" and jobs[1]["n_segments"] == 3
    listing = pair.same("/api/jobs")
    assert all("segments" not in j for j in listing["jobs"])
    total = pair.same("/api/segments")["total"]
    out = pair.same("/api/delete?source=b.wav", b"")
    assert out["removed"] == 3 and out["total"] == total - 3
    for q in ("upbeat music with drums", "rain"):
        hits = pair.same(f"/api/search?q={_q(q)}")["results"]
        assert all(h["source"] != "b.wav" for h in hits)
    pair.same("/api/save?path=idx", b"")
    before = pair.same("/api/segments")
    top = pair.same("/api/search?q=music")
    assert pair.same("/api/reset", b"")["reset"] is True
    assert pair.same("/api/segments")["total"] == 0
    assert pair.same("/api/load?path=idx", b"")["total"] == before["total"]
    assert pair.same("/api/segments") == before
    assert pair.same("/api/search?q=music")["results"] == top["results"]
    # a stream in uneven chunks of int16 PCM
    sid = [b["session"] for _, b in pair.call("/api/stream/open?name=mic",
                                              b"")]
    pcm = (np.clip(_pieces(np.random.default_rng(7), 25), -1, 1)
           * 32767).astype(np.int16)
    cuts = [0, int(3.3 * SR), int(11.3 * SR), int(23.0 * SR), len(pcm)]
    outs = []
    for lo, hi in zip(cuts, cuts[1:]):
        res = [pair.urls()[i] + f"/api/stream/{s}/chunk?rate={SR}"
               for i, s in enumerate(sid)]
        got = []
        for url in res:
            req = urllib.request.Request(url, data=pcm[lo:hi].tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                got.append(json.loads(r.read()))
        _same(got[1], got[0], f"chunk {lo}")
        outs.append(got[1])
    assert [len(o["segments"]) for o in outs] == [0, 1, 1, 0]
    closed = []
    for i, s in enumerate(sid):
        req = urllib.request.Request(pair.urls()[i] +
                                     f"/api/stream/{s}/close", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            closed.append(json.loads(r.read()))
    _same(closed[1], closed[0], "close")
    assert [s["start_time"] for s in closed[1]["segments"]] == [20.0]


def test_metrics_stats_and_profile(pair):
    (js, jm), (ts, tm) = pair.call("/metrics", raw=True)
    assert js == ts == 200

    def names(body):
        out = set()
        for line in body.decode().splitlines():
            if line.startswith("#"):
                continue
            name, value = line.rsplit(" ", 1)
            float(value)
            out.add(name)
        return out
    assert names(tm) == names(jm)
    total = pair.call("/api/segments")[1][1]["total"]
    assert f"mas_index_segments {total}" in tm.decode()
    (js, jc), (ts, tc) = pair.call("/api/metrics.csv", raw=True)
    assert js == ts == 200
    rows = list(csv.reader(io.StringIO(tc.decode())))
    assert rows[0] == ["timestamp", "operation", "duration_s", "details"]
    assert {"ingest_file", "search"} <= {r[1] for r in rows[1:]}
    (js, jst), (ts, tst) = pair.call("/api/stats")
    assert js == ts == 200
    assert set(tst) == set(jst)
    assert set(tst["models"]) == set(jst["models"])
    assert tst["database"] == jst["database"]
    assert tst["system"]["torch_version"] == torch.__version__
    # a trace of one search, under the data root
    out = pair.same("/api/profile?q=music", b"")
    trace = pair.call("/api/profile?q=rain", b"")[1][1]["trace_dir"]
    import pathlib
    files = list(pathlib.Path(trace).rglob("*"))
    assert str(trace).startswith(str(pair.roots[1].resolve()))
    assert any(f.name == "trace.json" and f.stat().st_size for f in files)
    assert out["hits"] >= 1


@pytest.mark.parametrize("name", EMBEDDERS[:2])
def test_config_embedder_over_http(tmp_path_factory, tmp_path, monkeypatch,
                                   name):
    """POST /api/config {"embedder": ...} rebuilds both engines (200, the
    new embed_dim, an empty index); an upload and searches then agree,
    each text's query ranking a row with that text first; then back to
    MiniLM-L6."""
    from multimodal_audio_search_tpu import AudioSearchEngine as JEngine
    from multimodal_audio_search_tpu import config as jcfg
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from multimodal_audio_search_tpu_torch import config as tcfg
    carry_inits(monkeypatch)
    p = Pair(tmp_path_factory, (JEngine(cfg=_cfg(jcfg)),
                                AudioSearchEngine(cfg=_cfg(tcfg),
                                                  device="cpu")))
    try:
        body = p.same("/api/config", json.dumps({"embedder": name}).encode(),
                      headers={"Content-Type": "application/json"})
        assert body["embedder"] == name
        assert body["embed_dim"] == p.engines[1].embedder.dim != 64
        assert p.same("/api/segments")["total"] == 0
        segs = p.same("/api/ingest?name=e.wav", _wav(tmp_path, 25, 4))
        texts = [s["asr_text"] for s in segs["segments"]]
        assert len(set(texts)) > 1
        for t in set(texts):         # a row with the queried text first
            hits = p.same(f"/api/search?q={_q(t)}")["results"]
            assert hits[0]["asr_text"] == t
        p.same("/api/search?q=upbeat%20music%20with%20drums")
        body = p.same("/api/config", json.dumps(
            {"embedder": EMBEDDERS[2]}).encode())
        assert body["embed_dim"] == 384
    finally:
        p.shutdown()
