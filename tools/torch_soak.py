"""Service soak of the PyTorch port: the FULL HTTP surface on the card,
one command.

The port's counterpart of tools/soak.py: start serve() on a local port
with production defaults, POST a synthesized WAV through /api/ingest,
query /api/search, scrape /metrics, delete the source, and print one
JSON line of timings/results; with --loop-minutes, then run the mixed
ingest/search/delete/save load of ``_soak_loop`` with its three growth
checks.

    python tools/torch_soak.py [--seconds 60] [--port 8765]
        [--loop-minutes 15] [--device cpu]

It differs from tools/soak.py in three places:
  * the server gets a temporary ``data_root`` (serve(data_root=...)
    confines save paths to it), so the loop's /api/save?path=soak_ckpt
    writes there, not under the working directory;
  * RSS is read from /proc/self/status (``rss_bytes``), not from psutil;
  * the server is shut down and closed in a ``finally``.
The engine runs on ``--device`` (the card unless cpu is named). After the
loop, ``rss_fit`` adds a least-squares slope of the RSS samples; the
exit code is 1 unless every status was 200 (the loop's 500 included).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import struct
import sys
import time
import urllib.request

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# each request's deadline, seconds (the first ingest builds the kernels)
REQUEST_TIMEOUT_S = 900


def make_wav(seconds: float, sr: int = 16_000) -> bytes:
    import numpy as np
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    wave = (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.1 * rng.normal(size=len(t))).astype(np.float32)
    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    return hdr + pcm


def rss_bytes() -> int:
    """This process's resident set (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def rss_fit(samples: list[dict]) -> dict:
    """Least-squares slope of the samples' RSS (MB) over their index and
    over their time, and the first and last sample's RSS."""
    import numpy as np
    if len(samples) < 2:
        return {"samples": len(samples)}
    rss = np.array([s["rss_mb"] for s in samples], np.float64)
    it = np.arange(len(rss), dtype=np.float64)
    ts = np.array([s["t_s"] for s in samples], np.float64)
    return {"samples": len(samples),
            "mb_per_iteration": float(np.polyfit(it, rss, 1)[0]),
            "mb_per_minute": float(np.polyfit(ts, rss, 1)[0] * 60.0)
            if np.ptp(ts) > 0 else None,
            "rss_mb_first": float(rss[0]), "rss_mb_last": float(rss[-1])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
    ap.add_argument("--loop-minutes", type=float, default=0.0,
                    help="after the single-pass smoke, run a mixed "
                         "ingest/search/delete/save load until the "
                         "deadline, sampling RSS / segment count / "
                         "search p50, and check bounded growth. Emits "
                         "one timeline sample line per iteration so a "
                         "killed run still leaves evidence.")
    args = ap.parse_args(argv)

    import tempfile
    import threading

    from multimodal_audio_search_tpu_torch.config import config_from_env
    from multimodal_audio_search_tpu_torch.service.api import (
        AudioSearchEngine)
    from multimodal_audio_search_tpu_torch.service.server import serve

    out = {}
    with tempfile.TemporaryDirectory(prefix="soak_") as root:
        srv = serve(AudioSearchEngine(cfg=config_from_env(),
                                      device=args.device),
                    block=False, port=args.port, data_root=root)
        # serve(block=False) constructs the server but does not run its
        # accept loop: the caller owns that thread
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="http-accept").start()
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"

            def req(method, path, data=None, headers=None):
                r = urllib.request.Request(base + path, data=data,
                                           method=method,
                                           headers=headers or {})
                with urllib.request.urlopen(
                        r, timeout=REQUEST_TIMEOUT_S) as resp:
                    return resp.status, resp.read()

            wav = make_wav(args.seconds)
            t0 = time.perf_counter()
            st, body = req("POST", "/api/ingest?name=soak.wav", wav,
                           {"Content-Type": "application/octet-stream"})
            out["ingest"] = {"status": st,
                             "s": round(time.perf_counter() - t0, 1),
                             "segments": json.loads(body).get("segments")}

            t0 = time.perf_counter()
            st, body = req("GET", "/api/search?q=music+and+tones&k=5")
            hits = json.loads(body)
            out["search"] = {
                "status": st, "s": round(time.perf_counter() - t0, 2),
                "hits": len(hits.get("results", hits.get("hits", [])))}
            t0 = time.perf_counter()
            st, _ = req("GET", "/api/search?q=speech")
            out["search_warm"] = {"status": st,
                                  "s": round(time.perf_counter() - t0, 3)}

            st, body = req("GET", "/metrics")
            out["metrics"] = {"status": st,
                              "lines": body.decode().count("\n")}
            st, body = req("GET", "/api/stats")
            out["stats"] = {"status": st}
            st, body = req("POST", "/api/delete?source=soak.wav")
            out["delete"] = {"status": st, "body": json.loads(body)}

            if args.loop_minutes > 0:
                samples: list[dict] = []
                _soak_loop(req, wav, args.loop_minutes, out, samples)
                out["rss_fit"] = rss_fit(samples)
        finally:
            srv.shutdown()
            srv.server_close()
    result = {"metric": "service_soak", "ok": all(
        v.get("status") in (200,) for v in out.values()
        if isinstance(v, dict) and "status" in v), **out}
    print(json.dumps(result), flush=True)
    return result


def _soak_loop(req, wav: bytes, minutes: float, out: dict,
               samples: list | None = None) -> None:
    """Mixed ingest/search/delete/save load with resource-growth
    checks: after the warm first third, RSS must plateau (final-third
    median within 10% + 100 MB of the middle-third median), the segment
    store must stay bounded by the delete cadence, and search p50 must
    not degrade >2x between the first and final thirds. ``samples``, if
    given, receives each iteration's sample."""
    hdr = {"Content-Type": "application/octet-stream"}
    queries = ["music and tones", "speech sounds", "a dog barking",
               "rain and wind"]
    samples = [] if samples is None else samples
    kept: list[str] = []
    t_start = time.time()
    deadline = t_start + minutes * 60.0
    i = 0
    while time.time() < deadline:
        name = f"soak_loop_{i}.wav"
        st, _ = req("POST", f"/api/ingest?name={name}", wav, hdr)
        assert st == 200, ("ingest", i, st)
        kept.append(name)
        lat = []
        for q in queries:
            t0 = time.perf_counter()
            st, _ = req("GET", "/api/search?q=" + q.replace(" ", "+"))
            lat.append(time.perf_counter() - t0)
            assert st == 200, ("search", i, st)
        total = None
        if len(kept) > 8:                 # bounded store via deletes
            st, body = req("POST", f"/api/delete?source={kept.pop(0)}")
            assert st == 200, ("delete", i, st)
            total = json.loads(body)["total"]
        if i % 5 == 4:                    # periodic checkpoint
            st, _ = req("POST", "/api/save?path=soak_ckpt")
            assert st == 200, ("save", i, st)
        st, _ = req("GET", "/api/stats")
        assert st == 200, ("stats", i, st)
        s = {"t_s": round(time.time() - t_start, 1),
             "rss_mb": round(rss_bytes() / 1e6, 1),
             "p50_ms": round(sorted(lat)[len(lat) // 2] * 1e3, 1)}
        if total is not None:
            s["segments"] = total
        samples.append(s)
        print(json.dumps({"soak_sample": s}), flush=True)
        i += 1

    third = max(1, len(samples) // 3)
    med = lambda xs: sorted(xs)[len(xs) // 2]          # noqa: E731
    rss_mid = med([s["rss_mb"] for s in samples[third:2 * third]])
    rss_end = med([s["rss_mb"] for s in samples[-third:]])
    p50_first = med([s["p50_ms"] for s in samples[:third]])
    p50_end = med([s["p50_ms"] for s in samples[-third:]])
    segs = [s["segments"] for s in samples if "segments" in s]
    checks = {
        "rss_plateau": rss_end <= rss_mid * 1.10 + 100.0,
        "store_bounded": (not segs) or max(segs) <= max(segs[0], 16) * 2,
        "p50_stable": p50_end <= max(p50_first * 2.0, p50_first + 50.0),
    }
    out["loop"] = {
        "minutes": round((time.time() - t_start) / 60.0, 1),
        "iterations": len(samples),
        "rss_mb_mid_median": rss_mid, "rss_mb_final_median": rss_end,
        "p50_ms_first_median": p50_first, "p50_ms_final_median": p50_end,
        "segments_max": max(segs) if segs else None,
        "checks": checks,
        "status": 200 if all(checks.values()) else 500,
    }


if __name__ == "__main__":
    res = main()
    sys.exit(0 if res["ok"] else 1)
