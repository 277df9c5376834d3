"""tools/torch_soak.py against tools/soak.py.

``_soak_loop``'s sampling, delete and checkpoint cadence and its three
growth checks run through both tools on tests/test_soak_loop.py's fake
transports (flat resources, a hard RSS leak, a search that slows down),
with equal ``out["loop"]`` and sample lines; the port reads RSS from
/proc/self/status (``rss_bytes``), JAX from psutil, so both are fed the
same series. ``make_wav`` gives the same bytes. One CPU run of the port's
``main`` (a small engine through MAS_* overrides) writes nothing under
the repository or its working directory, and the loop's save lands in
main's temporary data root (the loop replaced by one save through the
real server: a time-bound loop's iterations vary with the CPU's load).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import soak as jax_soak  # noqa: E402
import torch_soak  # noqa: E402

ITERS = 12


class FakeReq:
    """tests/test_soak_loop.py's transport double: counts calls, tracks
    the segment total through ingest/delete."""

    def __init__(self, segs_per_wav=2):
        self.calls = []
        self.total = 0
        self.segs = segs_per_wav

    def __call__(self, method, path, data=None, headers=None):
        self.calls.append((method, path.split("?")[0]))
        if path.startswith("/api/ingest"):
            self.total += self.segs
            return 200, b"{}"
        if path.startswith("/api/delete"):
            self.total -= self.segs
            return 200, json.dumps({"total": self.total}).encode()
        return 200, b"{}"


# each case: the RSS in bytes as a function of (fake time, call number),
# and the latency a search adds (seconds) as a function of the call number
CASES = {
    "flat": (lambda t, n: int((300 + 0.01 * t) * 1e6), lambda n: 0.005),
    "leak": (lambda t, n: int(300.0 * 1.6 ** (n + 1) * 1e6),
             lambda n: 0.005),
    "slowing": (lambda t, n: int(300 * 1e6),
                lambda n: 0.005 if n < 3 else 0.2),
}


def _drive(monkeypatch, module, case, read_rss):
    """Run ``module``'s _soak_loop for ITERS iterations of fake time,
    RSS read through ``read_rss(fn)`` (which installs fn as the module's
    source of RSS bytes)."""
    rss_fn, lat_fn = CASES[case]
    t = {"v": 0.0, "n": 0, "perf": 0}

    class FakeTime:
        @staticmethod
        def time():
            return t["v"]

        @staticmethod
        def perf_counter():
            # each perf_counter pair brackets one search, four searches
            # an iteration
            t["v"] += lat_fn(t["perf"] // 8)
            t["perf"] += 1
            return t["v"]

    def rss():
        v = rss_fn(t["v"], t["n"])
        t["n"] += 1
        return v

    monkeypatch.setattr(module, "time", FakeTime)
    read_rss(rss)
    out = {}
    fake = FakeReq()
    module._soak_loop(fake, b"RIFF", minutes=ITERS * 0.04 / 60.0, out=out)
    return out, fake.calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_soak_loop_equals_jax(monkeypatch, capsys, case):
    def jax_rss(fn):
        proc = types.SimpleNamespace(memory_info=lambda: types.SimpleNamespace(
            rss=fn()))
        monkeypatch.setitem(sys.modules, "psutil",
                            types.SimpleNamespace(Process=lambda: proc))

    want, want_calls = _drive(monkeypatch, jax_soak, case, jax_rss)
    want_lines = capsys.readouterr().out.splitlines()
    got, got_calls = _drive(
        monkeypatch, torch_soak, case,
        lambda fn: monkeypatch.setattr(torch_soak, "rss_bytes", fn))
    got_lines = capsys.readouterr().out.splitlines()
    assert got["loop"] == want["loop"]
    assert got_calls == want_calls
    assert got_lines == want_lines
    assert len(got_lines) == got["loop"]["iterations"]
    checks = got["loop"]["checks"]
    if case == "flat":
        assert got["loop"]["status"] == 200 and all(checks.values())
        saves = sum(1 for _, p in got_calls if p == "/api/save")
        assert saves == got["loop"]["iterations"] // 5
    elif case == "leak":
        assert got["loop"]["status"] == 500 and not checks["rss_plateau"]
    else:
        assert got["loop"]["status"] == 500 and not checks["p50_stable"]


def test_one_iteration_raises_in_both(monkeypatch, capsys):
    """A loop that ends after one iteration has an empty middle third:
    both loops raise IndexError (a fault of the reference the port keeps,
    ROADMAP §3)."""
    monkeypatch.setattr(torch_soak, "rss_bytes", lambda: int(3e8))
    proc = types.SimpleNamespace(memory_info=lambda: types.SimpleNamespace(
        rss=int(3e8)))
    monkeypatch.setitem(sys.modules, "psutil",
                        types.SimpleNamespace(Process=lambda: proc))
    for module in (jax_soak, torch_soak):
        t = {"v": 0.0}

        class FakeTime:
            @staticmethod
            def time():
                return t["v"]

            @staticmethod
            def perf_counter():
                t["v"] += 1.0
                return t["v"]

        monkeypatch.setattr(module, "time", FakeTime)
        with pytest.raises(IndexError):
            module._soak_loop(FakeReq(), b"RIFF", minutes=1 / 60.0, out={})
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_soak_loop_hands_back_its_samples(monkeypatch, capsys):
    samples = []
    monkeypatch.setattr(torch_soak, "rss_bytes", lambda: int(3e8))
    out = {}
    torch_soak._soak_loop(FakeReq(), b"RIFF", minutes=0.0005, out=out,
                          samples=samples)
    lines = [json.loads(ln)["soak_sample"]
             for ln in capsys.readouterr().out.splitlines()]
    assert samples == lines and len(samples) == out["loop"]["iterations"]
    fit = torch_soak.rss_fit(samples)
    assert fit["samples"] == len(samples)
    assert fit["mb_per_iteration"] == pytest.approx(0.0, abs=1e-9)
    assert torch_soak.rss_fit(
        [{"t_s": i * 2.0, "rss_mb": 100.0 + 0.5 * i} for i in range(9)]
    )["mb_per_iteration"] == pytest.approx(0.5)


def test_rss_bytes_reads_proc():
    assert 1e6 < torch_soak.rss_bytes() < 1e12


@pytest.mark.parametrize("seconds", [0.5, 7.25])
def test_make_wav_bytes_equal(seconds):
    assert torch_soak.make_wav(seconds) == jax_soak.make_wav(seconds)


def _digest(root: pathlib.Path) -> dict:
    """Every file under ``root`` (the committed soak_ckpt/) by content."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


SMALL_ENGINE = {"MAS_ASR_PRESET": "tiny", "MAS_SHORT_CONTEXT": "1",
                "MAS_MAX_NEW_TOKENS": "4"}


def test_main_on_cpu_writes_nothing_under_the_repo(tmp_path):
    """The port's main, --device cpu --seconds 10 (a small engine:
    whisper-tiny for ASR, short context, 4 tokens), from a working
    directory that must stay empty, with the repository's soak_ckpt/ and
    top level unchanged: every request's status 200, exit code 0."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    before = (_digest(ROOT / "soak_ckpt"), sorted(os.listdir(ROOT)))
    env = {**os.environ, **SMALL_ENGINE, "TMPDIR": str(tmp_path),
           "MAS_DATA_ROOT": str(ROOT)}
    p = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_soak.py"),
         "--device", "cpu", "--seconds", "10", "--port", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["ok"] and all(res[k]["status"] == 200 for k in (
        "ingest", "search", "search_warm", "metrics", "stats", "delete"))
    assert res["ingest"]["segments"] and "loop" not in res
    assert os.listdir(cwd) == []
    assert (_digest(ROOT / "soak_ckpt"), sorted(os.listdir(ROOT))) == before
    assert not [q for q in tmp_path.iterdir() if q.name.startswith("soak_")]


def test_loop_saves_under_the_temporary_root(tmp_path, monkeypatch):
    """The loop's /api/save?path=soak_ckpt lands in main's temporary data
    root, not in the working directory nor under MAS_DATA_ROOT (here the
    repository): main runs in this process with its loop replaced by one
    save through the real server, and the root is removed after."""
    import tempfile
    for k, v in SMALL_ENGINE.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("MAS_DATA_ROOT", str(ROOT))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _digest(ROOT / "soak_ckpt")
    seen = {}

    def one_save(req, wav, minutes, out, samples=None):
        seen["status"], _ = req("POST", "/api/save?path=soak_ckpt")
        seen["roots"] = [q for q in tmp_path.iterdir()
                         if q.name.startswith("soak_")]
        seen["saved"] = [sorted(os.listdir(q / "soak_ckpt"))
                         for q in seen["roots"]]
        out["loop"] = {"status": 200}

    monkeypatch.setattr(torch_soak, "_soak_loop", one_save)
    res = torch_soak.main(["--device", "cpu", "--seconds", "10",
                           "--port", "0", "--loop-minutes", "1"])
    assert res["ok"] and seen["status"] == 200
    assert len(seen["roots"]) == 1 and seen["saved"][0], seen
    assert not seen["roots"][0].exists()
    assert os.listdir(cwd) == [] and _digest(ROOT / "soak_ckpt") == before
