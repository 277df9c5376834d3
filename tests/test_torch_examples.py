"""examples/torch_0*.py, the port's user-facing examples, stay runnable.

All five run on the CPU (``--device cpu``) at their smallest sizes, one
after another in ONE child process (jax blocked; each through runpy with
its own argv), and each must print the lines its JAX counterpart in
examples/ prints. Example 02's exact top-10 is also held to a numpy
scoring of the same index.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (example, extra argv): the smallest sizes
RUNS = {"01": [], "02": ["--n", "2000"], "03": [], "04": ["--steps", "3"],
        "05": []}
MARK = "@@example "

_RUNNER = """
import contextlib, io, runpy, sys, traceback
sys.modules["jax"] = None
sys.modules["multimodal_audio_search_tpu"] = None
for path, argv in {runs!r}:
    print({mark!r} + path, flush=True)
    sys.argv = [path, "--device", "cpu", *argv]
    try:
        runpy.run_path(path, run_name="__main__")
        print({mark!r} + "rc 0", flush=True)
    except BaseException:
        traceback.print_exc(file=sys.stdout)
        print({mark!r} + "rc 1", flush=True)
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{example number: (rc, printed lines)} from one child process."""
    paths = {n: sorted((ROOT / "examples").glob(f"torch_{n}_*.py"))
             for n in RUNS}
    assert all(len(p) == 1 for p in paths.values()), paths
    runs = [(str(paths[n][0]), RUNS[n]) for n in sorted(RUNS)]
    code = _RUNNER.format(runs=runs, mark=MARK)
    env = {**os.environ, "TMPDIR": str(tmp_path_factory.mktemp("ex"))}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=420, cwd=ROOT, env=env)
    out, cur = {}, None
    for line in p.stdout.splitlines():
        if line.startswith(MARK + str(ROOT)):
            cur = re.search(r"torch_(\d\d)_", line).group(1)
            out[cur] = [None, []]
        elif line.startswith(MARK + "rc "):
            out[cur][0] = int(line.rsplit(" ", 1)[1])
        elif cur is not None:
            out[cur][1].append(line)
    assert sorted(out) == sorted(RUNS), p.stdout[-3000:] + p.stderr[-3000:]
    return out


def _ok(outputs, n):
    rc, lines = outputs[n]
    assert rc == 0, "\n".join(lines[-40:])
    return lines


def test_01_basic_search(outputs):
    lines = _ok(outputs, "01")
    m = re.match(r"ingested (\d+) segment\(s\); index now holds (\d+)",
                 lines[0])
    assert m and m.group(1) == m.group(2) == "3", lines
    assert sum(ln.startswith("  seg_") for ln in lines) == 3
    assert any(ln.startswith("query weights: asr=") for ln in lines)
    assert lines[-1] == "reloaded index: 3 segment(s)"


def test_02_scale_search(outputs):
    lines = _ok(outputs, "02")
    exact = next(ln for ln in lines if ln.startswith("exact top-10:"))
    assert any(ln.startswith("ivf top-10 (n_probe=") for ln in lines)
    assert any(ln.startswith("host int8 ivf top-10:") for ln in lines)
    # the example's index, scored in numpy (fused_scores' rule)
    rng = np.random.default_rng(0)
    n, d, topics = 2000, 64, 64
    cent = rng.normal(size=(topics, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=-1, keepdims=True)
    rows = cent[rng.integers(0, topics, size=n)]
    emb = (rows[:, None, :] + (0.35 / np.sqrt(d)) * rng.normal(
        size=(n, 2, d))).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    success = rng.random((n, 2)) > 0.2
    emb[~success] = 0.0
    q = (cent[7] + (0.4 / np.sqrt(d)) * rng.normal(size=d)).astype(
        np.float32)
    q /= np.linalg.norm(q)
    sims = emb @ q
    eff = np.array([0.6, 0.4], np.float32) * success
    score = (eff / np.maximum(eff.sum(-1, keepdims=True), 1e-30) * sims
             ).sum(-1)
    want = np.argsort(-score, kind="stable")[:10].tolist()
    assert json.loads(exact.split(":", 1)[1]) == want


def test_03_multichip(outputs):
    lines = _ok(outputs, "03")
    assert lines[0].startswith("8 devices: ")
    assert lines[1] == "mesh: {'data': 4, 'model': 2}"
    assert re.match(r"ingested \d+ segment\(s\) with batches sharded over "
                    r"4 data-parallel devices", lines[2]), lines
    assert re.match(r"sharded search: \d+ hit\(s\), weights "
                    r"\d\.\d\d/\d\.\d\d", lines[3]), lines


def test_04_training(outputs):
    lines = _ok(outputs, "04")
    assert re.match(r"trained 3 steps; loss \d+\.\d+ -> \d+\.\d+",
                    lines[0]), lines
    assert lines[1].startswith("ground truth: ")
    assert lines[2].startswith("decoded:      ")


def test_05_service(outputs):
    lines = _ok(outputs, "05")
    assert lines[0].startswith("serving on http://127.0.0.1:")
    assert re.match(r"job \w+: done, 1 segment\(s\)", lines[1]), lines
    assert lines[2] == "stream committed; index total 2"
    assert lines[3] == "search: 2 hit(s)"
    assert lines[4] == "stats: total_segments = 2"
    assert re.match(r"prometheus lines: \d+", lines[5])
