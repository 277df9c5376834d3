"""tools/torch_bigindex_drift.py, tools/torch_compare_modes.py and
tools/torch_eval_context.py against their JAX originals on the CPU:

* bigindex: both tools write byte-equal index files in float32, bf16 and
  int8 at N_ROWS rows, the port's HostIndex ranks the queries as JAX's
  does, and the whole sweep's report equals the JAX tool's;
* compare_modes: at the tiny preset (narrowed, in both packages'
  PRESETS, to a test width with its 1500 encoder positions kept), one
  short wave, the JAX engine's weights (tests/test_torch_service_engine
  .py::carry_inits), each mode's segment texts and top-10 equal JAX's
  engine's, and the report equals the JAX tool's arithmetic;
* eval_context: both tools' JSON (summary and rows) equal on one short
  WAV at the same preset and weights.
"""
import json
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu.index.bigindex import (
    HostIndex as JHostIndex)
from multimodal_audio_search_tpu.index.eval import (
    compare_rankings as jcompare)
from multimodal_audio_search_tpu.models import minilm as JML
from multimodal_audio_search_tpu.models import whisper as JW
from multimodal_audio_search_tpu.pipelines import ingest as JI
from multimodal_audio_search_tpu.pipelines import whisper_pipeline as JWP
from multimodal_audio_search_tpu_torch.audio.wav import write_wav
from multimodal_audio_search_tpu_torch.models import minilm as TML
from multimodal_audio_search_tpu_torch.models import whisper as TW
from tests.test_torch_service_engine import carry_inits
from tests.test_torch_slice import SR, _pieces

torch.set_num_threads(1)
N_ROWS = 2000
DIM = 384
N_QUERIES = 10
MAX_NEW = 6
WAVE_S = 20          # two 10 s segments
# whisper-tiny's geometry at a test width: 1500 encoder positions (the
# 30 s context), the vocabulary and special tokens kept
SMALL_TINY = dict(d_model=64, enc_layers=2, dec_layers=2, heads=4, ffn=128)


# ------------------------------------------------------------ bigindex
@pytest.fixture(scope="module")
def big():
    return (chip_smoke.load_tool("bigindex_drift"),
            chip_smoke.load_tool("torch_bigindex_drift"))


def _centers(seed: int = 0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(1024, DIM))
    return rng, c / np.linalg.norm(c, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_index_files_byte_equal_and_ranked_alike(big, tmp_path, dtype):
    jtool, ttool = big
    rng, centers = _centers()
    jp = jtool.make_index(tmp_path / "j", N_ROWS, DIM,
                          np.random.default_rng(1), dtype, centers)
    tp = ttool.make_index(tmp_path / "t", N_ROWS, DIM,
                          np.random.default_rng(1), dtype, centers)
    names = sorted(p.name for p in jp.iterdir())
    assert names == sorted(p.name for p in tp.iterdir())
    for name in names:
        assert (jp / name).read_bytes() == (tp / name).read_bytes(), name
    # the JAX tool's queries: centers + 0.25 noise, unit, then weights
    qs, ws = ttool.make_queries(rng, centers, N_QUERIES)
    r2 = np.random.default_rng(0)
    r2.normal(size=(1024, DIM))
    want_q = centers[r2.integers(0, 1024, size=N_QUERIES)] \
        + 0.25 * r2.normal(size=(N_QUERIES, DIM))
    want_q /= np.linalg.norm(want_q, axis=-1, keepdims=True)
    np.testing.assert_array_equal(qs, want_q.astype(np.float32))
    np.testing.assert_array_equal(
        ws, r2.uniform(0.2, 0.8, size=N_QUERIES).astype(np.float32))
    got, _ = ttool.rank({dtype: tp}, qs, ws, "cpu")
    jidx = JHostIndex(jp)
    want = [[int(v) for v in jidx.search(q, w, 1 - w, k=10)[1]]
            for q, w in zip(qs, ws)]
    assert got[dtype] == want


def test_sweep_report_equals_jax(big, tmp_path, capsys, monkeypatch):
    """The whole sweep at N_ROWS rows, each tool's temporary directory
    put under tmp_path (tempfile's default directory)."""
    jtool, ttool = big
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["bigindex_drift", "--n", str(N_ROWS),
                                      "--queries", str(N_QUERIES)])
    jtool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "port"))
    got = ttool.run(N_ROWS, DIM, N_QUERIES, device="cpu")
    for line in (got, want):
        line.pop("f32_query_ms")
        for m in line["modes"].values():
            m.pop("query_ms")
    assert got == want
    assert not list((tmp_path / "port").iterdir())     # removed


# ------------------------------------------------------- compare_modes
@pytest.fixture
def small_tiny(monkeypatch):
    """carry_inits, "tiny" at SMALL_TINY and MiniLM "L6" at one layer of
    a 2048-token vocabulary in both packages, and the JAX
    engines at float32 (JAX's make_default_ingest defaults to bf16; the
    port's to the device's dtype, float32 on the CPU)."""
    carry_inits(monkeypatch)
    for mod in (JW, TW):
        monkeypatch.setitem(mod.PRESETS, "tiny",
                            mod.config_for("tiny", **SMALL_TINY))
    for mod in (JML, TML):       # the embedder: L6's width, one layer
        monkeypatch.setitem(mod.PRESETS, "L6", mod.MiniLMConfig(
            vocab_size=2048, layers=1))
    make = JI.make_default_ingest
    monkeypatch.setattr(JI, "make_default_ingest", lambda cfg, **kw: make(
        cfg, dtype=jnp.float32, **kw))


def _jax_run(jtool, mode, waves):
    """The JAX tool's ``run`` (an inner function of its main)."""
    eng = jtool.build_engine(mode if mode != "parity" else "", "tiny",
                             MAX_NEW, seed=0)
    for i, w in enumerate(waves):
        eng.ingest_waveform(w, SR, f"clip{i}")
    texts = [(m.get("asr_text", ""), m.get("audio_description", ""))
             for m in eng.store.meta]
    return texts, {q: [h["index"] for h in eng.search(q)[0]]
                   for q in jtool.QUERIES}


def test_compare_modes_match_jax(small_tiny):
    jtool = chip_smoke.load_tool("compare_modes")
    ttool = chip_smoke.load_tool("torch_compare_modes")
    assert ttool.QUERIES == jtool.QUERIES
    waves = [_pieces(np.random.default_rng(4), WAVE_S)]
    jruns, truns = {}, {}
    for mode in ("parity", *ttool.MODES):
        jruns[mode] = _jax_run(jtool, mode, waves)
        truns[mode] = ttool.run_mode(ttool.build_engine(
            "" if mode == "parity" else mode, "tiny", MAX_NEW, 0, "cpu"),
            waves, SR)
        assert truns[mode] == jruns[mode], mode
    assert len(set(truns["parity"][0])) > 1      # the texts differ
    rep = ttool.report(truns["parity"], {m: truns[m] for m in ttool.MODES},
                       "tiny", MAX_NEW)
    base_texts, base_tops = jruns["parity"]
    for mode in ttool.MODES:
        texts, tops = jruns[mode]
        per_q = {q: jcompare(base_tops[q], tops[q]) for q in jtool.QUERIES}
        m = rep["modes"][mode]
        assert m["per_query"] == per_q
        assert m["segment_text_match"] == float(np.mean(
            [a == b for a, b in zip(base_texts, texts)]))
        assert m["mean_overlap@10"] == float(np.mean(
            [v["overlap@10"] for v in per_q.values()]))
    assert rep["segments"] == len(base_texts)


# -------------------------------------------------------- eval_context
def test_eval_context_matches_jax(small_tiny, tmp_path, monkeypatch):
    jtool = chip_smoke.load_tool("eval_context")
    ttool = chip_smoke.load_tool("torch_eval_context")
    # the JAX pipelines at float32 (their default is bf16)
    pipe = JWP.WhisperTextPipeline
    monkeypatch.setattr(JWP, "WhisperTextPipeline", lambda **kw: pipe(
        dtype=jnp.float32, **kw))
    wav = str(tmp_path / "short.wav")
    write_wav(wav, _pieces(np.random.default_rng(5), WAVE_S), SR)
    argv = ["--preset", "tiny", "--max-new", str(MAX_NEW), "--audio", wav]
    monkeypatch.setattr(sys, "argv", ["eval_context", *argv, "--out",
                                      str(tmp_path / "j.json")])
    jtool.main()
    ttool.main(["--device", "cpu", *argv, "--out", str(tmp_path / "t.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == want
    assert got["summary"]["segments"] == 2
