"""The transfer codecs of the port's ingest against the JAX package's, on
the CPU at the "test" preset in float32.

* host codes: every codec's codes as they leave the host (the JAX
  package's ``jax.device_put`` argument, the port's ``_device_mel``
  argument) bit-equal, through the C++ quantizers and mel encoder and
  through the numpy forms (which give the native codes too; mel codes
  within one code, as the JAX package's own test);
* device decode: the port's expansion of each codec within 1e-6 of the
  JAX package's jitted mel step on the same codes (for the waveform
  codecs the padded waveform, for the mel codecs the features);
* the engines: under ``fast``, ``fast`` with mel8, ``fast_lossless``
  with mel16 and with mel12, and int12, the same segments, texts,
  embeddings and top-10 as the JAX engine, and bf16 index codes
  bit-equal where the profile sets a bf16 index;
* the port with jax blocked decodes the committed MP3 and ingests it
  with mel16.
"""
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu import config as jcfg
from multimodal_audio_search_tpu.audio import native as JN
from multimodal_audio_search_tpu.ops import mel as JM
from multimodal_audio_search_tpu.pipelines.ingest import (
    DualPipelineIngest as JIngest)
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch.audio import native as TN
from multimodal_audio_search_tpu_torch.ops import mel as TM
from multimodal_audio_search_tpu_torch.pipelines import ingest as TI
from multimodal_audio_search_tpu_torch.pipelines.ingest import (
    DualPipelineIngest)

from make_mp3_vector import MP3
from test_torch_slice import (CPU, SR, _captured_codes, _check_engine_parity,
                              _make_engines, _pieces)

torch.set_num_threads(1)
CODECS = ("int16", "int12", "mulaw8", "mel16", "mel12", "mel8")
WAVE_CODECS = ("int16", "int16d", "int12", "mulaw8", "float32")
MEL_CODECS = ("mel16", "mel12", "mel8")
CODE_DTYPE = {"int16": np.int16, "int16d": np.int16, "int12": np.uint8,
              "mulaw8": np.int8, "mel16": np.uint16, "mel12": np.uint8,
              "mel8": np.uint8, "float32": np.float32}


@pytest.fixture(scope="module")
def engines():
    return _make_engines()


def _wave(kind: str) -> np.ndarray:
    r = np.random.default_rng(5)
    w = (r.normal(size=SR * 5) * 0.3).astype(np.float32)
    if kind == "full_scale_square":
        w = np.where(np.arange(w.size) % 2, 0.95, -0.95).astype(np.float32)
    elif kind == "nan_peaks":          # NaNs and a peak the scale pulls in
        w[::997] = np.nan
        w[1::991] = 4.0
    return w


def _ingests(engines, mode, seg_s=None):
    """A JAX and a port DualPipelineIngest over the shared toy models at
    transfer ``mode`` (segments of ``seg_s`` seconds where given)."""
    jeng, teng = engines

    def cfg(mod):
        c = mod.EngineConfig(ingest_batch=4, embed_dim=64,
                             transfer_dtype=mode)
        if seg_s:
            c = c.replace(segment=mod.SegmentConfig(
                segment_seconds=seg_s, min_segment_seconds=0.5))
        return c
    ji, ti = jeng.ingest_pipeline, teng.ingest_pipeline
    return (JIngest(ji.asr, ji.caption, ji.embedder, cfg(jcfg)),
            DualPipelineIngest(ti.asr, ti.caption, ti.embedder, cfg(tcfg)))


def _codes(monkeypatch, engines, mode, wave, seg_s=None):
    jing, ting = _ingests(engines, mode, seg_s)
    ref = _captured_codes(monkeypatch, lambda: jing.process_waveform(
        wave, SR), jax, "device_put")
    got = _captured_codes(monkeypatch, lambda: ting.process_waveform(
        wave, SR), ting, "_device_mel")
    assert len(got) == len(ref) >= 1
    return got, ref


# ------------------------------------------------------------ host codes
@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["noise", "full_scale_square",
                                  "nan_peaks"])
@pytest.mark.parametrize("mode", CODECS)
def test_transfer_codes_bit_equal(engines, monkeypatch, mode, kind, path):
    if path == "native":
        if not (TN.available() and JN.available()):
            pytest.skip("native audio library not built")
    else:
        for mod in (TN, JN):
            monkeypatch.setattr(mod, "available", lambda: False)
        monkeypatch.setenv("MAS_NO_NATIVE_MEL", "1")
    got, ref = _codes(monkeypatch, engines, mode, _wave(kind))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == CODE_DTYPE[mode]
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode", ("int12", "mulaw8", "int16") + MEL_CODECS)
def test_native_codes_equal_numpy_codes(engines, monkeypatch, mode):
    """The C++ quantizers give the numpy codes bit for bit; the C++ mel
    encoder within one code (the mel12/mel8 gmax tails bit for bit)."""
    if not TN.available():
        pytest.skip("native audio library not built")
    wave = _wave("noise")
    nat, _ = _codes(monkeypatch, engines, mode, wave)
    with monkeypatch.context() as m:
        m.setattr(TN, "available", lambda: False)
        m.setattr(JN, "available", lambda: False)
        m.setenv("MAS_NO_NATIVE_MEL", "1")
        num, _ = _codes(monkeypatch, engines, mode, wave)
    for a, b in zip(nat, num):
        if mode not in MEL_CODECS:
            np.testing.assert_array_equal(a, b)
            continue
        if mode == "mel16":
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        else:
            np.testing.assert_array_equal(a[:, -4:], b[:, -4:])
            if mode == "mel8":
                ca, cb = a[:, :-4], b[:, :-4]
            else:      # unpack both to codes
                ca, cb = (_unpack12(x[:, :-4]) for x in (a, b))
            diff = np.abs(ca.astype(np.int32) - cb.astype(np.int32))
        assert diff.max() <= 1


def _unpack12(p):
    u = p.astype(np.int32).reshape(p.shape[0], -1, 3)
    return np.stack([u[..., 0] | ((u[..., 1] & 0xF) << 8),
                     (u[..., 1] >> 4) | (u[..., 2] << 4)], -1)


def test_int12_odd_segment_length(engines, monkeypatch):
    """An odd segment length packs its last sample with an implicit zero;
    the device slices it off."""
    seg_s = 16001.5 / SR                 # 16001 samples a segment
    wave = _wave("noise")[: SR * 3]
    got, ref = _codes(monkeypatch, engines, "int12", wave, seg_s)
    for g, r in zip(got, ref):
        assert g.shape[1] == 3 * 8001
        np.testing.assert_array_equal(g, r)
    w = TI.expand_waveform(torch.from_numpy(got[0]), "int12", 16001)
    assert w.shape[1] == 16001


# ---------------------------------------------------------- device decode
class _Stop(Exception):
    pass


@pytest.mark.parametrize("mode", WAVE_CODECS + MEL_CODECS)
def test_device_decode_matches_jax(engines, monkeypatch, mode):
    """The port's device expansion of each codec's codes within 1e-6 of
    the JAX package's jitted mel step on the same codes. For the waveform
    codecs the step's log-mel is replaced by the identity on both sides,
    so the padded waveforms are compared; the mel codecs' step has no
    STFT, so their features are."""
    wave = _wave("noise")
    jing, ting = _ingests(engines, mode)
    with monkeypatch.context() as m:
        if mode in WAVE_CODECS:
            m.setattr(JM, "log_mel_spectrogram", lambda w, cfg: w)

        def stop(*a, **k):
            raise _Stop
        m.setattr(jing.asr, "dispatch_mel", stop)
        codes = _captured_codes(monkeypatch, lambda: pytest.raises(
            _Stop, jing.process_waveform, wave, SR), jax, "device_put")[0]
        step = jing._mel16_fn
    mel_cfg = ting.asr.mel_cfg
    seg_len = min(10 * SR, mel_cfg.n_samples)
    ref = np.asarray(step(codes))
    qd = torch.from_numpy(codes)
    if mode in WAVE_CODECS:
        got = TI.expand_waveform(qd, mode, seg_len)
        got = torch.nn.functional.pad(got, (0, mel_cfg.n_samples - seg_len))
    else:
        got = ting._device_mel(qd, mode, seg_len)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MEL_CODECS)
def test_mel_decoders_match_jax_on_codes(rng, mode):
    """decode_mel16/12/8 on codes the host encoders made from noise at
    a short segment (silent tail frames reconstructed), against JAX's."""
    jc, tc = jcfg.MelConfig(padded_seconds=2.0), \
        tcfg.MelConfig(padded_seconds=2.0)
    w = (rng.normal(size=(3, 20000)) * 0.3).astype(np.float32)
    t_seg = TM.mel_seg_frames(w.shape[1], tc)
    assert t_seg < tc.n_frames
    enc = {"mel16": TM.encode_mel16, "mel12": TM.encode_mel12,
           "mel8": TM.encode_mel8}[mode]
    codes = enc(w, tc, t_seg)
    jenc = {"mel16": JM.encode_mel16, "mel12": JM.encode_mel12,
            "mel8": JM.encode_mel8}[mode]
    np.testing.assert_array_equal(codes, jenc(w, jc, t_seg))
    if mode == "mel16":
        got = TM.decode_mel16(torch.from_numpy(codes), tc)
        ref = JM.decode_mel16(codes, jc)
    else:
        dec, jdec = (TM.decode_mel12, JM.decode_mel12) if mode == "mel12" \
            else (TM.decode_mel8, JM.decode_mel8)
        got = dec(torch.from_numpy(codes), tc, t_seg)
        ref = jdec(codes, jc, t_seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------- engines
@pytest.mark.parametrize("profile,transfer", [
    ("fast", None), ("fast", "mel8"), ("fast_lossless", "mel16"),
    ("fast_lossless", "mel12"), (None, "int12")],
    ids=["fast", "fast_mel8", "fast_lossless_mel16", "fast_lossless_mel12",
         "int12"])
def test_engine_parity_codec_paths(rng, tmp_path, profile, transfer):
    jeng, teng = _make_engines(profile, transfer=transfer)
    want = transfer or "mulaw8"
    assert teng.cfg.transfer_dtype == jeng.cfg.transfer_dtype == want
    _check_engine_parity(jeng, teng, rng, tmp_path)
    assert teng.ingest_pipeline.last_transfer_resolved == want
    if profile == "fast":
        assert teng.cfg.fusion.index_dtype == "bfloat16"
        jemb, jok = jeng.store.device_index("bfloat16")
        emb, ok = teng.store.device_index(CPU, torch.bfloat16)
        assert emb.dtype == torch.bfloat16
        np.testing.assert_array_equal(emb.view(torch.int16).numpy(),
                                      np.asarray(jemb).view(np.int16))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_int12_and_mel16_keep_the_int16_texts(engines, rng):
    """int12 and mel16, the finest lossy codecs, change the features a
    little: on these clips the same segments come out with every int16
    text."""
    wave = _pieces(rng, 35)
    out = {}
    for mode in ("int16", "int12", "mel16"):
        _, ting = _ingests(engines, mode)
        out[mode] = [(s["start_time"], s["asr_text"])
                     for s in ting.process_waveform(wave, SR)]
    assert [t for t, _ in out["int12"]] == [t for t, _ in out["int16"]]
    assert out["int12"] == out["int16"] and out["mel16"] == out["int16"]


# ------------------------------------------------------- jax not needed
def test_port_decodes_mp3_and_ingests_mel16_without_jax():
    code = textwrap.dedent("""
        import pathlib, sys
        sys.modules["jax"] = None          # any import of jax now fails
        import numpy as np, torch
        torch.set_num_threads(1)
        import multimodal_audio_search_tpu_torch as P
        from multimodal_audio_search_tpu_torch.audio.decode import load_audio
        from multimodal_audio_search_tpu_torch.config import (
            DecodeConfig, EngineConfig, MelConfig)
        from multimodal_audio_search_tpu_torch.models import whisper as W
        from multimodal_audio_search_tpu_torch.models.minilm import PRESETS
        from multimodal_audio_search_tpu_torch.pipelines.embed import (
            TextEmbedder)
        from multimodal_audio_search_tpu_torch.pipelines.ingest import (
            DualPipelineIngest)
        from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline \\
            import WhisperTextPipeline
        data = pathlib.Path(sys.argv[1]).read_bytes()
        x, sr = load_audio(data, 16000)
        mel = MelConfig(padded_seconds=2.0)
        w = W.PRESETS["test"]
        d = DecodeConfig(max_new_tokens=4)
        asr = WhisperTextPipeline(cfg=w, decode=d, mel_cfg=mel,
                                  device="cpu")
        cap = WhisperTextPipeline(cfg=w, decode=d, mel_cfg=mel, seed=1,
                                  prefix_ids=[w.bos_token_id],
                                  device="cpu")
        emb = TextEmbedder(cfg=PRESETS["test"], device="cpu")
        cfg = EngineConfig(ingest_batch=4, embed_dim=64,
                           transfer_dtype="mel16")
        eng = P.AudioSearchEngine(
            cfg=cfg, ingest_pipeline=DualPipelineIngest(asr, cap, emb, cfg))
        segs = eng.ingest(data, source_name="v.mp3")
        assert eng.ingest_pipeline.last_transfer_resolved == "mel16"
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("OK", len(x), sr, len(segs))
    """)
    res = subprocess.run([sys.executable, "-c", code, str(MP3)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(MP3.parents[2]))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK 225216 16000 ")
