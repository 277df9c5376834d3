"""chip_smoke.py's ``[audio]`` and ``[codecs]`` phases, held on the CPU.

* ``audio_phase`` is host code: run whole here, every container and the
  native-against-numpy quantizer check pass, and planted faults (a
  quantizer off by one code, a mel encoder off by two) are rejected;
* the codec engines (``CODEC_PATHS``, config-built as chip_smoke builds
  them, at the test presets with short_context) launch what
  ``expected_launches`` says, counted as calls of each kernel's entry
  point, and K2's cross calls run over the encoder's positions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_audio_search_tpu_torch import AudioSearchEngine
from multimodal_audio_search_tpu_torch import config as tcfg
from multimodal_audio_search_tpu_torch.audio import native as TN
from multimodal_audio_search_tpu_torch.ops import mel as TM

from test_torch_slice import SR, _pieces

torch.set_num_threads(1)
needs_native = pytest.mark.skipif(
    not TN.available(), reason="native audio library not built")


@pytest.fixture
def printed(monkeypatch):
    out = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, **kv: out.append((name, kv)))
    return out


@needs_native
def test_audio_phase_on_cpu(printed):
    got = chip_smoke.audio_phase("cpu", np.random.default_rng(1))
    steps = {kv.get("step"): kv for name, kv in printed if name == "audio"}
    assert set(steps) == {"build", "containers", "quantize"}
    assert steps["build"]["audio_kernels"]["available"]
    assert steps["build"]["mp3_decode"]["available"]
    mp3 = steps["containers"]["mp3"]
    assert mp3["samples"] == 225216 and mp3["rms_max_err"] <= 1e-5
    assert set(got["decode_ms"]) >= {"wav_44k1_stereo_10s",
                                     "flac_16k_mono_6s", "mp3_16k_mono_14s"}
    q = steps["quantize"]
    assert q["segments"] == 32 and q["samples_per_segment"] == 160000
    assert q["mel12"]["bytes_per_segment"] == 80 * 1002 * 3 // 2 + 4
    assert set(got["uploads"]) == {"vector.mp3", "tone.flac"}


def _batch():
    return chip_smoke.make_audio(20, np.random.default_rng(3)) \
        .reshape(2, -1)


@needs_native
def test_quantize_check_rejects_a_code_off_by_one(monkeypatch, printed):
    fn = TN.quantize_int12

    def off(w, scale, out):
        ok = fn(w, scale, out)
        out[7] ^= 1
        return ok
    monkeypatch.setattr(TN, "quantize_int12", off)
    with pytest.raises(AssertionError, match="int12"):
        chip_smoke.quantize_check("cpu", _batch())


@needs_native
def test_quantize_check_rejects_mel_codes_off_by_two(monkeypatch, printed):
    fn = TM._native_mel_codes

    def off(wave, cfg, n_frames, bits):
        out = fn(wave, cfg, n_frames, bits)
        if bits == 16 and out is not None and len(out) > 1:
            out = out.copy()
            out[0, 3, 5] += 2
        return out
    monkeypatch.setattr(TM, "_native_mel_codes", off)
    with pytest.raises(AssertionError, match="mel16"):
        chip_smoke.quantize_check("cpu", _batch())


@pytest.mark.parametrize("label", [p[0] for p in chip_smoke.CODEC_PATHS])
def test_codec_engine_launches_what_chip_smoke_expects(monkeypatch, rng,
                                                       label):
    """chip_smoke's codec engines, cut to the test presets (2 s segments
    and short_context on every path, the "test" preset's 100 encoder
    positions, as short_context runs whisper-base at chip_smoke.SHORT_T
    on the card): the kernels' entry points are called as
    expected_launches says, and K2's cross calls see the encoder's
    positions as keys."""
    from multimodal_audio_search_tpu_torch.ops import (
        cross_attention, decoder_block, encoder_block)
    _, profile, fused, transfer = next(
        p for p in chip_smoke.CODEC_PATHS if p[0] == label)
    calls = dict.fromkeys(chip_smoke.KEYS, 0)
    keys = set()
    for key, mod, name in (
            ("K1", encoder_block, "fused_attention_o_residual"),
            ("K2", cross_attention, "fused_single_query_attention"),
            ("K3", decoder_block, "fused_self_block"),
            ("K4", decoder_block, "fused_mlp_block")):
        fn = getattr(mod, name)

        def counted(*a, _f=fn, _k=key, **k):
            calls[_k] += 1
            if _k == "K2" and k.get("pos") is None:
                keys.add(a[1].shape[1])
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    cfg = chip_smoke.codec_config(profile, transfer)
    spec = tcfg.ModelSpec(family="whisper", preset="test")
    dec = dict(max_new_tokens=3)
    assert cfg.short_context == (profile == "fast")
    cfg = cfg.replace(
        ingest_batch=4, embed_dim=64, short_context=True,
        asr_model=spec, caption_model=spec,
        text_embedder=tcfg.ModelSpec(family="minilm", preset="test"),
        segment=tcfg.SegmentConfig(segment_seconds=2.0,
                                   min_segment_seconds=1.0),
        asr_decode=dataclasses.replace(cfg.asr_decode, **dec),
        caption_decode=dataclasses.replace(cfg.caption_decode, **dec))
    assert cfg.transfer_dtype == (transfer or "mulaw8")
    eng = AudioSearchEngine(cfg=cfg, device="cpu")
    ing = eng.ingest_pipeline
    asr, cap = ing.asr, ing.caption
    assert asr.decode.fused_layer is fused
    eng.ingest_waveform(_pieces(rng, 11), SR, "x")
    assert ing.last_transfer_resolved == cfg.transfer_dtype
    steps = (asr.total_steps, cap.total_steps)
    disp = (asr.dispatches, cap.dispatches)
    assert disp == (2, 2)
    assert calls == chip_smoke.expected_launches(fused, None, steps, disp,
                                                 asr, cap)
    assert keys == {asr.mel_cfg.n_frames // 2} == {100}
