"""The port's audio front door against the JAX package's, on the same
bytes: the native C++ libraries (WAV, FLAC, the resampler), the MP3
decoders, the FFmpeg container decoder (M4A, OGG) and ``load_audio``.

* WAV and the resampler: the port's native paths bit-equal to JAX's
  native paths and to the numpy paths (44.1, 48, 22.05 and 8 kHz ->
  16 kHz);
* FLAC: bit-equal to JAX's native decoder over tests/flac_fixture.py
  streams (every subframe kind, mono and stereo, an unknown length, the
  corrupt-tail salvage) and refusing what JAX refuses;
* MP3: the port's in-tree decoder sample for sample equal to JAX's and
  within 3e-6 of libmpg123 on lame vectors across MPEG-1/2/2.5, mono and
  stereo; the committed vector (tests/make_mp3_vector.py) against its
  fingerprint;
* M4A/OGG: equal to JAX's ffdecode; a named ValueError where the FFmpeg
  libraries are missing;
* the build: the port's three loaders compile into the port's _build/,
  never into native/build/, from the sources JAX's loaders hash.
"""
import json
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from multimodal_audio_search_tpu.audio import decode as JD
from multimodal_audio_search_tpu.audio import ffdecode as JFF
from multimodal_audio_search_tpu.audio import mp3 as JMP3
from multimodal_audio_search_tpu.audio import mp3_native as JMP3N
from multimodal_audio_search_tpu.audio import native as JN
from multimodal_audio_search_tpu_torch.audio import decode as TD
from multimodal_audio_search_tpu_torch.audio import ffdecode as TFF
from multimodal_audio_search_tpu_torch.audio import mp3_native as TMP3N
from multimodal_audio_search_tpu_torch.audio import native as TN
from multimodal_audio_search_tpu_torch.audio import resample as TR
from multimodal_audio_search_tpu_torch.audio.wav import (
    read_wav, to_mono, write_wav)

from flac_fixture import encode_flac
from make_mp3_vector import FINGERPRINT, MP3, fingerprint

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]

needs_native = pytest.mark.skipif(
    not (TN.available() and JN.available()),
    reason="g++ could not build the native audio library")
needs_mp3 = pytest.mark.skipif(
    not (TMP3N.available() and JMP3N.available() and JMP3.available()),
    reason="native mp3 decoder or libmpg123 unavailable")
needs_ff = pytest.mark.skipif(
    not (TFF.available() and JFF.available()),
    reason="FFmpeg libraries or headers unavailable")


def _eq(a, b):
    """Both None, or the same (array, rate) bit for bit."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a[1] == b[1]
    assert a[0].dtype == b[0].dtype and a[0].shape == b[0].shape
    np.testing.assert_array_equal(a[0], b[0])


# ------------------------------------------------------------------ WAV
def _wav24(x, rate):
    """24-bit PCM WAV bytes of [n, ch] float samples (wav.py writes only
    16- and 32-bit)."""
    import struct
    q = np.clip(np.round(x * 8388607.0), -8388608, 8388607).astype("<i4")
    payload = q.view(np.uint8).reshape(*q.shape, 4)[..., :3].tobytes()
    ch = x.shape[1]
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload),
                      b"WAVE", b"fmt ", 16, 1, ch, rate, rate * ch * 3,
                      ch * 3, 24, b"data", len(payload))
    return hdr + payload


@needs_native
@pytest.mark.parametrize("bits,ch,rate", [
    (16, 2, 44100), (16, 1, 16000), (24, 2, 48000), (32, 1, 22050)])
def test_wav_native_bit_equal(rng, tmp_path, bits, ch, rate):
    x = (rng.normal(size=(rate // 2, ch)) * 0.3).clip(-1, 1) \
        .astype(np.float32)
    p = tmp_path / "a.wav"
    if bits == 24:
        data = _wav24(x, rate)
    else:
        write_wav(str(p), x[:, 0] if ch == 1 else x, rate, bits=bits)
        data = p.read_bytes()
    got = TN.wav_decode_mono(data)
    _eq(got, JN.wav_decode_mono(data))
    y, r = read_wav(data)
    _eq(got, (to_mono(y).astype(np.float32), r))


@needs_native
@pytest.mark.parametrize("sr_in", [44100, 48000, 22050, 8000])
def test_resample_native_bit_equal_numpy(rng, sr_in):
    """The native polyphase resampler gives the numpy resampler's
    samples bit for bit (and JAX's native ones)."""
    x = (rng.normal(size=sr_in * 2 + 37) * 0.3).astype(np.float32)
    got = TN.resample(x, sr_in, 16000)
    np.testing.assert_array_equal(got, TR.resample(x, sr_in, 16000))
    np.testing.assert_array_equal(got, JN.resample(x, sr_in, 16000))
    np.testing.assert_array_equal(TR.resample_best(x, sr_in, 16000), got)


@needs_native
def test_load_audio_wav_equal_jax(rng, tmp_path):
    x = (rng.normal(size=(44100, 2)) * 0.3).astype(np.float32)
    p = tmp_path / "s.wav"
    write_wav(str(p), x, 44100)
    got = TD.load_audio(str(p), 16000)
    _eq(got, JD.load_audio(str(p), 16000))
    assert got[0].shape == (16000,)


# ----------------------------------------------------------------- FLAC
def _tone(n, ch=1, f=440.0, rate=16000, amp=8000):
    t = np.arange(n) / rate
    x = (amp * np.sin(2 * np.pi * f * t)).astype(np.int16)
    return np.stack([x, x // 2], axis=1) if ch == 2 else x


def _crafted(bs, subframe_bits):
    from test_flac import _crafted_frame
    return _crafted_frame(bs, subframe_bits)


def _lpc32(w):
    w.write(0, 1)
    w.write(0b111111, 6)       # LPC order 32 on a 1-sample block
    w.write(0, 1)
    w.write(0, 64)


def _wasted(w):
    w.write(0, 1)
    w.write(1, 6)              # VERBATIM
    w.write(1, 1)              # wasted bits 21 >= 16 bps
    w.write(0, 20)
    w.write(1, 1)
    w.write(0, 64)


FLAC_CASES = {
    **{f"mono_{m}": lambda m=m: encode_flac(
        np.full(3000, 1234, np.int16) if m == "constant" else _tone(3000),
        rate=16000, blocksize=1024, mode=m)
       for m in ("verbatim", "constant", "fixed0", "fixed1", "fixed2")},
    "stereo_fixed1_22k": lambda: encode_flac(
        _tone(2500, ch=2, rate=22050), rate=22050, blocksize=512,
        mode="fixed1"),
    "stereo_verbatim": lambda: encode_flac(
        _tone(2000, ch=2), rate=16000, blocksize=1024, mode="verbatim"),
    "unknown_length": lambda: encode_flac(
        np.full(200_000, 777, np.int16), rate=16000, blocksize=4096,
        mode="constant", total_in_streaminfo=False),
    "corrupt_tail": lambda: encode_flac(_tone(2048), blocksize=1024)
    + _crafted(1, _lpc32),
    "garbage": lambda: b"fLaC" + b"\x00" * 10,
    "lpc_order_past_block": lambda: encode_flac(np.zeros(0, np.int16))
    + _crafted(1, _lpc32),
    "wasted_bits_past_bps": lambda: encode_flac(np.zeros(0, np.int16))
    + _crafted(16, _wasted),
}


@needs_native
@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_bit_equal_jax(case):
    data = FLAC_CASES[case]()
    got = TN.flac_decode_mono(data)
    _eq(got, JN.flac_decode_mono(data))
    if case in ("garbage", "lpc_order_past_block", "wasted_bits_past_bps"):
        assert got is None
        with pytest.raises(ValueError, match="FLAC"):
            TD.load_audio(data)
    else:
        assert got is not None and len(got[0]) > 0
        _eq(TD.load_audio(data, 16000), JD.load_audio(data, 16000))


@needs_native
def test_flac_decodes_the_source_pcm():
    x = _tone(5000, ch=2)
    y, rate = TD.load_audio(encode_flac(x, rate=16000, mode="fixed2"),
                            16000)
    np.testing.assert_allclose(
        y, x.astype(np.float32).mean(axis=1) / 32768.0, atol=1e-6)


# ------------------------------------------------------------------ MP3
def _signal(rng, rate, secs=1.5, f=440.0):
    t = np.arange(int(rate * secs)) / rate
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.normal(size=len(t))
    for k in range(8):          # transients: short/start/stop blocks
        i = int((k + 0.5) * len(t) / 8)
        x[i:i + 50] += np.hanning(50) * 0.5 * (-1) ** k
    return np.clip(x, -0.9, 0.9).astype(np.float32)


def _mp3_exact(data):
    got, r1 = TMP3N.decode_mp3_native(data)
    ref, r0 = JMP3N.decode_mp3_native(data)
    assert r1 == r0 and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    lib, r2 = JMP3.decode_mp3(data)
    assert r2 == r1 and lib.shape == got.shape
    np.testing.assert_allclose(got, lib, atol=3e-6)
    _eq(TD.load_audio(data, 16000), JD.load_audio(data, 16000))


@needs_mp3
@pytest.mark.parametrize("rate,kbps", [
    (44100, 128), (32000, 64),            # MPEG-1
    (22050, 64), (16000, 32),             # MPEG-2
    (11025, 32), (8000, 24)])             # MPEG-2.5
def test_mp3_mono_sample_exact(rng, rate, kbps):
    from tests.lame_fixture import encode
    _mp3_exact(encode(_signal(rng, rate), rate, bitrate=kbps, mode=3))


@needs_mp3
@pytest.mark.parametrize("rate,mode,vbr", [
    (44100, 1, False), (44100, 0, True), (22050, 1, False)])
def test_mp3_stereo_sample_exact(rng, rate, mode, vbr):
    from tests.lame_fixture import encode
    left = _signal(rng, rate, f=440.0)
    right = np.clip(0.7 * _signal(rng, rate, f=650.0) + 0.3 * left, -.9, .9)
    _mp3_exact(encode(np.stack([left, right], 1), rate, bitrate=128,
                      mode=mode, vbr=vbr))


@needs_mp3
def test_committed_mp3_vector_fingerprint():
    """The committed vector decodes, through the port, to the fingerprint
    JAX's native decoder gave when it was made: sample count and rate
    exact, each 1024-sample block's RMS within 1e-5."""
    data = MP3.read_bytes()
    assert len(data) <= 64 * 1024 and TD.sniff_format(data) == "mp3"
    want = json.loads(FINGERPRINT.read_text())
    pcm, rate = TMP3N.decode_mp3_native(data)
    got = fingerprint(pcm, rate)
    assert (got["samples"], got["rate"]) == (want["samples"], want["rate"])
    np.testing.assert_allclose(got["rms"], want["rms"], rtol=0, atol=1e-5)
    y, sr = TD.load_audio(data, 16000)
    assert sr == 16000 and len(y) == want["samples"]


def test_mp3_falls_back_to_libmpg123(monkeypatch):
    """Without the in-tree build, load_audio decodes through libmpg123."""
    if not JMP3.available():
        pytest.skip("libmpg123 unavailable")
    from multimodal_audio_search_tpu_torch.audio import mp3 as TMP3
    data = MP3.read_bytes()
    monkeypatch.setattr(TMP3N, "available", lambda: False)
    y, _ = TD.load_audio(data, 16000)
    ref, _ = TMP3.decode_mp3(data)
    np.testing.assert_array_equal(y, ref)


# ------------------------------------------------------------- M4A, OGG
@needs_ff
@pytest.mark.parametrize("ext,kind", [("m4a", "m4a"), ("ogg", "ogg")])
def test_container_equal_jax(rng, tmp_path, ext, kind):
    p = tmp_path / f"x.{ext}"
    TFF.encode_file((rng.normal(size=44100 * 2) * 0.2).astype(np.float32),
                    44100, str(p))
    data = p.read_bytes()
    assert TD.sniff_format(data) == kind
    _eq(TFF.decode(data), JFF.decode(data))
    got = TD.load_audio(data, 16000)
    _eq(got, JD.load_audio(data, 16000))
    assert abs(len(got[0]) - 2 * 16000) < 2000


@pytest.mark.parametrize("head", [b"\x00\x00\x00\x1cftypM4A ", b"OggS"])
def test_container_without_ffmpeg_names_the_libraries(monkeypatch, head):
    monkeypatch.setattr(TFF, "get_lib", lambda: None)
    with pytest.raises(ValueError, match="libavformat/libavcodec"):
        TD.load_audio(head + b"\x00" * 256)


def test_register_decoder_overrides():
    seen = []

    def dec(data):
        seen.append(len(data))
        return np.ones(8000, np.float32), 8000
    old = dict(TD._DECODERS)
    try:
        TD.register_decoder("ogg", dec)
        y, sr = TD.load_audio(b"OggS" + bytes(12), 16000)
    finally:
        TD._DECODERS.clear()
        TD._DECODERS.update(old)
    assert seen == [16] and sr == 16000 and len(y) == 16000
    with pytest.raises(ValueError, match="register_decoder"):
        TD.load_audio(b"not audio at all")


# ---------------------------------------------------------------- build
def test_port_loaders_build_only_into_the_port(tmp_path):
    """A tree holding only native/ and the port's three loaders: loading
    them builds three libraries under the port's _build/, named by the
    hash JAX's loaders give the same sources, and creates no
    native/build/."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("build"))
    pkg = tmp_path / "multimodal_audio_search_tpu_torch" / "audio"
    pkg.mkdir(parents=True)
    for name in ("native.py", "mp3_native.py", "ffdecode.py"):
        shutil.copy(ROOT / "multimodal_audio_search_tpu_torch" / "audio"
                    / name, pkg / name)
    code = textwrap.dedent(f"""
        import importlib.util, pathlib
        out = []
        for name in ("native", "mp3_native", "ffdecode"):
            spec = importlib.util.spec_from_file_location(
                name, {str(pkg)!r} + "/" + name + ".py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            lib = mod.get_lib()
            out.append(pathlib.Path(lib._name).name if lib else "")
        print(",".join(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    names = res.stdout.strip().split(",")
    want = [pathlib.Path(m.get_lib()._name).name if m.get_lib() else ""
            for m in (JN, JMP3N, JFF)]
    assert names == want and names[0] and names[1]
    built = sorted(p.name for p in
                   (tmp_path / "multimodal_audio_search_tpu_torch"
                    / "_build").iterdir())
    assert built == sorted(n for n in names if n)    # no temporaries left
    assert not (tmp_path / "native" / "build").exists()

