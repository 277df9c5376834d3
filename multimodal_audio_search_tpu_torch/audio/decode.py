"""File -> 16 kHz mono float32 waveform (the reference's librosa.load).

Counterpart of ``multimodal_audio_search_tpu/audio/decode.py``, the same
code (held to it by tests/test_torch_copies.py; only the package named
in the unsupported-container message differs). Accept an uploaded file,
decode, downmix to mono, resample to the pipeline rate. Containers are
chosen by their magic bytes:

  * WAV  — native C++ decoder (audio/native.py), numpy fallback (wav.py)
  * FLAC — the from-scratch C++ decoder (native/flac_decode.cc)
  * MP3  — the from-scratch MPEG-1/2/2.5 Layer III decoder
           (audio/mp3_native.py over native/mp3_decode.cc); the
           libmpg123 FFI (audio/mp3.py) where that library did not build
  * M4A/AAC, OGG — libavformat/libavcodec (audio/ffdecode.py); a
           ValueError naming those libraries where they are missing

``register_decoder`` overrides any of them. Resampling takes the native
polyphase resampler where the library built, else the numpy one; both
give the same samples.
"""
from __future__ import annotations

import io
import pathlib
from typing import Callable

import numpy as np

from ..config import AudioConfig
from . import native
from .resample import resample
from .wav import read_wav, to_mono

# decoder: bytes -> (mono_or_multichannel float32, rate)
Decoder = Callable[[bytes], tuple[np.ndarray, int]]
_DECODERS: dict[str, Decoder] = {}


def register_decoder(name: str, fn: Decoder) -> None:
    """Register a container decoder (e.g. an ffmpeg-backed mp3 decoder)."""
    _DECODERS[name] = fn


def sniff_format(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF
                              and (data[1] & 0xE0) == 0xE0):
        return "mp3"
    if data[4:8] == b"ftyp":
        return "m4a"
    if data[:4] == b"OggS":
        return "ogg"
    return "unknown"


def _decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    got = native.wav_decode_mono(data)
    if got is not None:
        return got
    x, rate = read_wav(data)
    return to_mono(x), rate


def load_audio(
    src: bytes | str | pathlib.Path | io.BufferedIOBase,
    sample_rate: int = 16_000,
    mono: bool = True,
    cfg: AudioConfig | None = None,
) -> tuple[np.ndarray, int]:
    """Decode + downmix + resample. Returns (waveform float32, sample_rate).

    Parity with librosa.load(path, sr=16000, mono=True)
    (audio_search.py:233): mono is the channel mean, resampling is
    high-quality polyphase, output length ceil(n*sr_out/sr_in).
    """
    cfg = cfg or AudioConfig()
    if isinstance(src, (str, pathlib.Path)):
        data = pathlib.Path(src).read_bytes()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        data = src.read()

    kind = sniff_format(data)
    if kind == "wav":
        x, rate = _decode_wav(data)
    elif kind == "flac" and kind not in _DECODERS:
        got = native.flac_decode_mono(data)
        if got is None:
            raise ValueError("FLAC decode failed (native decoder "
                             "unavailable or unsupported stream feature)")
        x, rate = got
    elif kind == "mp3" and kind not in _DECODERS:
        from . import mp3_native
        if mp3_native.available():
            x, rate = mp3_native.decode_mp3_native(data)
        else:
            from .mp3 import decode_mp3
            x, rate = decode_mp3(data)
    elif kind in ("m4a", "ogg") and kind not in _DECODERS:
        from .ffdecode import decode as ff_decode
        x, rate = ff_decode(data)
    elif kind in _DECODERS:
        x, rate = _DECODERS[kind](data)
    else:
        raise ValueError(
            f"unsupported audio container {kind!r}; WAV, FLAC, MP3, M4A "
            f"and OGG are built in, register others via "
            f"multimodal_audio_search_tpu_torch.audio.decode.register_decoder")

    if mono and x.ndim == 2:
        x = to_mono(x)
    x = np.asarray(x, np.float32)
    if rate != sample_rate:
        def rs(ch):
            y = native.resample(ch, rate, sample_rate) \
                if native.available() else None
            return y if y is not None else resample(ch, rate, sample_rate)
        if x.ndim == 2:  # resample each channel along time
            x = np.stack([rs(np.ascontiguousarray(x[:, c]))
                          for c in range(x.shape[1])], axis=1)
        else:
            x = rs(x)
    return x, sample_rate
