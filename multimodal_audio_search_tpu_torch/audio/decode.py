"""File -> 16 kHz mono float32 waveform (the reference's librosa.load).

Counterpart of ``multimodal_audio_search_tpu/audio/decode.py``, WAV only:
the numpy reader (audio/wav.py) and the numpy resampler
(audio/resample.py). FLAC, MP3, M4A and OGG decoders and the native C++
fast paths are not ported yet (ROADMAP A16); those containers raise.
"""
from __future__ import annotations

import io
import pathlib

import numpy as np

from .resample import resample
from .wav import read_wav, to_mono

_NOT_PORTED = ("flac", "mp3", "m4a", "ogg")


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


def load_audio(
    src: bytes | str | pathlib.Path | io.BufferedIOBase,
    sample_rate: int = 16_000,
    mono: bool = True,
) -> tuple[np.ndarray, int]:
    """Decode + downmix + resample. Returns (waveform float32, sample_rate).

    Same contract as the JAX package's ``load_audio`` for WAV input."""
    if isinstance(src, (str, pathlib.Path)):
        data = pathlib.Path(src).read_bytes()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        data = src.read()

    kind = sniff_format(data)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"{kind.upper()} decoding is not ported to the PyTorch package "
            f"yet (ROADMAP A16); decode to WAV first")
    if kind != "wav":
        raise ValueError(
            f"unsupported audio container {kind!r}; the PyTorch package "
            f"reads WAV")
    x, rate = read_wav(data)
    if mono and x.ndim == 2:
        x = to_mono(x)
    x = np.asarray(x, np.float32)
    if rate != sample_rate:
        if x.ndim == 2:  # resample each channel along time
            x = np.stack([resample(np.ascontiguousarray(x[:, c]), rate,
                                   sample_rate)
                          for c in range(x.shape[1])], axis=1)
        else:
            x = resample(x, rate, sample_rate)
    return x, sample_rate
