"""RIFF/WAVE codec in pure numpy (no librosa/soundfile in this image).

Reads PCM u8/s16/s24/s32 and IEEE float32/64, including WAVE_FORMAT_EXTENSIBLE,
tolerating the odd-chunk padding and oversized/truncated ``data`` sizes that
real files exhibit. Returns float32 in [-1, 1). A minimal writer exists for
tests/fixtures. A C++ fast path for bulk s24 conversion lives in native/
(audio/native.py); this module is the always-available fallback.
"""
from __future__ import annotations

import io
import struct

import numpy as np

PCM = 1
IEEE_FLOAT = 3
EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    pass


def read_wav(src: bytes | str | io.BufferedIOBase) -> tuple[np.ndarray, int]:
    """Decode a WAV file. Returns (samples[frames, channels] float32, rate)."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = src.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise WavError("fmt chunk too small")
            tag, ch, rate, _, block, bits = struct.unpack_from(
                "<HHIIHH", body, 0)
            if tag == EXTENSIBLE and len(body) >= 26:
                # SubFormat GUID's first 2 bytes carry the real format tag
                (tag,) = struct.unpack_from("<H", body, 24)
            fmt = (tag, ch, rate, block, bits)
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise WavError("missing fmt or data chunk")
    tag, ch, rate, _block, bits = fmt
    if ch < 1:
        raise WavError("zero channels")

    if tag == PCM and bits == 16:
        x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
    elif tag == PCM and bits == 8:
        x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) \
            / 128.0
    elif tag == PCM and bits == 24:
        raw = np.frombuffer(payload, np.uint8)
        raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
        as32 = (
            raw[:, 0].astype(np.uint32)
            | (raw[:, 1].astype(np.uint32) << 8)
            | (raw[:, 2].astype(np.uint32) << 16)
        )
        signed = as32.astype(np.int32)
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        x = signed.astype(np.float32) / float(1 << 23)
    elif tag == PCM and bits == 32:
        x = np.frombuffer(payload, "<i4").astype(np.float32) \
            / float(1 << 31)
    elif tag == IEEE_FLOAT and bits == 32:
        x = np.frombuffer(payload, "<f4").astype(np.float32)
    elif tag == IEEE_FLOAT and bits == 64:
        x = np.frombuffer(payload, "<f8").astype(np.float32)
    else:
        raise WavError(f"unsupported format tag={tag} bits={bits}")

    frames = len(x) // ch
    return x[: frames * ch].reshape(frames, ch), rate


def to_mono(x: np.ndarray) -> np.ndarray:
    """Average channels (librosa's mono=True convention)."""
    if x.ndim == 2:
        return x.mean(axis=1, dtype=np.float32) if x.shape[1] > 1 \
            else x[:, 0]
    return x.astype(np.float32)


def write_wav(
    path: str, samples: np.ndarray, rate: int, bits: int = 16
) -> None:
    """Minimal PCM16/float32 writer for fixtures and playback export."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    ch = x.shape[1]
    if bits == 16:
        payload = (np.clip(x, -1.0, 1.0 - 1.0 / 32768) * 32768.0) \
            .astype("<i2").tobytes()
        tag, block = PCM, ch * 2
    elif bits == 32:
        payload = x.astype("<f4").tobytes()
        tag, block = IEEE_FLOAT, ch * 4
    else:
        raise WavError(f"writer supports 16/32 bits, got {bits}")
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(payload), b"WAVE", b"fmt ", 16,
        tag, ch, rate, rate * block, block, bits, b"data", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)
