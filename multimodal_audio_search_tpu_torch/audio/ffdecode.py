"""ctypes bridge to the FFmpeg-backed container decoder (native/ffdecode.cc)
for M4A (AAC) and OGG uploads.

Counterpart of ``multimodal_audio_search_tpu/audio/ffdecode.py``, the
same code over the same source but for the build step: compiled on first
use against the system's libavformat/libavcodec into the port's
git-ignored ``multimodal_audio_search_tpu_torch/_build/`` under a
per-process temporary name. Where the FFmpeg headers or libraries are
missing, ``available()`` is False and ``decode`` raises a ValueError that
names them; only M4A and OGG depend on this module (FLAC and MP3 have
their own sources).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "ffdecode.cc"
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False

_LIBS = ["-lavformat", "-lavcodec", "-lavutil"]


def _build_and_load() -> ctypes.CDLL | None:
    global _failed
    if not _SRC.exists():
        _failed = True
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"ffdecode_{tag}.so"
    if not so.exists():
        if shutil.which("g++") is None:
            _failed = True
            return None
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               "-o", str(tmp), str(_SRC)] + _LIBS
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
            os.replace(tmp, so)
        except Exception:
            _failed = True
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        _failed = True
        return None
    lib.mas_ff_decode.restype = ctypes.c_int
    lib.mas_ff_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.mas_ff_free.restype = None
    lib.mas_ff_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.mas_ff_encode_file.restype = ctypes.c_int
    lib.mas_ff_encode_file.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            _lib = _build_and_load()
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode(data: bytes) -> tuple[np.ndarray, int]:
    """Container bytes -> ([n] mono or [n, ch] float32, rate).

    Raises ValueError on undecodable input.
    """
    lib = get_lib()
    if lib is None:
        raise ValueError(
            "m4a/container decode requires the FFmpeg libraries "
            "(libavformat/libavcodec not usable on this system); register "
            "an alternative via audio.decode.register_decoder")
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64(0)
    ch = ctypes.c_int32(0)
    rate = ctypes.c_int32(0)
    rc = lib.mas_ff_decode(data, len(data), ctypes.byref(out),
                           ctypes.byref(frames), ctypes.byref(ch),
                           ctypes.byref(rate))
    if rc != 0 or frames.value <= 0:
        raise ValueError(f"container decode failed (rc={rc})")
    try:
        n = frames.value * ch.value
        pcm = np.ctypeslib.as_array(out, shape=(n,)).astype(np.float32)
        if ch.value > 1:
            pcm = pcm.reshape(-1, ch.value)
        return pcm, int(rate.value)
    finally:
        lib.mas_ff_free(out)


def encode_file(pcm: np.ndarray, rate: int, path: str) -> None:
    """Mono float PCM -> encoded file (AAC for .m4a). Test vectors only."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("ffdecode native module unavailable")
    x = np.ascontiguousarray(pcm, np.float32)
    rc = lib.mas_ff_encode_file(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), rate,
        str(path).encode())
    if rc != 0:
        raise RuntimeError(f"encode failed (rc={rc})")
