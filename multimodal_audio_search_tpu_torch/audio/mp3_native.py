"""ctypes bridge to the from-scratch MPEG-1/2/2.5 Layer III decoder
(native/mp3_decode.cc, with its Huffman tables and synthesis window in
native/*.inc).

Counterpart of ``multimodal_audio_search_tpu/audio/mp3_native.py``, the
same code over the same sources but for the build step: compiled on
first use into the port's git-ignored
``multimodal_audio_search_tpu_torch/_build/`` under a per-process
temporary name (``os.replace`` into place). audio/decode.py prefers it;
the libmpg123 FFI (audio/mp3.py) is the fallback and the tests' oracle.
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
_SRC = _REPO / "native" / "mp3_decode.cc"
_INCS = [_REPO / "native" / "mp3_tables.inc",
         _REPO / "native" / "mp3_synth_window.inc"]
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _build_and_load() -> ctypes.CDLL | None:
    global _failed
    srcs = [_SRC] + _INCS
    if not all(s.exists() for s in srcs):
        _failed = True
        return None
    tag = hashlib.sha256(
        b"".join(s.read_bytes() for s in srcs)).hexdigest()[:16]
    so = _BUILD / f"mp3_decode_{tag}.so"
    if not so.exists():
        if shutil.which("g++") is None:
            _failed = True
            return None
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               "-I", str(_REPO / "native"), "-o", str(tmp), str(_SRC)]
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
    lib.mas_mp3_decode.restype = ctypes.c_int
    lib.mas_mp3_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.mas_mp3_free.restype = None
    lib.mas_mp3_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
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


def decode_mp3_native(data: bytes) -> tuple[np.ndarray, int]:
    """mp3 bytes -> ([n] mono or [n, ch] float32, rate); ValueError on
    undecodable input."""
    lib = get_lib()
    if lib is None:
        raise ValueError("native mp3 decoder unavailable (build failed)")
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64(0)
    ch = ctypes.c_int32(0)
    rate = ctypes.c_int32(0)
    rc = lib.mas_mp3_decode(data, len(data), ctypes.byref(out),
                            ctypes.byref(frames), ctypes.byref(ch),
                            ctypes.byref(rate))
    if rc != 0 or frames.value <= 0:
        raise ValueError(f"no decodable mp3 audio found (rc={rc})")
    try:
        n = frames.value * ch.value
        pcm = np.ctypeslib.as_array(out, shape=(n,)).astype(np.float32)
        if ch.value > 1:
            pcm = pcm.reshape(-1, ch.value)
        return pcm, int(rate.value)
    finally:
        lib.mas_mp3_free(out)
