"""MP3 (MPEG-1/2/2.5 Layer III) decode via a direct libmpg123 FFI.

Counterpart of ``multimodal_audio_search_tpu/audio/mp3.py``, the same
code (held to it by tests/test_torch_copies.py). A ctypes binding onto
the system's libmpg123, feeding the decoder in memory and reading
native-rate float32 PCM into a numpy buffer. audio/decode.py uses it
only where the in-tree decoder (audio/mp3_native.py) did not build; the
tests hold that decoder to this one sample for sample.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

MPG123_OK = 0
MPG123_DONE = -12
MPG123_NEW_FORMAT = -11
MPG123_NEED_MORE = -10
MPG123_ENC_FLOAT_32 = 0x200


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL | None:
    for name in ("libmpg123.so.0", "libmpg123.so",
                 ctypes.util.find_library("mpg123")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_long, ctypes.c_double]
        return lib
    return None


def available() -> bool:
    return _lib() is not None


# all MPEG-1/2/2.5 Layer III rates, so mpg123_format can pre-accept them
_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)


def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """mp3 bytes -> ([n] mono or [n, ch] float32 in [-1, 1], rate).

    Raises ValueError on undecodable input (sniffed-as-mp3 garbage).
    """
    lib = _lib()
    if lib is None:
        raise ValueError(
            "mp3 decode requires libmpg123 (not found on this system); "
            "register an alternative via audio.decode.register_decoder")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(f"mpg123_new failed ({err.value})")
    try:
        # force float32 output at the stream's native rate, any channels
        lib.mpg123_format_none(h)
        for rate in _RATES:
            for ch in (1, 2):
                lib.mpg123_format(h, rate, ch, MPG123_ENC_FLOAT_32)
        if lib.mpg123_open_feed(h) != MPG123_OK:
            raise ValueError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != MPG123_OK:
            raise ValueError("mpg123_feed failed")

        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        chunks: list[bytes] = []
        buf = (ctypes.c_char * (1 << 18))()
        done = ctypes.c_size_t(0)
        got_format = False
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate),
                                     ctypes.byref(channels),
                                     ctypes.byref(enc))
                got_format = True
            elif rc in (MPG123_DONE, MPG123_NEED_MORE):
                # feed-mode: NEED_MORE after the full feed means EOF
                break
            elif rc != MPG123_OK:
                raise ValueError(f"mpg123_read error {rc}")
        if not got_format or not chunks:
            raise ValueError("no decodable mp3 audio found")
        pcm = np.frombuffer(b"".join(chunks), np.float32)
        if channels.value > 1:
            pcm = pcm.reshape(-1, channels.value)
        return pcm, int(rate.value)
    finally:
        lib.mpg123_delete(h)
