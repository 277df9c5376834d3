"""ctypes bridge to the C++ audio runtime (native/audio_kernels.cc and
native/flac_decode.cc): native WAV and FLAC decoding, the polyphase
resampler, the fused transfer quantizers (mu-law, int16, int12) and the
fused host log-mel encoder of the mel transfer codecs.

Counterpart of ``multimodal_audio_search_tpu/audio/native.py``, the same
code over the same sources (held to it by tests/test_torch_copies.py)
but for the build step: the library is compiled on first use (``g++ -O3
-ffp-contract=off``, no FMA contraction, so the quantizers round exactly
as the two-op float32 numpy path does) into the port's git-ignored
``multimodal_audio_search_tpu_torch/_build/``, under a per-process
temporary name moved into place with ``os.replace``, so processes that
build at once never load each other's half-written file. Without g++ or
the sources ``available()`` is False and every caller takes its numpy
path, which gives the same bits (wav.py, resample.py, the numpy
quantizers in pipelines/ingest.py and ops/mel.py). The arrays go to C as
``ctypes.cast(a.ctypes.data, POINTER(...))`` where the JAX package calls
``a.ctypes.data_as(POINTER(...))``: data_as leaves a reference cycle
behind each call (two objects only the garbage collector frees), which
showed as traced heap growth over repeated ingests.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "audio_kernels.cc"
_FLAC_SRC = _REPO / "native" / "flac_decode.cc"
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _build_and_load() -> ctypes.CDLL | None:
    global _failed
    srcs = [s for s in (_SRC, _FLAC_SRC) if s.exists()]
    if not srcs:
        _failed = True
        return None
    tag = hashlib.sha256(
        b"".join(s.read_bytes() for s in srcs)).hexdigest()[:16]
    so = _BUILD / f"audio_kernels_{tag}.so"
    if not so.exists():
        if shutil.which("g++") is None:
            _failed = True
            return None
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        # -ffp-contract=off: the quantize kernels must round exactly like
        # the two-op f32 numpy path; an FMA-contracted mul+add computes a
        # more-precise intermediate that can flip half-grid samples.
        cmd = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
               "-pthread", "-std=c++17", "-o", str(tmp)] \
            + [str(s) for s in srcs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except Exception:
            _failed = True
            return None
    lib = ctypes.CDLL(str(so))
    lib.mas_wav_probe.restype = ctypes.c_int
    lib.mas_wav_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        _i32p, _i32p, _i32p, _i32p, _i64p, _i64p]
    lib.mas_wav_decode_mono.restype = ctypes.c_int
    lib.mas_wav_decode_mono.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.mas_resample_poly.restype = None
    lib.mas_resample_poly.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.mas_peak_abs.restype = ctypes.c_float
    lib.mas_peak_abs.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.mas_quantize_mulaw.restype = None
    lib.mas_quantize_mulaw.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8)]
    lib.mas_quantize_int16.restype = None
    lib.mas_quantize_int16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int16)]
    if hasattr(lib, "mas_quantize_int12"):
        lib.mas_quantize_int12.restype = None
        lib.mas_quantize_int12.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8)]
    if hasattr(lib, "mas_mel_encode"):
        lib.mas_mel_encode.restype = ctypes.c_int
        lib.mas_mel_encode.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    if hasattr(lib, "mas_flac_probe"):
        lib.mas_flac_probe.restype = ctypes.c_int
        lib.mas_flac_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _i32p, _i32p, _i32p, _i64p]
        lib.mas_flac_decode_mono.restype = ctypes.c_int64
        lib.mas_flac_decode_mono.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
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


def wav_decode_mono(data: bytes) -> tuple[np.ndarray, int] | None:
    """Native WAV -> (mono float32, rate); None if unsupported here."""
    lib = get_lib()
    if lib is None:
        return None
    tag = ctypes.c_int32(); ch = ctypes.c_int32(); rate = ctypes.c_int32()
    bits = ctypes.c_int32(); off = ctypes.c_int64(); dlen = ctypes.c_int64()
    rc = lib.mas_wav_probe(
        data, len(data), ctypes.byref(tag), ctypes.byref(ch),
        ctypes.byref(rate), ctypes.byref(bits),
        ctypes.byref(off), ctypes.byref(dlen))
    if rc != 0 or bits.value % 8 != 0 or bits.value == 0:
        return None
    bytes_per = ch.value * bits.value // 8
    frames = dlen.value // bytes_per
    out = np.empty(frames, np.float32)
    payload = data[off.value: off.value + dlen.value]
    rc = lib.mas_wav_decode_mono(
        payload, dlen.value, tag.value, ch.value, bits.value,
        ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_float)), frames)
    if rc != 0:
        return None
    return out, rate.value


def resample_poly(
    x: np.ndarray, h: np.ndarray, up: int, down: int,
    start: int, n_out: int,
) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    xf = np.ascontiguousarray(x, np.float32)
    hd = np.ascontiguousarray(h, np.float64)
    y = np.empty(n_out, np.float32)
    lib.mas_resample_poly(
        ctypes.cast(xf.ctypes.data, ctypes.POINTER(ctypes.c_float)), len(xf),
        ctypes.cast(hd.ctypes.data, ctypes.POINTER(ctypes.c_double)), len(hd),
        up, down, start,
        ctypes.cast(y.ctypes.data, ctypes.POINTER(ctypes.c_float)), n_out)
    return y


def flac_decode_mono(data: bytes) -> tuple[np.ndarray, int] | None:
    """Native FLAC -> (mono float32, rate); None if unsupported here."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mas_flac_probe"):
        return None
    rate = ctypes.c_int32(); ch = ctypes.c_int32()
    bps = ctypes.c_int32(); total = ctypes.c_int64()
    rc = lib.mas_flac_probe(
        data, len(data), ctypes.byref(rate), ctypes.byref(ch),
        ctypes.byref(bps), ctypes.byref(total))
    if rc != 0:
        return None
    # When STREAMINFO carries total_samples, that IS the capacity. When it
    # is 0 (unknown-length stream), start from a bytes->samples guess and
    # regrow: FLAC constant/silence blocks compress far below 1 bit/sample,
    # so a full buffer (n == cap) means "truncated", not "done" — the C
    # decoder stops writing at capacity (native/flac_decode.cc:273-280).
    known = total.value > 0
    # unknown-length start: real-world FLAC runs ~0.5-0.7 compressed
    # bytes per 16-bit sample, so len(data) samples over-covers typical
    # files while the *4 regrow handles constant/silence blocks that
    # compress below 1 bit/sample — a len*8 start allocated ~32x the
    # file size in f32 up front (1.6 GB for a 50 MB stream)
    cap = int(total.value) if known else max(len(data), 1 << 16)
    while True:
        out = np.empty(cap, np.float32)
        n = lib.mas_flac_decode_mono(
            data, len(data),
            ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_float)), cap)
        if n < 0:
            return None
        if known or n < cap:
            return out[:n].copy(), rate.value
        cap *= 4


def quantize_mulaw(
    w: np.ndarray, scale: float, lut: np.ndarray, out: np.ndarray,
) -> bool:
    """Fused (scale, int16-grid, mu-law LUT) encode of one window into
    ``out`` (int8, contiguous, len == len(w)). Single pass, no temps —
    bit-identical to the numpy closed form (see mas_quantize_mulaw)."""
    lib = get_lib()
    if lib is None:
        return False
    w = np.ascontiguousarray(w, np.float32)  # ctypes reads raw memory
    lib.mas_quantize_mulaw(
        ctypes.cast(w.ctypes.data, ctypes.POINTER(ctypes.c_float)), len(w),
        ctypes.c_float(scale),
        ctypes.cast(lut.ctypes.data, ctypes.POINTER(ctypes.c_int8)),
        ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_int8)))
    return True


def quantize_int16(w: np.ndarray, scale: float, out: np.ndarray) -> bool:
    """Fused (scale, clip, int16) encode of one window into ``out``."""
    lib = get_lib()
    if lib is None:
        return False
    w = np.ascontiguousarray(w, np.float32)  # ctypes reads raw memory
    lib.mas_quantize_int16(
        ctypes.cast(w.ctypes.data, ctypes.POINTER(ctypes.c_float)), len(w),
        ctypes.c_float(scale),
        ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_int16)))
    return True


def quantize_int12(w: np.ndarray, scale: float, out: np.ndarray) -> bool:
    """Fused (scale, round, 12-bit two's-complement pack) encode of one
    window into ``out`` (uint8, contiguous, >= 3*ceil(len(w)/2) bytes;
    two samples per 3 bytes, odd tail pairs with an implicit zero)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mas_quantize_int12"):
        return False
    need = 3 * ((len(w) + 1) // 2)
    if out.size < need:
        return False
    w = np.ascontiguousarray(w, np.float32)  # ctypes reads raw memory
    lib.mas_quantize_int12(
        ctypes.cast(w.ctypes.data, ctypes.POINTER(ctypes.c_float)), len(w),
        ctypes.c_float(scale),
        ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_uint8)))
    return True


def mel_encode(x: np.ndarray, win: np.ndarray, melw: np.ndarray,
               n_fft: int, hop: int, n_frames: int, bits: int,
               log_lo: float, code_scale: float,
               relative: bool = False) -> np.ndarray | None:
    """Fused host log-mel transfer encode (mas_mel_encode): padded f64
    input [B, need] -> uint16 codes [B, n_mels, n_frames] (bits=16,
    absolute range) or the relative-range byte streams of
    encode_mel12/encode_mel8 (12-bit pack / 1 B codes + f32 gmax tail).
    None when the library or this n_fft factorization is unavailable —
    callers fall back to the numpy path in ops/mel.py."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "mas_mel_encode"):
        return None
    b = x.shape[0]
    n_mels = melw.shape[1]
    n_codes = n_mels * n_frames
    if bits == 12 and n_codes % 2 != 0:
        return None
    x = np.ascontiguousarray(x, np.float64)
    win = np.ascontiguousarray(win, np.float64)
    melw = np.ascontiguousarray(melw, np.float64)
    tail = 4 if relative else 0
    if bits == 16:
        out = np.empty((b, n_mels, n_frames), np.uint16)
        row_bytes = n_codes * 2
    elif bits == 12:
        out = np.empty((b, n_codes * 3 // 2 + tail), np.uint8)
        row_bytes = out.shape[1]
    else:
        out = np.empty((b, n_codes + tail), np.uint8)
        row_bytes = out.shape[1]
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.mas_mel_encode(
        ctypes.cast(x.ctypes.data, dp), b, x.shape[1],
        ctypes.cast(win.ctypes.data, dp), ctypes.cast(melw.ctypes.data, dp),
        n_fft, hop, melw.shape[0], n_mels, n_frames, bits,
        ctypes.c_double(log_lo), ctypes.c_double(code_scale),
        1 if relative else 0,
        ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_uint8)),
        row_bytes)
    return out if rc == 0 else None


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray | None:
    """Native end-to-end resample matching audio/resample.py semantics."""
    from .resample import design_kaiser_lowpass
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    h = design_kaiser_lowpass(up, down)
    n_out = -(-len(x) * sr_out // sr_in)
    # group delay, rounded to an output-sample boundary so this path is
    # bit-consistent with the python upfirdn slice in resample.py
    start = (((len(h) - 1) // 2) // down) * down
    return resample_poly(x, h, up, down, start, n_out)
