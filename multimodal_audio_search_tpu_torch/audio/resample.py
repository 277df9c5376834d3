"""Sample-rate conversion to the 16 kHz pipeline rate.

The reference delegates to librosa (soxr) at audio_search.py:233. This is a
Kaiser-windowed polyphase resampler: reduce the ratio to L/M, design one
lowpass FIR at cutoff min(1/L, 1/M), apply via upfirdn. Filter design is our
own (windowed sinc); the inner polyphase convolution uses scipy's C upfirdn
with a numpy fallback, and native/resample.cc provides a C++ path wired in
audio/native.py.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

try:
    from scipy.signal import upfirdn as _upfirdn
except ImportError:  # pragma: no cover
    _upfirdn = None


@lru_cache(maxsize=64)
def design_kaiser_lowpass(
    up: int, down: int, taps_per_phase: int = 24, beta: float = 12.984
) -> np.ndarray:
    """Windowed-sinc lowpass for an L/M polyphase resampler.

    beta ~= 12.98 gives ~130 dB stopband attenuation (Kaiser formula),
    comparable to soxr's HQ preset. Gain is ``up`` to preserve amplitude
    after zero-stuffing.
    """
    max_rate = max(up, down)
    cutoff = 0.5 / max_rate          # normalized to the upsampled Nyquist
    half = taps_per_phase * max_rate
    n = 2 * half + 1
    t = np.arange(n) - half
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.kaiser(n, beta)
    h /= np.sum(h)                   # unity DC gain
    return (h * up).astype(np.float64)


def _upfirdn_numpy(h: np.ndarray, x: np.ndarray, up: int, down: int):
    """Reference polyphase apply (slow; used when scipy is unavailable)."""
    zs = np.zeros(len(x) * up, x.dtype)
    zs[::up] = x
    y = np.convolve(zs, h)
    return y[::down]


def resample(
    x: np.ndarray, sr_in: int, sr_out: int, dtype=np.float32
) -> np.ndarray:
    """Resample 1-D audio from sr_in to sr_out.

    Output length matches the librosa/soxr convention:
    ``ceil(n * sr_out / sr_in)``.
    """
    x = np.asarray(x)
    if sr_in == sr_out:
        return x.astype(dtype, copy=False)
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError("sample rates must be positive")
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    h = design_kaiser_lowpass(up, down)
    n_out = -(-len(x) * sr_out // sr_in)  # ceil
    xf = x.astype(np.float64, copy=False)
    if _upfirdn is not None:
        y = _upfirdn(h, xf, up=up, down=down)
    else:
        y = _upfirdn_numpy(h, xf, up, down)
    # the FIR is centered: skip its group delay so output aligns with input
    delay = (len(h) - 1) // 2
    start = delay // down
    # fractional remainder of the delay is < 1 output sample; acceptable
    y = y[start: start + n_out]
    if len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    return y.astype(dtype)


def resample_best(x, sr_in: int, sr_out: int):
    """Native single-pass resampler when available, python upfirdn
    otherwise — the two are bit-consistent (audio/native.py::resample
    rounds the group delay to an output-sample boundary for exactly
    this). One dispatch point so fixes apply to every caller."""
    from . import native
    y = native.resample(x, sr_in, sr_out) if native.available() else None
    return y if y is not None else resample(x, sr_in, sr_out)
