"""The C++ audio fast paths of the JAX package (``audio/native.py`` over
``native/*.cc``) are not part of the port yet (ROADMAP A16).

``resample.resample_best`` asks this module first; it reports the native
library as unavailable, so every caller takes the numpy path.
"""
from __future__ import annotations


def available() -> bool:
    return False


def resample(x, sr_in: int, sr_out: int):
    raise NotImplementedError(
        "native resampler not ported (ROADMAP A16); "
        "audio.resample.resample is the path")
