"""Shared batch bucketing: pad batch sizes up to powers of two so XLA
compiles one program per bucket instead of one per batch size (used by
the whisper pipelines, the text embedder, and the CLAP flow)."""
from __future__ import annotations


def bucket_pow2(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b
