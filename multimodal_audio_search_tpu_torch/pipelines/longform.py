"""Overlap-stitched long-form transcription.

The reference configures its HF ASR pipeline with chunk_length_s=10,
stride_length_s=2 (audio_search.py:183-184) — though production only ever
feeds it <= 10 s segments, so the stitcher is idle there (SURVEY.md §5).
This implements the capability for real: windows of ``chunk_s`` advancing by
``chunk_s - 2*stride_s``, decoded as ONE batch (one dispatch), merged
host-side by longest-overlap suffix/prefix matching at each seam.
"""
from __future__ import annotations

import numpy as np

from .whisper_pipeline import WhisperTextPipeline


def merge_overlapping_texts(texts: list[str], min_overlap: int = 1) -> str:
    """Join chunk transcripts, deduplicating seam words.

    Finds the longest word-level suffix of the accumulated text that equals
    a prefix of the next chunk and drops the duplicate.
    """
    words: list[str] = []
    for t in texts:
        w = t.split()
        if not words:
            words = w
            continue
        best = 0
        max_k = min(len(words), len(w))
        for k in range(max_k, min_overlap - 1, -1):
            if words[-k:] == w[:k]:
                best = k
                break
        words.extend(w[best:])
    return " ".join(words)


def chunk_windows(
    n_samples: int, sr: int, chunk_s: float = 10.0, stride_s: float = 2.0
) -> list[tuple[int, int]]:
    """(start, length) windows with 2*stride overlap between neighbors
    (HF chunking geometry: effective advance = chunk - 2*stride)."""
    chunk = int(chunk_s * sr)
    advance = int((chunk_s - 2 * stride_s) * sr)
    if advance <= 0:
        raise ValueError("stride too large for chunk length")
    out = []
    start = 0
    while start < n_samples:
        out.append((start, min(chunk, n_samples - start)))
        if start + chunk >= n_samples:
            break
        start += advance
    return out


def transcribe_long(
    pipeline: WhisperTextPipeline,
    wave: np.ndarray,
    sr: int = 16_000,
    chunk_s: float = 10.0,
    stride_s: float = 2.0,
) -> str:
    """Transcribe arbitrarily long audio through a 30 s-context model."""
    wins = chunk_windows(len(wave), sr, chunk_s, stride_s)
    n_samples = pipeline.mel_cfg.n_samples
    batch = np.zeros((len(wins), n_samples), np.float32)
    for i, (start, length) in enumerate(wins):
        seg = wave[start: start + length]
        batch[i, : min(len(seg), n_samples)] = seg[:n_samples]
    texts = pipeline.transcribe_batch(batch)
    return merge_overlapping_texts([t for t in texts if t.strip()])
