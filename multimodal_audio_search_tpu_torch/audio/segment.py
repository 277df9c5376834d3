"""Waveform normalization + segmentation (ingest L1).

Boundary-parity with the reference (audio_search.py:237-263):

  * peak-conditional normalization: boost to 0.5 if peak < 0.1, attenuate to
    0.8 if peak > 0.95, otherwise untouched (we additionally guard all-zero
    audio, which would divide by zero in the reference),
  * non-overlapping ``segment_seconds`` windows from sample 0,
  * windows shorter than ``min_segment_seconds`` are dropped,
  * ``end_time`` is clamped to the waveform duration.

Also provides ``pad_segment_batch`` — the TPU-side addition that turns the
ragged final segment into fixed-shape batches (pad + true-length mask) so one
XLA compilation serves every batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import AudioConfig, SegmentConfig


def peak_scale(
    audio: np.ndarray, cfg: AudioConfig | None = None
) -> float:
    """Peak-conditional normalization FACTOR (1.0 = untouched).

    Temp-free scan (max/-min, no |x| materialization): on the 1-core
    host a full-waveform abs+multiply pass was the single biggest ingest
    host cost once attributed (bench host_ms round 3) — callers fold the
    factor into work they already do (the transfer quantize multiply,
    per-segment storage copies) instead of paying a dedicated 80 MB
    pass."""
    cfg = cfg or AudioConfig()
    if audio.size == 0:
        return 1.0
    peak = max(float(audio.max()), -float(audio.min()))
    if peak == 0.0:
        return 1.0
    if peak < cfg.quiet_peak:
        return cfg.quiet_target / peak
    if peak > cfg.loud_peak:
        return cfg.loud_target / peak
    return 1.0


def normalize_peak(
    audio: np.ndarray, cfg: AudioConfig | None = None
) -> tuple[np.ndarray, float]:
    """Peak-conditional normalization. Returns (audio, original_peak)."""
    cfg = cfg or AudioConfig()
    audio = np.asarray(audio, np.float32)
    peak = float(max(audio.max(), -audio.min())) if audio.size else 0.0
    if peak == 0.0:
        return audio, peak
    c = peak_scale(audio, cfg)
    if c != 1.0:
        audio = audio * np.float32(c)
    return audio, peak


@dataclass(frozen=True)
class SegmentWindow:
    index: int          # window index over the source file
    start_sample: int
    length: int         # true (unpadded) length in samples
    start_time: float
    end_time: float

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time


def segment_windows(
    n_samples: int,
    sample_rate: int,
    cfg: SegmentConfig | None = None,
) -> list[SegmentWindow]:
    """Compute kept segment windows (parity: audio_search.py:247-263)."""
    cfg = cfg or SegmentConfig()
    seg_len = int(cfg.segment_seconds * sample_rate)
    min_len = int(cfg.min_segment_seconds * sample_rate)
    total = n_samples / sample_rate
    out = []
    for i, start in enumerate(range(0, n_samples, seg_len)):
        length = min(seg_len, n_samples - start)
        if length < min_len:
            continue
        out.append(SegmentWindow(
            index=i,
            start_sample=start,
            length=length,
            start_time=start / sample_rate,
            end_time=min((start + seg_len) / sample_rate, total),
        ))
    return out


def segment_audio(
    audio: np.ndarray,
    sample_rate: int,
    seg_cfg: SegmentConfig | None = None,
    audio_cfg: AudioConfig | None = None,
) -> tuple[list[SegmentWindow], list[np.ndarray]]:
    """Normalize then window a waveform. Returns (windows, waveforms)."""
    audio, _ = normalize_peak(audio, audio_cfg)
    wins = segment_windows(len(audio), sample_rate, seg_cfg)
    return wins, [audio[w.start_sample: w.start_sample + w.length]
                  for w in wins]


def pad_segment_batch(
    waves: list[np.ndarray], target_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged segments to [B, target_len] + true lengths [B].

    Fixed shapes keep XLA to a single compilation; downstream mel/encoder
    masking consumes the true lengths.
    """
    b = len(waves)
    out = np.zeros((b, target_len), np.float32)
    lens = np.zeros((b,), np.int32)
    for i, w in enumerate(waves):
        n = min(len(w), target_len)
        out[i, :n] = w[:n]
        lens[i] = n
    return out, lens
