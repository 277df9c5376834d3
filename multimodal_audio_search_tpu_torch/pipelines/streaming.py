"""Streaming ingest: feed audio in arbitrary chunks, commit segments live.

The reference is strictly file-at-a-time (upload -> process_audio_file,
audio_search.py:770-817). This session object accepts PCM in arbitrary
chunk sizes (a live microphone, a network stream, a long file read in
pieces), cuts exactly the same 10 s / >=3 s windows the batch path cuts,
runs them through the SAME dual pipeline, and commits finished segments
to the store incrementally — search sees them immediately, and an
optional autosave persists the index every N commits.

Boundary parity: windows are cut in INPUT-rate samples and each complete
window is processed the moment it exists, so a stream fed in any chunking
produces byte-identical windows to the one-shot path on the concatenated
audio (tested) WHEN the input rate equals the mel target rate. Two
deliberate divergences: (a) the reference's peak-conditional
normalization (audio_search.py:237-242) is per-upload; a live stream has
no "whole file", so it applies per commit group — for mid-range audio
(peak in [0.1, 0.95]) neither path rescales and parity is exact; (b) at
any OTHER input rate, each committed window is resampled independently,
so the Kaiser FIR's edge transients make a handful of samples at window
boundaries differ from resampling the concatenated audio once (a
stateful streaming resampler would close this; not built — live sources
should feed 16 kHz). The <min-segment tail is emitted by ``flush()`` iff
it clears the reference's 3 s rule (audio_search.py:259-260).
"""
from __future__ import annotations

import threading

import numpy as np

from ..config import EngineConfig


class StreamingIngest:
    def __init__(
        self,
        ingest_pipeline,
        store,
        cfg: EngineConfig | None = None,
        source_name: str = "stream",
        autosave_path=None,
        autosave_every: int = 0,      # segments between autosaves; 0 = off
    ):
        self.pipeline = ingest_pipeline
        self.store = store
        self.cfg = cfg or EngineConfig()
        self.source_name = source_name
        self.autosave_path = autosave_path
        self.autosave_every = autosave_every
        self._buf = np.zeros(0, np.float32)
        self._rate: int | None = None
        self._consumed = 0            # input samples already windowed
        self._since_save = 0
        self._closed = False
        self._lock = threading.Lock()

    @property
    def segment_samples(self) -> int:
        if self._rate is None:
            raise RuntimeError(
                "stream not started: segment_samples is defined by the "
                "first feed()'s sample rate")
        return int(self.cfg.segment.segment_seconds * self._rate)

    def feed(self, samples: np.ndarray, sample_rate: int) -> list[dict]:
        """Append PCM; process + commit every complete window. Returns the
        newly committed segment records."""
        with self._lock:
            if self._closed:
                raise ValueError("stream already closed")
            if self._rate is None:
                self._rate = int(sample_rate)
            elif int(sample_rate) != self._rate:
                raise ValueError(
                    f"stream rate changed {self._rate}->{sample_rate}; "
                    "open a new stream")
            x = np.asarray(samples, np.float32).reshape(-1)
            self._buf = np.concatenate([self._buf, x])
            seg = self.segment_samples
            n_full = len(self._buf) // seg
            if n_full == 0:
                return []
            head, self._buf = (self._buf[: n_full * seg],
                               self._buf[n_full * seg:])
            return self._commit(head)

    def flush(self) -> list[dict]:
        """Process the remaining tail (if it clears the >=3 s rule) and
        close the stream."""
        with self._lock:
            if self._closed:
                return []
            self._closed = True
            tail, self._buf = self._buf, np.zeros(0, np.float32)
            if self._rate is None or len(tail) < int(
                    self.cfg.segment.min_segment_seconds * self._rate):
                records = []
            else:
                records = self._commit(tail)
            # final autosave: don't leave a sub-threshold remainder
            # unsaved when the stream ends
            if (self.autosave_path is not None and self.autosave_every > 0
                    and self._since_save > 0):
                try:
                    self.store.save_incremental(self.autosave_path)
                except ValueError:
                    self.store.save(self.autosave_path)
                self._since_save = 0
            return records

    def _commit(self, wave: np.ndarray) -> list[dict]:
        offset_s = self._consumed / self._rate
        self._consumed += len(wave)
        records = self.pipeline.process_waveform(
            wave, self._rate, self.source_name)
        for r in records:
            r["start_time"] += offset_s
            r["end_time"] += offset_s
        self.store.extend(records)
        self._since_save += len(records)
        if (self.autosave_path is not None and self.autosave_every > 0
                and self._since_save >= self.autosave_every):
            # append-only shard write (O(new rows)); falls back to a full
            # rewrite when the directory/store can't be extended (full-
            # save layout, or rows were deleted since the last save)
            try:
                self.store.save_incremental(self.autosave_path)
            except ValueError:
                self.store.save(self.autosave_path)
            self._since_save = 0
        return records

    @property
    def buffered_seconds(self) -> float:
        return len(self._buf) / self._rate if self._rate else 0.0
