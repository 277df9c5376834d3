"""AudioSearchEngine — the port's public surface.

Counterpart of ``multimodal_audio_search_tpu/service/api.py``:

    ingest(file_or_waveform) -> segment records (and index growth)
    search(query, k)         -> (ranked hits, weight_info)
    search_batch(queries, k) -> [(ranked hits, weight_info)] per query

plus persistence (save/load the index, same on-disk format as the JAX
package) and stats export. The engine runs on ``device`` ("cuda" unless
the caller names the CPU; there is no silent move to the CPU).

Not ported (ROADMAP A11-A13): meshes, IVF, historical search strategies,
long-form transcription, combined-text search, runtime reconfiguration.
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..config import EngineConfig
from ..index.analyzer import make_analyzer
from ..index.search import FusionSearcher
from ..index.store import SegmentStore
from ..pipelines.ingest import DualPipelineIngest, make_default_ingest
from .stats import StatsRegistry

MODEL_INFO = {
    # display parity with audio_search.py:118-140
    "text_embedder": {
        "name": "all-MiniLM-L6-v2 (PyTorch)", "type": "Sentence Transformer",
        "size": "90MB", "dimensions": "384D",
        "description": "Fast and efficient sentence embeddings"},
    "asr_model": {
        "name": "openai/whisper-base (PyTorch)", "type": "Speech Recognition",
        "size": "74MB", "dimensions": "Audio → Text",
        "description": "Proven ASR for speech transcription"},
    "audio_caption": {
        "name": "cahya/whisper-tiny-audio-captioning-v2.0 (PyTorch)",
        "type": "Audio Analysis", "size": "39MB",
        "dimensions": "Audio → Description",
        "description": "Audio content description for non-speech"},
}


class AudioSearchEngine:
    def __init__(
        self,
        cfg: EngineConfig | None = None,
        ingest_pipeline: DualPipelineIngest | None = None,
        store: SegmentStore | None = None,
        keep_audio: bool = True,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        from .. import runtime
        self.cfg = cfg or EngineConfig()
        self.device = runtime.select_device(
            ingest_pipeline.device if ingest_pipeline is not None
            else device)
        if ingest_pipeline is not None and ingest_pipeline.stats is not None:
            self.stats = ingest_pipeline.stats
        else:
            self.stats = StatsRegistry()
        self.model_info = MODEL_INFO
        self._seed = seed
        self._ingest = ingest_pipeline
        self.store = store or SegmentStore(
            embed_dim=self.cfg.embed_dim, keep_audio=keep_audio)
        self._searcher: FusionSearcher | None = None

    # -------------------------------------------------------------- models
    def load_all_models(self) -> bool:
        """Build all pipelines (random init from the engine's seed)."""
        if self._ingest is None:
            t0 = time.perf_counter()
            self._ingest = make_default_ingest(
                self.cfg, self.stats, seed=self._seed, device=self.device)
            self.stats.pipelines["text_embedder"].load_time = \
                time.perf_counter() - t0
        return True

    @property
    def ingest_pipeline(self) -> DualPipelineIngest:
        if self._ingest is None:
            self.load_all_models()
        return self._ingest

    @property
    def embedder(self):
        return self.ingest_pipeline.embedder

    # -------------------------------------------------------------- ingest
    def ingest(self, src, source_name: str = "upload") -> list[dict]:
        """file path/bytes/stream -> processed segments appended to index."""
        t0 = time.perf_counter()
        segments = self.ingest_pipeline.process_file(src, source_name)
        self.store.extend(segments)
        self.stats.log.log(
            "ingest_file", time.perf_counter() - t0,
            segments=len(segments), source=source_name)
        return segments

    def ingest_waveform(
        self, wave: np.ndarray, sr: int, source_name: str = "waveform"
    ) -> list[dict]:
        t0 = time.perf_counter()
        segments = self.ingest_pipeline.process_waveform(
            wave, sr, source_name)
        self.store.extend(segments)
        self.stats.log.log(
            "ingest_waveform", time.perf_counter() - t0,
            segments=len(segments), source=source_name)
        return segments

    # -------------------------------------------------------------- search
    def _ensure_searcher(self) -> FusionSearcher:
        if self._searcher is None or self._searcher.store is not self.store:
            analyzer = make_analyzer(
                self.cfg.analyzer, embed_fn=self.embedder,
                cfg=self.cfg.fusion)
            self._searcher = FusionSearcher(
                self.store, self.embedder, analyzer, self.cfg.fusion)
        return self._searcher

    def search(
        self, query: str, k: int | None = None
    ) -> tuple[list[dict[str, Any]], dict[str, Any]]:
        """Keyword-weighted fusion search (audio_search.py:624-699)."""
        searcher = self._ensure_searcher()
        t0 = time.perf_counter()
        results, weight_info = searcher(query, k)
        self.stats.pipelines["search_pipeline"].update(
            time.perf_counter() - t0, success=len(results) > 0)
        self.stats.log.log(
            "search", time.perf_counter() - t0,
            query=query, hits=len(results))
        return results, weight_info

    def search_batch(
        self, queries: list[str], k: int | None = None
    ) -> list[tuple[list[dict[str, Any]], dict[str, Any]]]:
        """Many queries in one pass over the index (one batched embed, one
        scoring pass for all of them)."""
        searcher = self._ensure_searcher()
        t0 = time.perf_counter()
        out = searcher.search_batch(queries, k)
        self.stats.pipelines["search_pipeline"].update_batch(
            time.perf_counter() - t0,
            sum(len(r) > 0 for r, _ in out),
            sum(len(r) == 0 for r, _ in out))
        return out

    # --------------------------------------------------------- persistence
    def save_index(self, path) -> None:
        self.store.save(path)

    def load_index(self, path) -> None:
        self.store = SegmentStore.load(path)
        self._searcher = None

    # --------------------------------------------------------------- stats
    def export_stats_json(self) -> str:
        return self.stats.export_json(
            extra={"database": {"total_segments": len(self.store)},
                   "model_info": self.model_info})
