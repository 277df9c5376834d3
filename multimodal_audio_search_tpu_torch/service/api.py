"""AudioSearchEngine — the port's public surface.

Counterpart of ``multimodal_audio_search_tpu/service/api.py``:

    ingest(file_or_waveform) -> segment records (and index growth)
    search(query, k)         -> (ranked hits, weight_info)
    search_batch(queries, k) -> [(ranked hits, weight_info)] per query

plus bulk ingest with a decode thread (``ingest_many``), the historical
search strategies and combined-text modes, long-form transcription,
runtime reconfiguration, per-source deletion, persistence (save/load the
index, same on-disk format as the JAX package) and stats export. The
engine runs on ``device`` ("cuda" unless the caller names the CPU; there
is no silent move to the CPU).

``FusionConfig.ann="ivf"`` (``MAS_ANN=ivf``) opts the searcher into IVF
candidate generation (index/ivf.py); its layout is rebuilt on the write
path after each ingest (``_prewarm_searcher``, once at the end of an
``ingest_many`` or of the server's async job queue).
``EngineConfig.data_parallel`` (a power of two) builds the engine's mesh
(parallel/mesh.py::mesh_from_config on the engine's device): ingest
batches split over its data devices and the index sharded on N over them
(the searcher, its warm-up and its IVF layout); ``model_parallel``
shards the Whisper models and the embedder by heads over each data
row's model devices (tensor parallelism; the index stays split over the
data axis only, as in the JAX package) under every decode option
(sampling and beam, "v2", the int8 decoder and cross K/V, the int8 and
paired encoders). ``reconfigure``
builds every transfer of TRANSFER_CHOICES and every embedder of
EMBEDDER_CHOICES (MiniLM-L6, all-mpnet-base-v2, the
clip-ViT-B-32-multilingual-v1 text tower), over the engine's mesh.
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
        self._combined_searcher = None
        # read and set by the server's ingest worker, as on the JAX engine
        self._defer_prewarm = False
        # the mesh every engine path runs over (ingest batches and the
        # index split over its data devices); None = one device, the
        # reference's execution model
        from ..parallel.mesh import mesh_from_config
        self.mesh = mesh_from_config(self.cfg, self.device)
        if self.mesh is not None and ingest_pipeline is not None \
                and ingest_pipeline.mesh is None:
            ingest_pipeline.use_mesh(self.mesh)

    # -------------------------------------------------------------- models
    def load_all_models(self, warmup: bool = False) -> bool:
        """Build all pipelines (random init from the engine's seed).

        ``warmup=True`` also runs one full ``ingest_batch`` of silence
        through the ingest pipeline and one query, so the first real
        request pays neither the kernels' build nor their launch plans."""
        if self._ingest is None:
            t0 = time.perf_counter()
            self._ingest = make_default_ingest(
                self.cfg, self.stats, seed=self._seed, device=self.device,
                mesh=self.mesh)
            self.stats.pipelines["text_embedder"].load_time = \
                time.perf_counter() - t0
        if warmup:
            t0 = time.perf_counter()
            sr = self.cfg.audio.sample_rate
            silent = np.zeros(
                int(sr * self.cfg.segment.segment_seconds
                    * self.cfg.ingest_batch), np.float32)
            self._ingest.process_waveform(silent, sr, "__warmup__")
            # the query path returns early on an empty store: warm it
            # against a throwaway one-row store
            if len(self.store) > 0:
                self.search("warmup query")
            else:
                tmp = SegmentStore(embed_dim=self.cfg.embed_dim,
                                   keep_audio=False)
                tmp.add({"segment_id": "w"},
                        np.ones(self.cfg.embed_dim, np.float32), None)
                FusionSearcher(tmp, self.embedder, cfg=self.cfg.fusion,
                               mesh=self.mesh)("warmup query")
            self.stats.log.log("warmup", time.perf_counter() - t0)
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
    def _prewarm_searcher(self) -> None:
        """Move the IVF layout rebuild to the write path (FusionSearcher
        .prewarm) so the first query after growth does not stall on
        k-means/packing. Strictly an optimization: failures are logged
        and swallowed (the query path rebuilds lazily), it runs AFTER
        the ingest metric is logged (ingest_* and ivf_prewarm stay
        disjoint), and bulk flows (ingest_many, a non-empty async job
        queue) defer it to one build at drain end instead of one per
        file."""
        wants_ivf = self.cfg.fusion.ann == "ivf" or (
            self._searcher is not None
            and self._searcher._ivf_cfg is not None)
        if not wants_ivf or self._defer_prewarm:
            return
        try:
            t0 = time.perf_counter()
            self._ensure_searcher().prewarm()
            dt = time.perf_counter() - t0
            if dt > 0.01:
                self.stats.log.log("ivf_prewarm", dt)
        except Exception as e:  # noqa: BLE001 -- optimization only
            self.stats.log.log("ivf_prewarm_failed", 0.0, error=str(e))

    def ingest(self, src, source_name: str = "upload") -> list[dict]:
        """file path/bytes/stream -> processed segments appended to index."""
        t0 = time.perf_counter()
        segments = self.ingest_pipeline.process_file(src, source_name)
        self.store.extend(segments)
        self.stats.log.log(
            "ingest_file", time.perf_counter() - t0,
            segments=len(segments), source=source_name)
        self._prewarm_searcher()
        return segments

    def ingest_many(
        self, sources: list, source_names: list[str] | None = None,
        retries: int = 1, on_error: str = "skip",
    ) -> list[dict]:
        """Ingest many files with decode/resample on a background thread
        while the device processes the previous file.

        Per-file failures retry ``retries`` times, then follow ``on_error``:
        "skip" logs and continues, "raise" propagates.
        """
        from ..audio.decode import load_audio
        from ..utils.loader import PrefetchLoader
        names = source_names or [str(s)[:80] for s in sources]

        def decoded():
            for src, name in zip(sources, names):
                last = None
                for _ in range(retries + 1):
                    try:
                        wave, sr = load_audio(
                            src, self.cfg.audio.sample_rate)
                        yield name, wave, sr, None
                        break
                    except Exception as e:  # noqa: BLE001
                        last = e
                else:
                    yield name, None, 0, last

        out: list[dict] = []
        self._defer_prewarm = True
        try:
            for name, wave, sr, err in PrefetchLoader(decoded(), depth=2):
                if err is not None:
                    self.stats.log.log("ingest_error", 0.0,
                                       source=name, error=str(err))
                    if on_error == "raise":
                        raise err
                    continue
                out.extend(self.ingest_waveform(wave, sr, name))
        finally:
            self._defer_prewarm = False
        self._prewarm_searcher()        # ONE rebuild for the whole batch
        return out

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
        self._prewarm_searcher()
        return segments

    # -------------------------------------------------------------- search
    def _ensure_searcher(self) -> FusionSearcher:
        if self._searcher is None or self._searcher.store is not self.store:
            analyzer = make_analyzer(
                self.cfg.analyzer, embed_fn=self.embedder,
                cfg=self.cfg.fusion)
            self._searcher = FusionSearcher(
                self.store, self.embedder, analyzer, self.cfg.fusion,
                mesh=self.mesh)
            # FusionConfig.ann="ivf" (MAS_ANN=ivf) opts the production
            # searcher into sublinear candidate generation (index/ivf.py;
            # with a mesh, per-shard buckets and a merge of the candidates)
            if self.cfg.fusion.ann == "ivf":
                self._searcher.enable_ivf(
                    n_probe=self.cfg.fusion.ann_nprobe)
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

    def search_strategy(
        self, query: str, strategy: str, k: int | None = None
    ) -> tuple[list[dict[str, Any]], dict[str, Any]]:
        """Historical fusion strategies over the production index
        (streamlit_app_backup.py:62-66,647-734): the unified-text store's
        ASR slot is the text space and the caption slot the audio space.
        Missing embeddings are zero rows — exactly the historical
        zero-embedding fallback (streamlit_app_backup.py:500-508).
        ``strategy='compare_all'`` returns every strategy's top-k in
        weight_info (results = production fusion)."""
        from ..index.store import ASR, AUDIO
        from ..index.strategies import compare_all, run_strategy
        if strategy in ("fusion", "", None):
            return self.search(query, k)
        k = k or self.cfg.fusion.top_k
        analyzer = make_analyzer(self.cfg.analyzer,
                                 embed_fn=self.embedder,
                                 cfg=self.cfg.fusion)
        emb = self.store.embeddings
        qz = self.embedder([query])[0]
        t0 = time.perf_counter()
        if strategy == "compare_all":
            allout = compare_all(query, qz, qz, emb[:, ASR],
                                 emb[:, AUDIO], analyzer, k)
            results, _ = self.search(query, k)
            def snippet(i: int) -> str:
                m = self.store.meta[int(i)]
                return str(m.get("asr_text") or
                           m.get("audio_description") or
                           f"seg {int(i)}")[:60]
            info = {"strategy": "compare_all", "per_strategy": {
                s: {"top": [int(i) for i in o["top"]],
                    "scores": [float(o["scores"][i]) for i in o["top"]],
                    # text snippets ride the response so the UI panel
                    # doesn't re-download the full /api/segments listing
                    # per search (tens of MB at 100k rows)
                    "texts": [snippet(i) for i in o["top"]],
                    "info": o["info"]}
                for s, o in allout.items()}}
            return results, info
        out = run_strategy(strategy, query, qz, qz,
                           emb[:, ASR], emb[:, AUDIO], analyzer, k)
        results = []
        for i in out["top"]:
            row = dict(self.store.meta[int(i)])
            row["fusion_score"] = float(out["scores"][int(i)])
            row["index"] = int(i)
            results.append(row)
        self.stats.log.log("search_strategy", time.perf_counter() - t0,
                           query=query, strategy=strategy)
        return results, out["info"]

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

    def transcribe_long(self, src, chunk_s: float = 10.0,
                        stride_s: float = 2.0) -> str:
        """Overlap-stitched long-form ASR (the reference's chunk/stride
        capability, pipelines/longform.py) over a whole file."""
        from ..audio.decode import load_audio
        from ..pipelines.longform import transcribe_long
        wave, sr = load_audio(src, self.cfg.audio.sample_rate)
        return transcribe_long(
            self.ingest_pipeline.asr, wave, sr, chunk_s, stride_s)

    def search_combined(
        self, query: str, mode: str = "combined", k: int = 10
    ) -> list[dict[str, Any]]:
        """Historical combined-text search modes (raw dot product over
        combined/asr/caption spaces, clean_audio_search.py:305-310)."""
        from ..index.combined import CombinedTextSearcher
        if self._combined_searcher is None or \
                self._combined_searcher.store is not self.store:
            self._combined_searcher = CombinedTextSearcher(
                self.store, self.embedder)
        return self._combined_searcher(query, mode, k)

    # ------------------------------------------------------- reconfigure
    EMBEDDER_CHOICES = {
        # reference dropdown values (clean_audio_search.py:32-47)
        "all-MiniLM-L6-v2": ("minilm", "L6"),
        "all-mpnet-base-v2": ("mpnet", "base"),
        "clip-ViT-B-32-multilingual-v1": ("minilm", "clip512_text"),
    }
    # host->device transfer encodings, fastest-exact first
    # (config.py transfer_dtype; measured drift in docs/BENCHMARKS.md)
    TRANSFER_CHOICES = ("int16", "int16d", "int12", "auto", "mel16",
                        "mel12", "mel8", "mulaw8", "float32")

    def reconfigure(
        self,
        segment_seconds: float | None = None,
        min_segment_seconds: float | None = None,
        asr_preset: str | None = None,
        caption_preset: str | None = None,
        embedder: str | None = None,
        transfer_dtype: str | None = None,
    ) -> dict[str, Any]:
        """Runtime re-configuration: the historical UI's chunk-duration
        slider (streamlit_app_backup.py:875, 5-30 s) and model dropdowns
        (clean_audio_search.py:32-47): a new EngineConfig, fresh
        pipelines on the engine's device, and an index reset (the
        model-comparison semantics of streamlit_app_backup.py:1419-1433:
        embeddings from different models/segmentations don't mix). The
        new pipelines are built before anything is committed: a build
        that raises leaves the engine as it was."""
        import dataclasses
        from ..models import whisper as W
        cfg = self.cfg
        if segment_seconds is not None:
            s = float(segment_seconds)
            if not 1.0 <= s <= 30.0:
                raise ValueError("segment_seconds must be in [1, 30]")
            cfg = cfg.replace(segment=dataclasses.replace(
                cfg.segment, segment_seconds=s))
        if min_segment_seconds is not None:
            cfg = cfg.replace(segment=dataclasses.replace(
                cfg.segment,
                min_segment_seconds=float(min_segment_seconds)))
        for name, preset in (("asr_model", asr_preset),
                             ("caption_model", caption_preset)):
            if preset is not None:
                if preset not in W.PRESETS:
                    raise ValueError(f"unknown whisper preset {preset!r}")
                cfg = cfg.replace(**{name: dataclasses.replace(
                    getattr(cfg, name), preset=preset)})
        if embedder is not None:
            if embedder not in self.EMBEDDER_CHOICES:
                raise ValueError(
                    f"unknown embedder {embedder!r}; options: "
                    f"{sorted(self.EMBEDDER_CHOICES)}")
            family, preset = self.EMBEDDER_CHOICES[embedder]
            cfg = cfg.replace(text_embedder=dataclasses.replace(
                cfg.text_embedder, family=family, preset=preset))
        if transfer_dtype is not None:
            if transfer_dtype not in self.TRANSFER_CHOICES:
                raise ValueError(
                    f"unknown transfer_dtype {transfer_dtype!r}; "
                    f"options: {list(self.TRANSFER_CHOICES)}")
            cfg = cfg.replace(transfer_dtype=transfer_dtype)
        # Build the new pipelines BEFORE touching engine state: a failed
        # rebuild (bad weights path, OOM on a big preset) must leave the
        # engine exactly as it was — committing cfg first would pair the
        # new embedder with the old, dimension-mismatched index on the
        # next lazy rebuild.
        t0 = time.perf_counter()
        new_ingest = make_default_ingest(
            cfg, self.stats, seed=self._seed, device=self.device,
            mesh=self.mesh)
        self.stats.pipelines["text_embedder"].load_time = \
            time.perf_counter() - t0
        # commit point: everything below is in-memory assignment only
        # embed dim follows the embedder; the index resets with it
        self.cfg = cfg.replace(embed_dim=new_ingest.embedder.dim)
        self._ingest = new_ingest
        self._searcher = None
        self._combined_searcher = None
        keep_audio = self.store.keep_audio
        self.store = SegmentStore(
            embed_dim=self.cfg.embed_dim, keep_audio=keep_audio)
        self.stats.log.log("reconfigure", 0.0,
                           segment_seconds=cfg.segment.segment_seconds,
                           asr=cfg.asr_model.preset,
                           caption=cfg.caption_model.preset,
                           embedder=f"{cfg.text_embedder.family}/"
                                    f"{cfg.text_embedder.preset}",
                           transfer=cfg.transfer_dtype)
        return self.describe_config()

    def describe_config(self) -> dict[str, Any]:
        from ..models import whisper as W
        return {
            "segment_seconds": self.cfg.segment.segment_seconds,
            "min_segment_seconds": self.cfg.segment.min_segment_seconds,
            "asr_preset": self.cfg.asr_model.preset,
            "caption_preset": self.cfg.caption_model.preset,
            "embedder": next(
                (k for k, v in self.EMBEDDER_CHOICES.items()
                 if v == (self.cfg.text_embedder.family,
                          self.cfg.text_embedder.preset)),
                f"{self.cfg.text_embedder.family}/"
                f"{self.cfg.text_embedder.preset}"),
            "embed_dim": self.cfg.embed_dim,
            "asr_options": sorted(
                k for k in W.PRESETS if k not in ("test", "large-v3")),
            "embedder_options": sorted(self.EMBEDDER_CHOICES),
            "transfer_dtype": self.cfg.transfer_dtype,
            "transfer_options": list(self.TRANSFER_CHOICES),
        }

    # --------------------------------------------------------- persistence
    def save_index(self, path) -> None:
        self.store.save(path)

    def load_index(self, path) -> None:
        self.store = SegmentStore.load(path)
        self._searcher = None

    def delete_source(self, source_name: str) -> int:
        """Remove one uploaded file's segments from the index (capability
        beyond the reference's all-or-nothing reset).

        Also drops the combined-text searcher, whose matrix is keyed on
        the row count: after a delete and an ingest of the same size it
        would score the deleted rows' texts (the JAX engine keeps it,
        ROADMAP §3)."""
        self._combined_searcher = None
        return self.store.delete_source(source_name)

    def reset_index(self) -> None:
        """Model-comparison mode support: clear the database so a different
        embedder/model set can be A/B'd (streamlit_app_backup.py:1419-1433).
        Swap models by constructing a new ingest pipeline or EngineConfig."""
        self.store = SegmentStore(
            embed_dim=self.cfg.embed_dim, keep_audio=self.store.keep_audio)
        self._searcher = None
        self._combined_searcher = None

    # --------------------------------------------------------------- stats
    def export_stats_json(self) -> str:
        return self.stats.export_json(
            extra={"database": {"total_segments": len(self.store)},
                   "model_info": self.model_info})
