"""Fusion search over a SegmentStore (exact path).

Counterpart of ``multimodal_audio_search_tpu/index/search.py::
FusionSearcher``: analyze the query for weights, embed it, score every
segment with availability-renormalized weighted cosine fusion, keep
scores > threshold, return the top-10 plus a weight-info dict. The query
embedding stays on the device between the embedder and the scoring.
``search_batch`` embeds many queries at once and scores them all in one
pass over the index. ``FusionConfig.index_dtype`` "float32" (default,
exact top-k parity) or "bfloat16" sets the device index's dtype.

Not ported (ROADMAP A12/A13): IVF, sharded search over a mesh.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

from ..config import FusionConfig
from ..pipelines.embed import TextEmbedder
from .analyzer import KeywordAnalyzer, WeightAnalysis
from .fusion import NEG_INF, fused_topk
from .store import SegmentStore

# FusionConfig.index_dtype -> the device index's dtype
INDEX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FusionSearcher:
    """search(query) -> (results, weight_info) with reference-shaped rows."""

    def __init__(
        self,
        store: SegmentStore,
        embedder: TextEmbedder,
        analyzer: Callable[[str], WeightAnalysis] | None = None,
        cfg: FusionConfig | None = None,
    ):
        """The index is scored on the embedder's device."""
        self.store = store
        self.embedder = embedder
        self.cfg = cfg or FusionConfig()
        if self.cfg.ann != "none":
            raise NotImplementedError(
                f"ann={self.cfg.ann!r} is not ported (ROADMAP A12)")
        if self.cfg.index_dtype not in INDEX_DTYPES:
            raise NotImplementedError(
                f"index_dtype={self.cfg.index_dtype!r} is not ported; "
                f"the port takes {sorted(INDEX_DTYPES)}")
        self.index_dtype = INDEX_DTYPES[self.cfg.index_dtype]
        self.analyzer = analyzer or KeywordAnalyzer(self.cfg)
        self.device = embedder.device

    def _rows(self, out, wa) -> list[dict[str, Any]]:
        results: list[dict[str, Any]] = []
        for rank in range(len(out["indices"])):
            if not out["valid"][rank] or out["scores"][rank] <= NEG_INF / 2:
                continue
            i = int(out["indices"][rank])
            if i >= len(self.store):   # capacity padding
                continue
            row = dict(self.store.meta[i])
            row.update(
                index=i,
                asr_similarity=float(out["sims"][rank, 0]),
                audio_similarity=float(out["sims"][rank, 1]),
                fusion_score=float(out["scores"][rank]),
                effective_asr_weight=float(
                    out["effective_weights"][rank, 0]),
                effective_audio_weight=float(
                    out["effective_weights"][rank, 1]),
                query_asr_weight=wa.asr_weight,
                query_audio_weight=wa.audio_weight,
            )
            results.append(row)
        return results

    @torch.inference_mode()
    def __call__(
        self, query: str, k: int | None = None
    ) -> tuple[list[dict[str, Any]], dict[str, Any]]:
        if len(self.store) == 0:
            return [], {}
        k = k or self.cfg.top_k
        t0 = time.perf_counter()
        wa = self.analyzer(query)
        emb, ok = self.store.device_index(self.device, self.index_dtype)
        q = self.embedder.embed_device([query])[0]   # unit-norm
        out = fused_topk(q, emb, ok, wa.asr_weight,
                         wa.audio_weight, k=min(k, emb.shape[0]),
                         threshold=self.cfg.relevance_threshold)
        out = {kk: v.cpu().numpy() for kk, v in out.items()}
        results = self._rows(out, wa)
        weight_info = {
            "asr_weight": wa.asr_weight,
            "audio_weight": wa.audio_weight,
            "analysis": wa.analysis,
            "query": query,
            "latency_s": time.perf_counter() - t0,
        }
        return results, weight_info

    @torch.inference_mode()
    def search_batch(
        self, queries: Sequence[str], k: int | None = None
    ) -> list[tuple[list[dict[str, Any]], dict[str, Any]]]:
        """Batched fusion search: one embed of all queries, one scoring pass
        over the index for all of them. Returns [(results, weight_info)]
        aligned with ``queries``."""
        if len(self.store) == 0 or not queries:
            return [([], {}) for _ in queries]
        k = k or self.cfg.top_k
        was = [self.analyzer(q) for q in queries]
        emb, ok = self.store.device_index(self.device, self.index_dtype)
        t0 = time.perf_counter()
        q = self.embedder.embed_device(list(queries))      # [Q, D] unit-norm
        out = fused_topk(q, emb, ok, [w.asr_weight for w in was],
                         [w.audio_weight for w in was],
                         k=min(k, emb.shape[0]),
                         threshold=self.cfg.relevance_threshold)
        out = {kk: v.cpu().numpy() for kk, v in out.items()}
        dt = time.perf_counter() - t0
        return [(self._rows({kk: v[qi] for kk, v in out.items()}, wa),
                 {"asr_weight": wa.asr_weight,
                  "audio_weight": wa.audio_weight,
                  "analysis": wa.analysis, "query": query,
                  "latency_s": dt})
                for qi, (query, wa) in enumerate(zip(queries, was))]
