"""Fusion search over a SegmentStore (exact path).

Counterpart of ``multimodal_audio_search_tpu/index/search.py::
FusionSearcher``: analyze the query for weights, embed it, score every
segment with availability-renormalized weighted cosine fusion, keep
scores > threshold, return the top-10 plus a weight-info dict. The query
embedding stays on the device between the embedder and the scoring.
``search_batch`` embeds many queries at once and scores them all in one
pass over the index. ``FusionConfig.index_dtype`` "float32" (default,
exact top-k parity) or "bfloat16" sets the device index's dtype.
``enable_ivf`` (or ``FusionConfig.ann="ivf"`` through the engine) narrows
the candidates to the probed clusters of ``index/ivf.py``, with the
fusion math exact on each; the layout is built on the embedder's device
from the store's host rows and rebuilt when the store mutates.

``mesh`` (parallel/mesh.py) shards the index's N axis over the mesh's
data devices and scores through the per-shard top-k and merge of
parallel/sharding.py; ``search_batch`` then still reads each shard once
for the whole batch. With IVF over a mesh, each shard builds its own
buckets (index/ivf.py::build_ivf_sharded, rebuilt when the store's
version or capacity changes) and probes them on its device.

``reference_fusion_oracle`` is a copy of the JAX module's numpy
transcription of the reference's per-segment loop
(tests/test_torch_copies.py holds it to the original): the parity
tool's reference-stack ranking (tools/torch_parity_eval.py).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..config import FusionConfig
from ..parallel.mesh import validate_data_axis
from ..parallel.sharding import sharded_fused_search_impl
from ..pipelines.embed import TextEmbedder
from .analyzer import KeywordAnalyzer, WeightAnalysis
from .fusion import NEG_INF, fused_topk
from .ivf import (IVFIndex, build_ivf, build_ivf_sharded,
                  sharded_ivf_search_impl)
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
        mesh=None,
    ):
        """The index is scored on the embedder's device or, with ``mesh``,
        in contiguous row blocks on the mesh's data devices (the query
        is embedded on the embedder's device; the candidates merge on
        the mesh's first data device)."""
        self.store = store
        self.embedder = embedder
        self.cfg = cfg or FusionConfig()
        if self.cfg.index_dtype not in INDEX_DTYPES:
            raise NotImplementedError(
                f"index_dtype={self.cfg.index_dtype!r} is not ported; "
                f"the port takes {sorted(INDEX_DTYPES)}")
        self.index_dtype = INDEX_DTYPES[self.cfg.index_dtype]
        self.analyzer = analyzer or KeywordAnalyzer(self.cfg)
        self.device = embedder.device
        if mesh is not None:
            validate_data_axis(mesh)
        self.mesh = mesh
        self._sharded_cache: dict[tuple, Any] = {}
        self._ivf_cfg: tuple | None = None
        self._ivf: IVFIndex | None = None

    # ------------------------------------------------------------ IVF (ANN)
    def enable_ivf(self, n_probe: int = 8, n_clusters: int | None = None,
                   rebuild_growth: float = 0.2) -> None:
        """Opt-in sublinear search for very large indexes (index/ivf.py).

        The fusion math on every scored candidate stays exact; only the
        candidate set narrows (n_probe of ~sqrt(2N) clusters + the spill
        tail). The layout rebuilds lazily whenever the store mutates,
        reusing centroids (assignment + repack only) while the row count
        is within ``rebuild_growth`` of the built size, full k-means
        beyond that. With a mesh, each data shard builds its own buckets
        and probes them on its device; only k candidates a shard move.
        Default exact search is untouched unless this is called."""
        self._ivf_cfg = (n_probe, n_clusters, rebuild_growth)
        self._ivf = None

    def disable_ivf(self) -> None:
        self._ivf_cfg = None
        self._ivf = None

    def prewarm(self) -> None:
        """Build/refresh the IVF layout for the store's CURRENT contents
        (no-op without enable_ivf or on an up-to-date layout). Called
        after ingest (service/api.py) so the k-means/packing cost lands
        on the write path, not on the first query after growth."""
        if self._ivf_cfg is not None and len(self.store) > 0:
            self._ensure_ivf_layout()

    def _ensure_ivf_layout(self):
        """(Re)build the IVF layout if the store mutated; returns the
        store's device index (with a mesh, its shards)."""
        _, n_clusters, growth = self._ivf_cfg
        n = len(self.store)
        if self.mesh is not None:
            # per-shard buckets over the capacity-padded sharded view
            # (padding rows have success=False and enter no bucket),
            # keyed on the mutation counter and the capacity
            emb, ok = self.store.device_index(self.device, self.index_dtype,
                                              self.mesh)
            key = (self.store.version, sum(e.shape[0] for e in emb))
            if self._ivf is None or self._ivf_key != key:
                cent = None
                if self._ivf is not None and \
                        abs(n - self._ivf_rows) <= growth * max(
                            self._ivf_rows, 1):
                    cent = self._ivf.centroids   # re-assign / re-pack
                h_emb, h_suc = self.store.host_index(padded=True)
                self._ivf = build_ivf_sharded(
                    h_emb, h_suc, len(emb), n_clusters=n_clusters,
                    centroids=cent, device=self.device)
                self._ivf_key = key
                self._ivf_rows = n
                self._ivf_spill = int((self._ivf.spill >= 0).sum())
                self._ivf_dev = self._ivf.place(self.mesh.data_devices())
                self._ivf_run = {}
            return emb, ok
        # keyed on the store's mutation counter, NOT len(): a delete +
        # ingest of equal size shifts row ids without changing the count
        ver = self.store.version
        if self._ivf is None or self._ivf_key != ver:
            cent = None
            if self._ivf is not None and \
                    abs(n - self._ivf.n_rows) <= growth * self._ivf.n_rows:
                cent = self._ivf.centroids
            h_emb, h_suc = self.store.host_index()
            self._ivf = build_ivf(h_emb, h_suc, n_clusters=n_clusters,
                                  centroids=cent, device=self.device)
            self._ivf_key = ver
            self._ivf_spill = int(self._ivf.spill.shape[0])
        return self.store.device_index(self.device, self.index_dtype)

    def _ivf_out(self, query: str, wa, k: int):
        n_probe = self._ivf_cfg[0]   # rebuild policy lives in
        n = len(self.store)          # _ensure_ivf_layout
        emb, ok = self._ensure_ivf_layout()
        q = self.embedder.embed_device([query])[0]   # unit-norm
        if self.mesh is not None:
            rk = (min(k, n), n_probe)
            if rk not in self._ivf_run:
                self._ivf_run[rk] = sharded_ivf_search_impl(
                    self.mesh, self._ivf, k=rk[0], n_probe=n_probe,
                    threshold=self.cfg.relevance_threshold)
            return self._ivf_run[rk](q, *self._ivf_dev, emb, ok,
                                     wa.asr_weight, wa.audio_weight)
        run = self._ivf.search_fn(
            k=min(k, n), n_probe=n_probe,
            threshold=self.cfg.relevance_threshold)
        return run(q, wa.asr_weight, wa.audio_weight, emb, ok)

    def _sharded_topk(self, k: int):
        """The sharded full-payload search for (k, threshold), cached."""
        key = (k, self.cfg.relevance_threshold)
        if key not in self._sharded_cache:
            self._sharded_cache[key] = sharded_fused_search_impl(
                self.mesh, k=k, threshold=self.cfg.relevance_threshold)
        return self._sharded_cache[key]

    def _topk(self, q, asr_weight, audio_weight, k: int):
        """The exact fused top-k of q ([D] or [Q, D]) over the store's
        device index, or over its shards with a mesh."""
        emb, ok = self.store.device_index(self.device, self.index_dtype,
                                          self.mesh)
        if self.mesh is not None:
            n = sum(e.shape[0] for e in emb)
            return self._sharded_topk(min(k, n))(q, emb, ok, asr_weight,
                                                 audio_weight)
        return fused_topk(q, emb, ok, asr_weight, audio_weight,
                          k=min(k, emb.shape[0]),
                          threshold=self.cfg.relevance_threshold)

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
        if self._ivf_cfg is not None:
            out = {kk: v.cpu().numpy()
                   for kk, v in self._ivf_out(query, wa, k).items()}
            return self._rows(out, wa), {
                "asr_weight": wa.asr_weight,
                "audio_weight": wa.audio_weight,
                "analysis": wa.analysis, "query": query,
                "ann": {"mode": "ivf",
                        "n_clusters": self._ivf.n_clusters,
                        "n_probe": min(self._ivf_cfg[0],
                                       self._ivf.n_clusters),
                        "sharded": self.mesh is not None,
                        "spill": self._ivf_spill},
                "latency_s": time.perf_counter() - t0,
            }
        q = self.embedder.embed_device([query])[0]   # unit-norm
        out = self._topk(q, wa.asr_weight, wa.audio_weight, k)
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
        over the index for all of them (over each shard, with a mesh).
        Returns [(results, weight_info)] aligned with ``queries``."""
        if len(self.store) == 0 or not queries:
            return [([], {}) for _ in queries]
        k = k or self.cfg.top_k
        if self._ivf_cfg is not None:
            # IVF candidate generation is per query (each probes its own
            # buckets): run the sublinear search per query rather than
            # silently falling back to the exact O(N) scan
            return [self(q, k) for q in queries]
        was = [self.analyzer(q) for q in queries]
        # place (or reuse) the device index before the clock starts
        self.store.device_index(self.device, self.index_dtype, self.mesh)
        t0 = time.perf_counter()
        q = self.embedder.embed_device(list(queries))      # [Q, D] unit-norm
        out = self._topk(q, [w.asr_weight for w in was],
                         [w.audio_weight for w in was], k)
        out = {kk: v.cpu().numpy() for kk, v in out.items()}
        dt = time.perf_counter() - t0
        return [(self._rows({kk: v[qi] for kk, v in out.items()}, wa),
                 {"asr_weight": wa.asr_weight,
                  "audio_weight": wa.audio_weight,
                  "analysis": wa.analysis, "query": query,
                  "latency_s": dt})
                for qi, (query, wa) in enumerate(zip(queries, was))]


def reference_fusion_oracle(
    query_emb: np.ndarray,
    segments: list[dict[str, Any]],
    asr_weight: float,
    audio_weight: float,
    threshold: float = 0.1,
    k: int = 10,
) -> list[dict[str, Any]]:
    """Direct numpy transcription of the reference's per-segment loop
    (audio_search.py:639-699), used as the parity oracle in tests."""
    def cos(a, b):
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        return float(a @ b / (na * nb)) if na > 0 and nb > 0 else 0.0

    out = []
    for i, seg in enumerate(segments):
        asr_sim = cos(query_emb, seg["asr_embedding"]) \
            if seg.get("asr_embedding") is not None else 0.0
        audio_sim = cos(query_emb, seg["audio_embedding"]) \
            if seg.get("audio_embedding") is not None else 0.0
        if asr_sim > 0 or audio_sim > 0:
            ew_asr = asr_weight if seg["asr_success"] else 0.0
            ew_audio = audio_weight if seg["audio_success"] else 0.0
            total = ew_asr + ew_audio
            if total > 0:
                ew_asr, ew_audio = ew_asr / total, ew_audio / total
                score = ew_asr * asr_sim + ew_audio * audio_sim
                if score > threshold:
                    out.append({
                        "index": i, "fusion_score": score,
                        "asr_similarity": asr_sim,
                        "audio_similarity": audio_sim,
                        "effective_asr_weight": ew_asr,
                        "effective_audio_weight": ew_audio,
                    })
    out.sort(key=lambda r: r["fusion_score"], reverse=True)
    return out[:k]
