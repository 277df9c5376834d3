"""Combined-text search modes (historical clean_audio_search variant).

That iteration additionally embedded the concatenated ASR+caption text as a
third ``combined_embedding`` and searched one of combined/asr/caption spaces
with a RAW DOT PRODUCT rather than cosine
(previous_iterations/clean_audio_search.py:161-184,305-310). Implemented as a
thin view over a SegmentStore: combined embeddings are built lazily with the
engine's embedder and the three modes score as a batched matmul.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .store import ASR, AUDIO, SegmentStore

MODES = ("combined", "asr", "caption")


class CombinedTextSearcher:
    def __init__(
        self,
        store: SegmentStore,
        embed_fn: Callable[[Sequence[str]], np.ndarray],
    ):
        self.store = store
        self.embed_fn = embed_fn
        self._combined: np.ndarray | None = None
        self._built_for = -1

    def _combined_matrix(self) -> np.ndarray:
        if self._combined is None or self._built_for != len(self.store):
            texts = []
            for row in self.store.meta:
                asr = row.get("asr_text", "") or ""
                cap = row.get("audio_description", "") or ""
                texts.append((asr + " " + cap).strip() or " ")
            self._combined = np.asarray(self.embed_fn(texts), np.float32) \
                if texts else np.zeros((0, self.store.embed_dim), np.float32)
            self._built_for = len(self.store)
        return self._combined

    def __call__(self, query: str, mode: str = "combined", k: int = 10):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if len(self.store) == 0:
            return []
        q = np.asarray(self.embed_fn([query]), np.float32)[0]
        if mode == "combined":
            m = self._combined_matrix()
            scores = m @ q                       # raw dot product (parity)
        else:
            slot = ASR if mode == "asr" else AUDIO
            scores = self.store.embeddings[:, slot, :] @ q
            ok = self.store.success[:, slot]
            scores = np.where(ok, scores, -np.inf)
        top = np.argsort(-scores)[:k]
        out = []
        for i in top:
            if not np.isfinite(scores[i]):
                continue
            row = dict(self.store.meta[int(i)])
            row.update(index=int(i), score=float(scores[i]), mode=mode)
            out.append(row)
        return out
