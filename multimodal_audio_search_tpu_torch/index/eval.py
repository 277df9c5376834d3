"""Retrieval evaluation metrics.

The reference evaluates by eyeball ("Compare All" side-by-side,
streamlit_app_backup.py:1110-1133); these are the standard quantitative
counterparts for comparing perf modes against the parity default
(bf16 vs f32 index, short_context, int8 KV) or our stack against the
torch reference (tools/parity_eval.py records top-10 overlap with the
same conventions).

All functions take ranked id lists (store row indices or any hashables),
most-relevant first.
"""
from __future__ import annotations

from typing import Hashable, Sequence

Ranked = Sequence[Hashable]


def recall_at_k(retrieved: Ranked, relevant: Ranked, k: int) -> float:
    """|top-k retrieved ∩ relevant| / |relevant| (0 if no relevant)."""
    rel = set(relevant)
    if not rel:
        return 0.0
    return len(set(retrieved[:k]) & rel) / len(rel)


def mrr(retrieved: Ranked, relevant: Ranked) -> float:
    """Reciprocal rank of the first relevant hit (0 if none)."""
    rel = set(relevant)
    for i, r in enumerate(retrieved):
        if r in rel:
            return 1.0 / (i + 1)
    return 0.0


def overlap_at_k(a: Ranked, b: Ranked, k: int) -> float:
    """Jaccard overlap of two top-k sets — the parity metric the
    north-star contract uses for 'top-10 parity' (BASELINE.md)."""
    sa, sb = set(a[:k]), set(b[:k])
    denom = len(sa | sb)
    return len(sa & sb) / denom if denom else 1.0


def rank_agreement(a: Ranked, b: Ranked, k: int) -> float:
    """Fraction of the first k positions where both rankings agree
    exactly (position-sensitive; 1.0 = identical order)."""
    if k == 0:
        return 1.0
    n = min(k, max(len(a), len(b)))
    hits = sum(1 for i in range(n)
               if i < len(a) and i < len(b) and a[i] == b[i])
    return hits / n


def compare_rankings(a: Ranked, b: Ranked, ks: Sequence[int] = (1, 5, 10)
                     ) -> dict:
    """Summary dict for reporting (used by evaluation tooling)."""
    return {
        f"overlap@{k}": overlap_at_k(a, b, k) for k in ks
    } | {
        f"exact@{k}": rank_agreement(a, b, k) for k in ks
    }
