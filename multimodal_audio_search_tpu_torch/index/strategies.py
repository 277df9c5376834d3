"""Historical v1 fusion strategies over a direct audio-embedding index.

The backup iteration searched a CLAP audio-embedding index with four
strategies (streamlit_app_backup.py:62-66, dispatch 647-734):

  * "Audio Only"          — cosine vs the audio embedding alone
  * "Fixed 50/50"         — equal blend of audio and text-derived scores
  * "Dynamic Selection"   — semantic classifier picks ONE modality
  * "Adaptive Weighting"  — confidence-scaled weights, base 0.7/0.3 toward
    the detected modality, ±0.2 confidence boost, clipped to [0.1, 0.9]
    (streamlit_app_backup.py:432-475)
  * "Compare All"         — run every strategy side by side
    (streamlit_app_backup.py:736-790, 1110-1133)

Scores are batched matmuls over the whole index, like index/fusion.py.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .analyzer import KeywordAnalyzer, WeightAnalysis

STRATEGIES = ("audio_only", "fixed_5050", "dynamic_selection",
              "adaptive_weighting")


def _cos_scores(query_z: np.ndarray, index_z: np.ndarray) -> np.ndarray:
    q = query_z / max(float(np.linalg.norm(query_z)), 1e-12)
    return index_z @ q


def adaptive_weights(wa: WeightAnalysis) -> tuple[float, float]:
    """Confidence-scaled weights (streamlit_app_backup.py:432-475)."""
    toward_asr = wa.asr_weight >= wa.audio_weight
    conf = abs(wa.asr_weight - 0.5) * 2.0          # 0..1
    base = 0.7 if toward_asr else 0.3
    w_asr = base + (0.2 * conf if toward_asr else -0.2 * conf)
    w_asr = float(np.clip(w_asr, 0.1, 0.9))
    return w_asr, 1.0 - w_asr


def run_strategy(
    strategy: str,
    query: str,
    text_query_z: np.ndarray,       # query in the text/ASR space
    audio_query_z: np.ndarray,      # query in the audio-tower space
    text_index_z: np.ndarray,       # [N, Dt] per-segment text-derived emb
    audio_index_z: np.ndarray,      # [N, Da] per-segment audio-tower emb
    analyzer: Callable[[str], WeightAnalysis] | None = None,
    k: int = 10,
) -> dict:
    """Returns {'scores': [N], 'top': idx[k], 'info': {...}}."""
    analyzer = analyzer or KeywordAnalyzer()
    a_scores = _cos_scores(audio_query_z, audio_index_z)
    t_scores = _cos_scores(text_query_z, text_index_z)

    if strategy == "audio_only":
        scores, info = a_scores, {"strategy": "audio_only"}
    elif strategy == "fixed_5050":
        scores = 0.5 * a_scores + 0.5 * t_scores
        info = {"strategy": "fixed_5050", "asr_weight": 0.5,
                "audio_weight": 0.5}
    elif strategy == "dynamic_selection":
        wa = analyzer(query)
        use_asr = wa.asr_weight > wa.audio_weight
        scores = t_scores if use_asr else a_scores
        info = {"strategy": "dynamic_selection",
                "selected": "asr" if use_asr else "audio",
                "analysis": wa.analysis}
    elif strategy == "adaptive_weighting":
        wa = analyzer(query)
        w_asr, w_audio = adaptive_weights(wa)
        scores = w_asr * t_scores + w_audio * a_scores
        info = {"strategy": "adaptive_weighting", "asr_weight": w_asr,
                "audio_weight": w_audio, "analysis": wa.analysis}
    else:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"one of {STRATEGIES}")
    top = np.argsort(-scores)[:k]
    return {"scores": scores, "top": top, "info": info}


def quality_adaptive_search(
    store,
    embed_fn,
    query: str,
    k: int = 10,
    long_threshold: int = 10,
    w_long: float = 0.7,
    w_short: float = 0.3,
):
    """Transcription-quality adaptive fusion (historical per-SEGMENT rule).

    The lightweight iterations weighted each segment by its own transcript
    quality: ASR weight 0.7 when the transcript is longer than 10 chars,
    else 0.3 (lightweight_audio_search.py:232-237; streamlit_app.py:216-219
    used 0.2/0.8). Unlike the production analyzer this keys on the segment,
    not the query — weights vary per row, computed as one vectorized pass.
    """
    import numpy as np
    n = len(store)
    if n == 0:
        return []
    q = np.asarray(embed_fn([query]), np.float32)[0]
    nq = np.linalg.norm(q)
    if nq > 0:
        q = q / nq
    sims = store.embeddings @ q                       # [N, 2]
    ok = store.success.astype(np.float32)
    lens = np.asarray(
        [len((m.get("asr_text") or "").strip()) for m in store.meta])
    w_asr = np.where(lens > long_threshold, w_long, w_short)
    w = np.stack([w_asr, 1.0 - w_asr], axis=1) * ok   # [N, 2]
    total = w.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(total[:, None] > 0, w / total[:, None], 0.0)
    scores = (w * sims).sum(axis=1)
    scores = np.where(total > 0, scores, -np.inf)
    top = np.argsort(-scores)[:k]
    out = []
    for i in top:
        if not np.isfinite(scores[i]):
            continue
        row = dict(store.meta[int(i)])
        row.update(index=int(i), score=float(scores[i]),
                   asr_weight=float(w[i, 0]), audio_weight=float(w[i, 1]))
        out.append(row)
    return out


def compare_all(
    query: str, text_query_z, audio_query_z, text_index_z, audio_index_z,
    analyzer=None, k: int = 10,
) -> dict[str, dict]:
    """'Compare All' side-by-side harness
    (streamlit_app_backup.py:1110-1133)."""
    return {
        s: run_strategy(s, query, text_query_z, audio_query_z,
                        text_index_z, audio_index_z, analyzer, k)
        for s in STRATEGIES
    }
