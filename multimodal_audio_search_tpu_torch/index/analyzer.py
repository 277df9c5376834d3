"""Query -> (asr_weight, audio_weight) analyzers.

Two analyzers matching the reference's explored design space:

* ``KeywordAnalyzer`` — the production rule (audio_search.py:457-622):
  substring-count both lexicons, then
    - no matches         -> 0.5 / 0.5
    - one-sided          -> 0.5 + 0.3 * min(n/3, 1)   (range 0.5..0.8)
    - mixed              -> asr_w = 0.2 + 0.6 * asr_ratio (range 0.2..0.8)
  Duplicate lexicon entries count twice, exactly as the reference's
  ``sum(1 for kw in keywords if kw in query_lower)`` does.

* ``SemanticAnalyzer`` — the historical prototype-sentence classifier
  (streamlit_app_backup.py:274-359): embeds the query plus speech/audio
  prototype sentences, takes max-cosine per class, blends 0.7 semantic with
  0.3 keyword signal, and damps on disagreement. Needs a text embedder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..config import FusionConfig
from .lexicon import ASR_QUERY_KEYWORDS, AUDIO_QUERY_KEYWORDS


@dataclass(frozen=True)
class WeightAnalysis:
    asr_weight: float
    audio_weight: float
    analysis: str
    asr_matches: int = 0
    audio_matches: int = 0


def count_keyword_matches(
    query_lower: str, keywords: Sequence[str]
) -> int:
    """Substring-count match rule (audio_search.py:586-587)."""
    return sum(1 for kw in keywords if kw in query_lower)


class KeywordAnalyzer:
    """Production analyzer (decision-parity with audio_search.py:457-622)."""

    def __init__(self, cfg: FusionConfig | None = None):
        self.cfg = cfg or FusionConfig()

    def __call__(self, query: str) -> WeightAnalysis:
        cfg = self.cfg
        q = query.lower()
        asr_n = count_keyword_matches(q, ASR_QUERY_KEYWORDS)
        audio_n = count_keyword_matches(q, AUDIO_QUERY_KEYWORDS)

        if asr_n == 0 and audio_n == 0:
            w = cfg.balanced_weight
            return WeightAnalysis(
                w, 1.0 - w, "Balanced (no specific keywords detected)", 0, 0)
        if asr_n > 0 and audio_n == 0:
            strength = min(asr_n / cfg.one_sided_saturation, 1.0)
            asr_w = cfg.balanced_weight + cfg.one_sided_gain * strength
            return WeightAnalysis(
                asr_w, 1.0 - asr_w,
                f"ASR-focused ({asr_n} speech keywords)", asr_n, 0)
        if audio_n > 0 and asr_n == 0:
            strength = min(audio_n / cfg.one_sided_saturation, 1.0)
            audio_w = cfg.balanced_weight + cfg.one_sided_gain * strength
            return WeightAnalysis(
                1.0 - audio_w, audio_w,
                f"Audio-focused ({audio_n} audio keywords)", 0, audio_n)
        ratio = asr_n / (asr_n + audio_n)
        asr_w = cfg.mixed_floor + cfg.mixed_span * ratio
        return WeightAnalysis(
            asr_w, 1.0 - asr_w,
            f"Mixed query (ASR:{asr_n}, Audio:{audio_n})", asr_n, audio_n)


# Prototype sentences from the historical semantic classifier
# (streamlit_app_backup.py:286-302 defines 6 speech + 6 audio prototypes;
# reproduced behaviorally, not verbatim).
SPEECH_PROTOTYPES = (
    "a person speaking words clearly",
    "someone talking in a conversation",
    "spoken dialogue with specific words and phrases",
    "a voice saying something in a speech",
    "lyrics being sung with specific words",
    "a narrator reading text aloud",
)
AUDIO_PROTOTYPES = (
    "instrumental music with no words",
    "musical instruments playing a melody",
    "ambient environmental sounds and noise",
    "the sound and texture of music",
    "drums guitar and piano playing",
    "general audio characteristics like tempo and tone",
)


class SemanticAnalyzer:
    """Historical semantic classifier (streamlit_app_backup.py:274-359).

    ``embed_fn`` maps a list of strings to L2-normalized [n, d] embeddings.
    Blend: 0.7 * semantic class preference + 0.3 * keyword preference,
    with confidence damping when the two signals disagree
    (streamlit_app_backup.py:322-342). Weights clipped to [0.1, 0.9]
    (streamlit_app_backup.py:432-475).
    """

    def __init__(
        self,
        embed_fn: Callable[[Sequence[str]], np.ndarray],
        cfg: FusionConfig | None = None,
        semantic_blend: float = 0.7,
    ):
        self.embed_fn = embed_fn
        self.cfg = cfg or FusionConfig()
        self.semantic_blend = semantic_blend
        self._proto = None  # lazy: [2, n_proto, d]

    def _prototypes(self) -> tuple[np.ndarray, np.ndarray]:
        if self._proto is None:
            speech = np.asarray(self.embed_fn(list(SPEECH_PROTOTYPES)))
            audio = np.asarray(self.embed_fn(list(AUDIO_PROTOTYPES)))
            self._proto = (speech, audio)
        return self._proto

    def __call__(self, query: str) -> WeightAnalysis:
        speech_p, audio_p = self._prototypes()
        q = np.asarray(self.embed_fn([query]))[0]
        q = q / (np.linalg.norm(q) + 1e-9)
        speech_sim = float(np.max(speech_p @ q))
        audio_sim = float(np.max(audio_p @ q))
        denom = abs(speech_sim) + abs(audio_sim) + 1e-9
        sem_asr = 0.5 + 0.5 * (speech_sim - audio_sim) / denom

        kw = KeywordAnalyzer(self.cfg)(query)
        blend = self.semantic_blend
        asr_w = blend * sem_asr + (1.0 - blend) * kw.asr_weight
        # disagreement damping: shrink toward 0.5 when signals conflict
        disagreement = abs(sem_asr - kw.asr_weight)
        asr_w = 0.5 + (asr_w - 0.5) * (1.0 - 0.5 * disagreement)
        asr_w = float(np.clip(asr_w, 0.1, 0.9))
        return WeightAnalysis(
            asr_w, 1.0 - asr_w,
            f"Semantic (speech={speech_sim:.3f}, audio={audio_sim:.3f}; "
            f"kw ASR:{kw.asr_matches} Audio:{kw.audio_matches})",
            kw.asr_matches, kw.audio_matches)


def make_analyzer(kind: str, embed_fn=None, cfg: FusionConfig | None = None):
    if kind == "keyword":
        return KeywordAnalyzer(cfg)
    if kind == "classifier":
        return ClassifierAnalyzer()
    if kind == "semantic":
        if embed_fn is None:
            raise ValueError("semantic analyzer requires embed_fn")
        return SemanticAnalyzer(embed_fn, cfg)
    raise ValueError(f"unknown analyzer: {kind!r}")


def classify_query_keyword(query: str) -> tuple[bool, float, str]:
    """Historical keyword classifier — exact decision parity with
    ``analyze_query_type_keyword`` (streamlit_app_backup.py:363-430,
    oracle-tested): keyword substring hits score 1, regex phrase-pattern
    hits score 2; returns (is_speech, confidence, reasoning). No
    indicators defaults to audio at confidence 0.5.
    """
    import re

    from .lexicon import (CLASSIFIER_AUDIO_KEYWORDS,
                          CLASSIFIER_SPEECH_KEYWORDS,
                          CLASSIFIER_SPEECH_PHRASES)
    q = query.lower()
    speech = 0
    audio = 0
    parts = []
    for kw in CLASSIFIER_SPEECH_KEYWORDS:
        if kw in q:
            speech += 1
            parts.append(f"speech keyword: '{kw}'")
    for kw in CLASSIFIER_AUDIO_KEYWORDS:
        if kw in q:
            audio += 1
            parts.append(f"audio keyword: '{kw}'")
    for pat in CLASSIFIER_SPEECH_PHRASES:
        if re.search(pat, q):
            speech += 2
            parts.append(f"speech pattern: '{pat}'")
    total = speech + audio
    if total == 0:
        return False, 0.5, "No clear speech/audio indicators, " \
                           "defaulting to audio"
    return (speech > audio, max(speech, audio) / total, "; ".join(parts))


class ClassifierAnalyzer:
    """Historical classify-then-scale analyzer: the keyword classifier
    above feeding the confidence-scaled weight rule
    (index/strategies.py::adaptive_weights == streamlit_app_backup.py:
    432-475). ``make_analyzer("classifier")`` selects it."""

    def __call__(self, query: str) -> WeightAnalysis:
        is_speech, conf, reasoning = classify_query_keyword(query)
        asr_w = conf if is_speech else 1.0 - conf
        return WeightAnalysis(asr_w, 1.0 - asr_w, reasoning,
                              int(is_speech), int(not is_speech))
