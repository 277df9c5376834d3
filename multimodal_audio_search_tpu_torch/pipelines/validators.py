"""Text-quality validation gates, as pure functions.

Reimplements the reference's runtime quality filters with identical
accept/reject decisions (reference: audio_search.py:399-435 for ASR,
audio_search.py:437-455 for captions), minus its print-to-stdout side
effects — callers get a structured ``ValidationResult`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..config import ValidatorConfig
from ..index.lexicon import CAPTION_CONTENT_KEYWORDS

# Obvious repetitive-garbage substrings the reference rejects
# (audio_search.py:407-409). Note 'lalala'*3 == 'lalalalalalalalala'.
GARBAGE_SUBSTRINGS = ("laionionion", "ononon", "lalala" * 3)

# Very short filler words rejected when the whole text is <= 3 chars
# (audio_search.py:428-432).
FILLER_WORDS = frozenset({"um", "uh", "ah", "eh", "oh", "mm"})


@dataclass(frozen=True)
class ValidationResult:
    ok: bool
    reason: str = ""

    def __bool__(self) -> bool:  # allow `if validate_asr_text(t):`
        return self.ok


def validate_asr_text(
    text: str, cfg: ValidatorConfig | None = None
) -> ValidationResult:
    """ASR transcript gate (decision-parity with audio_search.py:399-435)."""
    cfg = cfg or ValidatorConfig()
    if not text or len(text.strip()) < cfg.asr_min_chars:
        return ValidationResult(False, "too_short")
    stripped = text.strip()
    lower = stripped.lower()
    for pattern in GARBAGE_SUBSTRINGS:
        if pattern in lower:
            return ValidationResult(False, f"garbage:{pattern}")
    n_alnum = sum(1 for c in stripped if c.isalnum())
    if len(stripped) > 0 and n_alnum / len(stripped) < cfg.asr_min_alnum_ratio:
        return ValidationResult(False, "low_alnum_ratio")
    if len(stripped) <= 3 and lower in FILLER_WORDS:
        return ValidationResult(False, "filler_word")
    return ValidationResult(True)


def validate_audio_description(
    text: str, cfg: ValidatorConfig | None = None
) -> ValidationResult:
    """Caption gate (decision-parity with audio_search.py:437-455).

    Note the reference checks ``len(description) < 5`` on the *unstripped*
    string and requires at least one of 13 audio-content keywords.
    """
    cfg = cfg or ValidatorConfig()
    if not text or len(text) < cfg.caption_min_chars:
        return ValidationResult(False, "too_short")
    lower = text.lower()
    if "laionionion" in lower:
        return ValidationResult(False, "garbage:laionionion")
    if cfg.require_caption_keyword:
        if not any(kw in lower for kw in CAPTION_CONTENT_KEYWORDS):
            return ValidationResult(False, "no_audio_keyword")
    return ValidationResult(True)
