"""End-to-end parity evaluation of the PyTorch port against the HF
reference stack.

This environment has no model weights (zero egress), so ranking parity with
the *pretrained* reference cannot be measured here. This harness makes that
evaluation one command once checkpoints exist:

    python tools/torch_parity_eval.py \
        --whisper-base ~/ckpts/whisper-base \
        --captioner ~/ckpts/whisper-tiny-audio-captioning \
        --minilm ~/ckpts/all-MiniLM-L6-v2 \
        --audio fixtures/*.wav [--device cpu]

The port's counterpart of tools/parity_eval.py. It runs both stacks on
the same audio and reports:
  * per-segment transcript agreement (exact + token-level F1)
  * embedding cosine between our MiniLM and sentence-transformers
  * top-10 overlap and rank correlation of fused search results for a
    query set, using each stack's own embeddings

The reference stack is HF ``transformers`` + ``sentence-transformers`` on
the CPU, as in the JAX tool; "our stack" is the port's (models/convert.py,
WhisperTextPipeline, TextEmbedder, DualPipelineIngest, SegmentStore,
FusionSearcher) on ``--device`` (the card unless cpu is named). The
decode settings are the JAX tool's: ASR 224 tokens, caption 100 tokens
through DecodeConfig's default method (the reference decodes the caption
with beam 2). ``run(...)`` is the whole evaluation, for callers and
tests. Without ``transformers`` or ``sentence_transformers`` the tool
exits non-zero naming the package; the reference half is never skipped.

Without --audio it synthesizes deterministic test tones/noise (useful as a
smoke run, though transcripts will be degenerate).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# the reference stack's packages, each checked before anything runs
REFERENCE_PACKAGES = ("transformers", "sentence_transformers")


def token_f1(a: str, b: str) -> float:
    ta, tb = a.lower().split(), b.lower().split()
    if not ta and not tb:
        return 1.0
    common = 0
    used = [False] * len(tb)
    for w in ta:
        for j, v in enumerate(tb):
            if not used[j] and v == w:
                used[j] = True
                common += 1
                break
    if common == 0:
        return 0.0
    p, r = common / len(ta), common / len(tb)
    return 2 * p * r / (p + r)


QUERIES = [
    "upbeat music with drums",
    "a person speaking clearly",
    "guitar solo",
    "what did they say about the weather",
    "ambient background noise",
    "someone singing a song",
]


def require_reference() -> None:
    """Import the reference stack's packages, or exit naming the one
    that is missing."""
    for name in REFERENCE_PACKAGES:
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise SystemExit(
                f"torch_parity_eval: the reference stack needs the "
                f"'{name}' package, which cannot be imported here ({e})")


def run(whisper_base: str, captioner: str, minilm: str,
        audio: list[str] | None = None, out: str = "parity_report.json",
        device: str = "cuda") -> dict:
    require_reference()
    # ---------------- reference stack (torch/HF) ----------------
    import torch
    from transformers import (
        WhisperForConditionalGeneration, WhisperProcessor, pipeline)
    from sentence_transformers import SentenceTransformer

    st = SentenceTransformer(minilm)
    asr_ref = pipeline("automatic-speech-recognition",
                       model=whisper_base, device=-1)
    cap_proc = WhisperProcessor.from_pretrained(captioner)
    cap_ref = WhisperForConditionalGeneration.from_pretrained(
        captioner).eval()

    # ---------------- our stack ----------------
    from multimodal_audio_search_tpu_torch import weights
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig)
    from multimodal_audio_search_tpu_torch.models import convert
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.minilm import (
        MiniLMConfig)
    from multimodal_audio_search_tpu_torch.models.tokenizer import (
        load_tokenizer)
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        DualPipelineIngest)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline \
        import WhisperTextPipeline
    from multimodal_audio_search_tpu_torch.index.search import (
        FusionSearcher, reference_fusion_oracle)
    from multimodal_audio_search_tpu_torch.index.store import SegmentStore
    from multimodal_audio_search_tpu_torch.index.analyzer import (
        KeywordAnalyzer)

    wb = weights.whisper_params(convert.convert_whisper(
        convert.load_state_dict_from_dir(whisper_base), W.PRESETS["base"]))
    cp = weights.whisper_params(convert.convert_whisper(
        convert.load_state_dict_from_dir(captioner), W.PRESETS["tiny"]))
    mlm = weights.minilm_params(convert.convert_bert(
        convert.load_state_dict_from_dir(minilm), MiniLMConfig()))

    asr = WhisperTextPipeline(
        params=wb, cfg=W.PRESETS["base"],
        tokenizer=load_tokenizer(whisper_base),
        decode=DecodeConfig(max_new_tokens=224), name="asr", device=device)
    cap = WhisperTextPipeline(
        params=cp, cfg=W.PRESETS["tiny"],
        tokenizer=load_tokenizer(captioner),
        decode=DecodeConfig(max_new_tokens=100), name="caption",
        prefix_ids=[W.PRESETS["tiny"].bos_token_id], device=device)
    emb = TextEmbedder(params=mlm, tokenizer=load_tokenizer(minilm),
                       device=device)
    cfg = EngineConfig()
    ours = DualPipelineIngest(asr, cap, emb, cfg)

    # ---------------- audio ----------------
    from multimodal_audio_search_tpu_torch.audio.decode import load_audio
    waves = []
    if audio:
        for f in audio:
            w, _ = load_audio(f, 16000)
            waves.append((f, w))
    else:
        rng = np.random.default_rng(0)
        t = np.arange(16000 * 25) / 16000
        waves = [
            ("tone", (0.3 * np.sin(2 * np.pi * 440 * t))
             .astype(np.float32)),
            ("noise", (rng.normal(size=len(t)) * 0.2).astype(np.float32)),
        ]

    report = {"segments": [], "queries": []}
    store = SegmentStore(keep_audio=False)
    ref_segments = []
    for name, w in waves:
        segs = ours.process_waveform(w, 16000, name)
        store.extend(segs)
        for s in segs:
            lo = int(s["start_time"] * 16000)
            hi = int(s["end_time"] * 16000)
            piece = w[lo:hi]
            ref_text = asr_ref(piece.copy())["text"].strip()
            feats = cap_proc(piece, sampling_rate=16000,
                             return_tensors="pt").input_features
            with torch.no_grad():
                ids = cap_ref.generate(feats, max_length=100, num_beams=2)
            ref_cap = cap_proc.batch_decode(
                ids, skip_special_tokens=True)[0].strip()
            ref_segments.append({
                "asr_text": ref_text,
                "audio_description": ref_cap,
                "asr_embedding": st.encode(ref_text) if ref_text else None,
                "audio_embedding": st.encode(ref_cap) if ref_cap else None,
                "asr_success": bool(ref_text),
                "audio_success": bool(ref_cap),
            })
            report["segments"].append({
                "source": name, "start": s["start_time"],
                "ours_asr": s["asr_text"], "ref_asr": ref_text,
                "asr_exact": s["asr_text"] == ref_text,
                "asr_f1": token_f1(s["asr_text"], ref_text),
                "ours_cap": s["audio_description"], "ref_cap": ref_cap,
                "cap_f1": token_f1(s["audio_description"], ref_cap),
            })

    searcher = FusionSearcher(store, emb)
    analyzer = KeywordAnalyzer()
    for q in QUERIES:
        hits, info = searcher(q)
        wa = analyzer(q)
        ref_hits = reference_fusion_oracle(
            np.asarray(st.encode(q)), ref_segments,
            wa.asr_weight, wa.audio_weight)
        ours_top = [h["index"] for h in hits]
        ref_top = [h["index"] for h in ref_hits]
        inter = len(set(ours_top) & set(ref_top))
        denom = max(len(set(ours_top) | set(ref_top)), 1)
        report["queries"].append({
            "query": q, "ours_top": ours_top, "ref_top": ref_top,
            "top10_overlap": inter / denom,
            "exact_order": ours_top == ref_top,
        })

    if report["segments"]:
        report["summary"] = {
            "asr_exact_rate": float(np.mean(
                [s["asr_exact"] for s in report["segments"]])),
            "asr_f1_mean": float(np.mean(
                [s["asr_f1"] for s in report["segments"]])),
            "cap_f1_mean": float(np.mean(
                [s["cap_f1"] for s in report["segments"]])),
            "top10_overlap_mean": float(np.mean(
                [q["top10_overlap"] for q in report["queries"]])),
        }
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--whisper-base", required=True)
    ap.add_argument("--captioner", required=True)
    ap.add_argument("--minilm", required=True)
    ap.add_argument("--audio", nargs="*", default=None)
    ap.add_argument("--out", default="parity_report.json")
    ap.add_argument("--device", default="cuda",
                    help="our stack's device: cuda (default) or cpu")
    args = ap.parse_args()
    report = run(args.whisper_base, args.captioner, args.minilm,
                 args.audio, args.out, args.device)
    print(json.dumps(report.get("summary", {}), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
