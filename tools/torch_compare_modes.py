"""Ranking drift of the engine's speed levers against the parity default,
on the card.

Counterpart of ``tools/compare_modes.py`` for the PyTorch port (imports
torch and the port only). Each mode is an AudioSearchEngine from the
port's ``make_default_ingest`` (random init from one seed, so every mode
holds the same weights) that ingests the same audio and answers the same
queries; its segment texts and top-10 are held to the parity engine's
with index/eval.py's retrieval metrics:

  * bf16_index    -- the device index in bf16
  * short_context -- the mel context cut to the segment
  * mulaw8        -- the 8-bit companded host->device transfer
  * fused_layer   -- the fused decode kernels (K3 + K4)

    python3 tools/torch_compare_modes.py [--audio f.wav ...] [--preset tiny]
        [--max-new 16] [--out mode_report.json]
    python3 tools/torch_compare_modes.py --device cpu     # no card

With random-init weights the absolute rankings are arbitrary but the
deltas still say which modes flip tokens (a plumbing run); with
converted checkpoints this is the accuracy side of each speed lever.
Runs on the card (it raises without one) unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

QUERIES = [
    "upbeat music with drums",
    "someone speaking clearly",
    "rain and wind in the background",
    "loud engine noise",
    "quiet piano melody",
]
MODES = ("bf16_index", "short_context", "mulaw8", "fused_layer")


def build_engine(mode: str, preset: str, max_new: int, seed: int,
                 device="cuda"):
    """The engine of ``mode`` ("" = parity) on ``device``."""
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig, FusionConfig, ModelSpec)
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        make_default_ingest)
    from multimodal_audio_search_tpu_torch.service.api import (
        AudioSearchEngine)

    decode = DecodeConfig(max_new_tokens=max_new,
                          fused_layer=(mode == "fused_layer"))
    cfg = EngineConfig(
        ingest_batch=8,
        asr_decode=decode, caption_decode=decode,
        asr_model=ModelSpec(family="whisper", preset=preset),
        caption_model=ModelSpec(family="whisper", preset=preset),
        short_context=(mode == "short_context"),
        transfer_dtype=mode if mode in ("mulaw8", "int12") else "int16",
        fusion=FusionConfig(
            index_dtype="bfloat16" if mode == "bf16_index"
            else "float32"),
    )
    return AudioSearchEngine(cfg=cfg, ingest_pipeline=make_default_ingest(
        cfg, seed=seed, device=device))


def run_mode(eng, waves, sr: int = 16_000, queries=QUERIES):
    """(segment texts [(asr, description)], {query: top ids}) of ``eng``
    after it ingests ``waves``."""
    for i, w in enumerate(waves):
        eng.ingest_waveform(w, sr, f"clip{i}")
    texts = [(m.get("asr_text", ""), m.get("audio_description", ""))
             for m in eng.store.meta]
    tops = {}
    for q in queries:
        hits, _ = eng.search(q)
        tops[q] = [h["index"] for h in hits]
    return texts, tops


def report(base, runs: dict, preset: str, max_new: int,
           queries=QUERIES) -> dict:
    """The JAX tool's report: each mode's segment text match and its
    rankings against the parity run's (index/eval.py::compare_rankings).
    ``base`` and each of ``runs`` are run_mode's pairs."""
    from multimodal_audio_search_tpu_torch.index.eval import (
        compare_rankings)
    base_texts, base_tops = base
    out = {"preset": preset, "max_new": max_new,
           "segments": len(base_texts), "modes": {}}
    for mode, (texts, tops) in runs.items():
        text_match = (float(np.mean([a == b for a, b in
                                     zip(base_texts, texts)]))
                      if len(texts) == len(base_texts) else 0.0)
        per_q = {q: compare_rankings(base_tops[q], tops.get(q, []))
                 for q in queries}
        out["modes"][mode] = {
            "segment_text_match": text_match,
            "mean_overlap@10": float(np.mean(
                [m["overlap@10"] for m in per_q.values()])),
            "mean_exact@10": float(np.mean(
                [m["exact@10"] for m in per_q.values()])),
            "per_query": per_q,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--audio", nargs="*", default=None)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--modes", nargs="*", default=list(MODES))
    ap.add_argument("--out", default="mode_report.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from multimodal_audio_search_tpu_torch import runtime
    runtime.select_device(args.device)
    sr = 16_000
    if args.audio:
        from multimodal_audio_search_tpu_torch.audio.decode import load_audio
        waves = [load_audio(f, sr)[0] for f in args.audio]
    else:
        rng = np.random.default_rng(0)
        waves = [(rng.normal(size=sr * 35) * 0.25).astype(np.float32)]

    def run(mode: str):
        return run_mode(build_engine(mode if mode != "parity" else "",
                                     args.preset, args.max_new, seed=0,
                                     device=args.device), waves, sr)

    base = run("parity")
    runs = {}
    for mode in args.modes:
        runs[mode] = run(mode)
        m = report(base, {mode: runs[mode]}, args.preset,
                   args.max_new)["modes"][mode]
        print(f"{mode:14s} text_match={m['segment_text_match']:.2f} "
              f"overlap@10={m['mean_overlap@10']:.2f} "
              f"exact@10={m['mean_exact@10']:.2f}", flush=True)
    with open(args.out, "w") as f:
        json.dump(report(base, runs, args.preset, args.max_new), f,
                  indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
