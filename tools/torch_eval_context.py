"""Short-context transcript drift, on the card.

Counterpart of ``tools/eval_context.py`` for the PyTorch port (imports
torch and the port only). The audio_ctx lever (EngineConfig.
short_context) cuts the encoder's work and the cross K/V ~3x for 10 s
segments; what it costs in transcripts needs real checkpoints:

    python3 tools/torch_eval_context.py --whisper ~/ckpts/whisper-base \\
        [--audio clip1.wav ...] [--preset base] [--max-new 64]
    python3 tools/torch_eval_context.py --device cpu      # no card

Each segment of each file (or of two synthesized fixtures) is decoded
twice, at the full 30 s mel context and at the segment's length; the
summary gives the exact rate, the mean token F1 and how often
validate_asr_text's verdict flips between the two, as one JSON line
(rows and summary to ``--out``). Without ``--whisper`` the weights are
random (seed 0) and the run is a plumbing check: the transcripts are
degenerate. Runs on the card (it raises without one) unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def token_f1(a: str, b: str) -> float:
    ta, tb = a.lower().split(), b.lower().split()
    if not ta and not tb:
        return 1.0
    used = [False] * len(tb)
    common = 0
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


def make_pipes(wcfg, params=None, tokenizer=None, max_new: int = 64,
               segment_seconds: float = 10.0, device="cuda") -> dict:
    """{"full": the 30 s-context pipeline, "short": the segment-length
    one}, on the same weights (``params`` None: random init, seed 0)."""
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, MelConfig)
    from multimodal_audio_search_tpu_torch.pipelines.whisper_pipeline import (
        WhisperTextPipeline)
    decode = DecodeConfig(max_new_tokens=max_new)
    return {
        "full": WhisperTextPipeline(
            params=params, cfg=wcfg, tokenizer=tokenizer, decode=decode,
            mel_cfg=MelConfig(n_mels=wcfg.n_mels), name="full",
            device=device),
        "short": WhisperTextPipeline(
            params=params, cfg=wcfg, tokenizer=tokenizer, decode=decode,
            mel_cfg=MelConfig(n_mels=wcfg.n_mels,
                              padded_seconds=segment_seconds),
            name="short", device=device),
    }


def fixtures(sr: int = 16_000) -> list:
    """The JAX tool's two 25 s fixtures: a 440 Hz tone and noise."""
    rng = np.random.default_rng(0)
    t = np.arange(sr * 25) / sr
    return [("tone", (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)),
            ("noise", (rng.normal(size=len(t)) * 0.2).astype(np.float32))]


def evaluate(pipes: dict, waves, segment_seconds: float = 10.0,
             sr: int = 16_000) -> list[dict]:
    """One row a segment: its full and short transcripts, whether they
    are equal, their token F1 and whether validate_asr_text's verdict
    flips."""
    from multimodal_audio_search_tpu_torch.audio.segment import segment_audio
    from multimodal_audio_search_tpu_torch.config import (
        AudioConfig, SegmentConfig)
    from multimodal_audio_search_tpu_torch.pipelines.validators import (
        validate_asr_text)
    seg_cfg = SegmentConfig(segment_seconds=segment_seconds)
    rows = []
    for name, w in waves:
        _, pieces = segment_audio(w, sr, seg_cfg, AudioConfig())
        texts = {}
        for mode, pipe in pipes.items():
            n = pipe.mel_cfg.n_samples
            batch = np.zeros((len(pieces), n), np.float32)
            for i, piece in enumerate(pieces):
                m = min(len(piece), n)
                batch[i, :m] = piece[:m]
            texts[mode] = pipe.transcribe_batch(batch)
        for i, (full, short) in enumerate(zip(texts["full"],
                                              texts["short"])):
            rows.append({"source": name, "segment": i, "full": full,
                         "short": short})
    for r in rows:
        r["exact"] = r["full"] == r["short"]
        r["f1"] = token_f1(r["full"], r["short"])
        r["valid_flip"] = (bool(validate_asr_text(r["full"]))
                           != bool(validate_asr_text(r["short"])))
    return rows


def summarize(rows: list[dict], random_init: bool,
              segment_seconds: float) -> dict:
    return {
        "metric": "short_context_transcript_agreement",
        "segments": len(rows),
        "exact_rate": float(np.mean([r["exact"] for r in rows])),
        "f1_mean": float(np.mean([r["f1"] for r in rows])),
        "validation_flip_rate": float(np.mean(
            [r["valid_flip"] for r in rows])),
        "random_init": random_init,
        "context_seconds": [30.0, segment_seconds],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--whisper", default=None,
                    help="converted/HF checkpoint dir (random init if unset)")
    ap.add_argument("--preset", default="base")
    ap.add_argument("--audio", nargs="*", default=None)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--segment-seconds", type=float, default=10.0)
    ap.add_argument("--out", default="context_eval.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from multimodal_audio_search_tpu_torch import runtime, weights
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.tokenizer import (
        load_tokenizer)

    runtime.select_device(args.device)
    wcfg = W.PRESETS[args.preset]
    params, tokenizer = None, None
    if args.whisper:
        from multimodal_audio_search_tpu_torch.models.convert import (
            convert_whisper, load_state_dict_from_dir)
        params = weights.whisper_params(convert_whisper(
            load_state_dict_from_dir(args.whisper), wcfg))
        tokenizer = load_tokenizer(
            args.whisper, vocab_size=wcfg.vocab_size, add_cls_sep=False,
            pad_id=wcfg.pad_token_id, eos_id=wcfg.eos_token_id)
    pipes = make_pipes(wcfg, params, tokenizer, args.max_new,
                       args.segment_seconds, args.device)
    sr = 16_000
    if args.audio:
        from multimodal_audio_search_tpu_torch.audio.decode import load_audio
        waves = [(f, load_audio(f, sr)[0]) for f in args.audio]
    else:
        waves = fixtures(sr)
    rows = evaluate(pipes, waves, args.segment_seconds, sr)
    summary = summarize(rows, args.whisper is None, args.segment_seconds)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "rows": rows}, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
