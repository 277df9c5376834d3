"""Weights-day readiness on the PyTorch port: one command from checkpoint
dirs to a report.

    python tools/torch_weights_day.py \
        --whisper-base ~/ckpts/whisper-base \
        --captioner   ~/ckpts/whisper-tiny-audio-captioning \
        --minilm      ~/ckpts/all-MiniLM-L6-v2 \
        [--audio clip1.wav clip2.mp3] [--dry-run] [--device cpu]

The port's counterpart of tools/weights_day.py, with the same four steps,
the same ``run(...)`` arguments (plus ``device``) and the same report
keys, each step recorded in weights_day_report.json:
  1. convert  — load each dir's state dict (safetensors / pytorch bin),
     convert to the port's param trees (models/convert.py), report
     parameter counts.
  2. tokenize — build tokenizer.json from raw assets if absent
     (tools/torch_build_tokenizer.py); report which tokenizer class the
     pipelines will actually use (a directory of weights alone takes the
     hash tokenizer).
  3. smoke    — assemble the production engine FROM THE CONVERTED
     WEIGHTS (``EngineConfig`` weight paths) on ``device`` (the card
     unless the caller passes cpu), ingest synthetic audio (or --audio
     files), run a fusion query; records transcript samples + timing.
  4. parity   — unless --dry-run: defer to tools/torch_parity_eval.py for
     transcript F1 / embedding cosine / top-10 overlap vs the HF
     reference stack, folding its summary into the report.

Random-init stand-ins exercise the whole chain until real checkpoints
are in the repository (tests/test_torch_weights_day.py on the CPU,
chip_smoke.py's ``[weights]`` phase on the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def n_params(tree) -> int:
    """Elements in a param tree's leaves (None leaves count nothing)."""
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(n_params(v) for v in tree)
    if tree is None:
        return 0
    return int(np.prod(tree.shape))


def smoke_config(whisper_base: str, captioner: str, minilm: str,
                 asr_preset: str = "base", caption_preset: str = "tiny",
                 minilm_preset: str = "L6", embed_dim: int = 384,
                 short_context: bool = False, smoke_max_new: int = 64):
    """Step 3's EngineConfig: the production engine over the three
    checkpoint directories."""
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, EngineConfig, ModelSpec)
    decode = DecodeConfig(max_new_tokens=smoke_max_new)
    return EngineConfig(
        ingest_batch=8, embed_dim=embed_dim, short_context=short_context,
        asr_decode=decode, caption_decode=decode,
        asr_model=ModelSpec(family="whisper", preset=asr_preset,
                            weights_path=whisper_base),
        caption_model=ModelSpec(family="whisper", preset=caption_preset,
                                weights_path=captioner),
        text_embedder=ModelSpec(family="minilm", preset=minilm_preset,
                                weights_path=minilm))


def run(whisper_base: str, captioner: str, minilm: str,
        audio: list[str] | None = None, dry_run: bool = False,
        out: str = "weights_day_report.json",
        asr_preset: str = "base", caption_preset: str = "tiny",
        minilm_preset: str = "L6", embed_dim: int = 384,
        short_context: bool = False, smoke_max_new: int = 64,
        clap: str | None = None, device: str = "cuda") -> dict:
    from multimodal_audio_search_tpu_torch.models import convert
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.minilm import (
        PRESETS as MLP)
    from multimodal_audio_search_tpu_torch.models.tokenizer import (
        HFTokenizerWrapper, load_tokenizer)
    from multimodal_audio_search_tpu_torch.service.api import (
        AudioSearchEngine)
    import tools.torch_build_tokenizer as bt
    import pathlib

    report: dict = {"steps": {}}

    # 1. conversion
    t0 = time.perf_counter()
    conv = {}
    for name, path, kind, preset in (
            ("whisper_base", whisper_base, "whisper", asr_preset),
            ("captioner", captioner, "whisper", caption_preset),
            ("minilm", minilm, "bert", "L6")):
        sd = convert.load_state_dict_from_dir(path)
        if kind == "whisper":
            params = convert.convert_whisper(sd, W.PRESETS[preset])
        else:
            params = convert.convert_bert(sd, MLP[minilm_preset])
        conv[name] = {"tensors": len(sd), "params": n_params(params)}
    if clap:
        from multimodal_audio_search_tpu_torch.models import clap_htsat as CH
        ap, tp, acfg, tcfg = CH.load_from_dir(clap)
        conv["clap"] = {"params": n_params(ap) + n_params(tp),
                        "audio_hidden": acfg.hidden_size,
                        "text_hidden": tcfg.hidden,
                        "projection_dim": acfg.projection_dim}
    report["steps"]["convert"] = {
        "ok": True, "seconds": round(time.perf_counter() - t0, 2), **conv}

    # 2. tokenizers
    toks = {}
    for name, path in (("whisper_base", whisper_base),
                       ("captioner", captioner), ("minilm", minilm)):
        try:
            msg = bt.build_dir(pathlib.Path(path))
        except FileNotFoundError as e:
            msg = f"no assets ({e}); hash fallback will be used"
        tok = load_tokenizer(path)
        toks[name] = {"build": msg,
                      "class": type(tok).__name__,
                      "real": isinstance(tok, HFTokenizerWrapper)}
    report["steps"]["tokenize"] = toks

    # 3. engine smoke from the converted weights
    t0 = time.perf_counter()
    cfg = smoke_config(whisper_base, captioner, minilm, asr_preset,
                       caption_preset, minilm_preset, embed_dim,
                       short_context, smoke_max_new)
    eng = AudioSearchEngine(cfg=cfg, device=device)
    eng.load_all_models()
    if audio:
        segs = []
        for f in audio:
            segs += eng.ingest(f, source_name=os.path.basename(f))
    else:
        rng = np.random.default_rng(0)
        wave = (rng.normal(size=16000 * 25) * 0.3).astype(np.float32)
        segs = eng.ingest_waveform(wave, 16000, "synthetic")
    hits, info = eng.search("music with drums")
    report["steps"]["smoke"] = {
        "ok": True, "seconds": round(time.perf_counter() - t0, 2),
        "segments": len(segs),
        "sample_transcripts": [s["asr_text"][:80] for s in segs[:3]],
        "hits": len(hits), "weights": {
            "asr": info.get("asr_weight"),
            "audio": info.get("audio_weight")} if info else {},
    }

    # 4. full parity eval (the HF reference stack) unless dry-run
    if not dry_run:
        import subprocess
        cmd = [sys.executable,
               os.path.join(os.path.dirname(__file__),
                            "torch_parity_eval.py"),
               "--whisper-base", whisper_base, "--captioner", captioner,
               "--minilm", minilm, "--out", "parity_report.json",
               "--device", device]
        if audio:
            cmd += ["--audio", *audio]
        rc = subprocess.run(cmd, capture_output=True, text=True)
        report["steps"]["parity"] = {"returncode": rc.returncode,
                                     "stdout_tail": rc.stdout[-2000:]}
        try:
            with open("parity_report.json") as f:
                report["steps"]["parity"]["summary"] = \
                    json.load(f).get("summary")
        except OSError:
            pass
    else:
        report["steps"]["parity"] = "skipped (--dry-run)"

    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--whisper-base", required=True)
    ap.add_argument("--captioner", required=True)
    ap.add_argument("--minilm", required=True)
    ap.add_argument("--audio", nargs="*", default=None)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--asr-preset", default="base")
    ap.add_argument("--caption-preset", default="tiny")
    ap.add_argument("--clap", default=None,
                    help="optional ClapModel checkpoint dir (HTSAT towers)")
    ap.add_argument("--out", default="weights_day_report.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args()
    report = run(a.whisper_base, a.captioner, a.minilm, a.audio,
                 a.dry_run, a.out, a.asr_preset, a.caption_preset,
                 clap=a.clap, device=a.device)
    print(json.dumps(
        {k: ("ok" if isinstance(v, dict) else v)
         for k, v in report["steps"].items()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
