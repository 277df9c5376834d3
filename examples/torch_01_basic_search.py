"""Basic library usage on the PyTorch port: build an engine, ingest audio,
search.

The port's counterpart of examples/01_basic_search.py. Runs on the card
unless ``--device cpu`` is passed: whisper-tiny for both pipelines, short
mel context, and a small decode budget keep it quick. With converted
checkpoints on disk, point ModelSpec.weights_path at them and the same
code produces real transcripts (tools/torch_weights_day.py).

    python examples/torch_01_basic_search.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from multimodal_audio_search_tpu_torch import (
        AudioSearchEngine, EngineConfig)
    from multimodal_audio_search_tpu_torch.audio.wav import write_wav
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, ModelSpec)

    cfg = EngineConfig(
        asr_model=ModelSpec(family="whisper", preset="tiny"),
        caption_model=ModelSpec(family="whisper", preset="tiny"),
        asr_decode=DecodeConfig(max_new_tokens=12),
        caption_decode=DecodeConfig(max_new_tokens=12),
        short_context=True,          # mel context = segment length
        ingest_batch=4,
    )
    engine = AudioSearchEngine(cfg=cfg, device=args.device)

    # 25 s of synthetic audio -> three windows: two full 10 s segments
    # plus the 5 s tail (kept: >= the reference's 3 s minimum)
    rng = np.random.default_rng(0)
    t = np.arange(25 * 16000) / 16000
    wave = (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.normal(size=t.size)).astype(np.float32)
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        write_wav(f.name, wave, 16000)
        segments = engine.ingest(f.name, source_name="demo.wav")
    print(f"ingested {len(segments)} segment(s); "
          f"index now holds {len(engine.store)}")
    for s in segments:
        print(f"  {s['segment_id']}  {s['start_time']:.0f}-"
              f"{s['end_time']:.0f}s  asr={s['asr_text'][:40]!r} "
              f"caption={s['audio_description'][:40]!r}")

    hits, weights = engine.search("steady tone with background noise",
                                  k=5)
    print(f"query weights: asr={weights['asr_weight']:.2f} "
          f"audio={weights['audio_weight']:.2f} "
          f"({weights['analysis']})")
    for h in hits:
        print(f"  #{h['index']}  score={h['fusion_score']:.3f}  "
              f"{h['segment_id']}")

    # persistence round-trip
    with tempfile.TemporaryDirectory() as d:
        engine.save_index(d)
        engine.load_index(d)
        print(f"reloaded index: {len(engine.store)} segment(s)")


if __name__ == "__main__":
    main()
