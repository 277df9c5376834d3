"""Training on the PyTorch port: fine-tune the captioner on procedural
synthetic audio until its transcripts are non-degenerate, then decode a
held-out clip.

The port's counterpart of examples/04_training.py: the same stack
(training/synth.py -> training/finetune.py) that tools/torch_synth_drift.py
measures; with converted real checkpoints, training/loop.py's
finetune_captioner runs data- and tensor-parallel fine-tuning with
checkpoint/resume. On the card the captioner is whisper-tiny (the
decode kernels take a head width of 64; the toy "test" preset, the CPU's
default, has 16).

    python examples/torch_04_training.py [--device cpu] [--steps 150]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--preset", default=None,
                    help="Whisper preset (default: tiny on the card, test "
                         "on the CPU)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from multimodal_audio_search_tpu_torch.training.synth import (
        make_clip, train_synth_captioner)

    dev = torch.device(args.device)
    preset = args.preset or ("tiny" if dev.type == "cuda" else "test")
    model = train_synth_captioner(steps=args.steps, batch=8, preset=preset,
                                  device=dev)
    print(f"trained {args.steps} steps; "
          f"loss {model.losses[0]:.3f} -> {model.losses[-1]:.3f}")

    # decode a held-out clip and compare to its known ground truth
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, MelConfig)
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.generate import generate
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram

    wave, truth = make_clip(np.random.default_rng(123),
                            clip_seconds=model.mel_seconds / 2)
    mel_cfg = MelConfig(padded_seconds=model.mel_seconds)
    pad = np.zeros(mel_cfg.n_samples, np.float32)
    pad[: len(wave)] = wave
    dtype = runtime.default_dtype(dev)
    params = W.prepare_params(model.params, dtype, dev)
    with torch.inference_mode():
        mel = log_mel_spectrogram(torch.from_numpy(pad[None]).to(dev),
                                  mel_cfg)
        enc = W.encode(params, mel.to(dtype), model.cfg)
        prefix = torch.tensor([[model.cfg.bos_token_id]], dtype=torch.int32,
                              device=dev)
        out = generate(params, enc, prefix, cfg=model.cfg,
                       decode=DecodeConfig(method="greedy",
                                           max_new_tokens=8),
                       max_new_tokens=8)
    toks = out.tokens.cpu().numpy()[0]
    text = model.vocab.decode(toks[1:].tolist())
    print(f"ground truth: {truth!r}")
    print(f"decoded:      {text!r}")


if __name__ == "__main__":
    main()
