"""Perf-mode accuracy drift measured on self-trained weights, on the card.

Counterpart of ``tools/synth_drift.py`` for the PyTorch port (imports
torch and the port only). Random-init transcripts are degenerate, so this
harness trains the captioner on procedural audio (training/synth.py)
until transcripts carry signal, then decodes held-out clips once a row
and holds each row's transcripts to the parity row's:

  * parity        -- float32, plain encoder (the baseline)
  * short_context -- mel context cut to the clip (1 s at the test
    geometry's 2 s)
  * mulaw8 / int16 / int12 -- the host->device transfer round trips
  * bf16          -- the card's compute dtype, plain encoder
  * int8_dec      -- the int8 decoder (ops/quant.py; K5 on the card)
  * int8_enc      -- ``fused_encoder="int8"`` (K9 on the card)
  * fused_enc     -- bf16 with ``fused_encoder=True`` (K1)
  * mel16 / mel12 / mel8 -- the host log-mel codecs
  * fused_enc_f32 (only by ``--modes``) -- ``fused_encoder=True`` at
    float32: K1's float32 form on the card (3xTF32 on the tensor cores),
    its plain twin on the CPU
  * extra rows (by ``--modes`` or ``--extra``), each a DecodeConfig
    option both packages run: fused_layer (K3 + K4), v2 (K3-q + K4-o),
    int8_fused (K5 + K6), int8_kv (K5 + K7), paired (K10)
  * fused_layer_f32 / v2_f32 (only by ``--modes``) -- fused_layer True /
    "v2" at float32: K3's and K4's / K3-q's and K4-o's float32 forms on
    the card, their plain twins on the CPU

Per row: transcript agreement with the parity decode (exact rate, token
F1) and the exact rate against the generator's captions, as one JSON
line on stdout with the JAX tool's keys. Each row's route (dtype,
device, options, seconds, and on the card the kernel launches it made,
from ``runtime.COUNTS``) goes to stderr as one JSON line, with the
training's wall seconds.

Dtypes: the float32 rows decode in float32 on every device (on the card
through K2's float32 form, K8's at T >= 512, K1's for fused_enc_f32 and
the decoder blocks' for fused_layer_f32 and v2_f32, as the TPU kernels
take float32); ``bf16`` and ``fused_enc`` in bf16; the kernel rows
(int8_dec, int8_enc and the extra rows) in the device's dtype, float32
on the CPU, where the tests hold them to the JAX rows, and bf16 on the
card: there int8_dec, int8_enc, int8_fused, int8_kv and paired take
kernels that take bf16 only, and fused_layer and v2 run as a bf16 engine
runs them beside their float32 rows.

    python3 tools/torch_synth_drift.py [--steps 600] [--clips 64] [--out f.json]
    python3 tools/torch_synth_drift.py --production \\
        --save-model drift_tiny_prod.npz --save-every 250
    python3 tools/torch_synth_drift.py --device cpu --steps 80   # no card

Runs on the card (it raises without one) unless ``--device cpu``. The
preset defaults to whisper-tiny on the card (the kernels take head dim
64, which the JAX tool's default "test" preset, 4 heads of 16, does not
have) and to "test" on the CPU. Checkpoints are utils/checkpoint.py
pytrees, which load in either package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the JAX tool's rows, in its order; fused_enc_f32 only by name
ROWS = ("parity", "short_context", "mulaw8", "int16", "int12", "bf16",
        "int8_dec", "int8_enc", "fused_enc", "fused_enc_f32", "mel16",
        "mel12", "mel8")
# the port's rows, each a DecodeConfig option both packages run
EXTRA_ROWS = ("fused_layer", "v2", "int8_fused", "int8_kv", "paired",
              "fused_layer_f32", "v2_f32")
# rows run only when named (--modes)
OPT_IN = ("fused_enc_f32", "fused_layer_f32", "v2_f32")


def token_f1(a: str, b: str) -> float:
    ta, tb = a.split(), b.split()
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


def mulaw_roundtrip(w: np.ndarray) -> np.ndarray:
    """The production mulaw8 transfer: LUT encode (pipelines/ingest.py)
    + the device-side expansion of _mel16."""
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        _mulaw_lut)
    lut = _mulaw_lut()
    idx = np.clip(np.rint(np.nan_to_num(w) * 32767.5 + 32767.5),
                  0.0, 65535.0).astype(np.uint16)
    q = lut[idx].astype(np.float32) / 127.0
    return (np.sign(q) * (np.power(256.0, np.abs(q)) - 1.0) / 255.0
            ).astype(np.float32)


def int16_roundtrip(w: np.ndarray) -> np.ndarray:
    q = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
    return q.astype(np.float32) / 32767.0


def int12_roundtrip(w: np.ndarray) -> np.ndarray:
    """The production int12 packed transfer: pack (pipelines/ingest.py
    _pack_int12) + the device-side unpack of _mel16, per clip row."""
    from multimodal_audio_search_tpu_torch.pipelines.ingest import (
        _pack_int12)
    out = np.empty_like(w, dtype=np.float32)
    for i in range(w.shape[0]):
        pk = _pack_int12(w[i]).astype(np.int32).reshape(-1, 3)
        q0 = pk[:, 0] | ((pk[:, 1] & 0xF) << 8)
        q1 = (pk[:, 1] >> 4) | (pk[:, 2] << 4)
        q = np.stack([q0, q1], -1).reshape(-1)[: w.shape[1]]
        q = np.where(q >= 2048, q - 4096, q)
        out[i] = q.astype(np.float32) / 2047.0
    return out


def transcribe_hostmel(model, waves: np.ndarray, bits: int = 16,
                       device=None, dtype=torch.float32) -> list[str]:
    """Greedy decode through the mel16/mel12/mel8 transfer path: the
    host's quantized log-mel (ops/mel.py encode_mel16/12/8) rebuilt on
    the device (decode_mel16/12/8) and fed to the pipeline's mel entry,
    as ingest does under transfer_dtype="mel16"/"mel12"/"mel8"; the
    plain encoder, as the parity row."""
    from multimodal_audio_search_tpu_torch.ops.mel import (
        decode_mel8, decode_mel12, decode_mel16, encode_mel8, encode_mel12,
        encode_mel16, mel_seg_frames)
    from multimodal_audio_search_tpu_torch.training.synth import (
        synth_pipeline)
    from multimodal_audio_search_tpu_torch.utils.batching import bucket_pow2

    pipe = synth_pipeline(model, dtype=dtype, fused_encoder=False,
                          device=device)
    mel_cfg = pipe.mel_cfg
    seg_len = max(len(w) for w in waves)
    t_seg = mel_seg_frames(seg_len, mel_cfg)
    n = len(waves)
    b = bucket_pow2(n, pipe.batch_floor())
    w = np.zeros((b, seg_len), np.float32)
    for i, src in enumerate(waves):
        m = min(len(src), seg_len)
        w[i, :m] = src[:m]
    encode, decode = {16: (encode_mel16, decode_mel16),
                      12: (encode_mel12, decode_mel12),
                      8: (encode_mel8, decode_mel8)}[bits]
    codes = encode(w, mel_cfg, t_seg)
    buf = torch.empty(codes.shape, dtype=torch.uint16 if bits == 16
                      else torch.uint8)
    buf.numpy()[...] = codes
    buf = buf.to(pipe.device)
    with torch.inference_mode():
        mel = decode(buf, mel_cfg) if bits == 16 else decode(buf, mel_cfg,
                                                             t_seg)
        toks, lens = pipe.dispatch_mel(mel)
    return pipe.texts_from_tokens(toks.cpu().numpy(), lens.cpu().numpy(), n)


def short_context_seconds(clip_seconds: float, mel_seconds: float) -> float:
    """The short_context lever's mel context: the clip's length (the
    production lever cuts the context to the segment), or half the
    context where the clip fills it."""
    return clip_seconds if clip_seconds < mel_seconds else mel_seconds / 2


def select_rows(modes=None, extra: bool = False) -> list[str]:
    """The rows to run, parity first: ``modes`` (names) or
    every row of the JAX tool but the opt-in ones, plus EXTRA_ROWS but
    the opt-in ones with ``extra``. Raises SystemExit on an unknown
    row."""
    known = ROWS + EXTRA_ROWS
    unknown = set(modes or ()) - set(known)
    if unknown:
        raise SystemExit(f"unknown modes {sorted(unknown)}; "
                         f"choose from {known}")
    want = set(modes) if modes else {r for r in ROWS if r not in OPT_IN}
    if extra:
        want |= {r for r in EXTRA_ROWS if r not in OPT_IN}
    return ["parity"] + [r for r in known if r in want and r != "parity"]


def decode_row(name: str, model, waves: np.ndarray, device,
               short_ctx_s: float, quantized=None) -> tuple[list, dict]:
    """(transcripts, route) of one row on ``device``. ``quantized``: the
    model with ops/quant.py's int8 decoder, for the int8 rows."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.training.synth import transcribe

    dev = torch.device(device)
    f32, bf16 = torch.float32, torch.bfloat16
    kernels = runtime.default_dtype(dev)      # what the levers' kernels take
    waves_in, dtype, mel_s, m, kw = waves, f32, None, model, {}
    fused = False
    if name == "short_context":
        mel_s = short_ctx_s
    elif name == "mulaw8":
        waves_in = mulaw_roundtrip(waves)
    elif name == "int16":
        waves_in = int16_roundtrip(waves)
    elif name == "int12":
        waves_in = int12_roundtrip(waves)
    elif name == "bf16":
        dtype = bf16
    elif name in ("int8_dec", "int8_fused", "int8_kv"):
        dtype, m = kernels, quantized
        if name != "int8_dec":
            kw["cross_attn"] = "int8_fused" if name == "int8_fused" \
                else "int8"
    elif name in ("int8_enc", "paired"):
        dtype, fused = kernels, "int8" if name == "int8_enc" else "paired"
    elif name == "fused_enc":
        dtype, fused = bf16, True
    elif name == "fused_enc_f32":
        fused = True
    elif name in ("fused_layer", "v2"):
        dtype, kw["fused_layer"] = kernels, "v2" if name == "v2" else True
    elif name in ("fused_layer_f32", "v2_f32"):
        kw["fused_layer"] = "v2" if name == "v2_f32" else True
    elif name.startswith("mel"):
        texts = transcribe_hostmel(model, waves, int(name[3:]), dev)
        return texts, {"dtype": str(f32), "device": str(dev),
                       "fused_encoder": False}
    elif name != "parity":
        raise ValueError(f"unknown row {name!r}")
    texts = transcribe(m, waves_in, mel_seconds=mel_s, dtype=dtype,
                       fused_encoder=fused, device=dev, **kw)
    route = {"dtype": str(dtype), "device": str(dev), "fused_encoder": fused,
             **kw, **({"mel_seconds": mel_s} if mel_s else {})}
    return texts, route


def drift(texts, parity, truths) -> dict:
    """Agreement of ``texts`` with the parity row's and with the truth."""
    exact = float(np.mean([g == p for g, p in zip(texts, parity)]))
    f1 = float(np.mean([token_f1(g, p) for g, p in zip(texts, parity)]))
    truth = float(np.mean([g == t for g, t in zip(texts, truths)]))
    return {"agree_exact": round(exact, 3),
            "agree_token_f1": round(f1, 3),
            "truth_exact": round(truth, 3)}


def measure(model, waves: np.ndarray, truths, rows, device,
            short_ctx_s: float) -> tuple[dict, dict]:
    """Decode ``waves`` once a row (select_rows) on ``device``: ({row:
    drift(...)}, {row: route + its texts, seconds and the kernel
    launches it made}). The launch counts are set to 0 before each row
    and read after it."""
    import dataclasses

    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops.quant import (
        quantize_whisper_decoder)

    dev = runtime.select_device(device)
    if dev.type == "cuda":
        runtime.kernels(dev)        # the build outside the rows' seconds
    quantized = None
    if {"int8_dec", "int8_fused", "int8_kv"} & set(rows):
        quantized = dataclasses.replace(
            model, params=quantize_whisper_decoder(model.params))
    details = {}
    for name in rows:
        runtime.reset_counts()
        t0 = time.perf_counter()
        texts, route = decode_row(name, model, waves, dev, short_ctx_s,
                                  quantized)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        details[name] = {**route, "seconds": time.perf_counter() - t0,
                         "launches": {k: v for k, v in runtime.COUNTS.items()
                                      if v},
                         "texts": texts}
    parity = details["parity"]["texts"]
    modes = {name: drift(d["texts"], parity, truths)
             for name, d in details.items()}
    return modes, details


def held_out(rng: np.random.Generator, clips: int, clip_seconds: float,
             n_events) -> tuple[np.ndarray, tuple]:
    """(waves [clips, samples], captions) from training/synth.py's
    generator."""
    from multimodal_audio_search_tpu_torch.training.synth import make_clip
    waves, truths = zip(*(make_clip(rng, clip_seconds, n_events)
                          for _ in range(clips)))
    return np.stack(waves), truths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--clips", type=int, default=64)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--preset", default=None,
                    help="Whisper preset (default: \"tiny\" on the card, "
                         "whose kernels take head dim 64; \"test\", the "
                         "JAX tool's, on the CPU)")
    ap.add_argument("--clip-seconds", type=float, default=1.0)
    ap.add_argument("--mel-seconds", type=float, default=2.0)
    ap.add_argument("--max-events", type=int, default=3)
    ap.add_argument("--save-model", default=None,
                    help="save trained params (utils/checkpoint.py "
                         "pytree npz) so later runs can --load-model "
                         "instead of retraining")
    ap.add_argument("--load-model", default=None,
                    help="skip training; load params saved by a prior "
                         "--save-model run (of either package) with the "
                         "SAME geometry flags")
    ap.add_argument("--resume", action="store_true",
                    help="with --load-model: continue training --steps "
                         "MORE steps from the checkpoint instead of "
                         "skipping training (fresh optimizer/schedule)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint params to --save-model every N "
                         "steps (plus a .meta.json with step/loss) so a "
                         "long run survives interruption")
    ap.add_argument("--train-only", action="store_true",
                    help="train + save and exit without measuring modes")
    ap.add_argument("--modes", nargs="*", default=None,
                    help="measure only these rows (parity is always "
                         "computed as the baseline)")
    ap.add_argument("--extra", action="store_true",
                    help="also the port's rows: " + ", ".join(
                        r for r in EXTRA_ROWS if r not in OPT_IN))
    ap.add_argument("--production", action="store_true",
                    help="the production geometry: whisper-tiny preset, "
                         "10 s clips, full 30 s mel context, up to 6 "
                         "events")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train and decode (the card unless "
                         "told the CPU)")
    args = ap.parse_args(argv)
    if args.production:
        args.preset, args.clip_seconds = "tiny", 10.0
        args.mel_seconds, args.max_events = 30.0, 6
    if args.preset is None:
        args.preset = "tiny" if args.device == "cuda" else "test"

    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.training.synth import (
        SynthModel, SynthVocab, train_synth_captioner)
    from multimodal_audio_search_tpu_torch.utils.checkpoint import (
        load_pytree, save_pytree)

    dev = runtime.select_device(args.device)
    rows = select_rows(args.modes, args.extra)
    n_events = (1 if args.max_events <= 3 else 2, args.max_events)
    wcfg = W.PRESETS[args.preset]
    loaded_params = None
    if args.load_model:
        template = W.init_params(torch.Generator().manual_seed(0), wcfg)
        loaded_params = load_pytree(template, args.load_model)
    train_s = 0.0
    if args.load_model and not args.resume:
        model = SynthModel(
            params=loaded_params, cfg=wcfg, vocab=SynthVocab(wcfg),
            mel_seconds=args.mel_seconds, losses=[0.0],
            n_events=n_events)   # loss unknown: loaded
    else:
        t0 = time.perf_counter()
        save_cb = None
        if args.save_model and args.save_every:
            def save_cb(step, params, losses):
                save_pytree(params, args.save_model)
                with open(args.save_model + ".meta.json", "w") as f:
                    json.dump({"step": step,
                               "loss_recent": round(float(
                                   np.mean(losses[-20:])), 4)}, f)
        model = train_synth_captioner(
            steps=args.steps, batch=args.batch, seed=args.seed,
            preset=args.preset, clip_seconds=args.clip_seconds,
            mel_seconds=args.mel_seconds, n_events=n_events,
            params_init=loaded_params, save_cb=save_cb,
            save_every=args.save_every, device=dev)
        if args.save_model:
            save_pytree(model.params, args.save_model)
        train_s = time.perf_counter() - t0
    if args.train_only:
        print(json.dumps({
            "metric": "synth_drift_train_only",
            "steps": args.steps,
            "final_loss": round(float(np.mean(model.losses[-20:])), 4),
            "saved": args.save_model}))
        return
    waves, truths = held_out(np.random.default_rng(args.seed + 1),
                             args.clips, args.clip_seconds, n_events)
    short_ctx_s = short_context_seconds(args.clip_seconds, args.mel_seconds)
    modes, details = measure(model, waves, truths, rows, dev, short_ctx_s)
    out = {
        "metric": "synth_drift",
        "train": {"steps": (0 if (args.load_model and not args.resume)
                            else args.steps),
                  "final_loss": round(float(
                      np.mean(model.losses[-20:])), 4),
                  "preset": args.preset,
                  "loaded": bool(args.load_model)},
        "geometry": {"clip_seconds": args.clip_seconds,
                     "mel_seconds": args.mel_seconds,
                     "max_events": args.max_events,
                     "short_context_seconds": short_ctx_s},
        "clips": args.clips,
        "modes": modes,
    }
    print(json.dumps({"train_seconds": train_s, "routes": {
        name: {k: v for k, v in d.items() if k != "texts"}
        for name, d in details.items()}}), file=sys.stderr, flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
