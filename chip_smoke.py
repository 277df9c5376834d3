"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, one line each (``[phase] ...``):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No card -> the script raises before anything else.
2. build: K1 and K2 compiled from ``multimodal_audio_search_tpu_torch/
   csrc`` with nvcc for sm_90a; build seconds and ptxas resource lines.
3. kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them: K1 at B=32, T=1500, (H, D) = (8, 64)
   (whisper-base) and (6, 64) (whisper-tiny), each on a residual input
   and on two inputs that isolate the attention term (K1_CASES); K2
   cross at B=32, T=1500,
   H=8 and K2 self at B=32, L=68, pos in {0, 3, 67}. Tolerances asserted;
   median times from CUDA events after a warm-up.
4. the engine: a default-config AudioSearchEngine on cuda (random init
   from a seed, bf16) ingests two 16-bit WAVs made with numpy (320 s =
   one full batch of 32 segments, and 25 s = 3 segments) and answers
   queries. The launch counts of K1 and K2 over that run must be > 0 and
   equal the counts the path implies; the ASR text of one ingested
   segment, used as a query, must rank its own segment first; the
   encoder and a decode step are held against their plain paths on a
   small input.

The second-to-last line is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
"""
from __future__ import annotations

import json
import math
import os
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000

# tolerances of kernel vs plain version on identical bf16 inputs
# K1 is held to its plain version on three inputs at each shape
# (K1_CASES). The kernel rounds P to bf16 before PV (the TPU kernel's
# rounding) where the plain version keeps f32, and the two sum in
# different orders.
# * "residual" (x ~ N(0, 1), bo ~ 0.1 N(0, 1)): out = x + y + bo
#   elementwise within 2 bf16 ulps relative + 1e-2. This checks the
#   residual and bias epilogue; x dominates out, so it cannot see the
#   attention term y = attn @ Wo (~0.04 in scale).
# * "attention" (x = 0, bo = 0, unit-variance logits) and "peaked" (the
#   same with q scaled by 3): out is y alone, held to the plain y relative
#   to its own scale: max |err| <= K1_Y_MAX * max |y_ref| and
#   ||err|| <= K1_Y_L2 * ||y_ref||. A float32 emulation of the kernel's
#   roundings at T=1500 reads 0.44 % and 0.33 %; the 36 zero-padded keys
#   of the last 64-key tile left unmasked read 1.75 % and 1.47 % on the
#   "attention" input, and a missing 1/l reads over 300 %
#   (tests/test_torch_kernels.py and tests/test_torch_cuda.py plant these
#   faults and show the check rejects them).
K1_ATOL, K1_RTOL = 1e-2, 1.6e-2
K1_Y_MAX, K1_Y_L2 = 1e-2, 7e-3
# (label, q scale, residual)
K1_CASES = (("residual", 1.0, True), ("attention", 1.0, False),
            ("peaked", 3.0, False))
# K2: f32 output, f32 softmax and products on the same bf16 inputs in
#     both -> only the summation order differs.
K2_ATOL, K2_RTOL = 1e-3, 1e-3
# the engine's kernel path (K1 encoder, K2 decode step) against its plain
# path (plain encoder, einsum cross attention) on one bf16 input: both
# round bf16 activations at different places through 6 layers. Limits are
# twice the readings on an H100 (encoder mean 0.0059, logits max 0.021 on
# a scale of 2.23); PERF.md lists what planted faults read.
ENC_MEAN_ERR_MAX = 1.2e-2
LOGITS_ERR_REL = 2e-2


def phase(name: str, **kv) -> None:
    print(f"[{name}] " + json.dumps(kv, default=str), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median per-call milliseconds from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wav_bytes(x: np.ndarray, rate: int = SR) -> bytes:
    """Mono 16-bit PCM WAV in memory."""
    payload = (np.clip(x, -1.0, 1.0 - 1.0 / 32768) * 32768.0) \
        .astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload),
                      b"WAVE", b"fmt ", 16, 1, 1, rate, rate * 2, 2, 16,
                      b"data", len(payload))
    return hdr + payload


def make_audio(seconds: int, rng: np.random.Generator) -> np.ndarray:
    """Distinct 10 s pieces (tones of different pitch and noise of
    different level) so the segments differ from one another."""
    out = []
    t = np.arange(10 * SR) / SR
    for i in range(-(-seconds // 10)):
        f = 110.0 * 2 ** (i / 5)
        piece = 0.3 * np.sin(2 * np.pi * f * t) * (1 + (i % 3)) / 3 \
            + rng.normal(size=t.size) * 0.02 * (1 + i % 7)
        out.append(piece)
    return np.concatenate(out)[: seconds * SR].astype(np.float32)


def _same_shape_finite(name, got, ref) -> None:
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite values")


def check_close(name, got, ref, atol, rtol) -> float:
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} + rtol "
            f"{rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def k1_inputs(gen: torch.Generator, b: int, t: int, heads: int, *,
              q_scale: float = 1.0, residual: bool = True,
              device="cuda"):
    """K1's inputs in bf16 as the encoder hands them over: q/k/v are
    head-split views of [B, T, H*D] dense outputs. Without ``residual``,
    x and bo are zero, so the output is the attention term alone."""
    d = 64
    hd = heads * d

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device, torch.bfloat16)

    q, k, v = (rn(b, t, hd, scale=s).view(b, t, heads, d).transpose(1, 2)
               for s in (q_scale, 1.0, 1.0))
    wo = rn(hd, hd, scale=1 / math.sqrt(hd))
    if residual:
        x, bo = rn(b, t, hd), rn(hd, scale=0.1)
    else:
        x = torch.zeros(b, t, hd, device=device, dtype=torch.bfloat16)
        bo = torch.zeros(hd, device=device, dtype=torch.bfloat16)
    return q, k, v, x, wo, bo


def check_k1(name, got, ref, residual: bool) -> dict:
    """K1's output against its plain version's (see K1_CASES); raises
    outside the tolerance, returns the errors."""
    if residual:
        return {"max_abs_err": check_close(name, got, ref, K1_ATOL,
                                           K1_RTOL)}
    got, ref = got.float(), ref.float()
    _same_shape_finite(name, got, ref)
    err = got - ref
    rel_max = float(err.abs().max() / ref.abs().max())
    rel_l2 = float(err.norm() / ref.norm())
    if not (rel_max <= K1_Y_MAX and rel_l2 <= K1_Y_L2):
        raise AssertionError(
            f"{name}: attention term off its plain version: max |err| = "
            f"{rel_max:.3e} of max |y| (limit {K1_Y_MAX}), ||err|| = "
            f"{rel_l2:.3e} of ||y|| (limit {K1_Y_L2})")
    return {"max_abs_err": float(err.abs().max()), "rel_max_err": rel_max,
            "rel_l2_err": rel_l2}


def kernel_phase(card: str, gen: torch.Generator):
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import encoder_block as K1
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    k1 = {"name": "encoder_attn_o_residual", "route": "cuda",
          "source": "multimodal_audio_search_tpu_torch/csrc/encoder_block.cu",
          "replaces": "multimodal_audio_search_tpu/ops/encoder_block.py:425",
          "cases": []}
    for heads, label in ((8, "base"), (6, "tiny")):
        b, t, d = 32, 1500, 64
        for inputs, q_scale, residual in K1_CASES:
            args = k1_inputs(gen, b, t, heads, q_scale=q_scale,
                             residual=residual)
            got = K1.fused_attention_o_residual(*args)
            ref = K1.attention_o_residual_plain(*args)
            torch.cuda.synchronize()
            case = {"shape": f"{label} B={b} T={t} H={heads} D={d}",
                    "inputs": inputs,
                    **check_k1(f"K1 {label} {inputs}", got, ref, residual)}
            if residual:
                ms = time_ms(lambda: K1.fused_attention_o_residual(*args))
                plain_ms = time_ms(
                    lambda: K1.attention_o_residual_plain(*args), reps=5)
                hd = heads * d
                flops = 4 * b * heads * t * t * d + 2 * b * t * hd * hd
                case.update(ms=ms, plain_ms=plain_ms,
                            tflops=flops / ms / 1e9)
            k1["cases"].append(case)
            phase("kernels", kernel="K1", card=card,
                  tol=[K1_ATOL, K1_RTOL] if residual
                  else {"y_max": K1_Y_MAX, "y_l2": K1_Y_L2}, **case)
            del args, got, ref
            torch.cuda.empty_cache()

    k2 = {"name": "single_query_attention", "route": "cuda",
          "source": "multimodal_audio_search_tpu_torch/csrc/"
                    "cross_attention.cu",
          "replaces": "multimodal_audio_search_tpu/ops/cross_attention.py:145",
          "cases": []}
    for label, t, pos in (("cross", 1500, None), ("self", 68, 0),
                          ("self", 68, 3), ("self", 68, 67)):
        b, heads, d = 32, 8, 64
        hd = heads * d
        q, k, v = rn(b, hd), rn(b, t, hd), rn(b, t, hd)
        got = K2.fused_single_query_attention(q, k, v, heads=heads, pos=pos)
        ref = K2.single_query_attention_plain(q, k, v, heads=heads, pos=pos)
        torch.cuda.synchronize()
        err = check_close(f"K2 {label} pos={pos}", got, ref, K2_ATOL,
                          K2_RTOL)
        ms = time_ms(lambda: K2.fused_single_query_attention(
            q, k, v, heads=heads, pos=pos))
        plain_ms = time_ms(lambda: K2.single_query_attention_plain(
            q, k, v, heads=heads, pos=pos))
        n = t if pos is None else pos + 1
        case = {"shape": f"{label} B={b} T={t} H={heads} pos={pos}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "gbps": 2 * b * n * hd * 2 / ms / 1e6}
        k2["cases"].append(case)
        phase("kernels", kernel="K2", card=card, tol=[K2_ATOL, K2_RTOL],
              **case)
    return k1, k2


def engine_phase(card: str, rng: np.random.Generator):
    from multimodal_audio_search_tpu_torch import AudioSearchEngine, runtime

    t0 = time.perf_counter()
    eng = AudioSearchEngine(device="cuda", seed=0)
    eng.load_all_models()
    ing = eng.ingest_pipeline
    asr, cap = ing.asr, ing.caption
    torch.cuda.synchronize()
    phase("engine", step="built", seconds=time.perf_counter() - t0,
          asr=f"whisper-base d={asr.cfg.d_model} L={asr.cfg.enc_layers}",
          caption=f"whisper-tiny d={cap.cfg.d_model}",
          dtype=str(asr.dtype), batch=eng.cfg.ingest_batch)

    clips = [("long.wav", make_audio(320, rng)),
             ("short.wav", make_audio(25, rng))]
    # ---- the main path, counted
    runtime.reset_counts()
    steps0 = (asr.total_steps, cap.total_steps)
    disp0 = (asr.dispatches, cap.dispatches)
    t0 = time.perf_counter()
    n_segs, audio_s, traces = 0, 0.0, []
    for name, x in clips:
        segs = eng.ingest(wav_bytes(x), source_name=name)
        n_segs += len(segs)
        audio_s += len(x) / SR
        traces.append(dict(ing.last_trace))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    queries = []
    texts = [m["asr_text"] for m in eng.store.meta]
    if not texts:
        raise AssertionError("no segment survived validation")
    # the query: the ASR text of an ingested segment, unique if any is
    counts_by_text = {tx: texts.count(tx) for tx in texts}
    unique = [i for i, tx in enumerate(texts) if counts_by_text[tx] == 1
              and tx]
    own = unique[0] if unique else next(i for i, tx in enumerate(texts) if tx)
    queries.append(texts[own])
    queries += ["upbeat music with drums", "someone speaking clearly",
                "rain and birds in the background"]
    lat, hits0 = [], None
    for qi, qtext in enumerate(queries):
        tq = time.perf_counter()
        hits, info = eng.search(qtext)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - tq) * 1e3)
        if qi == 0:
            hits0 = hits
    counts = dict(runtime.COUNTS)
    steps = (asr.total_steps - steps0[0], cap.total_steps - steps0[1])
    disp = (asr.dispatches - disp0[0], cap.dispatches - disp0[1])
    # ---- what the main path must have launched
    exp_k1 = disp[0] * asr.cfg.enc_layers + disp[1] * cap.cfg.enc_layers
    exp_k2 = 2 * (steps[0] * asr.cfg.dec_layers
                  + steps[1] * cap.cfg.dec_layers)
    if counts["encoder_attn_o_residual"] != exp_k1 or exp_k1 == 0:
        raise AssertionError(f"K1 launches {counts} != expected {exp_k1}")
    if counts["single_query_attention"] != exp_k2 or exp_k2 == 0:
        raise AssertionError(f"K2 launches {counts} != expected {exp_k2}")
    # ---- self-retrieval
    if not hits0:
        raise AssertionError("self-retrieval query returned no hit")
    top = hits0[0]
    if unique:
        if top["index"] != own:
            raise AssertionError(
                f"own segment {own} not first: {[h['index'] for h in hits0]}")
    elif top["asr_text"] != texts[own]:
        raise AssertionError("no unique ASR text, and the top hit does "
                             "not even share the query's text")
    if not top["asr_similarity"] > 0.999:
        raise AssertionError(f"self cosine {top['asr_similarity']}")
    phase("engine", step="main path", card=card, segments=n_segs,
          audio_seconds=audio_s, ingest_seconds=ingest_s,
          ingest_audio_s_per_s=audio_s / ingest_s,
          query_ms=lat, query_p50_ms=float(np.median(lat)),
          decode_steps={"asr": steps[0], "caption": steps[1]},
          dispatches={"asr": disp[0], "caption": disp[1]},
          launches=counts, expected={"K1": exp_k1, "K2": exp_k2},
          distinct_asr_texts=len(counts_by_text), stored=len(texts),
          self_query_segment=own, self_query_unique=bool(unique),
          top_hit=top["index"], top_score=top["fusion_score"],
          trace_ms=[{k: round(v * 1e3, 3) for k, v in tr.items()}
                    for tr in traces])
    reference_check(asr, rng)
    return counts


def reference_check(asr, rng: np.random.Generator) -> None:
    """The ASR model's kernel path against its plain path on one small
    input: the K1 encoder against the plain encoder, a decode step over
    merged cross K/V (K2) against the einsum one, and an 8-token greedy
    run for shapes. Raises outside ENC_MEAN_ERR_MAX / LOGITS_ERR_REL.
    Both decode steps take K2 for the cached self attention, so this sees
    K2's cross use only; the kernel phase checks its ``pos`` mask."""
    from multimodal_audio_search_tpu_torch.models import whisper as W
    from multimodal_audio_search_tpu_torch.models.generate import generate
    from multimodal_audio_search_tpu_torch.ops.mel import log_mel_spectrogram
    dev = asr.device
    with torch.inference_mode():
        x = make_audio(20, rng).reshape(2, -1)[:, : asr.mel_cfg.n_samples]
        w = torch.nn.functional.pad(
            torch.as_tensor(x, device=dev),
            (0, asr.mel_cfg.n_samples - x.shape[1]))
        mel = log_mel_spectrogram(w, asr.mel_cfg).to(asr.dtype)
        enc_k = W.encode(asr.params, mel, asr.cfg, fused_blocks=True)
        enc_p = W.encode(asr.params, mel, asr.cfg, fused_blocks=False)
        enc_err = (enc_k.float() - enc_p.float()).abs()
        ckv = W.cross_kv_merged(asr.params, enc_k, asr.cfg)
        ckv_e = W.cross_kv(asr.params, enc_k, asr.cfg)
        cache = W.init_cache(asr.cfg, 2, 8, asr.dtype, dev)
        cache_e = W.init_cache(asr.cfg, 2, 8, asr.dtype, dev)
        tok = torch.tensor([asr.cfg.bos_token_id] * 2, device=dev)
        lg = W.decode_step(asr.params, tok, 0, cache, ckv, asr.cfg)
        lg_e = W.decode_step(asr.params, tok, 0, cache_e, ckv_e, asr.cfg)
        lg_err = (lg - lg_e).abs()
        prefix = torch.tensor([asr.prefix_ids] * 2, device=dev)
        out = generate(asr.params, enc_k, prefix, cfg=asr.cfg,
                       decode=asr.decode, max_new_tokens=8)
    ok_shapes = (tuple(enc_k.shape) == (2, asr.mel_cfg.n_frames // 2,
                                        asr.cfg.d_model)
                 and tuple(lg.shape) == (2, asr.cfg.vocab_size)
                 and tuple(out.tokens.shape) == (2, len(asr.prefix_ids) + 8))
    finite = bool(torch.isfinite(enc_k).all() and torch.isfinite(lg).all())
    phase("engine", step="reference", encoder_max_abs_err=float(
        enc_err.max()), encoder_mean_abs_err=float(enc_err.mean()),
        logits_max_abs_err=float(lg_err.max()),
        logits_scale=float(lg_e.abs().max()), shapes_ok=ok_shapes,
        finite=finite)
    if not (ok_shapes and finite):
        raise AssertionError("engine outputs: wrong shape or non-finite")
    if float(enc_err.mean()) > ENC_MEAN_ERR_MAX or float(lg_err.max()) > \
            LOGITS_ERR_REL * float(lg_e.abs().max()):
        raise AssertionError(
            f"kernel path disagrees with the plain path: encoder mean "
            f"{float(enc_err.mean()):.3e} (limit {ENC_MEAN_ERR_MAX}), "
            f"logits max {float(lg_err.max()):.3e} (limit {LOGITS_ERR_REL} "
            f"x {float(lg_e.abs().max()):.3f})")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    if torch.cuda.device_count() != 1:
        raise SystemExit(
            f"chip_smoke drives one card; {torch.cuda.device_count()} are "
            f"visible (expose one, e.g. CUDA_VISIBLE_DEVICES=0)")
    card = card_line()
    phase("env", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          devices=torch.cuda.device_count())
    sys.path.insert(0, ROOT)
    from multimodal_audio_search_tpu_torch import runtime
    runtime.select_device("cuda")
    runtime.kernels()
    info = runtime.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    phase("build", seconds=info["seconds"], command=info["command"],
          ptxas=ptxas)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    k1, k2 = kernel_phase(card, gen)
    counts = engine_phase(card, rng)
    kern = []
    for k in (k1, k2):
        first = k["cases"][0]
        kern.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": counts[k["name"]],
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "shape": first["shape"], "cases": k["cases"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
