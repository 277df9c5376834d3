"""Where an ingest batch of the PyTorch port spends its time, on the card.

    python3 tools/torch_profile_ingest.py [--paths default,fast_lossless,v2,
                                           int8_fused,int8]
                                          [--seconds 320] [--out DIR]
                                          [--root CHECKOUT]
                                          [--dtype bf16|float32]

Builds one engine per path (chip_smoke.ENGINE_PATHS: the default config,
``apply_profile(..., "fast_lossless")``, that profile with
``fused_layer="v2"``, and the int8 decoder memory mode with
``cross_attn="int8_fused"`` or ``"int8"``; random init, bf16, cuda) and
warms each up with
one ingest. Then ingests ``--seconds`` of audio (320 s = one full batch
of 32 segments) with each path in turns (A B C C B A), timing the host
wall and the host trace, and once more per path under torch.profiler
for the device's busy time and idle share, and the device memory an
ingest holds at its peak (``peak_bytes``, every engine resident) and
above what it holds before (``extra_bytes``). Prints one JSON line per run
and a last line with each path's median wall and audio-s/s; with
``--out`` the full kernel tables go to ``DIR/profile_ingest.json``.
``--root`` imports the package from another checkout (e.g. the parent
commit unpacked by ``git archive``), with this checkout's engine
configurations, for A/B runs in one call. ``--dtype float32`` builds
each path's pipelines with ``make_default_ingest(..., dtype=
torch.float32)``, as chip_smoke.py's ``[f32]`` does (the decoder blocks'
float32 forms under ``fast_lossless``). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_rows(prof) -> list[dict]:
    """Device-side kernel events only: the aten op rows carry the same
    device time again, attributed to the op that launched it."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append({"kernel": e.key[:120], "device_ms": dev_us / 1e3,
                         "count": e.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="default",
                    help="comma-separated labels of chip_smoke.ENGINE_PATHS")
    ap.add_argument("--seconds", type=int, default=320)
    ap.add_argument("--out", default=None,
                    help="directory for the full kernel tables")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose package is profiled")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "float32"),
                    help="the pipelines' dtype")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, ROOT)
    from chip_smoke import (ENGINE_PATHS, card_line, engine_config,
                            make_audio, wav_bytes)
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from torch.profiler import ProfilerActivity, profile

    card = card_line()
    rng = np.random.default_rng(0)
    paths = {label: rest for label, *rest in ENGINE_PATHS}
    labels = args.paths.split(",")
    engines = {}
    for label in labels:
        cfg = engine_config(*paths[label])
        if args.dtype == "float32":
            from multimodal_audio_search_tpu_torch.pipelines.ingest import (
                make_default_ingest)
            eng = AudioSearchEngine(
                cfg=cfg, device="cuda", seed=0,
                ingest_pipeline=make_default_ingest(
                    cfg, seed=0, dtype=torch.float32, device="cuda"))
        else:
            eng = AudioSearchEngine(cfg=cfg, device="cuda", seed=0)
        eng.load_all_models()
        eng.ingest(wav_bytes(make_audio(args.seconds, rng)), "warmup")
        engines[label] = eng
    clip = wav_bytes(make_audio(args.seconds, rng))

    def run(label):
        eng = engines[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.ingest(clip, label)
        torch.cuda.synchronize()
        ing = eng.ingest_pipeline
        return ((time.perf_counter() - t0) * 1e3,
                {k: round(v * 1e3, 3) for k, v in ing.last_trace.items()},
                ing.asr.last_steps + ing.caption.last_steps)

    walls = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        wall_ms, trace, steps = run(label)
        walls[label].append(wall_ms)
        print(json.dumps({
            "card": card, "path": label, "dtype": args.dtype, "run": "timed",
            "wall_ms": wall_ms,
            "audio_s_per_s": args.seconds / wall_ms * 1e3,
            "decode_steps": steps,
            "dispatch_ms_per_step": trace["dispatch"] / steps,
            "host_trace_ms": trace}), flush=True)
    tables = {}
    for label in labels:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms, trace, steps = run(label)
        peak = torch.cuda.max_memory_allocated()
        rows = kernel_rows(prof)
        busy_ms = sum(r["device_ms"] for r in rows)
        tables[label] = rows
        print(json.dumps({
            "card": card, "path": label, "run": "profiled",
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if rows else "not measured",
            "device_idle_share": 1 - busy_ms / wall_ms if rows
            else "not measured",
            "peak_bytes": peak, "extra_bytes": peak - held,
            "host_trace_ms": trace, "top": rows[:10]}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_ingest.json"), "w") as f:
            json.dump({"card": card, "tables": tables}, f, indent=1)
    print(json.dumps({"card": card, "audio_seconds": args.seconds,
                      "median_wall_ms": {k: float(np.median(v))
                                         for k, v in walls.items()},
                      "median_audio_s_per_s": {
                          k: args.seconds / float(np.median(v)) * 1e3
                          for k, v in walls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
