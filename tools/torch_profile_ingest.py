"""Where an ingest batch of the PyTorch port spends its time, on the card.

    python3 tools/torch_profile_ingest.py [--seconds 320] [--out DIR]

Builds the default-config engine (random init, bf16, cuda), warms it up
with one ingest, then ingests ``--seconds`` of audio (320 s = one full
batch of 32 segments) under torch.profiler. Prints one JSON line: wall
time, summed device (kernel) time, the device's idle share over the
window, the per-phase host trace of the ingest, and the top kernels by
device time; with ``--out`` the full kernel table goes to
``DIR/profile_ingest.json``.
Needs one CUDA card.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=320)
    ap.add_argument("--out", default=None,
                    help="directory for the full kernel table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, make_audio, wav_bytes
    from multimodal_audio_search_tpu_torch import AudioSearchEngine
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    eng = AudioSearchEngine(device="cuda", seed=0)
    eng.load_all_models()
    eng.ingest(wav_bytes(make_audio(args.seconds, rng)), "warmup")
    clip = wav_bytes(make_audio(args.seconds, rng))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest(clip, "profiled")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side kernel events only: the aten op rows carry the same
        # device time again, attributed to the op that launched it
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append({"kernel": e.key[:120], "device_ms": dev_us / 1e3,
                         "count": e.count})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    trace = {k: round(v * 1e3, 3)
             for k, v in eng.ingest_pipeline.last_trace.items()}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_ingest.json"), "w") as f:
            json.dump({"card": card_line(), "rows": rows}, f, indent=1)
    print(json.dumps({
        "card": card_line(), "audio_seconds": args.seconds,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if rows
        else "not measured",
        "host_trace_ms": trace, "top": rows[:12]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
