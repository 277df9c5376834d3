"""Does deferring the softmax division pay on the card? The A/B of K11.

    python3 tools/torch_profile_encoder_kernel_ab.py [--batch 64] [--reps 20]

The counterpart of tools/profile_encoder_kernel_ab.py (the TPU A/B of the
encoder block kernel's softmax division) for the PyTorch port on one CUDA
card. It runs K11 (ops/encoder_block.py::attention_o_residual_ab, the
encoder attention + o-projection + residual) at whisper-base width (H=8,
D=64), B=--batch, T=500 and T=1500, in each form of the division:
False divides p by l before the PV product (two passes over K), True
divides each head's PV output by l, "post" multiplies it by 1/l (the TPU
tool's division after the head concat). One JSON line per case: the
median milliseconds of --reps calls from CUDA events after a warm-up,
TFLOP/s of the function's work, its share of the card's bound (bf16
tensor cores at 989 TFLOP/s, 3.35 TB/s; NVIDIA's H100 SXM data sheet),
and max |out - out of the first form|. The first line names the card
and its power limit. Inputs are the TPU tool's: q/k/v/x ~ 0.1 N(0, 1),
Wo ~ 0.05 N(0, 1), bo ~ 0.01 N(0, 1), from numpy seed 0, in bf16.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMS = (False, True, "post")
WARMUP = 3          # untimed calls before the timed ones
BF16_FLOPS, HBM_BYTES = 989e12, 3.35e12   # per second, H100 SXM at 700 W


def time_ms(fn, reps: int) -> float:
    """Median per-call milliseconds from CUDA events after WARMUP calls."""
    for _ in range(WARMUP):
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


def bound_ms(b: int, h: int, t: int, d: int = 64) -> float:
    """The least time of the function on the card: the larger of its
    bf16 work over the tensor-core peak and its bytes (q/k/v/x read, out
    written, Wo and bo read once) over the memory rate."""
    hd = h * d
    flops = 4 * b * h * t * t * d + 2 * b * t * hd * hd
    nbytes = 2 * (3 * b * h * t * d + 2 * b * t * hd + hd * hd + hd)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES) * 1e3


def run(batch: int = 64, contexts=(500, 1500), reps: int = 20,
        emit=print) -> list[dict]:
    """Time every form at every context; emit (and return) one dict per
    case."""
    from multimodal_audio_search_tpu_torch.ops.encoder_block import (
        attention_o_residual_ab)
    h, d = 8, 64
    hd = h * d
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def rn(shape, scale):
        a = rng.standard_normal(size=shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    rows = []
    for t in contexts:
        q, k, v = (rn((batch, h, t, d), 0.1) for _ in range(3))
        x = rn((batch, t, hd), 0.1)
        wo, bo = rn((hd, hd), 0.05), rn((hd,), 0.01)
        flops = 4 * batch * h * t * t * d + 2 * batch * t * hd * hd
        first = None
        for form in FORMS:
            def fn(form=form):
                return attention_o_residual_ab(q, k, v, x, wo, bo, form)
            out = fn()
            torch.cuda.synchronize()
            first = out if first is None else first
            ms = time_ms(fn, reps)
            row = {"case": f"defer_div={form} t={t} B={batch}", "ms": ms,
                   "tflops": flops / ms / 1e9,
                   "share_of_bound": bound_ms(batch, h, t) / ms,
                   "max_abs_vs_first": float(
                       (out.float() - first.float()).abs().max())}
            rows.append(row)
            emit(json.dumps(row))
        del q, k, v, x, wo, bo, out, first
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    from multimodal_audio_search_tpu_torch import runtime
    runtime.select_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    run(args.batch, reps=args.reps,
        emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
