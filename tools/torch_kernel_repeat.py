"""Launch a kernel many times on the same inputs and count the launches
whose output differs from the first.

    python3 tools/torch_kernel_repeat.py [--root DIR] [--kernels K9,K3,K3-q]
                                         [--reps N] [--k3-reps N]

The kernels held here read TMA-filled shared-memory stages with plain
loads before they hand a stage back to the copy engine: K9 (the int8-dot
encoder block: scales and Wo tiles) and K3 / K3-q (the decoder self
block: ldmatrix on its weight tiles). Each sums in a fixed order, so
every launch on the same inputs must give the same bits; a launch that
differs shows a race. ``--root`` imports
``multimodal_audio_search_tpu_torch`` from another checkout (its kernels
are built there), so two versions can be compared on one card in one run.

Shapes are chip_smoke.py's, at whisper-base and whisper-tiny width: K9 at
B=32, T=1500 on the attention-only input (x and bo zero; also held to
chip_smoke's tolerance against the plain version), K3 / K3-q at B=32 over
a 68-row cache at pos 67 (caches cloned for each launch). Prints one JSON
line a kernel and width: launches, those that differ from the first, the
most elements differing in one, the median milliseconds a launch (CUDA
events); then the card's name and power limit.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This checkout's chip_smoke.py (its input makers and tolerances)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median_ms(fn, n: int = 21) -> float:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n)]
    for i in range(n):
        ev[2 * i].record()
        fn()
        ev[2 * i + 1].record()
    torch.cuda.synchronize()
    return sorted(ev[2 * i].elapsed_time(ev[2 * i + 1])
                  for i in range(n))[n // 2]


def repeat(fn, reps: int, extra=None) -> dict:
    """``reps`` launches of ``fn`` (a tuple of tensors) against the first;
    ``extra(outs)`` adds a per-launch float32 reading (max over launches)."""
    first = fn()
    differ = torch.zeros(reps, dtype=torch.int64, device="cuda")
    worst = None
    for i in range(reps):
        outs = fn()
        differ[i] = sum((o != f).sum() for o, f in zip(outs, first))
        if extra is not None:
            e = extra(outs)
            worst = e if worst is None else torch.maximum(worst, e)
    torch.cuda.synchronize()
    out = {"launches": reps, "differ_from_first": int((differ > 0).sum()),
           "elements_differing_max": int(differ.max())}
    if worst is not None:
        out["worst"] = worst.tolist()
    return out


def k9(C, label: str, heads: int, reps: int) -> dict:
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    b, t = 32, 1500
    q, k, v, x, wo, bo = C.k1_inputs(torch.Generator().manual_seed(0), b, t,
                                     heads, residual=False)
    args = (q, *quantize_kv(k, v), x, wo, bo)
    ref = EB.attention_o_residual_int8_plain(*args).float()
    ref_max, ref_l2 = ref.abs().max(), ref.norm()

    def rel(outs):
        err = outs[0].float() - ref
        return torch.stack([err.abs().max() / ref_max, err.norm() / ref_l2])

    r = repeat(lambda: (EB.attention_o_residual_int8(*args),), reps, rel)
    rel_max, rel_l2 = r.pop("worst")
    return {"kernel": "K9", "width": label,
            "shape": f"B={b} T={t} H={heads} D=64", **r,
            "rel_max_err_max": rel_max, "rel_l2_err_max": rel_l2,
            "within_tolerance": rel_max <= C.K1_Y_MAX
            and rel_l2 <= C.K1_Y_L2,
            "ms": median_ms(lambda: EB.attention_o_residual_int8(*args))}


def k3(C, key: str, label: str, d: int, heads: int, reps: int) -> dict:
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    b, l, pos = 32, 68, C.K3_POS[-1]
    x, selfw, tail, kc, vc = C.k3_inputs(torch.Generator().manual_seed(0),
                                         b, l, d)
    fused = DB.fused_self_block_q if key == "K3-q" else DB.fused_self_block
    args = (x, *selfw, *(tail if key == "K3-q" else []))

    def run():
        return fused(*args, kc.clone(), vc.clone(), pos, heads=heads)

    return {"kernel": key, "width": label,
            "shape": f"B={b} D={d} H={heads} L={l} pos={pos}",
            **repeat(run, reps), "ms": median_ms(run)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernels", default="K9,K3,K3-q")
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--k3-reps", type=int, default=20000)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_repeat: no CUDA device")
    C = smoke()
    sys.path.insert(0, os.path.abspath(a.root))
    from multimodal_audio_search_tpu_torch import runtime
    runtime.select_device("cuda")
    runtime.kernels()
    kernels = a.kernels.split(",")
    for label, d, heads, _ in C.DEC_WIDTHS:
        rows = []
        if "K9" in kernels:
            rows.append(k9(C, label, heads, a.reps))
        rows += [k3(C, key, label, d, heads, a.k3_reps)
                 for key in ("K3", "K3-q") if key in kernels]
        for row in rows:
            print(json.dumps({"root": a.root, **row}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
