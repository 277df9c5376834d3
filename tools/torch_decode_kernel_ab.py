"""K5 (int8 dense layer), K4 / K4-o (decoder MLP block) and K14 of one
checkout of the port, timed at the main path's shapes, for A/B runs of
two checkouts in turns on one card.

    python3 tools/torch_decode_kernel_ab.py --root DIR --label NAME \
        [--out chiprun_out]

DIR is the root of a checkout (its ``multimodal_audio_search_tpu_torch``
is imported, so run one process per checkout, e.g. parent, change,
change, parent); the inputs, checks and timing helpers are this
checkout's chip_smoke.py. For each case it prints one JSON line: the card
(name and power limit), the check against the plain version, and

* ``ms``: median of 20 single calls in a CUDA-event window (the wrapper's
  host work included, as chip_smoke.py times every kernel);
* ``device_ms``: torch.profiler's CUDA kernel rows over 20 calls, per call;
* ``host_us``: wall time of 200 calls issued back to back, per call;
* the plain version's ms and device ms, the bound of the work, and for K5
  one torch._weight_int8pack_mm call (``library_*``) where the card's
  torch runs it on CUDA.

Cases: K5 at every chip_smoke.K5_SHAPES entry (a decode step's layers,
the tied logits, the cross K/V projection over 48,000 rows, both
widths; where the checkout has a logits table, the logits on it and
again on the codes, ``logits_skinny`` or ``logits_copy`` as the plan
runs them); K4, K4-o and K14 at B=32 and both chip_smoke.DEC_WIDTHS;
K4 and K4-o at whisper-small's and large's widths (B=32) and at base
width with B=128.
Needs a CUDA card; inputs come from a seeded torch.Generator.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's chip_smoke.py, by path (DIR may hold another)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None,
                    help="directory for a copy of the JSON lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = load_chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import decoder_block as DB
    from multimodal_audio_search_tpu_torch.ops import quant as Q
    runtime.select_device("cuda")
    t0 = time.perf_counter()
    runtime.kernels()
    rows = [{"label": args.label, "card": cs.card_line(),
             "build_s": time.perf_counter() - t0, "torch": torch.__version__}]
    print(json.dumps(rows[0]), flush=True)

    def timings(fn, plain) -> dict:
        return {"ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn),
                "host_us": cs.host_us(fn), "plain_ms": cs.time_ms(plain),
                "plain_device_ms": cs.device_ms(plain)}

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def k5_row(regime, p, x, wq, scale, b, out_dtype, shape) -> dict:
        m, k = x.shape
        n = wq.shape[1]
        fn = (lambda: Q.quant_dense_apply(p, x, out_dtype=out_dtype))
        row = {"label": args.label, "kernel": "K5", "regime": regime,
               "shape": shape,
               "max_abs_err": cs.check_k5(f"K5 {regime} {m}x{k}x{n}", fn(),
                                          cs.k5_plain(x, wq, scale, b,
                                                      out_dtype)),
               **timings(fn, lambda: cs.k5_plain(x, wq, scale, b,
                                                 out_dtype)),
               **cs.bound(cs.nbytes(x, wq, scale, b) + m * n * (
                   2 if out_dtype == torch.bfloat16 else 4),
                          bf16=2 * m * k * n)}
        lib, why = cs.k5_library(x, wq, scale)
        if lib:
            row.update(library_ms=cs.time_ms(lib),
                       library_device_ms=cs.device_ms(lib),
                       library_host_us=cs.host_us(lib))
        else:
            row.update(library_ms=None, library=why)
        row["tflops"] = 2 * m * k * n / row["device_ms"] / 1e9
        row["weight_gbps"] = k * n / row["device_ms"] / 1e6
        return row

    gen = torch.Generator().manual_seed(0)
    for m, k, n, dt, bias in cs.K5_SHAPES:
        out_dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, wq, scale, b = cs.k5_inputs(gen, m, k, n, bias=bias)
        leaf = {"wq": wq, "scale": scale, **({"b": b} if bias else {})}
        # the logits on the transposed table the model holds on the card,
        # and again on the leaf's own codes: "logits_skinny" where the plan
        # gives codes of an odd N the skinny kernel, "logits_copy" where it
        # gives them the table kernel on a copy made for the call
        variants = [(cs.k5_regime(m, n), leaf)]
        if variants[0][0] == "logits" and hasattr(Q, "logits_table"):
            codes = "logits_" + ("skinny" if Q.split_plan(m, k, n)[0] ==
                                 "skinny" else "copy")
            variants = [("logits", Q.logits_table(leaf)), (codes, leaf)]
        for regime, p in variants:
            emit(k5_row(regime, p, x, wq, scale, b, out_dtype,
                        f"M={m} K={k} N={n} out={dt} bias={bias}"))
        del x, wq, scale, b, leaf, variants
    torch.cuda.empty_cache()

    b = 32
    for label, d, heads, f in cs.DEC_WIDTHS:
        x, mlp, head = cs.k4_inputs(gen, b, d, f)
        for key, fused, plain, a in (
                ("K4", DB.fused_mlp_block, DB.mlp_block_plain, (x, *mlp)),
                ("K4-o", DB.fused_mlp_block_o, DB.mlp_block_o_plain,
                 (x, *head, *mlp))):
            emit({"label": args.label, "kernel": key,
                  "shape": f"{label} B={b} D={d} F={f}",
                  **cs.check_delta(f"{key} {label}", fused(*a), plain(*a), x),
                  **timings(lambda: fused(*a), lambda: plain(*a)),
                  **cs.bound(cs.nbytes(*a, x), bf16=4 * b * d * f + (
                      2 * b * d * d if key == "K4-o" else 0))})
        a = cs.k14_inputs(gen, b, cs.K14_T, d, f)
        t = cs.K14_T
        emit({"label": args.label, "kernel": "K14",
              "shape": f"{label} B={b} T={t} D={d} H={heads} F={f}",
              **cs.check_delta(f"K14 {label}",
                               DB.fused_cross_mlp_block(*a, heads=heads),
                               DB.cross_mlp_block_plain(*a, heads=heads),
                               a[0]),
              **timings(lambda: DB.fused_cross_mlp_block(*a, heads=heads),
                        lambda: DB.cross_mlp_block_plain(*a, heads=heads)),
              **cs.bound(cs.nbytes(*a, a[0]), bf16=4 * b * d * d
                         + 4 * b * t * d + 4 * b * d * f)})
        del x, mlp, head, a
    # K4 / K4-o past the engine's shapes: whisper-small's and large's
    # widths, and base width at an ingest batch of 128
    for label, b, d, f in (("small", 32, 768, 3072), ("large", 32, 1280, 5120),
                           ("base", 128, 512, 2048)):
        x, mlp, head = cs.k4_inputs(gen, b, d, f)
        for key, fused, plain, a in (
                ("K4", DB.fused_mlp_block, DB.mlp_block_plain, (x, *mlp)),
                ("K4-o", DB.fused_mlp_block_o, DB.mlp_block_o_plain,
                 (x, *head, *mlp))):
            emit({"label": args.label, "kernel": key,
                  "shape": f"{label} B={b} D={d} F={f}",
                  **cs.check_delta(f"{key} {label}", fused(*a), plain(*a), x),
                  **timings(lambda: fused(*a), lambda: plain(*a)),
                  **cs.bound(cs.nbytes(*a, x), bf16=4 * b * d * f + (
                      2 * b * d * d if key == "K4-o" else 0))})
        del x, mlp, head
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "decode_kernel_ab.jsonl"), "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
