"""The decode step's kernels of one checkout of the port -- K3 / K3-q
(decoder self block), K4 / K4-o (decoder MLP block), K5 (int8 dense
layer), K6 and K7 (int8 K/V attention) and K14 -- timed at the main
path's shapes, for A/B runs of two checkouts in turns on one card.

    python3 tools/torch_decode_kernel_ab.py --root DIR --label NAME \
        [--kernels K3,K3-q,K7] [--out chiprun_out]

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
  torch runs it on CUDA;
* for K14, ``stages_device_ms``: the profiler's kernel rows a call by
  stage -- the q-projection (rowproj_kernel<true>), the attention, K4-o's
  o-projection head (rowproj_kernel<false>) and its MLP (mlp_kernel);
  ``span_device_ms``: from the start of a call's first kernel to the end
  of its last, on the device's clock; ``attention_after_q_ms``: from the
  end of the q-projection to the end of the attention; ``queued_ms``: the
  device's milliseconds a call between two CUDA events around 20 calls
  queued behind a sleep kernel (so no gap the host makes between
  launches is counted; median of 3); and its attention's cluster plan
  where the checkout has one. The profiled calls are queued the same
  way. The attention may start before the q-projection ends (it is
  launched early and waits for q1 inside), so the stages can add up to
  more than the span, and then ``device_ms`` (the rows' sum) counts the
  overlap twice.

The float32 forms (``--kernels K3f,K3-qf,K4f,K4-of,K3pf,K4pf``; none of
them by default): K3 f32 / K3-q f32 at B=32, L=68, pos 67 at both
chip_smoke.DEC_WIDTHS, whisper-small's and large's widths and base width
at B=128; K4 f32 / K4-o f32 at the same widths and batches; K3p f32 and
K4p f32 on a rank of two at base and tiny width (B=32). Each line holds
the check against the plain version (chip_smoke.F32_BLOCK_ATOL / RTOL),
``queued_ms``, the plain version's ms (3 calls), the bound
(chip_smoke.k3_f32_bound, or bytes against FFMA at 67 TFLOP/s) and the
checkout's plan where it has one (``plan``: blocks, cluster, clusters,
stages, rows a pass, passes; K4-o also ``proj_plan``); with ``--cold``
also ``cold_queued_ms``: the call with L2 emptied before it, as an
engine's decode step finds a layer's float32 weights (a 128 MB buffer
written between the calls, its own queued time subtracted).

Cases: K3 and K3-q at B=32, L=68, pos 67 and both chip_smoke.DEC_WIDTHS;
K3 at whisper-small's (D=768, H=12) and large's (D=1280, H=20) widths
and at base width with B=128; K6 and K7 at B=32, T=1500, H=8 and H=6 (K6
over every key and over keys 0..chip_smoke.K6_POS); K5 at every
chip_smoke.K5_SHAPES entry (a decode step's layers, the tied logits,
the cross K/V projection over 48,000 rows, both
widths; where the checkout has a logits table, the logits on it and
again on the codes, ``logits_skinny`` or ``logits_copy`` as the plan
runs them); K4, K4-o and K14 at B=32 and both chip_smoke.DEC_WIDTHS;
K4 and K4-o at whisper-small's and large's widths (B=32) and at base
width with B=128. ``--kernels`` keeps the named kernels' cases only.
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


# K14's kernels by stage: a substring of the profiler's kernel name
K14_STAGES = (("q_projection", "rowproj_kernel<true"),
              ("attention", "attention"),
              ("o_projection", "rowproj_kernel<false"),
              ("mlp", "mlp_kernel"))


# cycles of the sleep kernel that holds the stream while calls are queued
# behind it (~10 ms at the H100's clocks)
SLEEP_CYCLES = 20_000_000


def queued_ms(fn, n: int = 20, tries: int = 3) -> float:
    """Device milliseconds a call of ``n`` calls queued back to back: a
    sleep kernel holds the stream while the host enqueues them, and two
    CUDA events bracket the calls; median of ``tries``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(tries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


def stage_ms(fn, reps: int = 20) -> dict:
    """K14's stages on the device: torch.profiler's CUDA kernels over
    ``reps`` calls queued behind a sleep kernel after a warm-up, by name
    -- each stage's milliseconds a call, a call's span (first kernel's
    start to last kernel's end), the attention's end after the
    q-projection's, and queued_ms."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    stages = dict.fromkeys((s for s, _ in K14_STAGES), 0.0)
    calls = []   # per call: stage -> (start, end), microseconds
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        stage = next((s for s, key in K14_STAGES if key in e.name), None)
        if stage is None:   # the sleep kernel
            continue
        stages[stage] += e.time_range.elapsed_us() / reps / 1e3
        if stage == "q_projection":
            calls.append({})
        if calls:
            calls[-1][stage] = (e.time_range.start, e.time_range.end)
    calls = [c for c in calls if len(c) == len(K14_STAGES)]
    return {"stages_device_ms": stages,
            "span_device_ms": sum(max(b for _, b in c.values())
                                  - min(a for a, _ in c.values())
                                  for c in calls) / len(calls) / 1e3,
            "attention_after_q_ms": sum(
                c["attention"][1] - c["q_projection"][1]
                for c in calls) / len(calls) / 1e3,
            "calls_profiled": len(calls), "queued_ms": queued_ms(fn)}


def f32_plan(DB, kind: str, dev, b: int, d: int, heads: int, f: int,
             l: int) -> dict:
    """The checkout's plan of a float32 form where it has one (a parent
    without the grid plans: {})."""
    if not hasattr(DB, "F32Plan"):
        return {}
    if kind == "K3":
        fit = DB._fit(dev, DB.K3F_CS, DB.F32_SMEM,
                      "mas_decoder_self_block_f32_fit")
        return {"plan": DB.self_block_f32_plan(b, heads, l, fit,
                                               d=d)._asdict()}
    plan, proj = DB.mlp_f32_plans(dev, b, d, f, kind == "K4-o")
    return {"plan": plan._asdict(),
            **({"proj_plan": proj._asdict()} if proj else {})}


def f32_cases(label: str, cs, DB, gen, want, emit, cold: bool = False
              ) -> None:
    """The float32 decoder forms' lines (see the module's docstring)."""
    f32 = torch.float32
    tol = (cs.F32_BLOCK_ATOL, cs.F32_BLOCK_RTOL)
    l, pos = 68, 67
    widths = [(w, 32, d, h, f) for w, d, h, f in cs.DEC_WIDTHS] + [
        ("small", 32, 768, 12, 3072), ("large", 32, 1280, 20, 5120),
        ("base", 128, 512, 8, 2048)]
    flush = torch.empty(32 << 20, dtype=f32, device="cuda") if cold \
        else None

    def row(kernel, shape, err, fn, plain, bound, plan):
        out = {"label": label, "kernel": kernel, "shape": shape,
               "max_abs_err": err, "queued_ms": queued_ms(fn),
               "plain_ms": cs.time_ms(plain, reps=3, warmup=1), **bound,
               **plan}
        if cold:
            def evict():
                flush.fill_(1.0)
            out["cold_queued_ms"] = queued_ms(lambda: (evict(), fn())) - \
                queued_ms(evict)
        return out
    for w, b, d, heads, f in widths:
        for key in ("K3f", "K3-qf"):
            if not want(key):
                continue
            x, selfw, tail, kc, vc = cs.k3_inputs(gen, b, l, d, dtype=f32)
            fused, plain = ((DB.fused_self_block_q, DB.self_block_q_plain)
                            if key == "K3-qf" else
                            (DB.fused_self_block, DB.self_block_plain))
            a = (x, *selfw, *(tail if key == "K3-qf" else []))
            got = fused(*a, kc.clone(), vc.clone(), pos, heads=heads)
            ref = plain(*a, kc, vc, pos, heads=heads)
            err = max(cs.check_close(f"{key} {w} B={b}", g, r, *tol)
                      for g, r in zip(got, ref))
            emit(row(key, f"{w} B={b} D={d} H={heads} L={l} pos={pos}", err,
                     lambda: fused(*a, kc, vc, pos, heads=heads),
                     lambda: plain(*a, kc, vc, pos, heads=heads),
                     cs.k3_f32_bound(a, got, pos),
                     f32_plan(DB, "K3", x.device, b, d, heads, f, l)))
            del x, selfw, tail, kc, vc, a, got, ref
        for key in ("K4f", "K4-of"):
            if not want(key):
                continue
            x, mlp, head = cs.k4_inputs(gen, b, d, f, dtype=f32)
            fused, plain, a = ((DB.fused_mlp_block_o, DB.mlp_block_o_plain,
                                (x, *head, *mlp)) if key == "K4-of" else
                               (DB.fused_mlp_block, DB.mlp_block_plain,
                                (x, *mlp)))
            got = fused(*a)
            emit(row(key, f"{w} B={b} D={d} F={f}", cs.check_close(
                f"{key} {w} B={b}", got, plain(*a), *tol),
                lambda: fused(*a), lambda: plain(*a),
                {**cs.bound(cs.nbytes(*a, got), f32=4 * b * d * f + (
                    2 * b * d * d if key == "K4-of" else 0)),
                 "bound_rate": "f32"},
                f32_plan(DB, key[:-1], x.device, b, d, heads, f, l)))
            del x, mlp, head, a, got
    # a rank of two: H / 2 heads, F / 2 columns of the MLP
    sh = cs.tp_shard_rows
    for w, d, heads, f in cs.DEC_WIDTHS:
        b, hl = 32, heads // 2
        if want("K3pf"):
            x, selfw, _, kc, vc = cs.k3_inputs(gen, b, l, d, dtype=f32)
            g1, b1, wq, bq, wk, wv, bv, wo, _ = selfw
            rk = (g1, b1, sh(wq, 0, 1), sh(bq, 0, 0), sh(wk, 0, 1),
                  sh(wv, 0, 1), sh(bv, 0, 0), sh(wo, 0, 0), None)
            kr, vr = sh(kc, 0, 2), sh(vc, 0, 2)

            def k3p(rk=rk, kr=kr, vr=vr, x=x, hl=hl):
                return DB.fused_self_block(x, *rk, kr, vr, pos, heads=hl,
                                           partial=True)

            def k3p_plain(rk=rk, kr=kr, vr=vr, x=x, hl=hl):
                return DB.self_block_plain(x, *rk, kr, vr, pos, heads=hl,
                                           partial=True)
            got = DB.fused_self_block(x, *rk, kr.clone(), vr.clone(), pos,
                                      heads=hl, partial=True)
            err = max(cs.check_close(f"K3pf {w}", g, r, *tol)
                      for g, r in zip(got, k3p_plain()))
            emit(row("K3pf", f"{w} rank of 2: B={b} D={d} H={hl} L={l} "
                             f"pos={pos}", err, k3p, k3p_plain,
                     {**cs.bound(cs.nbytes(x, *rk[:-1], *got)
                                 + 2 * b * pos * hl * 64 * 4,
                                 f32=2 * b * d * hl * 64 * 4
                                 + 4 * b * (pos + 1) * hl * 64),
                      "bound_rate": "f32"},
                     f32_plan(DB, "K3", x.device, b, d, hl, f, l)))
            del x, selfw, kc, vc, rk, kr, vr, got
        if want("K4pf"):
            x, mlp, _ = cs.k4_inputs(gen, b, d, f, dtype=f32)
            g, bl, w1, b1f, w2, b2 = mlp
            rk = (g, bl, sh(w1, 0, 1), sh(b1f, 0, 0), sh(w2, 0, 0), b2)
            fn = (lambda rk=rk, x=x: DB.fused_mlp_block(x, *rk,
                                                         partial=True))
            plain = (lambda rk=rk, x=x: DB.mlp_block_plain(x, *rk,
                                                            partial=True))
            got = fn()
            emit(row("K4pf", f"{w} rank of 2: B={b} D={d} F={f // 2}",
                     cs.check_close(f"K4pf {w}", got, plain(), *tol), fn,
                     plain, {**cs.bound(cs.nbytes(x, *rk[:-1], got),
                                        f32=4 * b * d * f // 2),
                             "bound_rate": "f32"},
                     f32_plan(DB, "K4", x.device, b, d, hl, f // 2, l)))
            del x, mlp, rk, got
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None,
                    help="directory for a copy of the JSON lines")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--cold", action="store_true",
                    help="the float32 forms also with L2 emptied a call")
    args = ap.parse_args()
    only = set(args.kernels.split(",")) if args.kernels else None

    def want(*keys) -> bool:
        return only is None or bool(only.intersection(keys))

    def want_f32(*keys) -> bool:
        return only is not None and bool(only.intersection(keys))
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
    f32_cases(args.label, cs, DB, gen, want_f32, emit, args.cold)
    from multimodal_audio_search_tpu_torch.ops import cached_attention as CA
    from multimodal_audio_search_tpu_torch.ops import cross_attention as CX
    # K3 / K3-q: the engine's widths, then K3 past them
    l, pos = 68, 67
    k3_cases = [(label, 32, d, heads, key) for label, d, heads, _
                in cs.DEC_WIDTHS for key in ("K3", "K3-q")]
    k3_cases += [("small", 32, 768, 12, "K3"), ("large", 32, 1280, 20, "K3"),
                 ("base", 128, 512, 8, "K3")]
    for label, b, d, heads, key in k3_cases:
        if not want(key):
            continue
        x, selfw, tail, kc, vc = cs.k3_inputs(gen, b, l, d)
        fused, plain = ((DB.fused_self_block_q, DB.self_block_q_plain)
                        if key == "K3-q" else
                        (DB.fused_self_block, DB.self_block_plain))
        a = (x, *selfw, *(tail if key == "K3-q" else []))
        got = fused(*a, kc.clone(), vc.clone(), pos, heads=heads)
        emit({"label": args.label, "kernel": key,
              "shape": f"{label} B={b} D={d} H={heads} L={l} pos={pos}",
              **cs.check_k3(f"{key} {label}", got,
                            plain(*a, kc, vc, pos, heads=heads), x),
              **timings(lambda: fused(*a, kc, vc, pos, heads=heads),
                        lambda: plain(*a, kc, vc, pos, heads=heads)),
              **cs.k3_bound(a, got, pos)})
        del x, selfw, tail, kc, vc, a, got
    b, t = 32, 1500
    for label, heads in (("base", 8), ("tiny", 6)):
        if want("K6"):
            a = cs.k6_inputs(gen, b, t, heads)
            for pos in (None, cs.K6_POS):
                n = t if pos is None else pos + 1
                fn = (lambda: CX.fused_single_query_attention_int8(
                    *a, heads=heads, pos=pos))
                plain = (lambda: CX.single_query_attention_int8_plain(
                    *a, heads=heads, pos=pos))
                row = {"label": args.label, "kernel": "K6",
                       "shape": f"{label} B={b} T={t} H={heads} pos={pos}",
                       **({"plan": CX.int8_plan(n, heads, b, CX._fit_int8(
                           a[0].device))} if hasattr(CX, "int8_plan") else {}),
                       **cs.check_rel(f"K6 {label} pos={pos}", fn(), plain(),
                                      cs.INT8_ATT_MAX, cs.INT8_ATT_L2),
                       **timings(fn, plain),
                       **cs.bound(cs.nbytes(a[0]) + 2 * b * n * heads * 68
                                  + b * heads * 64 * 4,
                                  int8=4 * b * n * heads * 64)}
                row["gbps"] = 2 * b * n * heads * 68 / row["device_ms"] / 1e6
                emit(row)
            del a
        if want("K7"):
            a = cs.k7_inputs(gen, b, t, heads)
            fn = (lambda: CA.int8_cached_attention(*a))
            row = {"label": args.label, "kernel": "K7",
                   "shape": f"{label} B={b} T={t} H={heads}",
                   **cs.check_rel(f"K7 {label}", fn(),
                                  CA.int8_cached_attention_plain(*a),
                                  cs.INT8_ATT_MAX, cs.INT8_ATT_L2),
                   **timings(fn, lambda: CA.int8_cached_attention_plain(*a)),
                   **cs.bound(cs.nbytes(*a) + b * heads * 64 * 4,
                              int8=4 * b * t * heads * 64)}
            row["gbps"] = cs.nbytes(*a) / row["device_ms"] / 1e6
            emit(row)
            del a
    torch.cuda.empty_cache()
    for m, k, n, dt, bias in cs.K5_SHAPES if want("K5") else ():
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
    for label, d, heads, f in cs.DEC_WIDTHS if want("K4", "K4-o", "K14") \
            else ():
        x, mlp, head = cs.k4_inputs(gen, b, d, f)
        for key, fused, plain, a in (
                ("K4", DB.fused_mlp_block, DB.mlp_block_plain, (x, *mlp)),
                ("K4-o", DB.fused_mlp_block_o, DB.mlp_block_o_plain,
                 (x, *head, *mlp))):
            if not want(key):
                continue
            emit({"label": args.label, "kernel": key,
                  "shape": f"{label} B={b} D={d} F={f}",
                  **cs.check_delta(f"{key} {label}", fused(*a), plain(*a), x),
                  **timings(lambda: fused(*a), lambda: plain(*a)),
                  **cs.bound(cs.nbytes(*a, x), bf16=4 * b * d * f + (
                      2 * b * d * d if key == "K4-o" else 0))})
        del x, mlp, head
        if not want("K14"):
            continue
        a = cs.k14_inputs(gen, b, cs.K14_T, d, f)
        t = cs.K14_T

        def k14(a=a, heads=heads):
            return DB.fused_cross_mlp_block(*a, heads=heads)
        row = {"label": args.label, "kernel": "K14",
               "shape": f"{label} B={b} T={t} D={d} H={heads} F={f}",
               **cs.check_delta(f"K14 {label}", k14(),
                                DB.cross_mlp_block_plain(*a, heads=heads),
                                a[0]),
               **timings(k14,
                         lambda: DB.cross_mlp_block_plain(*a, heads=heads)),
               **stage_ms(k14),
               **cs.bound(cs.nbytes(*a, a[0]), bf16=4 * b * d * d
                          + 4 * b * t * d + 4 * b * d * f)}
        if hasattr(DB, "cross_plan"):
            row["plan"] = DB.cross_plan(t, heads, b,
                                        DB._fit_cross(a[0].device))
        emit(row)
        del a
    # K4 / K4-o past the engine's shapes: whisper-small's and large's
    # widths, and base width at an ingest batch of 128
    for label, b, d, f in (("small", 32, 768, 3072), ("large", 32, 1280, 5120),
                           ("base", 128, 512, 2048)) \
            if want("K4", "K4-o") else ():
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
