"""K2, K8, K1 and K9 of one checkout of the port, timed at the main path's
shapes (K2 and K8 beside one scaled_dot_product_attention call), for A/B
runs of two checkouts in turns on one card.

    python3 tools/torch_attention_ab.py --root DIR --label NAME \
        [--out chiprun_out]

DIR is the root of a checkout (its ``multimodal_audio_search_tpu_torch``
is imported, so run one process per checkout, e.g. parent, change,
change, parent); the timing helpers are this checkout's chip_smoke.py.
For each case it prints one JSON line: the card (name and power limit),
the check against the plain version, and

* ``ms``: median of 20 single calls in a CUDA-event window (the wrapper's
  host work included, as chip_smoke.py times every kernel);
* ``device_ms``: torch.profiler's CUDA kernel rows over 20 calls, per call;
* ``host_us``: wall time of 200 calls issued back to back, per call (the
  enqueue; fewer launches than the card's queue holds);
* the same three for the library call (K2, K8), and the bound of the work.

Cases: K8 at B=32, T=1500, H=8 and 6 on head-split views of separate q/k/v
dense outputs; K2 cross (B=32, T=1500, H=8) and self (B=32, L=68, pos=67)
on merged-head K/V; K1, K10 and K9 (the encoder block: bf16, head pairs,
int8 dots) at B=32, T=1500 and D = 384, 512, 768, 1024, 1280 on
chip_smoke's residual input (K10 at even head counts, K9 on quantize_kv's
codes), each K1/K10 row with its cluster plan where the checkout has one;
with K1, the unfused route at D = 384 and 512 on the same inputs (K8,
one torch.addmm for the o-projection, the residual add: the yardstick K1
should be at or under); K11 (the division A/B) in each of its three forms
at whisper-base width (H=8) at B=32, T=1500 and at the A/B tool's B=64,
T=500 and 1500, on the residual input against its plain forms, with the
cluster plan where the checkout runs K11 on K1's clusters.
The float32 forms (``--kernels K8f,K1f``, not in the default list), on
float32 inputs made as chip_smoke's [f32] makes them: K8f, K8's float32
form, at B=8, T=1500, H=6 (the drift tool's --production rows), B=64,
T=100, H=6 (the drift rows) and B=32, T=1500, H=8 and 6 (a float32
engine), beside SDPA on float32, each also as ``queued_ms`` (20 calls
queued behind a sleep kernel); K1f, K1's float32 form, at B=32, T=1500,
H=8 and 6 beside the unfused float32 route (K8f, one torch.addmm, the
add). A checkout whose K1 refuses float32 gives a row with the refusal.
``--kernels`` keeps the named kernels (K11 is not in the default
list). Needs a CUDA card; inputs come from a seeded torch.Generator.
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


def rel_err(got, ref) -> dict:
    got, ref = got.float(), ref.float()
    err = got - ref
    return {"rel_max_err": float(err.abs().max() / ref.abs().max()),
            "rel_l2_err": float(err.norm() / ref.norm()),
            "max_abs_err": float(err.abs().max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None,
                    help="directory for a copy of the JSON lines")
    ap.add_argument("--kernels", default="K8,K2,K1,K10,K9",
                    help="comma-separated kernels to time")
    args = ap.parse_args()
    only = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = load_chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.ops import attention as A
    from multimodal_audio_search_tpu_torch.ops import cross_attention as K2
    from multimodal_audio_search_tpu_torch.ops import encoder_block as EB
    from multimodal_audio_search_tpu_torch.ops.cached_attention import (
        quantize_kv)
    runtime.select_device("cuda")
    t0 = time.perf_counter()
    runtime.kernels()
    rows = [{"label": args.label, "card": cs.card_line(),
             "build_s": time.perf_counter() - t0, "torch": torch.__version__}]

    def timings(fn, lib) -> dict:
        return {"ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn),
                "host_us": cs.host_us(fn), "library_ms": cs.time_ms(lib),
                "library_device_ms": cs.device_ms(lib),
                "library_host_us": cs.host_us(lib)}

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    b, t, d = 32, 1500, 64
    for heads in (8, 6) if "K8" in only else ():
        q, k, v = (rn(b, t, heads * d).view(b, t, heads, d).transpose(1, 2)
                   for _ in range(3))
        fn = (lambda: A.fused_encoder_attention(q, k, v))
        row = {"label": args.label, "kernel": "K8",
               "shape": f"B={b} T={t} H={heads} D={d}",
               **rel_err(fn(), A.encoder_attention_plain(q, k, v)),
               **timings(fn, lambda: sdpa(q, k, v)),
               **cs.bound(4 * cs.nbytes(q), bf16=4 * b * heads * t * t * d)}
        row["tflops"] = 4 * b * heads * t * t * d / row["device_ms"] / 1e9
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v
    heads = 8
    hd = heads * d
    for label, t, pos in (("cross", 1500, None), ("self", 68, 67)) \
            if "K2" in only else ():
        q, k, v = rn(b, hd), rn(b, t, hd), rn(b, t, hd)
        n = t if pos is None else pos + 1
        fn = (lambda: K2.fused_single_query_attention(q, k, v, heads=heads,
                                                      pos=pos))
        qh = q.view(b, 1, heads, d).transpose(1, 2)
        kh, vh = (a[:, :n].view(b, n, heads, d).transpose(1, 2)
                  for a in (k, v))
        got = fn()
        ref = K2.single_query_attention_plain(q, k, v, heads=heads, pos=pos)
        row = {"label": args.label, "kernel": "K2",
               "shape": f"{label} B={b} T={t} H={heads} pos={pos}",
               **({"splits": K2.split_plan(n, b * heads)[0]}
                  if hasattr(K2, "split_plan") else {}),
               **rel_err(got, ref), **timings(fn, lambda: sdpa(qh, kh, vh)),
               "empty_host_us": cs.host_us(lambda: torch.empty(
                   (b, hd), dtype=torch.float32, device="cuda")),
               **cs.bound(cs.nbytes(q, got) + 2 * b * n * hd * 2,
                          bf16=4 * b * n * hd)}
        row["tbps"] = 2 * b * n * hd * 2 / row["device_ms"] / 1e9
        rows.append(row)
        print(json.dumps(row), flush=True)
    t = 1500
    plan = getattr(EB, "_card_plan", None)  # the checkout's cluster plan
    for heads in (8, 6, 12, 16, 20) if only & {"K1", "K10", "K9"} else ():
        a = cs.k1_inputs(gen, b, t, heads)
        a9 = (a[0], *quantize_kv(a[1], a[2]), *a[3:])
        for key, fn, plain in (
                ("K1", lambda: EB.fused_attention_o_residual(*a),
                 lambda: EB.attention_o_residual_plain(*a)),
                ("K10", lambda: EB.fused_attention_o_residual(
                    *a, pair_heads=True),
                 lambda: EB.attention_o_residual_paired_plain(*a)),
                ("K9", lambda: EB.attention_o_residual_int8(*a9),
                 lambda: EB.attention_o_residual_int8_plain(*a9))):
            if key not in only or (key == "K10" and heads % 2):
                continue
            row = {"label": args.label, "kernel": key,
                   "shape": f"B={b} T={t} H={heads} D={heads * d}",
                   **cs.check_k1(f"{key} H={heads}", fn(), plain(), True),
                   "ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn),
                   "host_us": cs.host_us(fn, n=20),
                   **cs.attn_o_bound(b, t, heads, int8=key == "K9")}
            if plan is not None and key != "K9":
                row["cluster"] = plan(heads, b, t, key == "K10")
            if key == "K9":
                # the other layout for PV's K-major V: the wrapper writing
                # v8 as [B, H, 64, T] with each 32-key step in the kernel's
                # contraction order, one gather and one transposed copy
                # (its extra pass over v8, timed alone)
                perm = torch.tensor([k // 32 * 32 + k % 32 // 16 * 16
                                     + k % 16 // 4 * 2 + k % 2
                                     + 8 * (k % 4 // 2)
                                     for k in range(t // 32 * 32)]
                                    + list(range(t // 32 * 32, t)),
                                    device="cuda")
                v8 = a9[3]
                row["v_transposed_copy_ms"] = cs.time_ms(
                    lambda: v8.index_select(2, perm).transpose(2, 3)
                    .contiguous())
            rows.append(row)
            print(json.dumps(row), flush=True)
        if "K1" in only and heads in (8, 6):
            q, k, v, x, wo, bo = a
            hd = heads * d

            def unfused():
                att = A.fused_encoder_attention(q, k, v)  # [B, T, H, D]
                y = torch.addmm(bo, att.transpose(1, 2).reshape(b * t, hd),
                                wo)
                return x + y.view(b, t, hd)
            row = {"label": args.label, "kernel": "unfused K8+addmm+add",
                   "shape": f"B={b} T={t} H={heads} D={hd}",
                   **cs.check_k1(f"unfused H={heads}", unfused(),
                                 EB.attention_o_residual_plain(*a), True),
                   "ms": cs.time_ms(unfused),
                   "device_ms": cs.device_ms(unfused),
                   "k8_device_ms": cs.device_ms(
                       lambda: A.fused_encoder_attention(q, k, v)),
                   **cs.attn_o_bound(b, t, heads)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del a, a9
        torch.cuda.empty_cache()
    f32_rows(args.label, only, cs, A, EB, rows)
    # K11 runs on K1's clusters where the checkout has no mma.sync copy
    k11_clusters = not os.path.exists(os.path.join(
        args.root, "multimodal_audio_search_tpu_torch", "csrc",
        "encoder_block.cu"))
    for b, t in ((32, 1500), (64, 500), (64, 1500)) if "K11" in only else ():
        heads = 8
        a = cs.k1_inputs(gen, b, t, heads)
        for form in (False, True, "post"):
            def fn(form=form):
                return EB.attention_o_residual_ab(*a, form)
            row = {"label": args.label, "kernel": "K11",
                   "shape": f"B={b} T={t} H={heads} D={heads * d}",
                   "defer_div": str(form),
                   **cs.check_k1(f"K11 {form} B={b} T={t}", fn(),
                                 EB.attention_o_residual_ab_plain(*a, form),
                                 True),
                   "ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn),
                   "host_us": cs.host_us(fn, n=20),
                   **cs.attn_o_bound(b, t, heads)}
            if k11_clusters:
                row["cluster"] = plan(heads, b, t, False)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del a
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "attention_ab.jsonl"), "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


def f32_rows(label, only, cs, A, EB, rows) -> None:
    """The float32 forms' rows (module docstring), appended to ``rows``
    and printed."""
    queued_ms = cs.load_tool("torch_decode_kernel_ab").queued_ms
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(24)
    for b, t, heads in ((8, 1500, 6), (64, 100, 6), (32, 1500, 8),
                        (32, 1500, 6)) if "K8f" in only else ():
        q, k, v = cs._f32_heads(gen, b, t, heads)
        fn = (lambda: A.fused_encoder_attention(q, k, v))
        lib = (lambda: sdpa(q, k, v))
        row = {"label": label, "kernel": "K8f",
               "shape": f"B={b} T={t} H={heads}",
               "max_abs_err": cs.check_close(
                   f"K8f B={b} T={t}", fn(), A.encoder_attention_plain(
                       q, k, v), cs.F32_ATT_ATOL, cs.F32_ATT_RTOL),
               "ms": cs.time_ms(fn), "queued_ms": queued_ms(fn),
               "library_ms": cs.time_ms(lib),
               "library_queued_ms": queued_ms(lib),
               **cs.f32_bound(4 * cs.nbytes(q), 4 * b * heads * t * t * 64)}
        row["vs_library_queued"] = row["queued_ms"] / row["library_queued_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v
    b, t = 32, 1500
    for heads in (8, 6) if "K1f" in only else ():
        q, k, v, x, wo, bo = a = cs._f32_block(gen, b, t, heads)
        hd = heads * 64
        fn = (lambda: EB.fused_attention_o_residual(*a))

        def unfused():
            att = A.fused_encoder_attention(q, k, v).transpose(1, 2)
            return x + torch.addmm(bo, att.reshape(b * t, hd), wo).view(
                b, t, hd)
        row = {"label": label, "kernel": "K1f",
               "shape": f"B={b} T={t} H={heads}",
               "unfused_ms": cs.time_ms(unfused),
               "unfused_queued_ms": queued_ms(unfused),
               **cs.f32_bound(cs.nbytes(*a, x),
                              4 * b * heads * t * t * 64
                              + 2 * b * t * hd * hd)}
        try:
            got = fn()
        except TypeError as e:               # a K1 without a float32 form
            row["refused"] = str(e)
        else:
            row.update(max_abs_err=cs.check_close(
                f"K1f H={heads}", got, EB.attention_o_residual_plain(*a),
                cs.F32_BLOCK_ATOL, cs.F32_BLOCK_RTOL),
                ms=cs.time_ms(fn), queued_ms=queued_ms(fn))
            row["vs_unfused_queued"] = (row["queued_ms"]
                                        / row["unfused_queued_ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
        del a, q, k, v, x, wo, bo
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
