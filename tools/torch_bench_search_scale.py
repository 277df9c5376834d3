"""Query latency at scale on the card: fused search over 100k / 400k / 1M
segments, float32 and bfloat16 index.

Counterpart of ``tools/bench_search_scale.py`` for the PyTorch port
(imports torch and the port only). Needs a CUDA card (it raises without
one):

    python3 tools/torch_bench_search_scale.py
    python3 tools/torch_bench_search_scale.py --sizes 100000 --dtypes float32

The index is generated on the device from a ``torch.Generator`` (unit
rows, success = uniform > 0.2); content is irrelevant to the timing. Per
index size and dtype, CUDA-event medians of:
  * the scoring alone: the plain ``index/fusion.py::fused_scores`` and
    K12 (``ops/fused_search.py``), each with its GB/s and its share of
    the calibrated K13 read rate (``utils/calibrate.py``) and of the
    data sheet's 3.35 TB/s;
  * the stable descending sort of the [N] scores alone (the top-k);
  * the plain ``fused_topk`` (the engine's search) and K12 + that sort;
and the query p50 over 20 queries through tokenizer ->
``TextEmbedder.embed_device`` (MiniLM-L6, 384-D, random weights from seed
0) -> ``fused_topk`` on the generated index (host clock, first query
dropped). The last line is the JAX tool's verdict on the < 50 ms target
at 1M segments, float32.
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

SIZES = (100_000, 400_000, 1_000_000)
DTYPES = ("float32", "bfloat16")
DIM = 384
WARMUP, REPS = 3, 20
N_QUERIES = 20
WEIGHTS = (0.6, 0.4)
SHEET_GBPS = 3350.0        # H100 SXM data sheet, device memory
TARGET_MS = 50.0           # query p50 at 1M segments, float32
# K12 launches per index: the scoring alone and K12 + sort, each timed
K12_LAUNCHES_PER_ROW = 2 * (WARMUP + REPS)


def time_ms(fn) -> float:
    """Median per-call milliseconds from CUDA events after a warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def make_index(n: int, dtype: torch.dtype, device, seed: int = 0):
    """([n, 2, DIM] unit rows in ``dtype``, success [n, 2] bool), made on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    e = torch.randn((n, 2, DIM), generator=gen, device=device)
    e /= e.norm(dim=-1, keepdim=True)
    ok = torch.rand((n, 2), generator=gen, device=device) > 0.2
    return e.to(dtype), ok


def run(sizes=SIZES, dtypes=DTYPES, emit=print, device="cuda") -> dict:
    """Measure every size x dtype; ``emit`` gets one JSON line per row.
    Returns {"calibration", "rows", "verdict"}."""
    from multimodal_audio_search_tpu_torch import runtime
    from multimodal_audio_search_tpu_torch.index.fusion import (
        fused_scores, fused_topk)
    from multimodal_audio_search_tpu_torch.ops.fused_search import (
        fused_scores_kernel)
    from multimodal_audio_search_tpu_torch.pipelines.embed import (
        TextEmbedder)
    from multimodal_audio_search_tpu_torch.utils.calibrate import calibrate
    from multimodal_audio_search_tpu_torch.utils.roofline import (
        search_hbm_bytes)
    dev = runtime.select_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the search-at-scale tool measures a CUDA card, "
                           f"not {dev}")
    cal = calibrate(dev)
    emit(json.dumps({"calibration": cal,
                     "device": torch.cuda.get_device_name(dev)}))
    embedder = TextEmbedder(device=dev)
    wa, wb = WEIGHTS
    rows = []
    with torch.inference_mode():
        for dt in dtypes:
            for n in sizes:
                e, ok = make_index(n, getattr(torch, dt), dev)
                q = e[min(123, n - 1), 0].float()
                scores = fused_scores(q, e, ok, wa, wb)[0]

                def kernel_topk():
                    s = fused_scores_kernel(q, e, ok, wa, wb)
                    return torch.sort(s, descending=True, stable=True)
                ms = {
                    "plain_scores_ms": time_ms(
                        lambda: fused_scores(q, e, ok, wa, wb)),
                    "kernel_scores_ms": time_ms(
                        lambda: fused_scores_kernel(q, e, ok, wa, wb)),
                    "sort_ms": time_ms(lambda: torch.sort(
                        scores, descending=True, stable=True)),
                    "plain_topk_ms": time_ms(
                        lambda: fused_topk(q, e, ok, wa, wb, k=10)),
                    "kernel_topk_ms": time_ms(kernel_topk)}
                lat = []
                for i in range(N_QUERIES):
                    t0 = time.perf_counter()
                    qv = embedder.embed_device(
                        [f"music with drums number {i}"])[0]
                    out = fused_topk(qv, e, ok, wa, wb, k=10)
                    out["scores"].cpu()
                    lat.append(time.perf_counter() - t0)
                gb = search_hbm_bytes(n, DIM, e.element_size()) / 1e9
                row = {"n": n, "dtype": dt, "index_gb": gb,
                       "query_p50_ms": float(np.median(lat[1:]) * 1e3),
                       **ms}
                for kind in ("plain", "kernel"):
                    gbps = gb / (ms[f"{kind}_scores_ms"] / 1e3)
                    row[f"{kind}_gbps"] = gbps
                    row[f"{kind}_hbm_frac_cal"] = gbps / cal["hbm_gbps"]
                    row[f"{kind}_hbm_frac_sheet"] = gbps / SHEET_GBPS
                rows.append(row)
                emit(json.dumps(row))
                del e, ok, q, scores
                torch.cuda.empty_cache()
    at_1m = [r for r in rows if r["n"] == 1_000_000
             and r["dtype"] == "float32"]
    verdict = None
    if at_1m:
        verdict = "PASS" if at_1m[0]["query_p50_ms"] < TARGET_MS else "FAIL"
        emit(f"1M f32 parity p50 target <{TARGET_MS:.0f} ms: {verdict}")
    return {"calibration": cal, "rows": rows, "verdict": verdict}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--dtypes", default=",".join(DTYPES))
    a = ap.parse_args()
    run([int(s) for s in a.sizes.split(",")], a.dtypes.split(","))


if __name__ == "__main__":
    main()
