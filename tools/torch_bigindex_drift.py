"""Rank drift of the host index's storage dtypes, on the card.

Counterpart of ``tools/bigindex_drift.py`` for the PyTorch port (imports
torch and the port only). index/bigindex.py stores bf16 and int8 (with
a per-vector scale) host indexes; this sweep measures what each costs in
rankings: recall@10 / MRR / overlap@10 / exact rank agreement against
the float32 index on the same rows, over a clustered synthetic geometry
(1024 unit centers + noise: cosine margins shaped like real text
embeddings, unlike i.i.d. Gaussian vectors whose top-10 are all ties).
The files are written as the JAX tool writes them, byte for byte (bf16
as its bits, index/bigindex.py::_bf16_bits), and searched by the port's
``HostIndex`` streamed through the device.

    python3 tools/torch_bigindex_drift.py [--n 1000000] [--queries 50] [--out f.json]
    python3 tools/torch_bigindex_drift.py --device cpu     # n 20k, no card

Runs on the card (it raises without one) unless ``--device cpu``; ``n``
defaults to 1M on the card and 20k on the CPU. The indexes go to a
temporary directory (``--dir``: under it), removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DTYPES = ("float32", "bfloat16", "int8")


def make_index(path, n, d, rng, dtype, centers):
    """Write a HostIndex layout directly (no 2x-RAM SegmentStore)."""
    from multimodal_audio_search_tpu_torch.index.bigindex import _bf16_bits
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    np_dtype = {"float32": np.float32, "bfloat16": np.uint16,
                "int8": np.int8}[dtype]
    emb = np.memmap(p / "emb.dat", mode="w+", dtype=np_dtype,
                    shape=(n, 2, d))
    scale = np.memmap(p / "scale.dat", mode="w+", dtype=np.float32,
                      shape=(n, 2)) if dtype == "int8" else None
    ok = np.memmap(p / "success.dat", mode="w+", dtype=np.bool_,
                   shape=(n, 2))
    f32 = np.memmap(p / "f32.dat", mode="w+", dtype=np.float32,
                    shape=(n, 2, d))
    chunk = 65_536
    c = len(centers)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        cid = rng.integers(0, c, size=(m, 2))
        x = centers[cid] + 0.3 * rng.normal(size=(m, 2, d))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x = x.astype(np.float32)
        okc = rng.random((m, 2)) > 0.15
        x *= okc[..., None]
        f32[lo:hi] = x
        ok[lo:hi] = okc
        if dtype == "int8":
            s = np.maximum(np.abs(x).max(axis=-1), 1e-12) / 127.0
            scale[lo:hi] = s
            emb[lo:hi] = np.clip(np.round(x / s[..., None]),
                                 -127, 127).astype(np.int8)
        elif dtype == "bfloat16":
            emb[lo:hi] = _bf16_bits(x)
        else:
            emb[lo:hi] = x.astype(np_dtype)
    for m_ in (emb, ok, f32) + ((scale,) if scale is not None else ()):
        m_.flush()
    with open(p / "index.json", "w") as f:
        json.dump({"n": n, "dim": d, "dtype": dtype}, f)
    (p / "meta.jsonl").write_text(
        "")  # HostIndex tolerates empty meta for score-only use
    return p


def make_queries(rng: np.random.Generator, centers: np.ndarray, n: int):
    """(unit queries [n, d] near the centers, asr weights [n])."""
    d = centers.shape[1]
    queries = centers[rng.integers(0, len(centers), size=n)] \
        + 0.25 * rng.normal(size=(n, d))
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    weights = rng.uniform(0.2, 0.8, size=n).astype(np.float32)
    return queries.astype(np.float32), weights


def rank(paths: dict, queries, weights, device, k: int = 10):
    """({dtype: top-k ids a query}, {dtype: ms a query}) from each
    index's streamed search on ``device``."""
    from multimodal_audio_search_tpu_torch.index.bigindex import HostIndex
    results, timing = {}, {}
    for dtype, path in paths.items():
        idx = HostIndex(path, device=device)
        ranked = []
        t0 = time.perf_counter()
        for q, w in zip(queries, weights):
            _, i = idx.search(q, w, 1 - w, k=k)
            ranked.append([int(v) for v in i])
        timing[dtype] = round((time.perf_counter() - t0)
                              / len(queries) * 1e3, 1)
        results[dtype] = ranked
    return results, timing


def drift_report(results: dict, timing: dict) -> dict:
    """Each lossy dtype's rankings against float32's (index/eval.py)."""
    from multimodal_audio_search_tpu_torch.index.eval import (
        mrr, overlap_at_k, rank_agreement, recall_at_k)
    truth = results["float32"]
    nq = len(truth)
    out = {}
    for dtype in ("bfloat16", "int8"):
        r = results[dtype]
        out[dtype] = {
            "recall@10": round(float(np.mean(
                [recall_at_k(r[q], truth[q], 10) for q in range(nq)])), 4),
            "mrr_vs_f32": round(float(np.mean(
                [mrr(r[q], truth[q][:1]) for q in range(nq)])), 4),
            "overlap@10": round(float(np.mean(
                [overlap_at_k(r[q], truth[q], 10) for q in range(nq)])), 4),
            "rank_agreement@10": round(float(np.mean(
                [rank_agreement(r[q], truth[q], 10) for q in range(nq)])),
                4),
            "query_ms": timing[dtype],
        }
    return out


def run(n: int, d: int = 384, queries: int = 50, seed: int = 0,
        device="cuda") -> dict:
    """The whole sweep: the three indexes written under a temporary
    directory, searched on ``device``, removed. Returns the JSON line's
    object."""
    from multimodal_audio_search_tpu_torch import runtime
    dev = runtime.select_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(1024, d))
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bigidx_"))
    try:
        # identical f32 source data for all dtypes: same rng seed stream
        paths = {dt: make_index(tmp / dt, n, d,
                                np.random.default_rng(seed + 1), dt,
                                centers) for dt in DTYPES}
        qs, ws = make_queries(rng, centers, queries)
        results, timing = rank(paths, qs, ws, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"metric": "bigindex_drift", "n": n, "dim": d,
            "queries": queries,
            "platform": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "f32_query_ms": timing["float32"],
            "modes": drift_report(results, timing)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from multimodal_audio_search_tpu_torch import runtime
    runtime.select_device(args.device)
    n = args.n or (1_000_000 if args.device == "cuda" else 20_000)
    line = json.dumps(run(n, args.dim, args.queries, args.seed,
                          args.device))
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
