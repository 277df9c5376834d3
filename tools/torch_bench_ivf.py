"""IVF search and the memory-mapped host index at scale on the card.

Counterpart of ``tools/bench_ivf.py`` and ``tools/bench_ivf_10m.py`` for
the PyTorch port (imports torch and the port only). Needs a CUDA card (it
raises without one):

    python3 tools/torch_bench_ivf.py                  # 1M segments
    python3 tools/torch_bench_ivf.py --rows 10000000 --dir /big/disk

Data: tools/bench_ivf.py's topical mixture, D=384: max(64, N/2000) topic
centers on the sphere, rows at sigma 0.35/sqrt(D) around them, queries
at 0.5/sqrt(D), success = uniform > 0.2, all from numpy with seed 0. The
rows are made once and shared by both halves:

1. In memory, float32 on the card: ``index/ivf.py::build_ivf`` (seconds
   of its stages), the exact ``fused_topk`` query p50 and the IVF p50 at
   each of N_PROBES, recall@10 against exact over N_QUERIES queries, the
   scanned fraction and the bytes gathered a query.
2. The host index (``index/bigindex.py``), written with HostIndexWriter
   in float32, bfloat16 and int8 into a temporary directory (~5.4 GB at
   1M rows, removed at the end): write seconds, the streamed exact
   search's first-query and p50 ms with its GB/s beside a pinned
   host->device copy rate and a host copy rate out of the page cache
   measured in the same run, ``build_ivf`` seconds, ``search_ivf`` p50,
   recall@10 against the streamed float32 exact and the bytes shipped at
   HOST_PROBES, and the bfloat16 and int8 streams' recall@10 against
   float32.

It also checks, raising on a failure: at CHECK_ROWS rows a full probe
equals exact ``fused_topk`` in float32 and bfloat16 on CHECK_QUERIES
queries, and two builds give identical buckets; at N rows the streamed
search equals the in-memory one (at the default chunk and at
SMALL_CHUNK, so the staging buffers are reused many times), for each
storage dtype against fused_topk over the same stored values on the
card; ``search_ivf`` ships exactly its candidate rows, under
BYTES_FRAC_MAX of the index at n_probe 8. "Equal" (same_topk): ids
identical except where neighbouring exact scores are within TOL, scores
within TOL.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROWS = 1_000_000
DIM = 384
N_QUERIES = 20
N_PROBES = (4, 8, 16, 32, 64)
HOST_PROBES = (8, 32)
STREAM_QUERIES = 8          # streamed searches a dtype (p50, recall)
CHECK_ROWS = 100_000
CHECK_QUERIES = 8
SMALL_CHUNK = 65_536
WEIGHTS = (0.6, 0.4)
TOL = 1e-5
BYTES_FRAC_MAX = 0.05
K = 10
STORAGE = ("float32", "bfloat16", "int8")


def make_data(n: int, d: int = DIM, queries: int = N_QUERIES,
              seed: int = 0, block: int = 65_536):
    """(emb [n, 2, d] unit rows with failed slots zeroed, success [n, 2],
    queries [queries, d]) from tools/bench_ivf.py's topical mixture. The
    rows are made in blocks, each from its own child of ``seed``'s
    SeedSequence with float32 draws, on a thread per core (numpy's
    generators release the GIL while they fill)."""
    rng = np.random.default_rng(seed)
    topics = max(64, n // 2000)
    cent = rng.normal(size=(topics, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=-1, keepdims=True)
    t_row = rng.integers(0, topics, size=n)
    s_row, s_q = 0.35 / np.sqrt(d), 0.5 / np.sqrt(d)
    emb = np.empty((n, 2, d), np.float32)
    starts = range(0, n, block)
    children = np.random.SeedSequence(seed).spawn(len(starts))

    def fill(lo, child):
        hi = min(lo + block, n)
        x = emb[lo:hi]
        np.random.default_rng(child).standard_normal(
            x.shape, dtype=np.float32, out=x)
        x *= np.float32(s_row)
        x += cent[t_row[lo:hi]][:, None, :]
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(fill, starts, children))
    qt = rng.integers(0, topics, size=queries)
    qs = (cent[qt] + s_q * rng.normal(size=(queries, d))).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    success = rng.random((n, 2)) > 0.2
    emb[~success] = 0.0
    return emb, success, qs


def same_topk(name: str, s, i, ref_s, ref_i, k: int = K,
              tol: float = TOL) -> float:
    """Top-k (s, i) against a reference with k + 1 entries: scores within
    ``tol``, ids identical at every rank whose reference score is more
    than ``tol`` from both neighbours. Returns max |score err|."""
    s, i, ref_s, ref_i = (np.asarray(a) for a in (s, i, ref_s, ref_i))
    if len(s) != min(k, len(ref_s)) or len(i) != len(s):
        raise AssertionError(f"{name}: {len(s)} results, want "
                             f"{min(k, len(ref_s))}")
    err = float(np.abs(s - ref_s[:len(s)]).max()) if len(s) else 0.0
    if not err <= tol:
        raise AssertionError(f"{name}: max |score err| {err:.3e} > {tol}")
    for r in range(len(s)):
        clear = (r + 1 >= len(ref_s) or ref_s[r] - ref_s[r + 1] > tol) and (
            r == 0 or ref_s[r - 1] - ref_s[r] > tol)
        if clear and ref_s[r] > -1e29 and i[r] != ref_i[r]:
            raise AssertionError(f"{name}: rank {r} is {int(i[r])}, the "
                                 f"reference's is {int(ref_i[r])}")
    return err


def exact_topk(q, emb, ok, k: int = K + 1):
    """The in-memory exact search's (scores, ids) on the host."""
    from multimodal_audio_search_tpu_torch.index.fusion import fused_topk
    out = fused_topk(q, emb, ok, *WEIGHTS, k=k)
    return out["scores"].cpu().numpy(), out["indices"].cpu().numpy()


def recall(got_ids, got_s, ref_ids, ref_s, k: int = K) -> float:
    """|hits in both top-k| / |reference hits| (misses dropped)."""
    g = set(np.asarray(got_ids)[:k][np.asarray(got_s)[:k] > -1e29].tolist())
    r = set(np.asarray(ref_ids)[:k][np.asarray(ref_s)[:k] > -1e29].tolist())
    return len(g & r) / max(len(r), 1)


def p50_ms(fn, items) -> tuple[float, list]:
    """Median host ms of fn(item) over ``items`` (the first dropped when
    there are more than two), and the results."""
    ts, outs = [], []
    for it in items:
        t0 = time.perf_counter()
        outs.append(fn(it))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts[1:] if len(ts) > 2 else ts)), outs


def check_full_probe(emb, success, qs, dev) -> dict:
    """A full probe equals exact fused_topk in float32 and bfloat16 (the
    store's device_index conversion), and two builds give identical
    buckets."""
    from multimodal_audio_search_tpu_torch.index.ivf import build_ivf
    ivf = build_ivf(emb, success, device=dev)
    again = build_ivf(emb, success, device=dev)
    for a in ("centroids", "members", "spill"):
        if not torch.equal(getattr(ivf, a), getattr(again, a)):
            raise AssertionError(f"two builds of {len(emb)} rows differ "
                                 f"in {a}")
    ok = torch.as_tensor(success).to(dev)
    errs = {}
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        e = torch.as_tensor(emb).to(device=dev, dtype=dt)
        run = ivf.search_fn(k=K, n_probe=ivf.n_clusters)
        err = 0.0
        for q in torch.as_tensor(qs).to(dev):
            out = run(q, *WEIGHTS, e, ok)
            err = max(err, same_topk(
                f"full probe {name}", out["scores"].cpu().numpy(),
                out["indices"].cpu().numpy(), *exact_topk(q, e, ok)))
        errs[name] = err
    return {"rows": len(emb), "queries": len(qs),
            "n_clusters": ivf.n_clusters, "max_abs_err": errs,
            "builds_identical": True}


def in_memory(emb, success, qs, dev, emit) -> tuple[dict, torch.Tensor,
                                                     torch.Tensor]:
    """Part 1. Returns (row, the float32 device index, success)."""
    from multimodal_audio_search_tpu_torch.index.ivf import build_ivf
    e = torch.as_tensor(emb).to(dev)
    ok = torch.as_tensor(success).to(dev)
    qd = torch.as_tensor(qs).to(dev)
    t0 = time.perf_counter()
    ivf = build_ivf(emb, success, device=dev)
    build_s = time.perf_counter() - t0
    cap, spill = int(ivf.members.shape[1]), int(ivf.spill.shape[0])
    row = {"n": len(emb), "build_s": build_s, "build_stages_s": ivf.build_s,
           "n_clusters": ivf.n_clusters, "cap": cap, "spill": spill}
    row["exact_p50_ms"], exact = p50_ms(lambda q: exact_topk(q, e, ok), qd)
    row["ivf"] = []
    for n_probe in N_PROBES:
        if n_probe > ivf.n_clusters:
            break
        run = ivf.search_fn(k=K, n_probe=n_probe)

        def one(q):
            out = run(q, *WEIGHTS, e, ok)
            return out["scores"].cpu().numpy(), out["indices"].cpu().numpy()
        ms, outs = p50_ms(one, qd)
        slots = n_probe * cap + spill
        row["ivf"].append({
            "n_probe": n_probe, "p50_ms": ms,
            "recall10_vs_exact": float(np.mean(
                [recall(i, s, ei, es) for (s, i), (es, ei)
                 in zip(outs, exact)])),
            "scanned_frac": slots / max(2 * len(emb), 1),
            "gathered_bytes": slots * (2 * DIM * 4 + 2)})
    emit(json.dumps({"in_memory": row}))
    return row, e, ok


def copy_rates(hi, dev) -> dict:
    """GB/s of a pinned host->device copy of one staging chunk, and of
    the host copy of a chunk out of the page cache into pinned memory."""
    rows = min(hi.chunk, hi.n)
    host = torch.empty((rows, 2, DIM), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    gb = host.numel() * 4 / 1e9
    t0 = time.perf_counter()
    np.copyto(host.numpy(), hi.emb[:rows])
    out = {"host_copy_gbps": gb / (time.perf_counter() - t0)}
    if dev.type == "cuda":
        d = torch.empty_like(host, device=dev)
        d.copy_(host)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(5):
            d.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        out["pinned_h2d_gbps"] = 5 * gb / (a.elapsed_time(b) / 1e3)
    return out


def host_index(emb, success, qs, e32, ok_d, dev, workdir, emit,
               chunk: int = 262_144, small_chunk: int = SMALL_CHUNK,
               bytes_frac_max: float = BYTES_FRAC_MAX) -> dict:
    """Part 2, with the streamed-equals-in-memory and bytes checks."""
    from multimodal_audio_search_tpu_torch.index.bigindex import (
        HostIndexWriter)
    n = len(emb)
    qd = torch.as_tensor(qs[:STREAM_QUERIES]).to(dev)
    res, ref = {}, None
    for dt in STORAGE:
        t0 = time.perf_counter()
        w = HostIndexWriter(os.path.join(workdir, dt), n, DIM, dtype=dt)
        for lo in range(0, n, chunk):
            w.append(emb[lo:lo + chunk], success[lo:lo + chunk])
        hi = w.finalize(chunk=chunk, device=dev)
        row = {"dtype": dt, "write_s": time.perf_counter() - t0,
               "index_bytes": hi.emb.nbytes + hi.success.nbytes
               + (hi.scale.nbytes if hi.scale is not None else 0)}
        # the in-memory search over the same stored values on the card
        if dt == "float32":
            e_mem = e32
        elif dt == "bfloat16":
            e_mem = e32.to(torch.bfloat16)
        else:
            e_mem = torch.from_numpy(np.array(hi.emb)).to(dev).float() \
                * torch.from_numpy(np.array(hi.scale)).to(dev)[..., None]
        t0 = time.perf_counter()
        first = hi.search(qs[0], *WEIGHTS, k=K)
        row["first_query_ms"] = (time.perf_counter() - t0) * 1e3
        mem0 = exact_topk(qd[0], e_mem, ok_d)
        row["streamed_vs_memory_err"] = same_topk(
            f"streamed {dt}", *first, *mem0)
        if dt == "int8":
            del e_mem
        row["p50_ms"], outs = p50_ms(
            lambda q: hi.search(q.cpu().numpy(), *WEIGHTS, k=K), qd)
        row["gbps"] = row["index_bytes"] / 1e9 / (row["p50_ms"] / 1e3)
        if dt == "float32":
            row.update(copy_rates(hi, dev))
            hi.chunk = small_chunk
            row["small_chunk"] = small_chunk
            row["small_chunk_chunks"] = -(-n // small_chunk)
            row["small_chunk_err"] = same_topk(
                f"streamed {dt} chunk={small_chunk}",
                *hi.search(qs[0], *WEIGHTS, k=K), *mem0)
            hi.chunk = chunk
            ref = outs
            t0 = time.perf_counter()
            hi.build_ivf()
            row["build_ivf_s"] = time.perf_counter() - t0
            row["ivf"] = []
            for n_probe in HOST_PROBES:
                ms, got = p50_ms(lambda q: hi.search_ivf(
                    q.cpu().numpy(), *WEIGHTS, k=K, n_probe=n_probe), qd)
                shipped = hi.last_query_bytes
                if shipped != hi.last_query_candidates * hi.row_bytes:
                    raise AssertionError(
                        f"search_ivf n_probe={n_probe}: {shipped} bytes "
                        f"for {hi.last_query_candidates} rows of "
                        f"{hi.row_bytes}")
                frac = shipped / row["index_bytes"]
                if n_probe == 8 and not frac < bytes_frac_max:
                    raise AssertionError(
                        f"search_ivf n_probe=8 shipped {frac:.3f} of the "
                        f"index (bound {bytes_frac_max})")
                row["ivf"].append({
                    "n_probe": n_probe, "p50_ms": ms,
                    "recall10_vs_streamed": float(np.mean(
                        [recall(i, s, ri, rs) for (s, i), (rs, ri)
                         in zip(got, ref)])),
                    "last_query_bytes": shipped,
                    "last_query_candidates": hi.last_query_candidates,
                    "bytes_frac": frac})
        else:
            row["recall10_vs_float32"] = float(np.mean(
                [recall(i, s, ri, rs) for (s, i), (rs, ri)
                 in zip(outs, ref)]))
        res[dt] = row
        emit(json.dumps({"host_index": row}))
        del hi
    return res


def measure(emit, dev: torch.device, rows: int = ROWS,
            check_rows: int = CHECK_ROWS, workdir: str | None = None,
            **host_kw) -> dict:
    """Both parts and every check on ``dev`` at ``rows`` segments."""
    t0 = time.perf_counter()
    emb, success, qs = make_data(rows)
    data_s = time.perf_counter() - t0
    emit(json.dumps({"rows": rows, "data_s": data_s}))
    checks = check_full_probe(emb[:check_rows], success[:check_rows],
                              qs[:CHECK_QUERIES], dev)
    emit(json.dumps({"full_probe": checks}))
    mem, e32, ok_d = in_memory(emb, success, qs, dev, emit)
    with tempfile.TemporaryDirectory(prefix="torch_bench_ivf_",
                                     dir=workdir) as d:
        host = host_index(emb, success, qs, e32, ok_d, dev, d, emit,
                          **host_kw)
    return {"data_s": data_s, "full_probe": checks, "in_memory": mem,
            "host_index": host}


def run(emit=print, rows: int = ROWS, device="cuda",
        workdir: str | None = None) -> dict:
    """Measure and check on a CUDA card; raises without one."""
    from multimodal_audio_search_tpu_torch import runtime
    dev = runtime.select_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the IVF tool measures a CUDA card, not {dev}")
    emit(json.dumps({"device": torch.cuda.get_device_name(dev)}))
    with torch.inference_mode():
        out = measure(emit, dev, rows=rows, workdir=workdir)
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--dir", default=None,
                    help="where the temporary host indexes go (default: "
                         "the system's temporary directory)")
    a = ap.parse_args()
    run(rows=a.rows, workdir=a.dir)


if __name__ == "__main__":
    main()
