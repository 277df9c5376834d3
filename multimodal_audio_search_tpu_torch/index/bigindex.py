"""Beyond-memory index: memory-mapped host store + chunk-streamed search.

Counterpart of ``multimodal_audio_search_tpu/index/bigindex.py``, with
the same on-disk layout, so a directory written by either package opens
in the other:

    emb.dat      [N, 2, D]  float32, bfloat16 bits, or int8
    scale.dat    [N, 2] f32         (int8 only: per-vector scales)
    success.dat  [N, 2] bool
    meta.jsonl   one segment record per line
    index.json   {"n", "dim", "dtype", "build_id"}
    ivf.npz      the IVF layout (``build_ivf``), tied to one build_id

bfloat16 is stored as its 16 bits in a uint16 memmap, rounded to nearest
even from float32 by torch (the rounding ``store.device_index`` uses),
so no ``ml_dtypes`` is needed; on the device the bits are viewed as
``torch.bfloat16``, and the bytes equal ``ml_dtypes.bfloat16``'s.

``search`` streams the memmap through the device in chunks: the host
copies chunk j out of the page cache into one of two pinned staging
buffers while a side stream copies chunk j-1 to the device and the
compute stream scores chunk j-2 (index/fusion.py::fused_scores, int8
dequantized as ``e * scale`` in float32) and takes its top-k. Events
guard each buffer's reuse: the host waits for the copy out of a staging
buffer before refilling it, and the copy stream waits for the scoring of
a device buffer before overwriting it. The per-chunk candidates merge on
the host with a stable sort, so results equal the in-memory fused_topk.

``search_ivf`` probes the layout's centroids on the host, gathers only
the candidate rows from the memmap and ships those: tens of MB a query
instead of the index.
"""
from __future__ import annotations

import json
import pathlib
import uuid

import numpy as np
import torch

from .. import runtime
from .fusion import NEG_INF, fused_scores

# storage dtype -> the memmap's numpy dtype (bfloat16 as its bits)
_NP_DTYPES = {"float32": np.float32, "bfloat16": np.uint16, "int8": np.int8}
# the same buffers as torch tensors (a view of the bits on the device)
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.int16,
                 "int8": torch.int8}


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _encode(x: np.ndarray, dtype: str):
    """[n, 2, D] float32 rows -> (stored rows, int8 scales or None)."""
    if dtype == "int8":
        s = np.maximum(np.abs(x).max(axis=-1), 1e-12) / 127.0
        return np.clip(np.round(x / s[..., None]),
                       -127, 127).astype(np.int8), s
    if dtype == "bfloat16":
        return _bf16_bits(x), None
    return x.astype(np.float32), None


def _write_spec(p: pathlib.Path, n: int, d: int, dtype: str) -> None:
    (p / "ivf.npz").unlink(missing_ok=True)   # layout of any prior build
    with open(p / "index.json", "w") as f:
        json.dump({"n": n, "dim": d, "dtype": dtype,
                   "build_id": uuid.uuid4().hex}, f)


def build_host_index(store, path, dtype: str = "float32",
                     chunk: int = 262_144,
                     device: torch.device | str = "cuda") -> "HostIndex":
    """Write a SegmentStore's index as memmaps (streams; no 2x RAM) and
    open it for search on ``device``."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    n = len(store)
    emb = store.embeddings[:n]          # [N, 2, D] float32 (host)
    ok = store.success[:n]
    d = emb.shape[-1]
    out = np.memmap(p / "emb.dat", mode="w+", dtype=_NP_DTYPES[dtype],
                    shape=(n, 2, d))
    scale = None
    if dtype == "int8":
        scale = np.memmap(p / "scale.dat", mode="w+", dtype=np.float32,
                          shape=(n, 2))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi], s = _encode(emb[lo:hi], dtype)
        if scale is not None:
            scale[lo:hi] = s
    out.flush()
    if scale is not None:
        scale.flush()
    okm = np.memmap(p / "success.dat", mode="w+", dtype=np.bool_,
                    shape=(n, 2))
    okm[:] = ok
    okm.flush()
    with open(p / "meta.jsonl", "w") as f:
        for m in store.meta[:n]:
            f.write(json.dumps({k: v for k, v in m.items()
                                if k not in ("audio_data",)},
                               default=float) + "\n")
    _write_spec(p, n, d, dtype)
    return HostIndex(p, device=device)


class HostIndexWriter:
    """Stream a host index to disk without materializing the source
    in RAM (build_host_index needs a whole SegmentStore; ingest at the
    10M+ scale produces embeddings in batches). Append [n_i, 2, D] f32
    chunks; rows are quantized to the storage dtype on the fly.

        w = HostIndexWriter(path, n_total, d, dtype="int8")
        for emb_chunk, success_chunk, meta_chunk in batches:
            w.append(emb_chunk, success_chunk, meta_chunk)
        hi = w.finalize()
    """

    def __init__(self, path, n: int, d: int, dtype: str = "float32"):
        self.p = pathlib.Path(path)
        self.p.mkdir(parents=True, exist_ok=True)
        self.n, self.d, self.dtype = n, d, dtype
        self._emb = np.memmap(self.p / "emb.dat", mode="w+",
                              dtype=_NP_DTYPES[dtype], shape=(n, 2, d))
        self._scale = np.memmap(
            self.p / "scale.dat", mode="w+", dtype=np.float32,
            shape=(n, 2)) if dtype == "int8" else None
        self._ok = np.memmap(self.p / "success.dat", mode="w+",
                             dtype=np.bool_, shape=(n, 2))
        self._meta = open(self.p / "meta.jsonl", "w")
        self._row = 0

    def append(self, emb: np.ndarray, success: np.ndarray,
               meta: list[dict] | None = None) -> None:
        lo, hi = self._row, self._row + len(emb)
        if hi > self.n:
            raise ValueError(f"writer sized for {self.n} rows, got {hi}")
        self._emb[lo:hi], s = _encode(emb, self.dtype)
        if self._scale is not None:
            self._scale[lo:hi] = s
        self._ok[lo:hi] = success
        for m in (meta if meta is not None else
                  ({} for _ in range(len(emb)))):
            self._meta.write(json.dumps(m, default=float) + "\n")
        self._row = hi

    def finalize(self, chunk: int = 262_144,
                 device: torch.device | str = "cuda") -> "HostIndex":
        if self._row != self.n:
            raise ValueError(f"wrote {self._row} of {self.n} rows")
        self._emb.flush()
        if self._scale is not None:
            self._scale.flush()
        self._ok.flush()
        self._meta.close()
        _write_spec(self.p, self.n, self.d, self.dtype)
        return HostIndex(self.p, chunk=chunk, device=device)


class _Slot:
    """One staging buffer of the stream: pinned host arrays, their device
    twins, and the events that guard their reuse."""

    def __init__(self, rows: int, dim: int, dtype: str, dev: torch.device):
        cuda = dev.type == "cuda"

        def pair(shape, dt):
            host = torch.empty(shape, dtype=dt, pin_memory=cuda)
            return host, (torch.empty(shape, dtype=dt, device=dev)
                          if cuda else host)
        self.emb = pair((rows, 2, dim), _TORCH_DTYPES[dtype])
        self.ok = pair((rows, 2), torch.bool)
        self.scale = pair((rows, 2), torch.float32) \
            if dtype == "int8" else None
        self.host_np = [b[0].numpy() for b in
                        (self.emb, self.ok, self.scale) if b is not None]
        if cuda:
            self.copied = torch.cuda.Event()   # its host buffers are free
            self.scored = torch.cuda.Event()   # its device buffers are free


class HostIndex:
    """Memory-mapped [N, 2, D] index searched in device-streamed chunks
    on ``device`` ("cuda" unless the caller names the CPU)."""

    def __init__(self, path, chunk: int = 262_144,
                 device: torch.device | str = "cuda"):
        self.device = runtime.select_device(device)
        p = pathlib.Path(path)
        spec = json.loads((p / "index.json").read_text())
        self.n, self.dim, self.dtype = spec["n"], spec["dim"], spec["dtype"]
        self.emb = np.memmap(p / "emb.dat", mode="r",
                             dtype=_NP_DTYPES[self.dtype],
                             shape=(self.n, 2, self.dim))
        self.scale = np.memmap(
            p / "scale.dat", mode="r", dtype=np.float32,
            shape=(self.n, 2)) if self.dtype == "int8" else None
        self.success = np.memmap(p / "success.dat", mode="r",
                                 dtype=np.bool_, shape=(self.n, 2))
        self.meta = [json.loads(line)
                     for line in (p / "meta.jsonl").read_text().splitlines()]
        self.chunk = chunk
        self.max_candidate_bytes = 512 * 1024 * 1024
        # bytes one row ships: its two embeddings, two success flags and,
        # for int8, two scales
        self.row_bytes = 2 * self.dim * self.emb.itemsize + 2 + (
            8 if self.scale is not None else 0)
        self.path = p
        self.build_id = spec.get("build_id", "")
        self._slots: list[_Slot] | None = None
        self._copy_stream = None
        self._ivf = None                # (centroids, members, spill)
        ivf_p = p / "ivf.npz"
        if ivf_p.exists():
            with np.load(ivf_p) as z:
                # stale layouts are ignored: the build_id ties the layout
                # to ONE build of the memmaps (a same-size rebuild at the
                # same path would otherwise reuse buckets built for other
                # data); build_host_index also unlinks ivf.npz.
                bid = str(z["build_id"]) if "build_id" in z.files else ""
                if int(z["n"]) == self.n and bid == self.build_id:
                    self._ivf = (z["centroids"], z["members"], z["spill"])

    def __len__(self) -> int:
        return self.n

    def _device_rows(self, e: torch.Tensor, scale) -> torch.Tensor:
        """Stored rows on the device -> float32 rows."""
        if self.dtype == "bfloat16":
            return e.view(torch.bfloat16).float()
        e = e.float()
        return e * scale[..., None] if scale is not None else e

    def _chunk_topk(self, q, e, ok, scale, wa, wb, k, threshold):
        """(top scores, top row ids) of one chunk by a stable descending
        sort (lax.top_k's tie rule)."""
        masked, _ = fused_scores(q, self._device_rows(e, scale), ok,
                                 wa, wb, threshold)
        s, i = torch.sort(masked, descending=True, stable=True)
        kk = min(k, masked.shape[0])
        return s[:kk], i[:kk]

    # ------------------------------------------------------------ IVF (ANN)
    def _rows_f32(self, idx: np.ndarray) -> np.ndarray:
        """Dequantized [len(idx), 2, D] f32 rows (host)."""
        x = self.emb[idx]
        if self.dtype == "bfloat16":
            return (x.astype(np.uint32) << 16).view(np.float32)
        if self.dtype == "int8":
            return x.astype(np.float32) * self.scale[idx][..., None]
        return np.asarray(x, np.float32)

    def build_ivf(self, n_clusters: int | None = None,
                  cap_factor: float = 4.0, iters: int = 10, seed: int = 0,
                  save: bool = True, sample: int = 16384) -> None:
        """One streaming pass over the memmap: train spherical k-means on
        a row subsample, assign every successful (row, slot) vector, pack
        buckets (index/ivf.py::pack_buckets), all on the index's device.
        Persisted as ivf.npz next to the memmaps (save=True) and loaded
        by __init__, so the build cost is paid once per index, not per
        process."""
        from .ivf import _chunked_argmax_sim, pack_buckets, spherical_kmeans
        rng = np.random.default_rng(seed)
        take = min(self.n, max(sample // 2, 1))
        t_rows = np.sort(rng.choice(self.n, size=take, replace=False))
        xs = self._rows_f32(t_rows).reshape(-1, self.dim)
        oks = np.asarray(self.success[t_rows]).reshape(-1) \
            & (np.linalg.norm(xs, axis=1) > 0)
        if n_clusters is None:
            n_clusters = max(1, int(np.sqrt(2 * self.n)))
        cent = spherical_kmeans(xs[oks], n_clusters, iters=iters,
                                seed=seed, device=self.device)
        n_clusters = int(cent.shape[0])
        rows_all, assign_all, n_vec = [], [], 0
        for lo in range(0, self.n, self.chunk):
            hi = min(lo + self.chunk, self.n)
            x = self._rows_f32(np.arange(lo, hi)).reshape(-1, self.dim)
            ok = np.asarray(self.success[lo:hi]).reshape(-1) \
                & (np.linalg.norm(x, axis=1) > 0)
            rows = np.repeat(np.arange(lo, hi, dtype=np.int32), 2)[ok]
            if len(rows):
                rows_all.append(rows)
                assign_all.append(_chunked_argmax_sim(x[ok], cent))
                n_vec += len(rows)
        rows_ok = np.concatenate(rows_all) if rows_all else \
            np.zeros(0, np.int32)
        assign = np.concatenate(assign_all) if assign_all else \
            np.zeros(0, np.int32)
        members, spill = pack_buckets(rows_ok, assign, n_clusters, n_vec,
                                      cap_factor)
        self._ivf = (cent.cpu().numpy(), members, spill)
        if save:
            np.savez(self.path / "ivf.npz", n=self.n,
                     build_id=self.build_id,
                     centroids=self._ivf[0], members=members, spill=spill)

    def search_ivf(self, query_emb, asr_weight, audio_weight, k: int = 10,
                   n_probe: int = 8, threshold: float = 0.1):
        """Sublinear beyond-memory search: centroid probe on the host,
        gather ONLY the candidate rows from the memmap, ship them in the
        storage dtype, score + top-k as the streamed path does. The bytes
        shipped drop from the whole index to ~n_probe/C of it;
        ``last_query_bytes`` reports them and ``last_query_candidates``
        the rows. Full probe == search()."""
        if self._ivf is None:
            self.build_ivf()
        cent, members, spill = self._ivf
        q = np.asarray(query_emb, np.float32)
        cs = cent @ q
        n_probe = min(n_probe, len(cs))
        probe = np.argpartition(-cs, n_probe - 1)[:n_probe]
        cand = members[probe].reshape(-1)
        cand = cand[cand >= 0]
        if spill.size:
            cand = np.concatenate([cand, spill])
        cand = np.unique(cand)          # host dedup: rows scored once
        if cand.size == 0:
            return (np.zeros(0, np.float32), np.zeros(0, np.int64))
        # a near-full probe would materialize ~the whole index in host
        # RAM, defeating the memmap design: past the budget, the chunk-
        # streamed exact path is both cheaper and identical in results
        # (superset candidate set)
        cand_bytes = 2 * cand.size * (2 * self.dim * self.emb.itemsize
                                      + (8 if self.scale is not None
                                         else 0))
        if cand_bytes > self.max_candidate_bytes:
            self.last_query_bytes = self.emb.nbytes + self.success.nbytes \
                + (self.scale.nbytes if self.scale is not None else 0)
            self.last_query_candidates = self.n
            return self.search(query_emb, asr_weight, audio_weight, k=k,
                               threshold=threshold)
        self.last_query_bytes = int(cand.size) * self.row_bytes
        self.last_query_candidates = int(cand.size)
        dev = self.device
        rows = self.emb[cand]
        emb_d = torch.from_numpy(rows.view(np.int16) if self.dtype ==
                                 "bfloat16" else rows).to(dev)
        ok_d = torch.from_numpy(self.success[cand]).to(dev)
        sc_d = torch.from_numpy(self.scale[cand]).to(dev) \
            if self.scale is not None else None
        s, li = self._chunk_topk(
            torch.from_numpy(q).to(dev), emb_d, ok_d, sc_d,
            float(asr_weight), float(audio_weight),
            k=min(k, int(cand.size)), threshold=threshold)
        return s.cpu().numpy(), cand[li.cpu().numpy()]

    # -------------------------------------------------------------- stream
    def _stream_slots(self) -> list[_Slot]:
        """The two staging slots, allocated at the first search and again
        only when ``chunk`` changes."""
        rows = min(self.chunk, self.n)
        if self._slots is None or self._slots[0].ok[0].shape[0] != rows:
            if self._slots is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._slots = None          # free the old buffers first
            self._slots = [_Slot(rows, self.dim, self.dtype, self.device)
                           for _ in range(2)]
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
        return self._slots

    def _upload(self, slot: _Slot, lo: int, hi: int):
        """Chunk [lo, hi) into ``slot``: host memcpy into the pinned
        buffers, then (on a card) the copy to the device on the side
        stream. Returns the device tensors the compute stream may read."""
        m = hi - lo
        src = [self.emb[lo:hi], self.success[lo:hi]]
        if self.scale is not None:
            src.append(self.scale[lo:hi])
        if self.device.type == "cuda":
            slot.copied.synchronize()    # the last copy out of it is done
        for dst, a in zip(slot.host_np, src):
            np.copyto(dst[:m], a.view(dst.dtype))
        bufs = [b for b in (slot.emb, slot.ok, slot.scale) if b is not None]
        if self.device.type == "cuda":
            cs = self._copy_stream
            cs.wait_event(slot.scored)   # the last scoring of it is done
            with torch.cuda.stream(cs):
                for host, dev in bufs:
                    dev[:m].copy_(host[:m], non_blocking=True)
                slot.copied.record(cs)
            torch.cuda.current_stream(self.device).wait_event(slot.copied)
        out = [dev[:m] for _, dev in bufs]
        return out[0], out[1], (out[2] if len(out) > 2 else None)

    @torch.inference_mode()
    def search(self, query_emb, asr_weight, audio_weight, k: int = 10,
               threshold: float = 0.1):
        """(scores[k], indices[k]) == in-memory fused_topk on the same
        data (merge math identical; parity-tested)."""
        dev = self.device
        q = torch.from_numpy(np.asarray(query_emb, np.float32)).to(dev)
        wa, wb = float(asr_weight), float(audio_weight)
        slots = self._stream_slots()
        all_s, all_i = [], []
        for j, lo in enumerate(range(0, self.n, self.chunk)):
            hi = min(lo + self.chunk, self.n)
            slot = slots[j % 2]
            e, ok, sc = self._upload(slot, lo, hi)
            s, i = self._chunk_topk(q, e, ok, sc, wa, wb, k, threshold)
            if dev.type == "cuda":
                slot.scored.record()
            all_s.append(s)
            all_i.append(i + lo)
        s = torch.cat(all_s).cpu().numpy()
        i = torch.cat(all_i).cpu().numpy()
        order = np.argsort(-s, kind="stable")[:k]
        return s[order], i[order]

    def records(self, indices, scores) -> list[dict]:
        out = []
        for idx, sc in zip(indices, scores):
            if sc <= NEG_INF / 2:
                continue
            r = dict(self.meta[int(idx)])
            r["index"] = int(idx)
            r["fusion_score"] = float(sc)
            out.append(r)
        return out
