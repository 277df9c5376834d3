"""Persistent segment index.

Counterpart of ``multimodal_audio_search_tpu/index/store.py`` with the
same on-disk format, so a store saved by either package loads in the
other:

  * metadata rows (times, texts, success flags, provenance) host-side,
  * a dense ``[capacity, 2, D]`` embedding matrix (unit-norm float32, zeros
    where a pipeline failed) mirrored to the device in power-of-two
    capacity buckets,
  * optional raw segment waveforms for playback parity.

Persistence is a directory: ``embeddings.npz`` + ``meta.jsonl`` (+ optional
``audio.npz``), or raw ``emb.npy``/``success.npy`` with ``mmap=True``.
``save_incremental`` writes the append-only sharded layout (the rows added
since the last call, then the manifest), which streaming ingest's
autosave uses; ``delete_where``/``delete_source`` compact the index.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Sequence

import numpy as np
import torch

ASR, AUDIO = 0, 1  # pipeline slots in the [N, 2, D] index


def _next_pow2(n: int, floor: int = 1024) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class SegmentStore:
    def __init__(self, embed_dim: int = 384, keep_audio: bool = True):
        self.embed_dim = embed_dim
        self.keep_audio = keep_audio
        self.meta: list[dict[str, Any]] = []
        self._cap = 1024
        self._emb = np.zeros((self._cap, 2, embed_dim), np.float32)
        self._success = np.zeros((self._cap, 2), bool)
        self._audio: list[np.ndarray | None] = []
        self._device_view: tuple[Any, Any, Any] | None = None  # (key, emb, ok)
        # monotonic mutation counter: a delete+ingest of equal size shifts
        # row ids without changing the count
        self.version = 0
        # bumped on every compaction; save_incremental records it in the
        # manifest so a deleted-then-regrown store can't silently append
        # to a stale on-disk prefix
        self._compactions = 0

    def __len__(self) -> int:
        return len(self.meta)

    # ------------------------------------------------------------------ add
    def add(
        self,
        meta: dict[str, Any],
        asr_embedding: np.ndarray | None,
        audio_embedding: np.ndarray | None,
        audio_data: np.ndarray | None = None,
    ) -> int:
        """Append one segment. Embeddings are L2-normalized on the way in."""
        i = len(self.meta)
        if i >= self._cap:
            self._grow(_next_pow2(i + 1, self._cap * 2))
        for slot, e in ((ASR, asr_embedding), (AUDIO, audio_embedding)):
            if e is not None:
                e = np.asarray(e, np.float32).reshape(-1)
                n = float(np.linalg.norm(e))
                self._emb[i, slot] = e / n if n > 0 else e
                self._success[i, slot] = True
        row = dict(meta)
        row.setdefault("segment_id", f"seg_{i}")
        row["asr_success"] = bool(self._success[i, ASR])
        row["audio_success"] = bool(self._success[i, AUDIO])
        self.meta.append(row)
        if self.keep_audio:
            self._audio.append(
                None if audio_data is None
                else np.asarray(audio_data, np.float32))
        self._device_view = None
        self.version += 1
        return i

    def extend(self, records: Sequence[dict[str, Any]]) -> list[int]:
        """Append reference-shaped segment dicts (audio_search.py:275-294)."""
        return [
            self.add(
                {k: v for k, v in r.items()
                 if k not in ("asr_embedding", "audio_embedding",
                              "audio_data")},
                r.get("asr_embedding"),
                r.get("audio_embedding"),
                r.get("audio_data"),
            )
            for r in records
        ]

    # ------------------------------------------------------------- delete
    def delete_where(self, pred) -> int:
        """Remove every segment whose meta row satisfies ``pred`` and
        compact the index (row order of survivors is preserved, so search
        result indices stay consistent with ``meta``). Returns the number
        of rows removed.

        Capability beyond the reference, which can only clear the whole
        database (audio_search.py:115 keeps a session-state list; the only
        mutation is append/reset)."""
        n = len(self.meta)
        keep = [i for i in range(n) if not pred(self.meta[i])]
        removed = n - len(keep)
        if removed == 0:
            return 0
        idx = np.asarray(keep, np.int64)
        self._emb[: len(keep)] = self._emb[idx]
        self._emb[len(keep): n] = 0.0
        self._success[: len(keep)] = self._success[idx]
        self._success[len(keep): n] = False
        self.meta = [self.meta[i] for i in keep]
        if self.keep_audio:
            self._audio = [self._audio[i] for i in keep
                           if i < len(self._audio)]
        # the cached device index keys on the capacity, which a delete
        # leaves as it was: drop it, or a search scores the old rows
        self._device_view = None
        self.version += 1
        self._compactions += 1
        return removed

    def delete_source(self, source_name: str) -> int:
        """Remove every segment ingested from ``source_name`` (the
        ``source`` field stamped by pipelines/ingest.py)."""
        return self.delete_where(
            lambda row: row.get("source") == source_name)

    def _grow(self, new_cap: int) -> None:
        emb = np.zeros((new_cap, 2, self.embed_dim), np.float32)
        ok = np.zeros((new_cap, 2), bool)
        emb[: self._cap] = self._emb
        ok[: self._cap] = self._success
        self._emb, self._success, self._cap = emb, ok, new_cap
        self._device_view = None
        self.version += 1

    # ---------------------------------------------------------------- views
    @property
    def embeddings(self) -> np.ndarray:
        return self._emb[: len(self.meta)]

    @property
    def success(self) -> np.ndarray:
        return self._success[: len(self.meta)]

    def audio(self, i: int) -> np.ndarray | None:
        return self._audio[i] if self.keep_audio and i < len(self._audio) \
            else None

    def host_index(self, padded: bool = False) \
            -> tuple[np.ndarray, np.ndarray]:
        """(emb, success) host views. ``padded=True`` returns the full
        capacity bucket (padding rows have success=False), row-aligned
        with device_index()."""
        if padded:
            return self._emb, self._success
        n = len(self.meta)
        return self._emb[:n], self._success[:n]

    def device_index(self, device, dtype=torch.float32, mesh=None):
        """(emb[cap,2,D], success[cap,2]) on ``device``, padded to the
        capacity bucket; padding rows have success=False so the fused
        scoring marks them invalid. With ``mesh`` (parallel/mesh.py), the
        same rows as dp contiguous blocks, one on each data device: (emb
        shards, success shards); the capacity is a power of two >= 1024,
        so every dp <= 1024 divides it. Cached until the store mutates or
        the requested device/dtype/mesh changes. float32 keeps exact
        top-k parity with the reference; bfloat16 (rounded to nearest
        even, as jnp.asarray rounds) halves the bytes a query reads."""
        # the key holds the Mesh object itself (hashed by identity), not
        # id(mesh): a collected mesh's id can be reused by a new one
        key = (self._cap, str(dtype), str(device), mesh)
        if self._device_view is None or self._device_view[0] != key:
            if mesh is not None:
                from ..parallel.mesh import data_sharded
                emb = [e.to(dtype=dtype)
                       for e in data_sharded(mesh, self._emb)]
                ok = data_sharded(mesh, self._success)
            else:
                emb = torch.as_tensor(self._emb).to(device=device,
                                                    dtype=dtype)
                ok = torch.as_tensor(self._success).to(device=device)
            self._device_view = (key, emb, ok)
        return self._device_view[1], self._device_view[2]

    # ---------------------------------------------------------- persistence
    def save(self, path: str | pathlib.Path, mmap: bool = False) -> None:
        """Persist the index. ``mmap=True`` writes raw .npy arrays instead
        of a compressed npz so load() can memory-map them — the right format
        past ~100k segments where decompress-on-load dominates cold start."""
        p = pathlib.Path(path)
        p.mkdir(parents=True, exist_ok=True)
        # a full save supersedes any sharded layout in the directory
        # (load() prefers the manifest, which would otherwise go stale)
        (p / "manifest.json").unlink(missing_ok=True)
        for f in p.glob("*.shard-*.np*"):
            f.unlink()
        n = len(self.meta)
        if mmap:
            np.save(p / "emb.npy", self._emb[:n])
            np.save(p / "success.npy", self._success[:n])
            (p / "embeddings.npz").unlink(missing_ok=True)
        else:
            np.savez_compressed(
                p / "embeddings.npz",
                emb=self._emb[:n], success=self._success[:n],
                embed_dim=self.embed_dim)
            (p / "emb.npy").unlink(missing_ok=True)
            (p / "success.npy").unlink(missing_ok=True)
        with open(p / "meta.jsonl", "w") as f:
            for row in self.meta:
                f.write(json.dumps(row) + "\n")
        if self.keep_audio and any(a is not None for a in self._audio):
            flat = np.concatenate(
                [a if a is not None else np.zeros(0, np.float32)
                 for a in self._audio]) if self._audio else np.zeros(0)
            lens = np.array(
                [0 if a is None else len(a) for a in self._audio], np.int64)
            np.savez_compressed(p / "audio.npz", flat=flat, lens=lens)
        else:
            # no waveforms any more (keep_audio off, or delete_where
            # removed every row that had audio): a stale audio.npz from a
            # previous save would attach wrong waveforms to the new rows
            (p / "audio.npz").unlink(missing_ok=True)

    def save_incremental(self, path: str | pathlib.Path) -> int:
        """Append-only sharded persistence: write ONLY the rows added
        since the last save to ``emb.shard-K.npy``/``success.shard-K.npy``
        (+ ``audio.shard-K.npz``), append their meta lines, and update
        ``manifest.json`` last (write-tmp + atomic rename), so a crash
        mid-save leaves the previous manifest consistent. O(new rows) per
        call where ``save()`` rewrites the whole store — the right
        persistence for streaming ingest's periodic commits
        (pipelines/streaming.py). Returns rows written.

        A directory previously written by ``save()`` is not extendable —
        call on a fresh directory (load() accepts either layout)."""
        p = pathlib.Path(path)
        p.mkdir(parents=True, exist_ok=True)
        manifest = p / "manifest.json"
        if not manifest.exists() and (p / "meta.jsonl").exists():
            raise ValueError(
                f"{p} holds a full-save layout; incremental save needs "
                "a fresh directory (or keep using save())")
        state = {"rows": 0, "shards": 0, "embed_dim": self.embed_dim,
                 "keep_audio": self.keep_audio,
                 "compactions": self._compactions}
        if manifest.exists():
            state = json.loads(manifest.read_text())
            if state["embed_dim"] != self.embed_dim:
                raise ValueError("manifest embed_dim mismatch")
            if state.get("compactions", 0) != self._compactions:
                # rows were deleted since the last save: the on-disk
                # prefix no longer matches this store's rows 0..lo, so
                # appending would corrupt; caller must full-save
                raise ValueError(
                    "store was compacted since the last incremental "
                    "save; use save() to rewrite")
        lo, n = state["rows"], len(self.meta)
        if lo > n:
            raise ValueError(
                f"directory already holds {lo} rows > store's {n}; "
                "incremental save can only append")
        if lo == n:
            return 0
        # A crash between the meta append and the manifest rename leaves
        # orphan meta lines past the committed row count. They must be
        # dropped BEFORE appending: _load_shards takes meta[:rows], so
        # orphans would otherwise shadow the newly committed rows with
        # stale metadata. The manifest records the committed byte length
        # (meta_bytes) so the truncate is O(1); legacy manifests without
        # it fall back to a one-time line-count rewrite.
        meta_path = p / "meta.jsonl"
        if meta_path.exists():
            committed = state.get("meta_bytes")
            if committed is not None:
                size = meta_path.stat().st_size
                if size > committed:
                    # only ever SHRINK: truncate(committed) on a file
                    # shorter than committed would extend it with NUL
                    # bytes and corrupt every later json.loads
                    with open(meta_path, "r+b") as f:
                        f.truncate(committed)
                elif size < committed:
                    # the manifest rename reached disk but the meta data
                    # blocks did not (nothing is fsynced): committed rows
                    # are unrecoverable here — refuse, caller full-saves
                    raise ValueError(
                        f"meta.jsonl is {size} bytes < manifest's "
                        f"committed {committed}; directory lost data — "
                        "rewrite with save()")
            else:
                lines = meta_path.read_text().splitlines(keepends=True)
                if len(lines) < lo:
                    # same data-loss condition the meta_bytes path refuses:
                    # appending after a gap would leave _load_shards'
                    # meta[:rows] silently misaligned with rows (ADVICE r3)
                    raise ValueError(
                        f"meta.jsonl has {len(lines)} lines < manifest's "
                        f"committed {lo} rows; directory lost data — "
                        "rewrite with save()")
                if len(lines) > lo:
                    meta_path.write_text("".join(lines[:lo]))
        k = state["shards"]
        np.save(p / f"emb.shard-{k:05d}.npy", self._emb[lo:n])
        np.save(p / f"success.shard-{k:05d}.npy", self._success[lo:n])
        if self.keep_audio:
            chunk = self._audio[lo:n]
            flat = np.concatenate(
                [a if a is not None else np.zeros(0, np.float32)
                 for a in chunk]) if chunk else np.zeros(0, np.float32)
            lens = np.array([0 if a is None else len(a) for a in chunk],
                            np.int64)
            np.savez_compressed(p / f"audio.shard-{k:05d}.npz",
                                flat=flat, lens=lens)
        with open(p / "meta.jsonl", "a") as f:
            for row in self.meta[lo:n]:
                f.write(json.dumps(row) + "\n")
        state.update(rows=n, shards=k + 1,
                     compactions=self._compactions,
                     meta_bytes=meta_path.stat().st_size)
        tmp = p / "manifest.json.tmp"
        tmp.write_text(json.dumps(state))
        tmp.replace(manifest)
        return n - lo

    @classmethod
    def _load_shards(cls, p: pathlib.Path) -> "SegmentStore":
        state = json.loads((p / "manifest.json").read_text())
        st = cls(embed_dim=int(state["embed_dim"]),
                 keep_audio=bool(state.get("keep_audio", True)))
        st._compactions = int(state.get("compactions", 0))
        n = int(state["rows"])
        st._cap = _next_pow2(max(n, 1))
        st._emb = np.zeros((st._cap, 2, st.embed_dim), np.float32)
        st._success = np.zeros((st._cap, 2), bool)
        row = 0
        for k in range(int(state["shards"])):
            e = np.load(p / f"emb.shard-{k:05d}.npy")
            st._emb[row: row + len(e)] = e
            st._success[row: row + len(e)] = np.load(
                p / f"success.shard-{k:05d}.npy")
            if st.keep_audio and (p / f"audio.shard-{k:05d}.npz").exists():
                za = np.load(p / f"audio.shard-{k:05d}.npz")
                flat, lens = za["flat"], za["lens"]
                offs = np.concatenate([[0], np.cumsum(lens)])
                st._audio.extend(
                    flat[offs[i]: offs[i + 1]].astype(np.float32)
                    if lens[i] > 0 else None for i in range(len(lens)))
            row += len(e)
        with open(p / "meta.jsonl") as f:
            st.meta = [json.loads(line) for line in f if line.strip()]
        # the manifest is authoritative: a crash after shard write but
        # before the manifest update leaves orphan rows to ignore
        st.meta = st.meta[:n]
        if not st.keep_audio:
            st._audio = []
        elif len(st._audio) < n:
            st._audio.extend([None] * (n - len(st._audio)))
        else:
            st._audio = st._audio[:n]
        return st

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "SegmentStore":
        p = pathlib.Path(path)
        if (p / "manifest.json").exists():    # append-only sharded format
            return cls._load_shards(p)
        if (p / "emb.npy").exists():          # mmap format
            emb = np.load(p / "emb.npy", mmap_mode="r")
            ok = np.load(p / "success.npy", mmap_mode="r")
            st = cls(embed_dim=int(emb.shape[-1]))
        else:
            z = np.load(p / "embeddings.npz")
            emb, ok = z["emb"], z["success"]
            st = cls(embed_dim=int(z["embed_dim"]))
        st._cap = _next_pow2(max(len(emb), 1))
        st._emb = np.zeros((st._cap, 2, st.embed_dim), np.float32)
        st._success = np.zeros((st._cap, 2), bool)
        st._emb[: len(emb)] = emb
        st._success[: len(ok)] = ok
        with open(p / "meta.jsonl") as f:
            st.meta = [json.loads(line) for line in f if line.strip()]
        audio_file = p / "audio.npz"
        if audio_file.exists():
            za = np.load(audio_file)
            flat, lens = za["flat"], za["lens"]
            offs = np.concatenate([[0], np.cumsum(lens)])
            st._audio = [
                flat[offs[i]: offs[i + 1]].astype(np.float32)
                if lens[i] > 0 else None
                for i in range(len(lens))
            ]
        else:
            st._audio = [None] * len(st.meta)
            st.keep_audio = False
        return st
