"""IVF (inverted-file) approximate fused search, in plain torch.

Counterpart of the single-device half of
``multimodal_audio_search_tpu/index/ivf.py``. The exact path scores every
segment a query (index/fusion.py); IVF scores only the rows of the
clusters nearest the query, with the FUSION MATH EXACT on every candidate:

  build:  spherical k-means over all successful (row, slot) embeddings
          (matmul assignment + a deterministic per-cluster sum, on the
          device), then the bucket layout ``members[C, cap]`` (row ids
          padded with -1) plus a ``spill`` tail of overflow rows that is
          scanned on EVERY query, so cluster imbalance degrades speed,
          never correctness.
  query:  q @ centroids -> the n_probe best live clusters -> gather their
          member rows (+ spill) -> exact fused scoring of the candidates
          (index/fusion.py's availability renorm and > threshold) -> row
          dedup (a row reachable via both slots must not appear twice) ->
          top-k, returning fused_topk's result dict.

The index arrays (emb/success) are call operands, shared with the exact
path's capacity-padded device view (index/store.py::device_index): IVF
adds centroids and buckets to the device, never a second copy of the
index. With n_probe == n_clusters the candidates are every row with a
successful slot and the result equals fused_topk.

Tie rules follow the JAX package's: ``lax.top_k`` (the lowest index wins
a tie) is a stable descending sort, and ``jnp.lexsort((-score, cand))``
is two stable sorts, by score descending and then by row ascending.

Determinism: the k-means step sums each cluster's members as a one-hot
matmul ([C, M'] x [M', D]) rather than with ``index_add_``, whose CUDA
float atomics add in a different order on every run; so two builds on
one card give the same centroids and the same buckets. TF32 stays off
(``runtime.select_device``).

Over a mesh (parallel/mesh.py), ``build_ivf_sharded`` builds one layout
per contiguous row block of the store's sharded view (k-means with seed
+ s on block s) and stacks them to uniform shapes with -1 padding;
``sharded_ivf_search_impl`` probes each shard's own buckets on its
device with ``local_candidate_scores`` and merges the k candidates of
every shard as parallel/sharding.py merges them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import runtime
from ..parallel.sharding import local_topk, merge_topk
from .fusion import NEG_INF, _weights, fused_topk, normalize


def _desc(x: torch.Tensor) -> torch.Tensor:
    """Indices of ``x`` sorted descending, ties by index (lax.top_k)."""
    return torch.sort(x, descending=True, stable=True)[1]


def _chunked_argmax_sim(x: np.ndarray, cent: torch.Tensor,
                        chunk: int = 16384) -> np.ndarray:
    """argmax_c <x_i, cent_c> for every row on ``cent``'s device, chunked
    so the [chunk, C] similarity tile stays small at any N. A tie goes to
    the lowest centroid, as jnp.argmax's does."""
    out = np.empty(len(x), np.int32)
    for lo in range(0, len(x), chunk):
        hi = min(lo + chunk, len(x))
        a = torch.from_numpy(np.array(x[lo:hi], np.float32)).to(cent.device)
        out[lo:hi] = torch.argmax(a @ cent.T, dim=1).cpu().numpy()
    return out


def spherical_kmeans(
    x: np.ndarray,              # [M, D] unit-norm training vectors
    n_clusters: int,
    iters: int = 10,
    seed: int = 0,
    sample: int = 32768,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Cosine k-means on ``device``: centroids re-normalized each step.
    Trains on a subsample drawn as the JAX package draws it (the same
    numpy generator calls), so both start from the same centroids."""
    dev = runtime.select_device(device)
    rng = np.random.default_rng(seed)
    m = len(x)
    if m > sample:
        x_train = x[rng.choice(m, size=sample, replace=False)]
    else:
        x_train = x
    n_clusters = min(n_clusters, max(len(x_train), 1))
    if len(x_train) == 0:
        return torch.zeros((1, x.shape[1] if x.ndim == 2 else 1),
                           dtype=torch.float32, device=dev)
    cent = torch.from_numpy(np.array(
        x_train[rng.choice(len(x_train), size=n_clusters, replace=False)],
        np.float32)).to(dev)
    xd = torch.from_numpy(np.array(x_train, np.float32)).to(dev)
    for _ in range(iters):
        assign = torch.argmax(xd @ cent.T, dim=1)                   # [M']
        onehot = torch.nn.functional.one_hot(
            assign, n_clusters).to(torch.float32)                  # [M', C]
        sums = onehot.T @ xd                                        # [C, D]
        counts = onehot.sum(dim=0)
        # empty clusters keep their previous centroid
        cent = torch.where(counts[:, None] > 0, normalize(sums), cent)
    return cent


def local_candidate_scores(q, centroids, members, spill, emb, success,
                           w_asr, w_audio, *, n_probe: int,
                           threshold: float):
    """Probe -> gather -> exact fused score -> dedup on one device.

    centroids [C, D], members [C, cap] (-1 padded), spill [S], emb
    [N, 2, D], success [N, 2]. Returns (score_s, rows_s): candidate scores
    sorted by (row asc, score desc) with duplicates and invalid rows at
    NEG_INF."""
    cs = centroids.float() @ q
    # clusters with no members must rank BELOW every real cluster: an
    # empty cluster's cs=0 would otherwise beat real centroids with
    # negative query similarity and waste probes
    live = (members >= 0).any(dim=-1)
    cs = torch.where(live, cs, torch.full_like(cs, NEG_INF))
    n_probe = min(n_probe, int(centroids.shape[0]))
    probe = _desc(cs)[:n_probe]
    cand = members[probe].reshape(-1)
    if spill.shape[0]:
        cand = torch.cat([cand, spill])
    valid_cand = cand >= 0
    cand = torch.where(valid_cand, cand, torch.zeros_like(cand)).long()
    sims = torch.einsum("npd,d->np", emb[cand].float(), q)     # [Nc, 2]
    w = _weights(w_asr, w_audio, q.device)
    eff = w * success[cand].float()
    total = eff.sum(dim=-1)
    eff = eff / total.clamp(min=1e-30)[:, None]
    score = (eff * sims).sum(dim=-1)
    ok = ((sims > 0.0).any(dim=-1) & (total > 0.0)
          & (score > threshold) & valid_cand)
    score = torch.where(ok, score, torch.full_like(score, NEG_INF))
    # row dedup: sort by (row asc, score desc); the best occurrence of
    # each row survives, later duplicates mask to NEG_INF. A padding slot
    # (row 0, NEG_INF) thus never shadows a valid row 0.
    by_score = _desc(score)
    order = by_score[torch.sort(cand[by_score], stable=True)[1]]
    rows_s = cand[order]
    score_s = score[order]
    first = torch.ones_like(rows_s, dtype=torch.bool)
    first[1:] = rows_s[1:] != rows_s[:-1]
    return torch.where(first, score_s, torch.full_like(score_s, NEG_INF)), \
        rows_s


def _ivf_query(query_emb, w_asr, w_audio, centroids, members, spill,
               emb, success, *, n_probe: int, k: int, threshold: float):
    q = query_emb.float()
    score_s, rows_s = local_candidate_scores(
        q, centroids, members, spill, emb, success, w_asr, w_audio,
        n_probe=n_probe, threshold=threshold)
    kk = min(k, score_s.shape[0])
    top_i = _desc(score_s)[:kk]
    top_s = score_s[top_i]
    hit = top_s > NEG_INF / 2
    idx = torch.where(hit, rows_s[top_i], torch.zeros_like(top_i))
    # per-hit diagnostics, as fused_topk's result dict carries them
    sims_k = torch.einsum("kpd,d->kp", emb[idx].float(), q)
    w = _weights(w_asr, w_audio, q.device)
    eff_k = w * success[idx].float()
    eff_k = eff_k / eff_k.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return {
        "indices": torch.where(hit, idx, torch.full_like(idx, -1)),
        "scores": top_s,
        "valid": hit,
        "sims": sims_k,
        "effective_weights": eff_k,
        # counted AFTER dedup: a row reachable via two probed buckets
        # (or bucket + spill) passes ``ok`` once per occurrence
        "num_valid": (score_s > NEG_INF / 2).sum(),
    }


@dataclasses.dataclass
class IVFIndex:
    """Built IVF layout (centroids + buckets only: the index arrays stay
    where the exact path keeps them and are passed per call)."""
    centroids: torch.Tensor      # [C, D] float32
    members: torch.Tensor        # [C, cap] int32 row ids, -1 padded
    spill: torch.Tensor          # [S] int32 row ids (always scanned)
    n_rows: int
    # host seconds of build_ivf's stages: select, kmeans, assign, pack
    build_s: dict = dataclasses.field(default_factory=dict)

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    def search_fn(self, k: int = 10, n_probe: int = 8,
                  threshold: float = 0.1):
        """run(query_emb, w_asr, w_audio, emb, success) -> result dict
        (fused_topk's keys; misses carry index -1 / score NEG_INF).
        ``emb``/``success`` may be capacity-padded (index/store.py):
        member ids never point past n_rows."""
        n_probe_ = min(n_probe, int(self.members.shape[0]))

        def run(query_emb, w_asr, w_audio, emb, success):
            return _ivf_query(
                query_emb, w_asr, w_audio, self.centroids, self.members,
                self.spill, emb, success,
                n_probe=n_probe_, k=k, threshold=threshold)

        return run


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def build_ivf(
    emb,                         # [N, 2, D] unit-norm (numpy or tensor)
    success,                     # [N, 2] bool
    n_clusters: int | None = None,
    cap_factor: float = 4.0,
    iters: int = 10,
    seed: int = 0,
    centroids=None,
    device: torch.device | str = "cuda",
) -> IVFIndex:
    """Cluster every successful (row, slot) vector on ``device``; rows
    whose bucket overflows ``cap_factor`` x the mean occupancy land in
    the spill tail (scanned every query). A row assigned to the same
    cluster via both slots is inserted once. Pass ``centroids`` to skip
    k-means and only re-assign/re-pack (incremental rebuild after index
    growth)."""
    dev = runtime.select_device(device)
    t = [time.perf_counter()]
    emb_np = _host(emb, np.float32)
    suc_np = _host(success, bool)
    n = len(emb_np)
    flat = emb_np.reshape(-1, emb_np.shape[-1])      # [(N*2), D]
    rows = np.repeat(np.arange(n, dtype=np.int32), 2)
    ok = suc_np.reshape(-1) & (np.linalg.norm(flat, axis=1) > 0)
    x = flat[ok]
    rows_ok = rows[ok]
    t.append(time.perf_counter())
    if centroids is None:
        if n_clusters is None:
            n_clusters = max(1, int(np.sqrt(max(len(x), 1))))
        cent = spherical_kmeans(x, n_clusters, iters=iters, seed=seed,
                                device=dev)
    elif isinstance(centroids, torch.Tensor):
        cent = centroids.to(device=dev, dtype=torch.float32)
    else:
        cent = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t.append(time.perf_counter())
    n_clusters = int(cent.shape[0])
    assign = _chunked_argmax_sim(x, cent) if len(x) else \
        np.zeros(0, np.int32)
    t.append(time.perf_counter())
    members, spill_rows = pack_buckets(
        rows_ok, assign, n_clusters, len(x), cap_factor)
    out = IVFIndex(
        centroids=cent,
        members=torch.from_numpy(members).to(dev),
        spill=torch.from_numpy(spill_rows).to(dev),
        n_rows=n,
    )
    t.append(time.perf_counter())
    out.build_s = dict(zip(("select", "kmeans", "assign", "pack"),
                           np.diff(t).tolist()))
    return out


def calibrate_n_probe(
    ivf: IVFIndex,
    emb, success,                # the index arrays, on the layout's device
    queries: np.ndarray,         # [Q, D] unit-norm sample queries
    w: tuple[float, float] = (0.6, 0.4),
    target_overlap: float = 0.95,
    k: int = 10,
    threshold: float = 0.1,
) -> int:
    """Smallest power-of-two n_probe whose mean top-k overlap vs the
    exact scan meets ``target_overlap`` on the sample queries (doubling
    sweep; returns n_clusters if even a full probe is needed). Run once
    at deploy time with production-like queries, then pin the result in
    FusionConfig.ann_nprobe."""
    dev = ivf.centroids.device
    emb_d = torch.as_tensor(emb).to(dev)
    suc_d = torch.as_tensor(success).to(dev)
    qs = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)

    def hits(out) -> set:
        s = out["scores"].cpu().numpy()
        return set(out["indices"].cpu().numpy()[s > NEG_INF / 2].tolist())

    exact = [hits(fused_topk(q, emb_d, suc_d, w[0], w[1], k=k,
                             threshold=threshold)) for q in qs]
    n_probe = 1
    while n_probe < ivf.n_clusters:
        run = ivf.search_fn(k=k, n_probe=n_probe, threshold=threshold)
        overlaps = [len(hits(run(q, w[0], w[1], emb_d, suc_d)) & exact[qi])
                    / max(len(exact[qi]), 1) for qi, q in enumerate(qs)]
        if float(np.mean(overlaps)) >= target_overlap:
            return n_probe
        n_probe *= 2
    return ivf.n_clusters


def pack_buckets(rows_ok: np.ndarray, assign: np.ndarray,
                 n_clusters: int, n_vectors: int,
                 cap_factor: float = 4.0) \
        -> tuple[np.ndarray, np.ndarray]:
    """Vectorized bucket packing (a per-(row,slot) Python loop ran for
    minutes at the 10M target scale and executed inside the first query
    after any store growth): dedup (row, cluster) pairs, group by
    cluster with a stable sort (rows ascending within each cluster),
    fill each bucket to cap, spill the rest. Returns
    (members[C, cap] int32 -1-padded, spill[S] int32 sorted-unique)."""
    cap = max(1, int(np.ceil(cap_factor * max(n_vectors, 1) / n_clusters)))
    members = np.full((n_clusters, cap), -1, np.int32)
    if not len(rows_ok):
        return members, np.zeros(0, np.int32)
    pair = rows_ok.astype(np.int64) * n_clusters + assign.astype(np.int64)
    pair = np.unique(pair)       # both slots -> same cluster: insert once
    r = (pair // n_clusters).astype(np.int32)
    c = (pair % n_clusters).astype(np.int32)
    order = np.argsort(c, kind="stable")
    r_s, c_s = r[order], c[order]
    counts = np.bincount(c_s, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(c_s)) - starts[c_s]
    in_cap = pos < cap
    members[c_s[in_cap], pos[in_cap]] = r_s[in_cap]
    return members, np.unique(r_s[~in_cap]).astype(np.int32)


@dataclasses.dataclass
class ShardedIVF:
    """Per-shard IVF layouts stacked on a leading shard axis: centroids
    [dp, C, D], members [dp, C, cap], spill [dp, S] (-1 padded). Member
    ids are shard-local; the query makes them global, as
    parallel/sharding.py does."""
    centroids: torch.Tensor
    members: torch.Tensor
    spill: torch.Tensor
    n_rows: int                   # global rows covered (padding included)
    shard_rows: int               # rows a shard
    build_s: dict = dataclasses.field(default_factory=dict)

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[1])

    def place(self, devices, first: int = 0) -> tuple[list, list, list]:
        """(centroids, members, spill) of shards first.. as one entry a
        shard, each on its device in ``devices``."""
        return tuple([a[first + s].to(d) for s, d in enumerate(devices)]
                     for a in (self.centroids, self.members, self.spill))


def build_ivf_sharded(
    emb,                          # [N, 2, D] (N divisible by n_shards)
    success,                      # [N, 2]
    n_shards: int,
    n_clusters: int | None = None,
    cap_factor: float = 4.0,
    iters: int = 10,
    seed: int = 0,
    centroids=None,               # [n_shards, C, D] to reuse
    device: torch.device | str = "cuda",
) -> ShardedIVF:
    """One IVF layout per contiguous row block (the store's sharded view's
    blocks), built on ``device`` and stacked to uniform shapes: padding
    centroids have no members, so the query's live-cluster mask ranks
    them below every real cluster, and -1 member / spill padding is
    masked too. Pass ``centroids`` (a previous layout's stack) to skip
    each block's k-means and only re-assign / re-pack."""
    t0 = time.perf_counter()
    emb_np = _host(emb, np.float32)
    suc_np = _host(success, bool)
    n = len(emb_np)
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide into {n_shards} shards")
    if centroids is not None and centroids.shape[0] != n_shards:
        centroids = None        # shard count changed: full rebuild
    blk = n // n_shards
    parts = [build_ivf(emb_np[s * blk:(s + 1) * blk],
                       suc_np[s * blk:(s + 1) * blk],
                       n_clusters=n_clusters, cap_factor=cap_factor,
                       iters=iters, seed=seed + s,
                       centroids=None if centroids is None else centroids[s],
                       device=device)
             for s in range(n_shards)]
    dev = parts[0].centroids.device
    c_max = max(p.n_clusters for p in parts)
    cap_max = max(int(p.members.shape[1]) for p in parts)
    s_max = max(int(p.spill.shape[0]) for p in parts)
    cents = torch.zeros((n_shards, c_max, emb_np.shape[-1]),
                        dtype=torch.float32, device=dev)
    membs = torch.full((n_shards, c_max, cap_max), -1, dtype=torch.int32,
                       device=dev)
    spills = torch.full((n_shards, max(s_max, 1)), -1, dtype=torch.int32,
                        device=dev)
    for s, p in enumerate(parts):
        cents[s, : p.n_clusters] = p.centroids
        membs[s, : p.n_clusters, : p.members.shape[1]] = p.members
        spills[s, : p.spill.shape[0]] = p.spill
    return ShardedIVF(centroids=cents, members=membs, spill=spills,
                      n_rows=n, shard_rows=blk,
                      build_s={"seconds": time.perf_counter() - t0,
                               "shards": [p.build_s for p in parts]})


def ivf_shard_tops(query, cent: list, members: list, spill: list,
                   emb: list, success: list, w_asr, w_audio, *, k: int,
                   n_probe: int, threshold: float,
                   first: int = 0) -> list[tuple]:
    """Probe each shard's own buckets on its device, rescore exactly and
    keep the top k: one (query on the shard's device, deduped candidate
    scores, scores [k], local rows [k] (0 on a miss), global ids [k] (-1
    on a miss)) a shard. ``first``: the global index of the first
    shard."""
    out = []
    for s, e in enumerate(emb):
        q = query.to(e.device).float()
        score_s, rows_s = local_candidate_scores(
            q, cent[s], members[s], spill[s], e, success[s],
            w_asr, w_audio, n_probe=n_probe, threshold=threshold)
        top_s, top_i = local_topk(score_s, k)
        hit = top_s > NEG_INF / 2
        li = torch.where(hit, rows_s[top_i], torch.zeros_like(top_i))
        out.append((q, score_s, top_s, li,
                    torch.where(hit, li + (first + s) * e.shape[0],
                                torch.full_like(li, -1))))
    return out


def sharded_ivf_search_impl(mesh, layout: ShardedIVF, k: int = 10,
                            n_probe: int = 8, threshold: float = 0.1):
    """IVF search over ``mesh``'s data devices: fn(query, cent, members,
    spill, emb, success, w_asr, w_audio), every index-shaped argument a
    list of one entry a shard (``ShardedIVF.place``, the store's sharded
    view), returns the fused_topk-shaped dict with GLOBAL indices on the
    first data device. Each shard probes its own buckets; only k
    candidates a shard and their payloads move."""
    n_probe_ = min(n_probe, layout.n_clusters)
    dev0 = mesh.data_devices()[0]

    def fn(query, cent, members, spill, emb, success, w_asr, w_audio):
        tops = ivf_shard_tops(query, cent, members, spill, emb, success,
                              w_asr, w_audio, k=k, n_probe=n_probe_,
                              threshold=threshold)
        sims = [torch.einsum("kpd,d->kp", e[t[3]].float(), t[0])
                for t, e in zip(tops, emb)]
        succ = [ok[t[3]].float() for t, ok in zip(tops, success)]
        hits = [t[2] > NEG_INF / 2 for t in tops]
        sc, i, h, sim, su = merge_topk(
            [t[2] for t in tops], [[t[4] for t in tops], hits, sims, succ],
            tops[0][2].shape[-1], dev0)
        w = _weights(w_asr, w_audio, dev0)
        eff = w * su
        eff = eff / eff.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        # counted per row (deduped), then summed over the shards
        return {"indices": i, "scores": sc, "valid": h, "sims": sim,
                "effective_weights": eff,
                "num_valid": sum((t[1] > NEG_INF / 2).sum().to(dev0)
                                 for t in tops)}

    return fn
