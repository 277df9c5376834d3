"""Sharded index search: per-shard top-k, then a merge of the candidates.

Counterpart of ``multimodal_audio_search_tpu/parallel/sharding.py``. The
[N, 2, D] index lies as contiguous row blocks, one on each data device of
a mesh (``shard_index``, index/store.py's sharded view). Each shard is
scored on its own device by index/fusion.py's ``fused_scores`` in plain
torch, as the JAX package's sharded path scores it (it reaches no Pallas
kernel, so this reaches no K12), and reduced to k candidates; the local
indices are made global (+ shard * rows a shard), and only the k
candidates of each shard and their payloads move, to the mesh's first
data device, where they merge. N never moves.

The merge keeps ``lax.top_k``'s tie rule: the candidates are
concatenated in shard order, each shard's in rank order, and a stable
descending sort takes the first k, so equal scores go to the lower global
index. Padding rows keep NEG_INF and valid=False. k is at most the rows
of one shard (``min(k, N / dp)``), as in the JAX package.

A query may carry leading dims (q [Q, D] with weights [Q]): each shard is
then read once for all Q queries (``FusionSearcher.search_batch``).
"""
from __future__ import annotations

import torch

from ..index.fusion import _weights, fused_scores
from .mesh import Mesh, data_sharded


def _desc(x: torch.Tensor) -> torch.Tensor:
    """Indices of ``x`` sorted descending along -1, ties by position
    (lax.top_k)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1]


def local_topk(masked: torch.Tensor, k: int):
    """(scores, local indices) of the top ``min(k, n)`` of one shard."""
    top_i = _desc(masked)[..., :min(k, masked.shape[-1])]
    return masked.gather(-1, top_i), top_i


def merge_topk(scores: list, payloads: list[list], kk: int, dev):
    """Merge per-shard candidates (in shard order) on ``dev``: the
    concatenated scores' top ``kk`` and each payload's rows in that
    order. ``payloads[i]`` holds one tensor per shard, candidates on the
    last dim (or the second last for a trailing [.., 2] payload)."""
    s = torch.cat([x.to(dev) for x in scores], dim=-1)
    order = _desc(s)[..., :kk]
    out = [s.gather(-1, order)]
    for parts in payloads:
        p = torch.cat([x.to(dev) for x in parts], dim=s.dim() - 1)
        if p.dim() == s.dim():
            out.append(p.gather(-1, order))
        else:                               # [..., n, 2] rows
            out.append(p.gather(-2, order[..., None].expand(
                *order.shape, p.shape[-1])))
    return out


def shard_index(mesh: Mesh, emb, success):
    """Place the index arrays as contiguous row blocks over the mesh's
    data devices: (emb shards, success shards)."""
    return data_sharded(mesh, emb), data_sharded(mesh, success)


def _on(x, dev):
    return x.to(dev) if torch.is_tensor(x) else x


def shard_tops(query, emb: list, success: list, w_asr, w_audio, *, k: int,
               threshold: float, first: int = 0) -> list[tuple]:
    """Score each shard on its device and keep its top k: one (query on
    the shard's device, valid [N/dp], scores [k], local rows [k], global
    ids [k]) a shard. ``first``: the global index of the first shard."""
    out = []
    for s, (e, ok) in enumerate(zip(emb, success)):
        q = _on(query, e.device)
        masked, valid = fused_scores(q, e, ok, _on(w_asr, e.device),
                                     _on(w_audio, e.device), threshold)
        top_s, top_i = local_topk(masked, k)
        out.append((q, valid, top_s, top_i,
                    top_i + (first + s) * masked.shape[-1]))
    return out


def sharded_fused_topk(mesh: Mesh, k: int = 10, threshold: float = 0.1):
    """fn(query[D], emb shards, success shards, w_asr, w_audio) ->
    (scores[k], global indices[k]) on the mesh's first data device; the
    shards as ``shard_index`` places them (N divides the data axis)."""
    dev = mesh.data_devices()[0]

    def fn(query, emb, success, w_asr, w_audio):
        tops = shard_tops(query, emb, success, w_asr, w_audio, k=k,
                          threshold=threshold)
        return tuple(merge_topk([t[2] for t in tops], [[t[4] for t in tops]],
                                tops[0][2].shape[-1], dev))

    return fn


def sharded_fused_search_impl(mesh: Mesh, k: int = 10,
                              threshold: float = 0.1):
    """The full-payload sharded search: fn(query, emb shards, success
    shards, w_asr, w_audio) -> the dict of index/fusion.py::fused_topk
    (indices, scores, valid, sims, effective_weights, num_valid) on the
    mesh's first data device, from k candidates a shard and their [k, 2]
    payloads; ``num_valid`` summed over the shards."""
    dev = mesh.data_devices()[0]

    def fn(query, emb, success, w_asr, w_audio):
        tops = shard_tops(query, emb, success, w_asr, w_audio, k=k,
                          threshold=threshold)
        sims = [torch.einsum("...kpd,...d->...kp", e[t[3]].float(),
                             t[0].float()) for t, e in zip(tops, emb)]
        succ = [ok[t[3]].float() for t, ok in zip(tops, success)]
        vals = [t[1].gather(-1, t[3]) for t in tops]
        s, i, v, sim, sc = merge_topk(
            [t[2] for t in tops], [[t[4] for t in tops], vals, sims, succ],
            tops[0][2].shape[-1], dev)
        w = _weights(_on(w_asr, dev), _on(w_audio, dev), dev)
        eff = w[..., None, :] * sc
        eff = eff / eff.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        return {"indices": i, "scores": s, "valid": v, "sims": sim,
                "effective_weights": eff,
                "num_valid": sum(t[1].sum(dim=-1).to(dev) for t in tops)}

    return fn
